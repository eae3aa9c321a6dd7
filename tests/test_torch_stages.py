"""The MSC schedule's stages in isolation: `core/schedule.py`'s
`build_epilogue_rowsum` and `build_mode_runner` across gloo ranks, and
their traced forms (`launch/dryrun.py:lower_epilogue`,
`lower_mode_stage`) on fake process groups, held to the reference.

One spawn of four gloo ranks (a FileStore under the test's temporary
directory, one thread per rank, bounded by a join timeout) runs every
rank-side case and writes each rank's results to a .npz:
  * the epilogue at the reference test's cell (p = 4, m = 32, c = 16;
    `tests/test_ring_epilogue.py`) and at m = 30 (padding), over a (4,)
    mesh, over every dim of a (2, 2) mesh (one group, row-major) and over
    its "slice" dim alone, with kernels off and on (on the CPU a kernel
    wrapper runs its plain version);
  * the mode runner on a (2, 2) ("slice", "inner") mesh at m = 45, γ = 70
    (the reference's padding cell, `benchmarks/inner_shard.py`).
The reference's oracles run in this process: `repro.kernels.ref.
ring_rowsum` (its bound, rtol = atol = 1e-6) and `msc_sequential` (masks
and sweeps identical, d within 3e-5 relative).  The traced forms are
held to the reference benchmarks' bars: the ring's p−1 permutes and link
bytes within 10% of `epilogue_model`, the all-gather's landing buffer
p× the ring's, the block bytes shrinking ≥ 0.8·q× with the inner dim.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MSCConfig, build_epilogue_rowsum  # noqa: E402
from repro_torch.core.msc import mode_slices  # noqa: E402
from repro_torch.core.schedule import (ModeSchedule,  # noqa: E402
                                       build_mode_runner, pad_to)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import _mesh  # noqa: E402
from repro_torch.roofline import eigensolve_model  # noqa: E402
from repro_torch.roofline import epilogue_model  # noqa: E402
from repro_torch.roofline.trace import fake_world  # noqa: E402

SPAWN_TIMEOUT = 150  # seconds for the spawn: its ranks and all its cases
P, C = 4, 16
EPI_ROWS = (32, 30)  # the reference test's m, and one that pads
# name: (mesh shape, the dims the epilogue runs over (None: every dim))
EPI_MESHES = {"4": ((4,), None), "2x2": ((2, 2), None),
              "2x2-slice": ((2, 2), "slice")}
EPI_CASES = [(mk, m, e, k) for mk in EPI_MESHES for m in EPI_ROWS
             for e in ("ring", "allgather") for k in (False, True)]
M, GAMMA = 45, 70.0  # the mode runner's cell: m pads on both dims
D_TOL = 3e-5


def _msc_cfg(cls):
    """The reference benchmark's config at m = M (either package's)."""
    return cls(epsilon=0.5 / (M - max(1, M // 10)) ** 2,
               max_extraction_iters=M)


def _stage_worker(device, in_path, out_dir):
    """One rank: every epilogue case and the mode runner's three modes;
    its results to out_dir/rank{r}.npz."""
    import torch.distributed as dist

    from repro_torch.core.parallel import _flat_schedule

    inputs = dict(np.load(in_path))
    rank = dist.get_rank()
    out = {}
    meshes = {shape: _mesh(shape, ("slice", "inner")[:len(shape)], "cpu")
              for shape in {s for s, _ in EPI_MESHES.values()}}
    for mk, m, epi, kernels in EPI_CASES:
        shape, axis_name = EPI_MESHES[mk]
        stage = build_epilogue_rowsum(
            meshes[shape], MSCConfig(epilogue=epi, use_kernels=kernels),
            axis_name)
        d_rows = stage(stage.rows(torch.from_numpy(inputs[f"V{m}"])))
        key = f"{mk}/{m}/{epi}/{kernels}"
        out[f"{key}/rows"] = d_rows.numpy()
        out[f"{key}/whole"] = stage.gather(d_rows, m).numpy()
        out[f"{key}/index"] = np.asarray([stage.index, stage.shards])
    sched = _flat_schedule(_msc_cfg(MSCConfig), meshes[(2, 2)])
    assert isinstance(sched, ModeSchedule) and sched.inner_shards == 2
    run = build_mode_runner(sched)
    tensor = torch.from_numpy(inputs["T"])
    for j in range(3):
        slices = mode_slices(tensor, j)
        block, valid_local = sched.local_block(slices)
        d, lam, iters = run(block, valid_local)
        m_pad, _ = sched.pad_amounts(M, M)
        res = sched.finalize_mode(d, lam, iters,
                                  torch.arange(m_pad) < M, M)
        out[f"mode/{j}/block"] = np.asarray(block.shape)
        out[f"mode/{j}/mask"] = res.mask.numpy()
        out[f"mode/{j}/d"] = res.d.numpy()
        out[f"mode/{j}/lam"] = res.lambdas.numpy()
        out[f"mode/{j}/iters"] = np.asarray(int(res.power_iters_run))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """V at both row counts (numpy, seed 0) and the reference's planted
    tensor at its padding cell, saved for the ranks."""
    import jax

    from repro.core import PlantedSpec, make_planted_tensor

    rng = np.random.default_rng(0)
    data = {f"V{m}": rng.standard_normal((m, C)).astype(np.float32)
            for m in EPI_ROWS}
    data["T"] = np.asarray(make_planted_tensor(
        jax.random.PRNGKey(0), PlantedSpec.paper(M, GAMMA)), np.float32)
    tmp = tmp_path_factory.mktemp("stages")
    path = tmp / "inputs.npz"
    np.savez(path, **data)
    return tmp, str(path), data


@pytest.fixture(scope="module")
def ranks(inputs):
    """[rank 0's results, …, rank 3's] of the one spawn."""
    tmp, in_path, _ = inputs
    out = tmp / "ranks"
    out.mkdir()
    tmesh.spawn(_stage_worker, P, out / "store", in_path, str(out),
                device_type="cpu",
                timeout=tmesh.datetime.timedelta(seconds=120),
                join_timeout=SPAWN_TIMEOUT)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(P)]


def _padded(v, p):
    out = np.zeros((pad_to(v.shape[0], p), v.shape[1]), np.float32)
    out[:v.shape[0]] = v
    return out


# ------------------------------------------------------------ (a) --
@pytest.mark.parametrize("mesh_key,m,epilogue,kernels", EPI_CASES,
                         ids=[f"{mk}-m{m}-{e}-{'k' if k else 'plain'}"
                              for mk, m, e, k in EPI_CASES])
def test_epilogue_matches_the_references_oracle(ranks, inputs, mesh_key, m,
                                                epilogue, kernels):
    """Each rank's rows of d: the ring's equal the reference's
    `ring_rowsum(chunks, i)` (its summation order, rank i of the group),
    the all-gather's a numpy row sum of |V Vᵀ| (float64), both within
    rtol = atol = 1e-6; the gathered d is the whole d on every rank."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    v = inputs[2][f"V{m}"]
    key = f"{mesh_key}/{m}/{epilogue}/{kernels}"
    for r, got in enumerate(ranks):
        i, p = (int(x) for x in got[f"{key}/index"])
        assert p == (2 if mesh_key == "2x2-slice" else 4)
        vp = _padded(v, p)
        rows = vp.shape[0] // p
        chunks = [jnp.asarray(vp[k * rows:(k + 1) * rows]) for k in range(p)]
        if epilogue == "ring":
            want = np.asarray(jref.ring_rowsum(chunks, i))
            whole = np.concatenate([np.asarray(jref.ring_rowsum(chunks, k))
                                    for k in range(p)])[:m]
        else:
            full = np.abs(vp.astype(np.float64) @ vp.astype(np.float64).T
                          ).sum(1)
            want, whole = full[i * rows:(i + 1) * rows], full[:m]
        np.testing.assert_allclose(got[f"{key}/rows"], want, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{key}/whole"], whole, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


# ------------------------------------------------------------ (b) --
@pytest.fixture(scope="module")
def sequential(inputs):
    from repro.core import MSCConfig as JConfig
    from repro.core import msc_sequential

    return msc_sequential(inputs[2]["T"], _msc_cfg(JConfig))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mode_runner_matches_msc_sequential(ranks, sequential, mode):
    """The (2, 2) mesh's stage of each mode, gathered and extracted: the
    reference's `msc_sequential` masks and sweeps, d within 3e-5 relative;
    each rank was handed only its (m'/2, r'/2, c) block; every rank holds
    the same result."""
    want = sequential[mode]
    got = ranks[0]
    assert tuple(got[f"mode/{mode}/block"]) == (23, 23, M)
    np.testing.assert_array_equal(got[f"mode/{mode}/mask"],
                                  np.asarray(want.mask))
    assert int(got[f"mode/{mode}/iters"]) == int(want.power_iters_run)
    wd = np.asarray(want.d)
    rel = np.max(np.abs(got[f"mode/{mode}/d"] - wd)) / np.max(np.abs(wd))
    assert rel <= D_TOL, rel
    for other in ranks[1:]:
        for f in ("mask", "d", "lam", "iters"):
            np.testing.assert_array_equal(other[f"mode/{mode}/{f}"],
                                          got[f"mode/{mode}/{f}"])


# ------------------------------------------------------------ (c) --
@pytest.mark.parametrize("p", [4, 8, 32])
def test_traced_epilogues_match_the_comm_model(p):
    """The ring: p−1 collective-permutes and no all-gather, link bytes
    within 10% of the reference's and the port's `epilogue_model`; the
    all-gather: one all-gather, its landing buffer ≥ p× the ring's (the
    reference benchmark's bars, at its full cell m = c = 1000)."""
    from repro.roofline import epilogue_model as jmodel

    m = c = 1000
    with fake_world(p):
        mesh = _mesh((p,), ("slice",), "cpu")
        ring = D.lower_epilogue(m, c, mesh, MSCConfig(epilogue="ring"))
        gather = D.lower_epilogue(m, c, mesh,
                                  MSCConfig(epilogue="allgather"))
    kinds = ring.by_kind()
    assert set(kinds) == {"collective-permute"}
    assert kinds["collective-permute"]["count"] == p - 1
    link = kinds["collective-permute"]["link_bytes"]
    for model in (jmodel, epilogue_model):
        pred = model(m, c, p, epilogue="ring")["link_bytes"]
        assert abs(link - pred) <= 0.1 * pred, (link, pred)
    g = gather.by_kind()
    assert set(g) == {"all-gather"} and g["all-gather"]["count"] == 1
    pred = epilogue_model(m, c, p, epilogue="allgather")
    assert abs(g["all-gather"]["link_bytes"] - pred["link_bytes"]) \
        <= 0.1 * pred["link_bytes"]
    assert D.landing_bytes(gather, "allgather") == pred["peak_buffer_bytes"]
    assert D.landing_bytes(gather, "allgather") >= \
        p * D.landing_bytes(ring, "ring") > 0


def test_traced_mode_stage_shrinks_with_the_inner_dim():
    """The stage at p = 4, m = 96 on (4, q) meshes: the traced argument
    bytes are `eigensolve_model`'s block bytes a device (the reference's
    and the port's) plus the slice mask's m'/p bytes, and shrink ≥ 0.8·q×
    against q = 1."""
    from repro.roofline import eigensolve_model as jmodel

    p, m = 4, 96
    args = {}
    for q in (1, 2, 4, 8):
        with fake_world(p * q):
            mesh = _mesh((p, q), ("slice", "inner"), "cpu")
            trace = D.lower_mode_stage(m, mesh, MSCConfig())
        block = eigensolve_model(m, m, m, p, q)["block_bytes_per_device"]
        assert block == jmodel(m, m, m, p, q)["block_bytes_per_device"]
        assert trace.argument_bytes == block + pad_to(m, p) // p
        assert trace.peak_bytes > 0
        assert trace.counts()["all_reduce"] > 0
        args[q] = trace.argument_bytes
    for q, b in args.items():
        assert args[1] / b >= 0.8 * q, (q, args)
