"""The port's parallel schedules across gloo ranks on the CPU.

Each mesh shape is one spawn of gloo ranks (a FileStore under the test's
temporary directory, one thread per rank, every spawn bounded by a join
timeout so that a deadlock fails instead of hanging) that runs all of
that shape's cases and writes every rank's results to a .npz.  The
reference's einsum path runs the same cases on the same mesh shapes in
one subprocess of forced host devices (`conftest.run_with_devices`),
started first so that it runs while the ranks do.

Held (ROADMAP.md's bounds): masks and `power_iters_run` identical to the
reference's per mode, d and λ within 3e-5 relative in fp32 and 1e-2
under bf16_fp32; every rank's result identical; `collective_stream`
bit-identical to `collective` and `inner_overlap` to the fused form; the
ring on rank i bit-identical to `kernels/ref.py:ring_rowsum(chunks,
start=i)`; the mesh path against the port's one-device path.

On a card (`pytest -m gpu`), one NCCL rank holds the (1,) and (1, 1)
meshes bit-identical to the one-device path.  This file imports jax only
inside the CPU fixtures (the card's machine has no jax).
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (MSCConfig, build_msc_batched,  # noqa: E402
                              build_msc_parallel, msc_sequential)
from repro_torch.core.schedule import epilogue_rowsum  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 150  # seconds for one spawn: its ranks and all its cases
EPS = 1e-4

# name: (schedule, mesh shape, ranks, input tensor)
MESHES = {
    "flat2": ("flat", (2,), 2, "A"),
    "flat3": ("flat", (3,), 3, "A"),
    "flat4": ("flat", (4,), 4, "A"),
    "flat2x2": ("flat", (2, 2), 4, "A"),
    "grouped3": ("grouped", None, 3, "C"),
    "grouped3x2": ("grouped", (2,), 6, "C"),  # two slice ranks per group
    "grouped3x1x2": ("grouped", (3, 1, 2), 6, "C"),
}

# case: (relayout, epilogue, precision, matrix_free, use_kernels,
#        inner_overlap); the reference runs the same relayout, epilogue,
#        precision and eigensolver on its einsum path
FLAT_CASES = {
    "gspmd": ("gspmd", "allgather", "fp32", True, False, False),
    "gspmd_ring_k": ("gspmd", "ring", "fp32", True, True, False),
    "collective_k": ("collective", "allgather", "fp32", True, True, False),
    "stream_k": ("collective_stream", "allgather", "fp32", True, True,
                 False),
    "bf16_k": ("gspmd", "allgather", "bf16_fp32", True, True, False),
    "gram_ring_k": ("collective", "ring", "fp32", False, True, False),
    "overlap": ("gspmd", "allgather", "fp32", True, False, True),
}
GROUPED_CASES = {
    "base": (None, "allgather", "fp32", True, False, False),
    "ring_k": (None, "ring", "fp32", True, True, False),
    "bf16_k": (None, "allgather", "bf16_fp32", True, True, False),
    "gram_k": (None, "allgather", "fp32", False, True, False),
    "overlap": (None, "allgather", "fp32", True, False, True),
}
# batched on (2,): B = 2 requests bucket-padded to one shape
BATCH_CASES = ("gspmd", "collective")
BATCH_DIMS = np.array([[13, 11, 10], [10, 12, 9]], np.int32)


def _cases(mesh_key):
    return FLAT_CASES if MESHES[mesh_key][0] == "flat" else GROUPED_CASES


def _cfg(case) -> MSCConfig:
    _, epilogue, precision, matrix_free, kernels, overlap = case
    return MSCConfig(epsilon=EPS, epilogue=epilogue, precision=precision,
                     matrix_free=matrix_free, use_kernels=kernels,
                     inner_overlap=overlap)


def _planted(shape, sizes, gamma, seed) -> np.ndarray:
    """γ·w⊗u⊗v + N(0, 1) noise, the factors uniform on their first
    `sizes` entries (the paper's planted model), made with numpy."""
    rng = np.random.default_rng(seed)
    fs = []
    for n, l in zip(shape, sizes):
        f = np.zeros(n, np.float32)
        f[:l] = 1.0 / np.sqrt(l)
        fs.append(f)
    t = gamma * np.einsum("i,j,k->ijk", *fs)
    return (t + rng.standard_normal(shape)).astype(np.float32)


def _inputs() -> dict:
    """A: a non-cube tensor whose dims 2, 3 and 4 do not divide (every
    padding path runs); C: a cube for the grouped schedule (its inner dim
    pads the rows); the batched bucket; V: rows of a similarity epilogue."""
    batch = np.zeros((2, 13, 12, 10), np.float32)
    for i, dims in enumerate(BATCH_DIMS):
        batch[i, :dims[0], :dims[1], :dims[2]] = _planted(
            tuple(dims), (3, 3, 2), 30.0, 10 + i)
    rng = np.random.default_rng(7)
    return {"A": _planted((13, 11, 10), (3, 3, 2), 28.0, 1),
            "C": _planted((13, 13, 13), (3, 3, 3), 30.0, 2),
            "batch": batch, "batch_dims": BATCH_DIMS,
            "V": rng.standard_normal((12, 7)).astype(np.float32),
            "VB": rng.standard_normal((2, 12, 7)).astype(np.float32)}


def _store(out, key, res):
    for j, mr in enumerate(res.modes):
        out[f"{key}/{j}/mask"] = mr.mask.numpy()
        out[f"{key}/{j}/d"] = mr.d.numpy()
        out[f"{key}/{j}/lam"] = mr.lambdas.numpy()
        out[f"{key}/{j}/iters"] = np.asarray(mr.power_iters_run)


def _port_worker(device, mesh_key, in_path, out_dir):
    """One rank: every case of `mesh_key` on its mesh (and rank 0 the
    one-device runs of the flat cases), then the epilogues on rows of V;
    the results to out_dir/rank{r}.npz."""
    import torch.distributed as dist

    schedule, shape, _, tname = MESHES[mesh_key]
    inputs = dict(np.load(in_path))
    t = torch.from_numpy(inputs[tname])
    rank = dist.get_rank()
    mesh = tmesh.make_msc_mesh(schedule, shape, "cpu")
    out = {}
    for name, case in _cases(mesh_key).items():
        kw = {"relayout": case[0]} if schedule == "flat" else {}
        _store(out, name, build_msc_parallel(_cfg(case), schedule,
                                             mesh=mesh, **kw)(t))
        if schedule == "flat" and rank == 0:
            _store(out, f"one/{name}", build_msc_parallel(
                _cfg(case), "flat", device="cpu")(t))
    if mesh_key == "flat2":
        for relayout in BATCH_CASES:
            res = build_msc_batched(_cfg(FLAT_CASES["gspmd"]), mesh=mesh,
                                    relayout=relayout)(
                torch.from_numpy(inputs["batch"]),
                torch.from_numpy(inputs["batch_dims"]))
            _store(out, f"batched/{relayout}", res)
    if schedule == "flat" and len(shape) == 1:
        # the epilogues on this rank's rows of V, over the slice group
        group = mesh.get_group("slice")
        for vname in ("V", "VB"):
            v = torch.from_numpy(inputs[vname])
            rows = v.shape[-2] // dist.get_world_size(group)
            mine = v[..., rank * rows:(rank + 1) * rows, :]
            for kernels in (False, True):
                for epi in ("ring", "allgather"):
                    cfg = MSCConfig(epilogue=epi, use_kernels=kernels)
                    out[f"epi/{vname}/{epi}/{kernels}"] = epilogue_rowsum(
                        mine, cfg=cfg, group=group).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


REFERENCE = r"""
import numpy as np, jax
from repro.core import MSCConfig
from repro.core.parallel import (build_msc_batched, build_msc_parallel,
                                 make_msc_mesh)
inputs = dict(np.load({in_path!r}))
meshes = {meshes!r}
out = {{}}

def store(key, res, batched=False):
    for j, mr in enumerate(res.modes):
        out[key + "/%d/mask" % j] = np.asarray(mr.mask)
        out[key + "/%d/d" % j] = np.asarray(mr.d)
        out[key + "/%d/lam" % j] = np.asarray(mr.lambdas)
        out[key + "/%d/iters" % j] = np.asarray(mr.power_iters_run)

for key, (schedule, shape, n, tname, cases) in meshes.items():
    mesh = make_msc_mesh(schedule, devices=jax.devices()[:n], shape=shape)
    done = {{}}
    for name, (relayout, epi, prec, mf) in cases.items():
        spec = (relayout, epi, prec, mf)
        if spec not in done:
            cfg = MSCConfig(epsilon={eps!r}, epilogue=epi, precision=prec,
                            matrix_free=mf)
            kw = {{"relayout": relayout}} if schedule == "flat" else {{}}
            done[spec] = build_msc_parallel(mesh, cfg, schedule, **kw)(
                inputs[tname])
        store(key + "/" + name, done[spec])
    if key == "flat2":
        for relayout in {batch_cases!r}:
            res = build_msc_batched(mesh, MSCConfig(epsilon={eps!r}),
                                    relayout=relayout)(
                inputs["batch"], inputs["batch_dims"])
            store(key + "/batched/" + relayout, res)
np.savez({out_path!r}, **out)
print("OK")
"""


class Runs:
    """The inputs, the reference's subprocess (started at once, in a
    thread) and one spawn of gloo ranks per mesh shape, each run once."""

    def __init__(self, tmp, subproc):
        self.tmp = tmp
        self.in_path = str(tmp / "inputs.npz")
        np.savez(self.in_path, **_inputs())
        self.port_runs = {}
        ref_path = str(tmp / "reference.npz")
        meshes = {k: (sched, shape, n, tname, {
            name: ("collective" if c[0] == "collective_stream" else c[0],
                   c[1], c[2], c[3]) for name, c in _cases(k).items()})
            for k, (sched, shape, n, tname) in MESHES.items()}
        code = REFERENCE.format(in_path=self.in_path, out_path=ref_path,
                                meshes=meshes, eps=EPS,
                                batch_cases=BATCH_CASES)
        self.ref_path, self.ref_error, self.ref_data = ref_path, None, None

        def reference():
            try:
                subproc(code, 6, timeout=300)
            except BaseException as e:  # noqa: BLE001 - raised in ref()
                self.ref_error = e

        self.thread = threading.Thread(target=reference, daemon=True)
        self.thread.start()

    def ref(self) -> dict:
        for mesh_key in MESHES:  # the ranks' runs, while the reference runs
            self.port(mesh_key)
        self.thread.join(320)
        assert not self.thread.is_alive(), "the reference did not end"
        if self.ref_error is not None:
            raise self.ref_error
        if self.ref_data is None:
            self.ref_data = dict(np.load(self.ref_path))
        return self.ref_data

    def port(self, mesh_key):
        """[rank 0's results, …, rank n−1's] of the mesh's spawn."""
        if mesh_key not in self.port_runs:
            out = self.tmp / mesh_key
            out.mkdir()
            n = MESHES[mesh_key][2]
            tmesh.spawn(_port_worker, n, out / "store", mesh_key,
                        self.in_path, str(out), device_type="cpu",
                        timeout=tmesh.datetime.timedelta(seconds=120),
                        join_timeout=SPAWN_TIMEOUT)
            self.port_runs[mesh_key] = [dict(np.load(out / f"rank{r}.npz"))
                                        for r in range(n)]
        return self.port_runs[mesh_key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    return Runs(tmp_path_factory.mktemp("parallel"), subproc)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _hold_to_reference(port, ref, key, ref_key, precision, modes=range(3),
                       trim=None):
    tol = 3e-5 if precision == "fp32" else 1e-2
    for j in modes:
        p = lambda f: port[f"{key}/{j}/{f}"]  # noqa: E731
        r = lambda f: ref[f"{ref_key}/{j}/{f}"]  # noqa: E731
        np.testing.assert_array_equal(p("mask"), r("mask"), err_msg=key)
        np.testing.assert_array_equal(p("iters"), r("iters"), err_msg=key)
        for f in ("d", "lam"):
            assert _rel(p(f), r(f)) <= tol, (key, j, f, _rel(p(f), r(f)))


CASE_IDS = [(k, c) for k in MESHES for c in _cases(k)]


@pytest.mark.parametrize("mesh_key,case", CASE_IDS,
                         ids=[f"{k}-{c}" for k, c in CASE_IDS])
def test_mesh_case_matches_reference(runs, mesh_key, case):
    port = runs.port(mesh_key)[0]
    _hold_to_reference(port, runs.ref(), case, f"{mesh_key}/{case}",
                       _cases(mesh_key)[case][2])


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_every_rank_holds_the_same_result(runs, mesh_key):
    ranks = runs.port(mesh_key)
    for r, other in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            if k.startswith(("one/", "epi/")):
                continue  # rank 0's alone, or the rank's own rows
            np.testing.assert_array_equal(other[k], v, err_msg=f"{k} {r}")


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_stream_and_overlap_keep_the_bits(runs, mesh_key):
    """collective_stream is collective's bits; inner_overlap the fused
    form's (two inner ranks at most on these meshes)."""
    port = runs.port(mesh_key)[0]
    pairs = [("overlap", "base" if "grouped" in mesh_key else "gspmd")]
    if "flat" in mesh_key:
        pairs.append(("stream_k", "collective_k"))
    for a, b in pairs:
        for j in range(3):
            for f in ("mask", "d", "lam", "iters"):
                np.testing.assert_array_equal(port[f"{a}/{j}/{f}"],
                                              port[f"{b}/{j}/{f}"],
                                              err_msg=f"{a} {b} {j} {f}")


@pytest.mark.parametrize("mesh_key", ["flat2", "flat3", "flat4", "flat2x2"])
def test_mesh_matches_the_one_device_path(runs, mesh_key):
    port = runs.port(mesh_key)[0]
    for case, c in FLAT_CASES.items():
        tol = 3e-5 if c[2] == "fp32" else 1e-2
        for j in range(3):
            one = lambda f: port[f"one/{case}/{j}/{f}"]  # noqa: E731
            np.testing.assert_array_equal(port[f"{case}/{j}/mask"],
                                          one("mask"))
            np.testing.assert_array_equal(port[f"{case}/{j}/iters"],
                                          one("iters"))
            assert _rel(port[f"{case}/{j}/d"], one("d")) <= tol


@pytest.mark.parametrize("mesh_key", ["flat2", "flat3", "flat4"])
def test_ring_sums_in_the_reference_order(runs, mesh_key):
    """The ring on rank i is `ref.ring_rowsum(chunks, start=i)` bit for
    bit (unbatched and under a request dim, kernels off and on: on the
    CPU both are the plain fp32 products); allgather is
    `ref.similarity_rowsum` against the whole V."""
    ranks = runs.port(mesh_key)
    inputs = dict(np.load(runs.in_path))
    p = len(ranks)
    for vname in ("V", "VB"):
        v = torch.from_numpy(inputs[vname])
        rows = v.shape[-2] // p
        chunks = [v[..., i * rows:(i + 1) * rows, :] for i in range(p)]
        for i, got in enumerate(ranks):
            want = kref.ring_rowsum(chunks, start=i).numpy()
            full = kref.similarity_rowsum(chunks[i], v).numpy()
            for kernels in (False, True):
                np.testing.assert_array_equal(
                    got[f"epi/{vname}/ring/{kernels}"], want)
                np.testing.assert_array_equal(
                    got[f"epi/{vname}/allgather/{kernels}"], full)


@pytest.mark.parametrize("relayout", BATCH_CASES)
def test_batched_on_a_mesh_matches_reference(runs, relayout):
    """build_msc_batched on (2,) with B = 2, each request held to the
    reference's batched runner on 2 forced devices at its true size."""
    port = runs.port("flat2")[0]
    ref = runs.ref()
    key = f"batched/{relayout}"
    for j in range(3):
        for i, dims in enumerate(BATCH_DIMS):
            m = dims[j]
            pf = lambda f: port[f"{key}/{j}/{f}"][i]  # noqa: E731
            rf = lambda f: ref[f"flat2/{key}/{j}/{f}"][i]  # noqa: E731
            np.testing.assert_array_equal(pf("mask")[:m], rf("mask")[:m])
            assert int(pf("iters")) == int(rf("iters"))
            for f in ("d", "lam"):
                assert _rel(pf(f)[:m], rf(f)[:m]) <= 3e-5


def _raise(device, exc):
    raise exc


def test_a_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*boom"):
        tmesh.spawn(_raise, 2, tmp_path / "store", ValueError("boom"),
                    device_type="cpu", join_timeout=SPAWN_TIMEOUT)


def _stall(device):
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(600)  # never reaches the collective


def test_a_stuck_rank_fails_the_spawn_within_its_timeout(tmp_path):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running"):
        tmesh.spawn(_stall, 2, tmp_path / "store", device_type="cpu",
                    join_timeout=5)
    assert time.monotonic() - t0 < 40


# ---------------------------------------------------------- pure parts

MESH_SHAPE_CASES = [
    ("flat", 8, None), ("flat", 8, (4, 2)), ("flat", 8, (4, 4)),
    ("flat", 8, (2, 2, 2)), ("grouped", 6, None), ("grouped", 12, (2, 2)),
    ("grouped", 12, (3, 2, 2)), ("grouped", 8, (2, 2, 2)),
    ("grouped", 7, None), ("grouped", 12, (2, 4)), ("spiral", 8, None),
]


@pytest.fixture(scope="module")
def jref():
    """The reference's pure functions (jax imported here only)."""
    from repro.kernels import ref as jkref
    from repro.launch import mesh as jmesh

    return jmesh, jkref


@pytest.mark.parametrize("schedule,n,shape", MESH_SHAPE_CASES)
def test_msc_mesh_shape_is_the_references(jref, schedule, n, shape):
    """Every input of tests/test_inner_shard.py::TestMscMeshShape: the
    same names and dims, or a ValueError with the same text."""
    def call(fn):
        try:
            return fn(schedule, n, shape)
        except ValueError as e:
            return ("ValueError", str(e))

    assert call(tmesh.msc_mesh_shape) == call(jref[0].msc_mesh_shape)


@pytest.mark.parametrize("p", [1, 2, 3, 5])
def test_ring_and_similarity_rowsum_are_the_references(jref, p):
    import jax.numpy as jnp

    rng = np.random.default_rng(p)
    v = rng.standard_normal((4 * p, 9)).astype(np.float32)
    chunks = np.split(v, p)
    tchunks = [torch.from_numpy(c) for c in chunks]
    for start in range(p):
        got = kref.ring_rowsum(tchunks, start=start).numpy()
        want = np.asarray(jref[1].ring_rowsum(
            [jnp.asarray(c) for c in chunks], start=start))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        # the ring's sum is the whole row sum, in another order
        full = kref.similarity_rowsum(tchunks[start],
                                      torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, full, rtol=1e-5)
        np.testing.assert_allclose(full, np.asarray(
            jref[1].similarity_rowsum(jnp.asarray(chunks[start]),
                                      jnp.asarray(v))), rtol=1e-6)


def _stub_mesh(*names):
    """Enough of a DeviceMesh for the checks that run before any
    collective: its dim names."""
    import types

    return types.SimpleNamespace(mesh_dim_names=names)


def _closed(mesh):
    """What raised naming item 9 (rest) before it was ported, each case on
    `mesh` (a (1,) gloo mesh) beside its one-device form: (on the mesh,
    on one device), equal when it runs."""
    from repro_torch.core.parallel import MSCChunkPlan
    from repro_torch.core.power_iter import SolveState
    from repro_torch.core.schedule import ModeSchedule
    from repro_torch.serving.msc_engine import (MSCContinuousEngine,
                                                MSCServeEngine)
    from repro_torch.sharding.specs import msc_axes

    cfg = MSCConfig(epsilon=EPS)
    reqs = [_planted((9, 8, 7), (3, 3, 2), 30.0, i) for i in range(2)]
    block = torch.from_numpy(_planted((2, 6, 5), (2, 2, 2), 20.0, 5))[None]

    def carry(sched):
        return sched.init_mode_carry(1, 2, 5, torch.tensor([5]),
                                     torch.tensor([False]))

    def fields(x):
        if isinstance(x, SolveState):
            return [getattr(x, f) for f in ("v", "lam", "resid", "iters",
                                            "done")]
        if isinstance(x, tuple):
            return [t for y in x for t in fields(y)]
        if isinstance(x, list):  # engine results
            return [t for r in x for m in r.modes
                    for t in (m.mask, m.d, m.lambdas)]
        return [x]

    def both(make):
        return tuple(fields(make(m)) for m in (mesh, None))

    one = ModeSchedule(cfg)
    return {
        "serve_engine": lambda: both(lambda m: MSCServeEngine(
            cfg, max_batch=2, mesh=m, device="cpu").run(reqs)),
        "continuous_engine": lambda: both(lambda m: MSCContinuousEngine(
            cfg, slots=2, mesh=m, device="cpu").run(reqs)),
        "chunk_plan": lambda: both(lambda m: MSCChunkPlan(
            cfg, mesh=m, device="cpu").mode_shapes((9, 8, 7), 2)),
        "chunk_local": lambda: both(lambda m: (
            ModeSchedule(cfg, m, ("slice",)) if m else one).chunk_local(
            block, carry(one))),
        "finalize_local": lambda: both(lambda m: (
            ModeSchedule(cfg, m, ("slice",)) if m else one).finalize_local(
            block, torch.ones((1, 2), dtype=torch.bool),
            carry(one).v)),
        "composite_slice_axes": lambda: (
            list(msc_axes(_stub_mesh("data", "model"))),
            [("data", "model"), ()]),
        "two_slice_dims": lambda: (
            [ModeSchedule(cfg, _stub_mesh("a", "b"), ("a", "b")).slice_axes],
            [("a", "b")]),
    }


CLOSED = ("serve_engine", "continuous_engine", "chunk_plan", "chunk_local",
          "finalize_local", "composite_slice_axes", "two_slice_dims")


@pytest.mark.parametrize("what", CLOSED)
def test_item_9_rest_raises_naming_it(what, tmp_path):
    """Item 9 (rest) is closed: each case that raised naming it now runs,
    on a one-rank gloo mesh, and gives what one device gives."""
    tmesh.join("cpu", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        got, want = _closed(tmesh.make_msc_mesh("flat", None, "cpu"))[what]()
    finally:
        tmesh.leave()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w)
        else:
            assert g == w


def test_mesh_roles_are_checked():
    from repro_torch.core.schedule import ModeSchedule
    from repro_torch.sharding.specs import msc_axes

    cfg = MSCConfig(epsilon=EPS)
    assert msc_axes(_stub_mesh("slice", "inner")) == (("slice",),
                                                      ("inner",))
    assert msc_axes(_stub_mesh("mode", "slice")) == (("slice",), ())
    with pytest.raises(ValueError, match="not in mesh"):
        ModeSchedule(cfg, _stub_mesh("slice"), ("rows",))
    with pytest.raises(ValueError, match="overlapping"):
        ModeSchedule(cfg, _stub_mesh("slice"), ("slice",), ("slice",))
    with pytest.raises(ValueError, match="need a mesh"):
        ModeSchedule(cfg, None, ("slice",))
    with pytest.raises(ValueError, match="grouped schedule needs mode=3"):
        from repro_torch.core.parallel import build_msc_parallel_grouped

        build_msc_parallel_grouped(cfg, _GroupedStub())


class _GroupedStub:
    mesh_dim_names = ("mode", "slice")
    shape = (2, 1)

    def size(self, dim):
        return self.shape[dim]


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_nccl_rank_is_the_one_device_path(cuda_device, tmp_path):
    """World size 1 on NCCL: the (1,) meshes give the one-device bits, the
    (1, 1) meshes its masks and sweeps (the inner dim sums per sweep)."""
    t = torch.from_numpy(_planted((40, 36, 32), (4, 4, 4), 40.0, 3)).to(
        cuda_device)
    tmesh.join("cuda", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        for shape in ((1,), (1, 1)):
            mesh = tmesh.make_msc_mesh("flat", shape)
            for relayout, epi, kw in (("gspmd", "allgather", {}),
                                      ("collective", "ring", {}),
                                      ("collective_stream", "allgather", {}),
                                      ("gspmd", "ring",
                                       {"matrix_free": False}),
                                      ("gspmd", "allgather",
                                       {"precision": "bf16_fp32"})):
                cfg = MSCConfig(epsilon=EPS, epilogue=epi, use_kernels=True,
                                **kw)
                got = build_msc_parallel(cfg, mesh=mesh,
                                         relayout=relayout)(t)
                want = build_msc_parallel(cfg, device=cuda_device)(t)
                for g, w in zip(got, want):
                    assert torch.equal(g.mask, w.mask)
                    assert int(g.power_iters_run) == int(w.power_iters_run)
                    if shape == (1,):
                        assert torch.equal(g.d, w.d)
                        assert torch.equal(g.lambdas, w.lambdas)
                    else:
                        assert _rel(g.d.cpu().numpy(),
                                    w.d.cpu().numpy()) <= 3e-5
    finally:
        tmesh.leave()


def test_sequential_matches_on_a_mesh_input():
    """The inputs the ranks see give the planted cluster on one device
    (so a mask equal to the reference's is a found cluster, not an empty
    one)."""
    res = msc_sequential(torch.from_numpy(_inputs()["A"]),
                         MSCConfig(epsilon=EPS), device="cpu")
    assert [r.size for r in res] == [3, 3, 2]


def test_spawn_defaults_to_the_card():
    """Without a device type, spawn asks for NCCL ranks on the cards, so
    more ranks than cards is refused before any process starts."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA devices; one rank per card"):
        tmesh.spawn(_raise, n, "unused", ValueError("never runs"))
