"""Port parity for batched serving on the CPU: the port's MSCServeEngine
against the reference's on a 1-device mesh.

Requests come from the reference's planted-tensor generator (cubes of
sizes 14 and 19, cycled over 5 requests, as `msc_serve --sizes 14,19`
makes them) and cross to torch as numpy arrays.  With max_batch 2 the
two buckets (16³ and 24³) take three dispatches, one of them with a
(1, 1, 1) filler slot.  The reference runs its einsum path
(`use_kernels=False`: its kernels do not run inside `shard_map` on this
jax); the port runs both paths, its kernels as their plain versions.

Bounds: per-request masks and `power_iters_run` identical, d and λ
within 3e-5 of the largest reference entry, and the engine's counters
(compiles, filler slots) equal to the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.core.parallel import make_msc_mesh  # noqa: E402
from repro.serving import MSCServeEngine as JEngine  # noqa: E402
from repro.serving import ServeStats as JStats  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import msc_sequential  # noqa: E402
from repro_torch.core.parallel import build_msc_batched  # noqa: E402
from repro_torch.serving import MSCServeEngine, ServeStats  # noqa: E402
from repro_torch.serving import msc_engine  # noqa: E402

SIZES, N_REQ, MAX_BATCH, TOL = (14, 19), 5, 2, 3e-5


@functools.cache
def _requests():
    out = []
    for i in range(N_REQ):
        m = SIZES[i % len(SIZES)]
        x = np.array(jplanted(jax.random.PRNGKey(i),
                              JSpec.paper(m, float(max(m, 40)))))
        x.setflags(write=False)
        out.append(x)
    return tuple(out)


def _jcfg(matrix_free):
    return JConfig(epsilon=3e-4, matrix_free=matrix_free)


@functools.cache
def _reference(matrix_free):
    eng = JEngine(make_msc_mesh("flat"), _jcfg(matrix_free),
                  max_batch=MAX_BATCH)
    res = eng.run([jax.numpy.asarray(x) for x in _requests()])
    return res, eng.stats


def _close(got, want):
    want = np.asarray(want, np.float64)
    err = (np.abs(np.asarray(got, np.float64) - want).max()
           / max(np.abs(want).max(), 1e-30))
    assert err <= TOL, err


def _assert_same(port, ref):
    for j, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(r.mask),
                                      err_msg=f"mode {j}")
        assert p.power_iters_run == int(r.power_iters_run), f"mode {j}"
        _close(p.d.numpy(), r.d)
        _close(p.lambdas.numpy(), r.lambdas)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
@pytest.mark.parametrize("matrix_free", [True, False],
                         ids=["matrix_free", "gram"])
def test_engine_matches_reference_engine(matrix_free, use_kernels):
    ref, ref_stats = _reference(matrix_free)
    cfg = bridge.config_from_fields(
        dataclasses.asdict(_jcfg(matrix_free))).with_(use_kernels=use_kernels)
    eng = MSCServeEngine(cfg, max_batch=MAX_BATCH, device="cpu")
    assert sorted({eng.bucket_of(x.shape) for x in _requests()}) == [
        (16, 16, 16), (24, 24, 24)]
    out = eng.run(list(_requests()))
    for i, (p, r) in enumerate(zip(out, ref)):
        assert p[0].mask.shape == (SIZES[i % 2],)
        _assert_same(p, r)
    s = eng.stats
    assert (s.requests, s.dispatches, s.compiles, s.filler_slots) == (
        ref_stats.requests, ref_stats.dispatches, ref_stats.compiles,
        ref_stats.filler_slots) == (5, 3, 2, 1)
    # warm: the same requests again count no compile and answer the same
    cold = eng.stats
    again = eng.run([bridge.tensor_from_numpy(x) for x in _requests()])
    warm = eng.stats.delta(cold)
    assert warm.compiles == 0 and warm.exec_cache_hits == warm.dispatches == 3
    for p, q in zip(again, out):
        for j in range(3):
            assert torch.equal(p[j].mask, q[j].mask)
            assert p[j].power_iters_run == q[j].power_iters_run


@pytest.mark.parametrize("matrix_free", [True, False],
                         ids=["matrix_free", "gram"])
def test_padded_request_matches_sequential_on_its_tensor(matrix_free):
    """A non-cube request padded into a larger bucket beside a filler
    slot answers as msc_sequential does on its unpadded tensor."""
    spec = JSpec(shape=(13, 18, 11), cluster_sizes=(2, 3, 2), gamma=60.0)
    x = np.array(jplanted(jax.random.PRNGKey(7), spec))
    cfg = bridge.config_from_fields(dataclasses.asdict(
        _jcfg(matrix_free))).with_(use_kernels=True)
    eng = MSCServeEngine(cfg, max_batch=2, bucket_quantum=8, device="cpu")
    (got,) = eng.run([x])
    assert eng.bucket_of(x.shape) == (16, 24, 16)
    assert eng.stats.filler_slots == 1
    want = msc_sequential(bridge.tensor_from_numpy(x),
                          cfg.with_(use_kernels=False), device="cpu")
    for j in range(3):
        assert torch.equal(got[j].mask, want[j].mask), j
        assert got[j].power_iters_run == want[j].power_iters_run, j
        torch.testing.assert_close(got[j].d, want[j].d, rtol=0,
                                   atol=TOL * float(want[j].d.abs().max()))


def test_batched_result_keeps_requests_apart():
    """build_msc_batched: per-request sweeps (not the batch max) and a
    filler slot with λ = 0 everywhere and finite d."""
    xs = [np.array(jplanted(jax.random.PRNGKey(i), JSpec.paper(12, g)))
          for i, g in enumerate((60.0, 12.0))]
    batch = np.zeros((3, 12, 12, 12), np.float32)
    batch[0], batch[1] = xs
    dims = np.array([[12, 12, 12], [12, 12, 12], [1, 1, 1]], np.int32)
    cfg = bridge.config_from_fields(dataclasses.asdict(
        JConfig(epsilon=3e-4, matrix_free=False)))
    out = build_msc_batched(cfg, device="cpu")(torch.from_numpy(batch),
                                               dims)
    for j, mr in enumerate(out.modes):
        assert tuple(mr.d.shape) == (3, 12) and len(mr.power_iters_run) == 3
        assert torch.isfinite(mr.d).all() and not mr.lambdas[2].any()
        for i, x in enumerate(xs):
            want = msc_sequential(torch.from_numpy(x), cfg, device="cpu")[j]
            assert mr.power_iters_run[i] == want.power_iters_run
            assert torch.equal(mr.mask[i], want.mask)


def test_engine_units():
    assert msc_engine._bucket_quantum(8) == 8
    assert msc_engine._bucket_of((14, 19, 8), 8) == (16, 24, 8)
    with pytest.raises(ValueError):
        msc_engine._bucket_of((4, 4), 8)
    with pytest.raises(ValueError):
        msc_engine._bucket_quantum(0)
    cfg = bridge.config_from_fields(dataclasses.asdict(_jcfg(True)))
    with pytest.raises(ValueError):
        MSCServeEngine(cfg, max_batch=0, device="cpu")
    # "auto" resolves per bucket (tests/test_torch_autotune.py)
    assert MSCServeEngine(cfg, relayout="auto", device="cpu")._auto
    assert callable(build_msc_batched(cfg.with_(epilogue="auto"),
                                      device="cpu"))
    with pytest.raises(ValueError, match="relayout"):
        MSCServeEngine(cfg, relayout="scatter", device="cpu")
    assert [f.name for f in dataclasses.fields(ServeStats)] == [
        f.name for f in dataclasses.fields(JStats)]
    assert ServeStats(requests=3).delta(ServeStats(requests=1)).requests == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MSCServeEngine(cfg)
