"""Port parity for the whole slice on the CPU.

Inputs come from the reference's planted-tensor generator and cross to
torch as numpy arrays.  Bounds: masks identical, `power_iters_run`
identical, d and λ within 3e-5 (fp32) or 1e-2 (bf16_fp32) of the
largest reference entry.

* The port's sequential entry point with kernels against the
  reference's, with kernels (Pallas in interpret mode, m ≤ 24).
* The port's one-device flat schedule (both epilogues, with and without
  kernels) against the reference's flat schedule on a 1-device mesh
  without kernels (the reference's flat kernel path does not run on
  this jax: `pallas_call` inside `shard_map` has no `vma`).
* The prototype grid m ∈ {45, 60} × γ ∈ {20, 70, 150} × both
  precisions × both eigensolvers (matrix-free and the explicit gram):
  the port's sequential einsum path and its flat kernel path against
  the reference's sequential einsum path.
* The explicit gram at m ∈ {16, 24}: sequential with kernels against
  the reference's (the gram kernel in interpret mode), and the flat
  schedule against the reference's flat einsum path.
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
from repro.core import msc_sequential as jseq  # noqa: E402
from repro.core.parallel import build_msc_parallel as jpar  # noqa: E402
from repro.core.parallel import make_msc_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import build_msc_parallel, msc_sequential  # noqa: E402
from repro_torch.core.msc import mode_slices  # noqa: E402
from repro_torch.core.schedule import epilogue_rowsum  # noqa: E402

TOL = {"fp32": 3e-5, "bf16_fp32": 1e-2}


@functools.cache
def _tensor(m, gamma, seed=0):
    x = np.array(jplanted(jax.random.PRNGKey(seed), JSpec.paper(m, gamma)))
    x.setflags(write=False)
    return x


def _jcfg(m, **kw):
    l = max(1, m // 10)
    return JConfig(epsilon=0.5 / (m - l) ** 2, max_extraction_iters=m, **kw)


def _port_cfg(jcfg, **kw):
    return bridge.config_from_fields(dataclasses.asdict(jcfg)).with_(**kw)


def _assert_same(port, ref, precision):
    for j, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(p.mask.cpu().numpy(),
                                      np.asarray(r.mask), err_msg=f"mode {j}")
        assert p.power_iters_run == int(r.power_iters_run), f"mode {j}"
        for got, want in ((p.d, r.d), (p.lambdas, r.lambdas)):
            want = np.asarray(want, np.float64)
            err = (np.abs(got.cpu().numpy() - want).max()
                   / max(np.abs(want).max(), 1e-30))
            assert err <= TOL[precision], (j, err)


@functools.cache
def _ref_sequential(m, gamma, precision, use_kernels, matrix_free=True):
    cfg = _jcfg(m, precision=precision, use_kernels=use_kernels,
                matrix_free=matrix_free)
    return jax.device_get(jseq(jax.numpy.asarray(_tensor(m, gamma)), cfg))


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("m,gamma", [(16, 40.0), (24, 40.0)])
def test_sequential_kernels_match_reference_kernels(m, gamma, precision):
    ref = _ref_sequential(m, gamma, precision, True)
    cfg = _port_cfg(_jcfg(m, precision=precision, use_kernels=True))
    port = msc_sequential(bridge.tensor_from_numpy(_tensor(m, gamma)), cfg,
                          device="cpu")
    _assert_same(port, ref, precision)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
@pytest.mark.parametrize("epilogue", ["allgather", "ring"])
def test_flat_one_device_matches_reference_flat(epilogue, use_kernels):
    m, gamma = 24, 40.0
    jcfg = _jcfg(m, epilogue=epilogue)
    x = _tensor(m, gamma)
    ref = jax.device_get(jpar(make_msc_mesh("flat"), jcfg)(
        jax.numpy.asarray(x)))
    run = build_msc_parallel(_port_cfg(jcfg, use_kernels=use_kernels),
                             device="cpu")
    _assert_same(run(bridge.tensor_from_numpy(x)), ref, "fp32")


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("m,gamma", [(16, 40.0), (24, 40.0)])
def test_gram_sequential_kernels_match_reference_kernels(m, gamma,
                                                         precision):
    ref = _ref_sequential(m, gamma, precision, True, matrix_free=False)
    cfg = _port_cfg(_jcfg(m, precision=precision, use_kernels=True,
                          matrix_free=False))
    port = msc_sequential(bridge.tensor_from_numpy(_tensor(m, gamma)), cfg,
                          device="cpu")
    _assert_same(port, ref, precision)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
@pytest.mark.parametrize("m", [16, 24])
def test_gram_flat_one_device_matches_reference_flat(m, use_kernels):
    jcfg = _jcfg(m, matrix_free=False)
    x = _tensor(m, 40.0)
    ref = jax.device_get(jpar(make_msc_mesh("flat"), jcfg)(
        jax.numpy.asarray(x)))
    run = build_msc_parallel(_port_cfg(jcfg, use_kernels=use_kernels),
                             device="cpu")
    _assert_same(run(bridge.tensor_from_numpy(x)), ref, "fp32")


@pytest.mark.parametrize("matrix_free", [True, False],
                         ids=["matrix_free", "gram"])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
@pytest.mark.parametrize("gamma", [20.0, 70.0, 150.0])
@pytest.mark.parametrize("m", [45, 60])
def test_prototype_grid(m, gamma, precision, matrix_free):
    ref = _ref_sequential(m, gamma, precision, False, matrix_free)
    x = bridge.tensor_from_numpy(_tensor(m, gamma))
    jcfg = _jcfg(m, precision=precision, matrix_free=matrix_free)
    _assert_same(msc_sequential(x, _port_cfg(jcfg), device="cpu"), ref,
                 precision)
    run = build_msc_parallel(_port_cfg(jcfg, use_kernels=True), device="cpu")
    _assert_same(run(x), ref, precision)


def test_mode_slices_are_contiguous_unfoldings():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    for j, perm in enumerate(((0, 1, 2), (1, 0, 2), (2, 0, 1))):
        s = mode_slices(x, j)
        assert s.is_contiguous()
        assert torch.equal(s, x.permute(perm))


def test_unported_schedules_raise():
    cfg = _port_cfg(_jcfg(24))
    # the grouped schedule needs a mesh of 3·s·q ranks
    # (tests/test_torch_parallel.py runs it over gloo ranks)
    with pytest.raises(ValueError, match="mesh"):
        build_msc_parallel(cfg, schedule="grouped", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_msc_parallel(cfg, device="cpu", relayout="auto")
    with pytest.raises(ValueError, match="epilogue"):
        epilogue_rowsum(torch.zeros(4, 3), cfg=cfg.with_(epilogue="tree"))
    with pytest.raises(ValueError, match="relayout"):
        build_msc_parallel(cfg, device="cpu", relayout="scatter")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            msc_sequential(torch.zeros(4, 4, 4), cfg)
