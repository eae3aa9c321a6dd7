"""flash_attention parity: the port's plain version (`repro_torch.kernels.
ref.flash_attention`, what the CUDA kernel computes and what the wrapper
runs on the CPU) against the reference's jnp oracle and its Pallas
kernel in interpret mode, on the reference's own kernel-test cases
(`tests/test_kernels.py::TestFlashAttentionKernel`); and the wrapper's
checks.

Tolerances, relative to the largest |output|: 1e-5 for fp32 (sums in
another order), 1e-2 for bf16 outputs (a value on the other side of a
bf16 rounding boundary moves by 2^-8).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference's kernel, its oracle and jnp (JAX imported here, not
    at module level)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import flash_attention as fa
    from repro.kernels import ref as jref

    return types.SimpleNamespace(jnp=jnp, fa=fa, ref=jref)


def _qkv(seed, b, sq, skv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, d)).astype(np.float32)
                 for s in (sq, skv, skv))


def _check(jx, arrays, dtype, blocks, **kw):
    """The port's plain version against the jnp oracle and the Pallas
    kernel (interpret mode), on the same values in `dtype`."""
    js = [jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype)) for a in arrays]
    ts = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    got = ref.flash_attention(*ts, **kw)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == arrays[0].shape
    got = got.float().numpy().astype(np.float64)
    for want in (jx.ref.flash_attention(*js, **kw),
                 jx.fa.flash_attention(*js, **kw, **blocks,
                                       interpret=True)):
        want = np.asarray(want.astype(jx.jnp.float32), np.float64)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d", [(16, 16, 8), (70, 70, 32),
                                      (33, 65, 16)])
def test_causal_plain_matches_reference(jx, sq, skv, d, dtype):
    _check(jx, _qkv(10, 2, sq, skv, d), dtype,
           dict(block_q=16, block_k=32), causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_plain_matches_reference(jx, dtype):
    _check(jx, _qkv(13, 1, 24, 24, 16), dtype, dict(block_q=8, block_k=8),
           causal=False)


@pytest.mark.parametrize("window", [8, 24])
def test_sliding_window_plain_matches_reference(jx, window):
    _check(jx, _qkv(16, 2, 48, 48, 16), "float32",
           dict(block_q=16, block_k=16), causal=True, window=window)


def test_softcap_plain_matches_reference(jx):
    _check(jx, _qkv(19, 2, 32, 32, 16), "float32",
           dict(block_q=16, block_k=16), causal=True, softcap=30.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_single_query_offset_plain_matches_reference(jx, dtype):
    _check(jx, _qkv(22, 3, 1, 100, 32), dtype, dict(block_q=1, block_k=32),
           causal=True, q_offset=63)


def test_cross_attention_shape_plain_matches_reference(jx):
    # the LM path's cross-attention: a few query rows over more keys,
    # neither causal nor a tile multiple
    _check(jx, _qkv(23, 4, 5, 45, 32), "bfloat16",
           dict(block_q=8, block_k=16), causal=False)


def test_plain_version_is_causal():
    # future keys must not move earlier outputs
    q, k, v = (torch.from_numpy(a) for a in _qkv(25, 1, 32, 32, 16))
    o1 = ref.flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:], v2[:, 20:] = 99.0, -99.0
    o2 = ref.flash_attention(q, k2, v2, causal=True)
    assert torch.equal(o1[:, :20], o2[:, :20])


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(26, 2, 7, 11, 16))
    n0 = tfa.launches
    for kw in (dict(causal=False), dict(causal=True, q_offset=4, window=5),
               dict(causal=True, softcap=20.0, scale=0.3)):
        assert torch.equal(ops.flash_attention(q, k, v, **kw),
                           ref.flash_attention(q, k, v, **kw))
    assert tfa.launches == n0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(27, 2, 4, 6, 8))
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v[:, :5])
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:1], v[:1])
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :0], v[:, :0])
