"""Kernel parity: each plain version in `repro_torch.kernels.ref` against
the Pallas kernel it stands for, run with `interpret=True` on the CPU;
the wrappers' checks and CPU dispatch; and (marked `gpu`, run on the
card) each CUDA kernel against its plain version.

Tolerances, relative to the largest entry: 1e-5 in fp32 (sums in
another order), 1e-2 in bf16 (an fp32 sum that lands on the other side
of a bf16 rounding boundary moves one operand by one bf16 ulp, 2^-8).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import power_iter as tpik  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ring as tring  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, r, c, block_r): one tile, ragged last r tile, several tiles
POWER_SHAPES = [(3, 16, 8, 16), (4, 37, 19, 16), (2, 70, 33, 32)]


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas kernels on the CPU (interpret mode).  JAX is
    imported here, not at module level, so the `gpu` test below also
    runs where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import power_iter, ring

    return types.SimpleNamespace(jnp=jnp, power_iter=power_iter, ring=ring)


def _pair(pallas, x, dtype):
    """The same values as a jax array and a torch tensor of `dtype`."""
    j = pallas.jnp.asarray(x).astype(getattr(pallas.jnp, dtype))
    t = torch.from_numpy(np.array(x)).to(TDT[dtype])
    return j, t


def _close(got, want, dtype, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max() if scale is None else scale, 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL[dtype], err


def _power_inputs(b, r, c, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (b, r, c)).astype(np.float32)
    v = rng.normal(size=lead + (b, c)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return x, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", POWER_SHAPES, ids=str)
def test_power_iterate_chunk_plain_matches_pallas(pallas, shape, dtype):
    b, r, c, block_r = shape
    x, v = _power_inputs(b, r, c)
    js, ts = _pair(pallas, x, dtype)
    want = pallas.power_iter.power_iterate_chunk(
        js, pallas.jnp.asarray(v), 3, block_r=block_r, interpret=True)
    got = ref.power_iterate_chunk(ts, torch.from_numpy(v), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", POWER_SHAPES[1:], ids=str)
def test_power_iterate_plain_matches_pallas(pallas, shape, dtype):
    b, r, c, block_r = shape
    x, v = _power_inputs(b, r, c, seed=1)
    js, ts = _pair(pallas, x, dtype)
    want = pallas.power_iter.power_iterate(
        js, pallas.jnp.asarray(v), 5, block_r=block_r, interpret=True)
    got = ref.power_iterate(ts, torch.from_numpy(v), 5)
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_matvec_plain_matches_pallas(pallas, dtype):
    x, v = _power_inputs(4, 37, 19, seed=2)
    js, ts = _pair(pallas, x, dtype)
    want = pallas.power_iter.power_matvec(js, pallas.jnp.asarray(v),
                                          block_r=16, interpret=True)
    got = ref.power_matvec(ts, torch.from_numpy(v))
    _close(got.numpy(), want, dtype)


def test_power_iterate_chunk_batched_plain_matches_pallas(pallas):
    x, v = _power_inputs(3, 20, 9, lead=(2,), seed=3)
    want = pallas.power_iter.power_iterate_chunk(
        pallas.jnp.asarray(x), pallas.jnp.asarray(v), 2, block_r=8,
        interpret=True)
    got = ref.power_iterate_chunk(torch.from_numpy(x), torch.from_numpy(v), 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w, "float32")


# (bl, bc, c, block_i, block_j, batch): tile-aligned, ragged i/j, batched
ROWSUM_CASES = [(16, 16, 8, 8, 8, None), (13, 21, 7, 8, 8, None),
                (9, 12, 5, 4, 8, 3)]


@pytest.mark.parametrize("with_acc", [False, True], ids=["no_acc", "acc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ROWSUM_CASES, ids=str)
def test_abs_rowsum_plain_matches_pallas(pallas, case, dtype, with_acc):
    bl, bc, c, bi, bj, batch = case
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(4)
    a = rng.normal(size=lead + (bl, c)).astype(np.float32)
    b = rng.normal(size=lead + (bc, c)).astype(np.float32)
    b[..., -2:, :] = 0.0  # zero rows (slice padding) add nothing
    acc = rng.uniform(size=lead + (bl,)).astype(np.float32) if with_acc \
        else None
    ja, ta = _pair(pallas, a, dtype)
    jb, tb = _pair(pallas, b, dtype)
    want = pallas.ring.abs_rowsum(
        ja, jb, None if acc is None else pallas.jnp.asarray(acc),
        block_i=bi, block_j=bj, interpret=True)
    got = ref.abs_rowsum(ta, tb, None if acc is None
                         else torch.from_numpy(acc))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want, dtype)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    x, v = _power_inputs(4, 37, 19)
    ts, tv = torch.from_numpy(x), torch.from_numpy(v)
    before = (tpik.launches, tring.launches)
    for got, want in [
            (tpik.power_iterate_chunk(ts, tv, 3), ref.power_iterate_chunk(
                ts, tv, 3)),
            (tpik.power_iterate(ts, tv, 4), ref.power_iterate(ts, tv, 4)),
            ((tpik.power_matvec(ts, tv),), (ref.power_matvec(ts, tv),)),
            ((ops.abs_rowsum(tv, tv),), (ref.abs_rowsum(tv, tv),))]:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (tpik.launches, tring.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, v = _power_inputs(4, 8, 6)
    ts, tv = torch.from_numpy(x), torch.from_numpy(v)
    with pytest.raises(TypeError):
        tpik.power_iterate_chunk(ts.double(), tv, 2)
    with pytest.raises(TypeError):
        tpik.power_iterate_chunk(ts, tv.to(torch.bfloat16), 2)
    with pytest.raises(ValueError):
        tpik.power_iterate_chunk(ts, tv[:3], 2)
    with pytest.raises(ValueError):
        tpik.power_iterate_chunk(ts.transpose(1, 2), tv[:, :8].contiguous(),
                                 2)
    with pytest.raises(TypeError):
        tring.abs_rowsum(tv, tv.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tring.abs_rowsum(tv, tv[:, :5].contiguous())
    with pytest.raises(ValueError):
        tring.abs_rowsum(tv, tv.T)
    with pytest.raises(ValueError):
        tring.abs_rowsum(tv, tv, torch.zeros(3))
    with pytest.raises(ValueError):
        tring.abs_rowsum(tv, tv, torch.zeros(4, dtype=torch.float64))


def test_flash_attention_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, s, 32)).astype(
        np.float32)) for s in (5, 9, 9))
    before = tfa.launches
    got = ops.flash_attention(q, k, v, causal=True, q_offset=4, window=6,
                              softcap=30.0)
    want = ref.flash_attention(q, k, v, causal=True, q_offset=4, window=6,
                               softcap=30.0)
    assert torch.equal(got, want)
    assert tfa.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    """Every CUDA kernel against its plain version on the card, at small
    ragged shapes and in both dtypes (batched_gram also request-batched
    and with an fp32 result, flash_attention with each of its masks); the
    launch counters move."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        for b, r, c in [(3, 37, 19), (5, 300, 257), (2, 1, 1000)]:
            x, v = _power_inputs(b, r, c)
            ts = torch.from_numpy(x).to(cuda_device, TDT[dtype])
            tv = torch.from_numpy(v).to(cuda_device)
            n0 = tpik.launches
            (kv, kl, kr), (pv, pl, pr) = (
                tpik.power_iterate_chunk(ts, tv, 4),
                ref.power_iterate_chunk(ts, tv, 4))
            # resid = ‖w − λv‖ is rounding noise once a slice has converged
            # (r = 1 converges in one sweep): hold it to the scale of λ
            _close(kr.cpu().numpy(), pr.cpu().numpy(), dtype,
                   scale=pl.abs().max().item())
            for got, want in [
                    ((kv, kl), (pv, pl)),
                    (tpik.power_iterate(ts, tv, 6),
                     ref.power_iterate(ts, tv, 6)),
                    ((tpik.power_matvec(ts, tv),),
                     (ref.power_matvec(ts, tv),))]:
                for g, w in zip(got, want):
                    _close(g.cpu().numpy(), w.cpu().numpy(), dtype)
            assert tpik.launches == n0 + 3
        rng = np.random.default_rng(5)
        for shape_a, shape_b in [((13, 21), (70, 21)), ((4, 30, 57),
                                                        (4, 65, 57))]:
            a = torch.from_numpy(rng.normal(size=shape_a).astype(np.float32))
            b = torch.from_numpy(rng.normal(size=shape_b).astype(np.float32))
            a, b = a.to(cuda_device, TDT[dtype]), b.to(cuda_device, TDT[dtype])
            acc = torch.rand(a.shape[:-1], device=cuda_device)
            n0 = tring.launches
            for ac in (None, acc):
                _close(tring.abs_rowsum(a, b, ac).cpu().numpy(),
                       ref.abs_rowsum(a, b, ac).cpu().numpy(), dtype)
            assert tring.launches == n0 + 2
        for shape in [(3, 37, 19), (2, 2, 300, 257), (4, 1, 1)]:
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            x = x.to(cuda_device, TDT[dtype])
            n0 = tgram.launches
            for out in (None, torch.float32):
                got = ops.batched_gram(x, out_dtype=out)
                want = ref.batched_gram(x, out)
                assert got.dtype == want.dtype and got.shape == want.shape
                _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                       "float32" if out is not None else dtype)
            assert tgram.launches == n0 + 2
        # (b, sq, skv, d, flash options): ragged tiles, q_offset, window,
        # softcap and one-row decode, at every head dim the kernel takes
        for b, sq, skv, d, kw in [
                (3, 70, 70, 32, dict(causal=True)),
                (2, 33, 65, 64, dict(causal=False)),
                (2, 48, 100, 128, dict(causal=True, q_offset=52, window=24)),
                (2, 40, 40, 256, dict(causal=True, softcap=30.0)),
                (4, 1, 100, 64, dict(causal=True, q_offset=63))]:
            q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(
                np.float32)).to(cuda_device, TDT[dtype])
                for s in (sq, skv, skv))
            n0 = tfa.launches
            got = ops.flash_attention(q, k, v, **kw)
            assert got.dtype == q.dtype and got.shape == q.shape
            _close(got.float().cpu().numpy(),
                   ref.flash_attention(q, k, v, **kw).float().cpu().numpy(),
                   dtype)
            assert tfa.launches == n0 + 1
    torch.cuda.synchronize()
