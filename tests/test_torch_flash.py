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


# ---- the algebra the CUDA routes rely on (pinned here on the CPU) --------

def _scores(q, k, scale, softcap):
    s = (q @ k.transpose(-1, -2)) * scale
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def _keep(sq, lo, hi, causal, q_offset, window):
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(lo, hi)[None, :]
    keep = torch.ones((sq, hi - lo), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def _slice_state(q, k, v, lo, hi, *, scale, causal, q_offset, window,
                 softcap, step=4):
    """(m, l, acc) of one warp's key slice [lo, hi) in fp32, as the
    small-sq route keeps them: an online softmax over `step` keys at a
    time in which a masked key adds p = 0.  An empty or wholly masked
    slice ends at m = -1e30, l = 0, acc = 0."""
    b, sq, d = q.shape
    m = torch.full((b, sq, 1), -1e30)
    l = torch.zeros((b, sq, 1))
    acc = torch.zeros((b, sq, d))
    for k0 in range(lo, hi, step):
        k1 = min(hi, k0 + step)
        keep = _keep(sq, k0, k1, causal, q_offset, window)
        s = torch.where(keep, _scores(q, k[:, k0:k1], scale, softcap),
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new), torch.tensor(0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p @ v[:, k0:k1]
        m = m_new
    return m, l, acc


def _merged(states):
    """The log-sum-exp merge of the slices' states, in slice order."""
    mm = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(torch.exp(m - mm) * ls for m, ls, _ in states)
    acc = sum(torch.exp(m - mm) * a for m, _, a in states)
    return acc / (l + 1e-30)


# (b, sq, skv, d, options): decode over every key, ragged decode with
# q_offset, causal rows that leave the later slices wholly masked, a
# window that leaves all but one or two slices masked, softcap, and a
# window with a causal q_offset as the chip's edge cases have it
MERGE_CASES = [
    (3, 1, 100, 32, dict(causal=False)),
    (7, 1, 100, 64, dict(causal=True, q_offset=99)),
    (2, 4, 100, 32, dict(causal=True, q_offset=10)),
    (2, 4, 100, 16, dict(causal=True, q_offset=90, window=8)),
    (2, 8, 150, 32, dict(causal=True, q_offset=142, softcap=30.0)),
    (2, 3, 300, 32, dict(causal=True, q_offset=297, window=40,
                         softcap=20.0)),
]


@pytest.mark.parametrize("trim", [False, True], ids=["all_keys", "live_keys"])
@pytest.mark.parametrize("case", MERGE_CASES, ids=str)
def test_warp_slice_lse_merge_matches_plain(case, trim):
    """The small-sq route's algebra: 16 warp slices, each an online softmax
    that drops masked keys, merged by log-sum-exp in a fixed order, equal
    to the plain version within 1e-6 of max |o| in fp32.  `live_keys`
    slices only the keys some row can see, as the kernel does;
    `all_keys` slices every key, so that whole slices are masked."""
    b, sq, skv, d, kw = case
    q, k, v = (torch.from_numpy(a) for a in _qkv(31, b, sq, skv, d))
    causal, q_offset = kw["causal"], kw.get("q_offset", 0)
    window, softcap = kw.get("window"), kw.get("softcap")
    lo, hi = 0, skv
    if trim:
        if causal:
            hi = min(skv, sq - 1 + q_offset + 1)
        if window is not None:
            lo = max(0, q_offset - window + 1)
    per = -(-(hi - lo) // 16)
    states, masked = [], 0
    for w in range(16):
        s0 = lo + w * per
        st = _slice_state(q, k, v, s0, min(hi, s0 + per), scale=d ** -0.5,
                          causal=causal, q_offset=q_offset, window=window,
                          softcap=softcap)
        if bool((st[0] == -1e30).all()):
            # wholly masked or empty: it must enter the merge as nothing
            assert not st[1].any() and not st[2].any()
            masked += 1
        states.append(st)
    want = ref.flash_attention(q, k, v, **kw)
    got = _merged(states)
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-6, err
    if not trim and (causal and q_offset < 50 or window is not None):
        assert masked > 0  # the case does reach the wholly masked slices


def test_two_term_bf16_split_of_p_keeps_fp32_pv():
    """The tile route's P·V: P = P_hi + P_lo, both bf16, against fp32 P
    times bf16 V.  The split stays within 1e-5 of max |o|; rounding P to
    bf16 once moves o by more than 1e-4, so the bound tells them apart."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float()
               for a in _qkv(32, 2, 64, 1500, 64))
    s = _scores(q, k, 64 ** -0.5, None)
    p = torch.exp(s - s.amax(-1, keepdim=True))  # fp32, as in the kernel
    l = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    vd = v.double()
    want = (p.double() @ vd) / l.double()
    split = (hi.double() @ vd + lo.double() @ vd) / l.double()
    once = (hi.double() @ vd) / l.double()
    scale = want.abs().max()
    assert (split - want).abs().max() / scale <= 1e-5
    assert (once - want).abs().max() / scale > 1e-4


def test_wrapper_rejects_an_unknown_route():
    q, k, v = (torch.from_numpy(a) for a in _qkv(33, 2, 4, 6, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, route="fast")
    # on the CPU a known route runs the plain version
    assert torch.equal(tfa.flash_attention(q, k, v, route="small"),
                       ref.flash_attention(q, k, v))
