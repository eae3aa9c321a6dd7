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


# (c, dtype, streams): rows of a 16-byte multiple up to MAX_COLS stream;
# ragged pitches and wider rows take the general route
ROUTE_CASES = [(1000, "float32", True), (1000, "bfloat16", True),
               (2048, "float32", True), (2048, "bfloat16", True),
               (1024, "float32", True), (1028, "float32", True),
               (2052, "float32", False), (2056, "bfloat16", False),
               (301, "float32", False), (301, "bfloat16", False),
               (12, "bfloat16", False), (8, "bfloat16", True),
               (4, "float32", True), (1, "float32", False)]


@pytest.mark.parametrize("c,dtype,streams", ROUTE_CASES, ids=str)
def test_power_route_streams_only_aligned_rows_in_the_register_budget(
        c, dtype, streams):
    dt = TDT[dtype]
    elt = torch.empty((), dtype=dt).element_size()
    assert streams == ((c * elt) % 16 == 0 and c <= tpik.MAX_COLS)
    got = tpik.route(c, dt)
    assert (got != "general") == streams
    assert got in tpik.routes(c, dt)
    assert ("direct" in tpik.routes(c, dt)) == (
        streams and c * elt <= tpik.DIRECT_BYTES)
    if streams:
        assert got == tpik.STREAM[dt] or "direct" not in tpik.routes(c, dt)


def test_power_route_names_are_checked_and_the_cpu_ignores_them():
    """route= forces a kernel route on the card; on the CPU every route
    name runs the plain version, and an unknown name raises."""
    x, v = _power_inputs(3, 9, 8)
    ts, tv = torch.from_numpy(x), torch.from_numpy(v)
    want = ref.power_iterate_chunk(ts, tv, 2)
    for route in ("general", "direct", "ring"):
        got = tpik.power_iterate_chunk(ts, tv, 2, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tpik.power_matvec(ts, tv, route="stream")


# (r, c, dtype, k): the resident route's rule at the shapes the port runs
# (1000^2 and 400^2 slices, gate chunks of 6 and 8 sweeps, the paper's
# largest m) and at its edges: one pass, rows that take the general route
# or reach MAX_COLS, one row, a slice too tall for 16 CTAs to hold
RESIDENT_CASES = [(1000, 1000, "float32", 6), (1000, 1000, "float32", 5),
                  (1000, 1000, "float32", 1), (1000, 1000, "bfloat16", 6),
                  (400, 400, "float32", 8), (400, 400, "bfloat16", 8),
                  (1400, 1400, "float32", 6), (1400, 1400, "bfloat16", 6),
                  (200, 1000, "float32", 2), (40, 48, "float32", 6),
                  (1003, 301, "float32", 6), (37, 19, "bfloat16", 8),
                  (1, 1000, "float32", 7), (100000, 4, "float32", 6),
                  (2000, 2048, "float32", 6), (2000, 2052, "float32", 6),
                  (6, 8, "bfloat16", 2), (64, 64, "float32", 61)]


@pytest.mark.parametrize("r,c,dtype,k", RESIDENT_CASES, ids=str)
def test_resident_route_rule_and_plan(r, c, dtype, k):
    """"resident" is offered for k >= 2 passes on rows that stream, and
    picked where RESIDENT[dtype] holds; its plan is the smallest power of
    two G <= 16 whose bands fit a CTA's shared memory (else 16), its
    bands cover the slice and its shared memory fits."""
    dt = TDT[dtype]
    ok = tpik.routes(c, dt, k)
    streams = "ring" in ok
    assert ("resident" in ok) == (streams and k >= 2)
    assert ok[:len(tpik.routes(c, dt))] == tpik.routes(c, dt)
    plan = tpik.resident_plan(r, c, dt)
    rule = tpik.RESIDENT[dt]
    want = (rule is not None and "resident" in ok and k >= rule[0]
            and plan is not None and plan.share(r) >= rule[1])
    got = tpik.route(c, dt, k, r)
    assert (got == "resident") == want
    assert got in ok
    if k == 1 or not streams:
        assert got != "resident"
    assert plan is not None
    assert 1 <= plan.g <= 16 and plan.g & (plan.g - 1) == 0
    assert plan.band == -(-r // plan.g) and plan.g * plan.band >= r
    assert 1 <= plan.rows <= plan.band
    assert tpik.resident_smem(c, dt, plan.rows,
                              plan.per_bar) <= tpik.SMEM_BYTES
    if plan.rows < plan.band:  # as many rows as fit, at the largest G
        assert plan.g == 16
        assert tpik.resident_smem(c, dt, plan.rows + 1,
                                  plan.per_bar) > tpik.SMEM_BYTES
    if plan.g > 1:  # half the CTAs would not hold their bands
        assert tpik.resident_smem(c, dt, -(-r // (plan.g // 2)),
                                  plan.per_bar) > tpik.SMEM_BYTES
    assert 1 <= plan.per_bar * c * torch.empty((), dtype=dt).element_size() \
        <= max(tpik.COPY_BYTES, c * torch.empty((), dtype=dt).element_size())


def test_resident_plans_at_the_cells_shapes():
    """G = 16 at the solve's 1000^2 fp32 slices (most of each band held),
    G = 4 at the serving cell's 400^2 fp32 slices (all of it), and a
    slice that no G holds still gets one row a CTA."""
    p = tpik.resident_plan(1000, 1000, torch.float32)
    assert (p.g, p.band) == (16, 63) and 0.75 <= p.share(1000) < 1
    p = tpik.resident_plan(400, 400, torch.float32)
    assert (p.g, p.band, p.rows) == (4, 100, 100) and p.share(400) == 1
    assert tpik.resident_plan(1400, 1400, torch.float32).share(1400) < 0.5
    assert tpik.resident_plan(0, 1000, torch.float32) is None
    assert tpik.resident_plan(1000, 1000, torch.float32, g_max=8).g == 8


# (entry, r, c, k): forced "resident" where it cannot run: one pass over
# T (the matvec, a one-sweep chunk) or rows that take the general route
RESIDENT_REFUSED = [("matvec", 9, 8, 1), ("chunk", 9, 8, 1),
                    ("chunk", 9, 7, 6), ("iterate", 9, 7, 3),
                    ("chunk", 5, 2052, 4)]


@pytest.mark.parametrize("entry,r,c,k", RESIDENT_REFUSED, ids=str)
def test_resident_route_refused_where_it_cannot_run(entry, r, c, k):
    x, v = _power_inputs(3, r, c)
    ts, tv = torch.from_numpy(x), torch.from_numpy(v)
    with pytest.raises(ValueError, match="resident"):
        if entry == "matvec":
            tpik.power_matvec(ts, tv, route="resident")
        elif entry == "chunk":
            tpik.power_iterate_chunk(ts, tv, k, route="resident")
        else:
            tpik.power_iterate(ts, tv, k, route="resident")


def test_resident_route_runs_the_plain_version_on_the_cpu():
    """Where the route can run, the CPU runs the plain version: two
    sweeps, and one sweep with the λ pass (two passes over T)."""
    x, v = _power_inputs(3, 9, 8)
    ts, tv = torch.from_numpy(x), torch.from_numpy(v)
    got = tpik.power_iterate_chunk(ts, tv, 2, route="resident")
    assert all(torch.equal(g, w) for g, w in
               zip(got, ref.power_iterate_chunk(ts, tv, 2)))
    got = tpik.power_iterate(ts, tv, 1, route="resident")
    assert all(torch.equal(g, w) for g, w in
               zip(got, ref.power_iterate(ts, tv, 1)))


def _stream_sweeps(slices, v0, n_upd, *, lambda_pass, emit_gate,
                   normalize=True, warps=tpik.WARPS):
    """The streaming route's order of operations in plain torch: v rounded
    once per sweep; warp q's partial w over rows k = q, q + warps, ...,
    added row by row; the partials added in warp order; the λ pass's tv²
    summed per warp, then in warp order."""
    dt, s, v = slices.dtype, slices.float(), v0.float()
    r = s.shape[-2]
    lam = torch.zeros(v.shape[:-1])
    resid = torch.zeros_like(lam)
    w = torch.zeros_like(v)

    def tv_of(v):
        return (s @ v.to(dt).float().unsqueeze(-1)).squeeze(-1)

    for it in range(n_upd):
        rt = tv_of(v).to(dt).float()
        parts = []
        for q in range(warps):
            p = torch.zeros_like(v)
            for k in range(q, r, warps):
                p = p + rt[..., k, None] * s[..., k, :]
            parts.append(p)
        w = parts[0]
        for p in parts[1:]:
            w = w + p
        if emit_gate and it == n_upd - 1:
            lam = torch.sum(w * v, dim=-1)
            resid = torch.sqrt(torch.sum((w - lam[..., None] * v) ** 2, -1))
        if normalize:
            v = w / (torch.sqrt(torch.sum(w * w, -1, keepdim=True)) + 1e-30)
    if lambda_pass:
        tv = tv_of(v)
        sums = []
        for q in range(warps):
            a = torch.zeros(tv.shape[:-1])
            for k in range(q, r, warps):
                a = a + tv[..., k] * tv[..., k]
            sums.append(a)
        lam = sums[0]
        for a in sums[1:]:
            lam = lam + a
    return lam, v, resid, w


# tolerance of the emulation against the plain version, relative to the
# largest plain entry: fp32 sums in another order; bf16 as in TOL
STREAM_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.mark.parametrize("entry", ["chunk", "iterate", "matvec"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_sweep_order_matches_plain(entry, dtype):
    """r = 37 is not a multiple of WARPS: the warps take 10, 9, 9 and 9
    rows.  resid, rounding noise on a converging slice, is held to the
    scale of λ."""
    x, v = _power_inputs(3, 37, 24, lead=(2,), seed=8)
    ts = torch.from_numpy(x).to(TDT[dtype])
    tv = torch.from_numpy(v)
    flags = {"chunk": dict(n_upd=3, lambda_pass=False, emit_gate=True),
             "iterate": dict(n_upd=4, lambda_pass=True, emit_gate=False),
             "matvec": dict(n_upd=1, lambda_pass=False, emit_gate=False,
                            normalize=False)}[entry]
    got = _stream_sweeps(ts, tv, **flags)
    want = ref.power_sweeps(ts, tv, **flags)
    lam_scale = np.abs(want[0].numpy()).max()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy().astype(np.float64), w.numpy().astype(np.float64)
        assert g.shape == w.shape
        scale = max(lam_scale if i == 2 else np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() / scale <= STREAM_TOL[dtype]


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
    ragged shapes and in both dtypes (power_iter on each of its routes,
    batched_gram also request-batched, with an fp32 result and at the
    mirror's edges, flash_attention with each of its masks); the launch
    counters move, and power_iter, abs_rowsum and batched_gram give the
    same bits in a second call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        # ragged c (general route); c = 1000, 1024 and 2048 stream (2048:
        # fp32 at the register budget, on the ring only)
        for b, r, c in [(3, 37, 19), (5, 300, 257), (2, 1, 1000),
                        (4, 50, 1000), (3, 41, 1024), (2, 40, 2048)]:
            x, v = _power_inputs(b, r, c)
            ts = torch.from_numpy(x).to(cuda_device, TDT[dtype])
            tv = torch.from_numpy(v).to(cuda_device)
            n0 = tpik.launches
            routes = tpik.routes(c, TDT[dtype])
            for route in (None,) + routes:
                (kv, kl, kr), (pv, pl, pr) = (
                    tpik.power_iterate_chunk(ts, tv, 4, route=route),
                    ref.power_iterate_chunk(ts, tv, 4))
                # resid = ‖w − λv‖ is rounding noise once a slice has
                # converged (r = 1 converges in one sweep): hold it to the
                # scale of λ
                _close(kr.cpu().numpy(), pr.cpu().numpy(), dtype,
                       scale=pl.abs().max().item())
                for got, want in [
                        ((kv, kl), (pv, pl)),
                        (tpik.power_iterate(ts, tv, 6, route=route),
                         ref.power_iterate(ts, tv, 6)),
                        ((tpik.power_matvec(ts, tv, route=route),),
                         (ref.power_matvec(ts, tv),))]:
                    for g, w in zip(got, want):
                        _close(g.cpu().numpy(), w.cpu().numpy(), dtype)
                # sums in a fixed order: the same bits again
                again = tpik.power_iterate_chunk(ts, tv, 4, route=route)
                assert all(torch.equal(g, a) for g, a in
                           zip((kv, kl, kr), again))
            assert tpik.launches == n0 + 4 * (1 + len(routes))
        rng = np.random.default_rng(5)
        # one tile, ragged c; several i- and j-tiles, request-batched, with
        # c a multiple of 16 bytes (16-byte loads) and not (single loads)
        for shape_a, shape_b in [((13, 21), (70, 21)), ((4, 30, 57),
                                                        (4, 65, 57)),
                                 ((3, 130, 64), (3, 200, 64)),
                                 ((2, 129, 301), (2, 65, 301))]:
            a = torch.from_numpy(rng.normal(size=shape_a).astype(np.float32))
            b = torch.from_numpy(rng.normal(size=shape_b).astype(np.float32))
            a, b = a.to(cuda_device, TDT[dtype]), b.to(cuda_device, TDT[dtype])
            acc = torch.rand(a.shape[:-1], device=cuda_device)
            n0 = tring.launches
            for ac in (None, acc):
                got = tring.abs_rowsum(a, b, ac)
                _close(got.cpu().numpy(),
                       ref.abs_rowsum(a, b, ac).cpu().numpy(), dtype)
                # the partials are added in a fixed order: same bits again
                assert torch.equal(got, tring.abs_rowsum(a, b, ac))
            assert tring.launches == n0 + 4
        # one tile, and a mirror at the edge of one and two tiles (c =
        # 127, 128, 129); an aligned c with a ragged last tile
        for shape in [(3, 37, 19), (2, 2, 300, 257), (4, 1, 1), (3, 7, 127),
                      (2, 9, 128), (3, 5, 129), (2, 40, 1000)]:
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            x = x.to(cuda_device, TDT[dtype])
            n0 = tgram.launches
            for out in (None, torch.float32):
                got = ops.batched_gram(x, out_dtype=out)
                want = ref.batched_gram(x, out)
                assert got.dtype == want.dtype and got.shape == want.shape
                _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                       "float32" if out is not None else dtype)
                assert torch.equal(got, ops.batched_gram(x, out_dtype=out))
            assert tgram.launches == n0 + 4
        # (b, sq, skv, d, flash options): ragged tiles, q_offset, window,
        # softcap and one-row decode, at every head dim the kernel takes;
        # sq on both sides of the small-sq route's limit and past one
        # 64-row tile, skv of one key and on both sides of a kv tile
        small = tfa.sq_small()
        for b, sq, skv, d, kw in [
                (3, 70, 70, 32, dict(causal=True)),
                (2, 33, 65, 64, dict(causal=False)),
                (2, 48, 100, 128, dict(causal=True, q_offset=52, window=24)),
                (2, 40, 40, 256, dict(causal=True, softcap=30.0)),
                (4, 1, 100, 64, dict(causal=True, q_offset=63)),
                (3, 2, 63, 64, dict(causal=False)),
                (2, small, 65, 128, dict(causal=True, q_offset=60)),
                (2, small + 1, 65, 64, dict(causal=True, q_offset=60)),
                (2, 65, 1, 32, dict(causal=False)),
                (2, 65, 63, 256, dict(causal=True, window=20)),
                (2, 3, 300, 32, dict(causal=True, q_offset=297, window=40,
                                     softcap=20.0))]:
            q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(
                np.float32)).to(cuda_device, TDT[dtype])
                for s in (sq, skv, skv))
            want = ref.flash_attention(q, k, v, **kw).float().cpu().numpy()
            n0 = tfa.launches
            got = ops.flash_attention(q, k, v, **kw)
            assert got.dtype == q.dtype and got.shape == q.shape
            _close(got.float().cpu().numpy(), want, dtype)
            assert tfa.launches == n0 + 1
            # every route computes the same function
            for route in ("small", "tile"):
                got = tfa.flash_attention(q, k, v, route=route, **kw)
                _close(got.float().cpu().numpy(), want, dtype)
            assert tfa.launches == n0 + 3
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_resident_route_matches_plain_versions(cuda_device):
    """The resident route against the plain version on the card: gate
    chunks of 2, 6 and 8 sweeps and the iteration with its λ pass, at
    uneven bands ((5, 200, 1000): G = 4 of 50 rows; (3, 1000, 1000): 16
    bands of 63, the last of 55, rows past the held ones from L2), one
    CTA a slice ((4, 40, 48)), the serving cell's 400^2 and the paper's
    largest m ((2, 1400, 1400), mostly from L2), in both dtypes; more
    slices than clusters resident at once; the same bits in two calls;
    a CUDA graph's replay the eager call's bits; each launch counted in
    `launches` and, while tracing, in `kernels.power_resident`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        dt = TDT[dtype]
        for b, r, c in [(5, 200, 1000), (7, 400, 400), (3, 1000, 1000),
                        (4, 40, 48), (2, 1400, 1400)]:
            x, v = _power_inputs(b, r, c)
            ts = torch.from_numpy(x).to(cuda_device, dt)
            tv = torch.from_numpy(v).to(cuda_device)
            n0 = tpik.launches
            for k in (2, 6, 8):
                got = tpik.power_iterate_chunk(ts, tv, k, route="resident")
                want = ref.power_iterate_chunk(ts, tv, k)
                _close(got[2].cpu().numpy(), want[2].cpu().numpy(), dtype,
                       scale=want[1].abs().max().item())
                for g, w in zip(got[:2], want[:2]):
                    _close(g.cpu().numpy(), w.cpu().numpy(), dtype)
                again = tpik.power_iterate_chunk(ts, tv, k, route="resident")
                assert all(torch.equal(g, a) for g, a in zip(got, again))
            got = tpik.power_iterate(ts, tv, 5, route="resident")
            for g, w in zip(got, ref.power_iterate(ts, tv, 5)):
                _close(g.cpu().numpy(), w.cpu().numpy(), dtype)
            assert tpik.launches == n0 + 7
        # more slices than the clusters resident at once: each cluster
        # walks over several
        n_cl = tpik.resident_clusters(40, 48, dt)
        x, v = _power_inputs(2 * n_cl + 3, 40, 48, seed=3)
        ts = torch.from_numpy(x).to(cuda_device, dt)
        tv = torch.from_numpy(v).to(cuda_device)
        eager = tpik.power_iterate_chunk(ts, tv, 6, route="resident")
        for g, w in zip(eager[:2], ref.power_iterate_chunk(ts, tv, 6)[:2]):
            _close(g.cpu().numpy(), w.cpu().numpy(), dtype)
        # captured once, replayed: the eager call's bits
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tpik.power_iterate_chunk(ts, tv, 6, route="resident")
        torch.cuda.current_stream().wait_stream(side)
        c0 = tpik.captured
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tpik.power_iterate_chunk(ts, tv, 6, route="resident")
        assert tpik.captured == c0 + 1
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip(out, eager))
        # the counter counts launches on the route, and no other
        with profile(activities=[ProfilerActivity.CPU]):
            tpik.power_iterate_chunk(ts, tv, 6, route="resident")
            tpik.power_iterate(ts, tv, 3, route="resident")
            tpik.power_iterate_chunk(ts, tv, 6, route="ring")
            tpik.power_matvec(ts, tv)
        assert spans.recorded().counters.get("kernels.power_resident") == 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch,bl,bc,grid", [
    (1, 1000, 1000, (16, 16, 1)),   # the flat epilogue: 256 CTAs
    (3, 1000, 1000, (16, 16, 3)),   # request-batched, requests on grid.z
    (2, 129, 65, (3, 2, 2)),        # ragged i and j tiles
    (1, 64, 64, (1, 1, 1)),
    (1, 5, 0, (1, 1, 1)),           # no rows of b: one zero j-tile
])
def test_abs_rowsum_tile_plan(batch, bl, bc, grid):
    plan = tring.tile_plan(batch, bl, bc)
    assert plan.grid == grid
    assert plan.nj == grid[1]
    assert plan.workspace == (batch, grid[1], bl)
    assert plan.tickets == (batch, grid[0])
    if (bl, bc) == (1000, 1000):
        assert grid[0] * grid[1] >= 128  # fills the card's 132 SMs


def test_abs_rowsum_partials_in_j_order_match_plain():
    """The kernel's reduction: per j-tile row partials Σ_j |a bᵀ| in the
    plan's workspace, then acc and the partials added in j order, equal
    the plain version within 1e-6."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(2, 129, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 200, 40)).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(size=(2, 129)).astype(np.float32))
    plan = tring.tile_plan(2, 129, 200)
    ws = torch.empty(plan.workspace)
    for j in range(plan.nj):
        bj = b[:, j * tring.TILE:(j + 1) * tring.TILE]
        ws[:, j] = (a @ bj.transpose(1, 2)).abs().sum(-1)
    got = acc.clone()
    for j in range(plan.nj):
        got += ws[:, j]
    want = ref.abs_rowsum(a, b, acc)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
