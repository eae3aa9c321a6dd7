"""Port parity for the explicit-gram slice: the plain `batched_gram`
against the Pallas kernel in interpret mode, the wrapper's checks, and
the gram eigensolvers against the reference's.

Inputs are made with numpy from a seed.  Bounds, relative to the largest
reference entry: `batched_gram` 1e-5 for an fp32 result (sums in another
order) and 1e-2 for a bf16 result (an fp32 sum on the other side of a
bf16 rounding boundary moves the entry by one bf16 ulp, 2^-8); the
solvers 3e-5 in fp32 and 1e-2 under bf16_fp32, with realized sweeps
identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import power_iter as jpi  # noqa: E402
from repro.kernels import gram as jgram  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import power_iter as tpi  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"fp32": 3e-5, "bf16_fp32": 1e-2}
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# (shape, block_r, block_c of the Pallas call): one tile; ragged r and c
# over several tiles; a leading request dim, flattened by the dispatchers
GRAM_CASES = [((3, 24, 16), 256, 128), ((5, 37, 130), 16, 128),
              ((2, 3, 20, 12), 8, 128)]


@pytest.mark.parametrize("out", [None, "float32"], ids=["out_in", "out_fp32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAM_CASES, ids=lambda c: str(c[0]))
def test_batched_gram_plain_matches_pallas(case, dtype, out):
    shape, block_r, block_c = case
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    js = jnp.asarray(x).astype(getattr(jnp, dtype))
    ts = torch.from_numpy(x).to(TDT[dtype])
    want = jops.batched_gram(js, interpret=True, block_r=block_r,
                             block_c=block_c,
                             out_dtype=None if out is None else jnp.float32)
    before = tgram.launches
    got = ops.batched_gram(ts,
                           out_dtype=None if out is None else torch.float32)
    assert tgram.launches == before  # the CPU runs the plain version
    out_dt = dtype if out is None else out
    assert got.dtype == TDT[out_dt]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           OUT_TOL[out_dt])


def test_batched_gram_zero_padding_adds_exact_zeros():
    """Zero rows and columns (bucket padding) leave C's true corner
    unchanged and add zero rows and columns."""
    x = np.random.default_rng(1).normal(size=(4, 9, 7)).astype(np.float32)
    pad = np.zeros((4, 13, 11), np.float32)
    pad[:, :9, :7] = x
    c = ref.batched_gram(torch.from_numpy(x))
    cp = ref.batched_gram(torch.from_numpy(pad))
    torch.testing.assert_close(cp[:, :7, :7], c, rtol=1e-6, atol=1e-6)
    assert not cp[:, 7:, :].any() and not cp[:, :, 7:].any()
    want = np.asarray(jgram.batched_gram(jnp.asarray(x), interpret=True))
    _close(c.numpy(), want, OUT_TOL["float32"])


def test_gram_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 5, 4)
    with pytest.raises(TypeError):
        tgram.batched_gram(x.double())
    with pytest.raises(TypeError):
        tgram.batched_gram(x, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        tgram.batched_gram(x[0])
    with pytest.raises(ValueError):
        tgram.batched_gram(x.transpose(1, 2))
    with pytest.raises(ValueError):
        tgram.batched_gram(torch.zeros(2, 5, 0))


@pytest.mark.parametrize("c", [1, 127, 128, 129, 1000, 1291])
def test_gram_tile_plan_covers_one_triangle_and_its_mirror(c):
    """The kernel's CTAs cover each tile pair (ti <= tj) once and their
    mirrors the rest of C; C assembled from the plan's tiles and mirrors
    is the plain version's, every entry written (NaN where none is)."""
    plan = tgram.tile_plan(c)
    tiles = -(-c // tgram.TILE)
    assert plan.tiles == tiles
    assert len(plan.pairs) == len(set(plan.pairs)) == tiles * (tiles + 1) // 2
    assert all(i <= j for i, j in plan.pairs)
    assert set(plan.pairs) | {(j, i) for i, j in plan.pairs} == {
        (i, j) for i in range(tiles) for j in range(tiles)}
    x = torch.from_numpy(np.random.default_rng(c).normal(size=(3, c)).astype(
        np.float32))
    t = tgram.TILE
    got = torch.full((c, c), float("nan"))
    for i, j in plan.pairs:
        blk = x[:, i * t:(i + 1) * t].T @ x[:, j * t:(j + 1) * t]
        got[i * t:(i + 1) * t, j * t:(j + 1) * t] = blk
        got[j * t:(j + 1) * t, i * t:(i + 1) * t] = blk.T
    _close(got.numpy(), ref.batched_gram(x[None])[0].numpy(),
           OUT_TOL["float32"])


def _slices(b=12, r=20, c=16, lead=(), gamma=25.0, seed=0):
    """A planted rank-1 signal on three slices plus noise, so the gate
    fires within the cap."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (b, r, c)).astype(np.float32)
    u = np.zeros(r, np.float32)
    u[:3] = 3 ** -0.5
    v = np.zeros(c, np.float32)
    v[:3] = 3 ** -0.5
    x[..., :3, :, :] += gamma * u[:, None] * v[None, :]
    return x


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["einsum", "kernel"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("tol", [0.0, 1e-2])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_power_iteration_gram_matches_reference(precision, tol, lead,
                                                use_kernel):
    """The port's formation (plain fp32 product, or the kernel's plain
    version) against the reference's (einsum, or Pallas in interpret
    mode)."""
    x = _slices(lead=lead, seed=2)
    kw = dict(n_iters=24, tol=tol, check_every=6, precision=precision)
    rl, rv, ri = jpi.power_iteration_gram(jnp.asarray(x),
                                          use_kernel=use_kernel, **kw)
    tl, tv, ti = tpi.power_iteration_gram(torch.from_numpy(x),
                                          use_kernel=use_kernel, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert tuple(ti.shape) == lead
    _close(tl.numpy(), rl, TOL[precision])
    _close(tv.numpy(), rv, TOL[precision])
    if tol > 0 and not lead:
        assert int(ti) < 24  # the planted slices gate early


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("tol", [0.0, 1e-2])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_power_iteration_on_gram_matches_reference(precision, tol, lead):
    """The same fp32 gram into both solvers: the iteration's bf16
    rounding of C and v, and λ = vᵀCv on the fp32 C."""
    x = _slices(lead=lead, seed=3).astype(np.float64)
    gram = np.einsum("...rc,...rd->...cd", x, x).astype(np.float32)
    kw = dict(n_iters=24, tol=tol, check_every=6, precision=precision)
    rl, rv, ri = jpi.power_iteration_on_gram(jnp.asarray(gram), **kw)
    tl, tv, ti = tpi.power_iteration_on_gram(torch.from_numpy(gram), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _close(tl.numpy(), rl, TOL[precision])
    _close(tv.numpy(), rv, TOL[precision])


def test_gram_solve_with_padded_columns_matches_unpadded():
    """c_valid keeps zero-padded columns of v at exactly 0, so the padded
    solve is the unpadded one (the serving engine's column padding)."""
    x = _slices(b=5, r=14, c=9, lead=(2,), seed=4)
    pad = np.zeros((2, 5, 14, 13), np.float32)
    pad[..., :9] = x
    pad[1, ..., 7:] = 0.0  # request 1 holds only 7 true columns
    c_valid = torch.tensor([[9], [7]])
    lam, v, it = tpi.power_iteration_gram(torch.from_numpy(pad), n_iters=24,
                                          tol=1e-2, c_valid=c_valid)
    assert not v[0, :, 9:].any() and not v[1, :, 7:].any()
    for i, c in enumerate((9, 7)):
        ul, uv, ui = tpi.power_iteration_gram(
            torch.from_numpy(np.ascontiguousarray(pad[i, ..., :c])),
            n_iters=24, tol=1e-2)
        assert int(it[i]) == int(ui)
        torch.testing.assert_close(lam[i], ul, rtol=1e-5, atol=0)
        torch.testing.assert_close(v[i, :, :c], uv, rtol=1e-5, atol=1e-6)


def test_chunk_fn_needs_matrix_free():
    from repro_torch.core.types import MSCConfig

    with pytest.raises(ValueError, match="matrix_free=True"):
        tpi.build_chunk_fn(torch.zeros(2, 3, 4), MSCConfig(matrix_free=False))
