"""Port parity: the matrix-free eigensolver (einsum path) and its gate.

Slices are made with numpy from a seed (a planted rank-1 signal plus
noise, so the gate fires within the cap) and fed to
`repro.core.power_iter` (JAX, CPU) and `repro_torch.core.power_iter`.
Bounds: realized sweeps and gate verdicts identical; λ and v within
3e-5 relative (of the largest entry) in fp32 and 1e-2 under bf16_fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import power_iter as jpi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import power_iter as tpi  # noqa: E402
from repro_torch.core.types import MSCConfig  # noqa: E402

TOL = {"fp32": 3e-5, "bf16_fp32": 1e-2}


def _slices(b=12, r=20, c=16, lead=(), gamma=25.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (b, r, c)).astype(np.float32)
    u = np.zeros(r, np.float32)
    u[:3] = 3 ** -0.5
    v = np.zeros(c, np.float32)
    v[:3] = 3 ** -0.5
    x[..., :3, :, :] += gamma * u[:, None] * v[None, :]
    return x


def _close(got, ref, precision):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= TOL[precision] * scale, (
        np.abs(got - ref).max() / scale)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_make_chunk_probe_matches_reference(precision):
    x = _slices()
    v = np.array(jpi._init_vectors(12, 16))
    rv, rl, rr = jpi.make_chunk_probe(
        jpi.matvec_matrix_free(jnp.asarray(x), precision), 4)(jnp.asarray(v))
    tv, tl, tr = tpi.make_chunk_probe(
        tpi.matvec_matrix_free(torch.from_numpy(x), precision), 4)(
            torch.from_numpy(v))
    _close(tv.numpy(), rv, precision)
    _close(tl.numpy(), rl, precision)
    _close(tr.numpy(), rr, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_step_chunk_resumes_reference_carry(precision):
    """Two chunks in the reference, then one more in each package from
    the reference's carry (handed over through the bridge)."""
    x = _slices(lead=(3,), seed=1)
    x[1] *= 0.05  # a noise-dominated request: its gate fires later
    tol, k, n_iters = 1e-2, 3, 30
    jchunk = jpi.make_chunk_probe(
        jpi.matvec_matrix_free(jnp.asarray(x), precision), k)
    state = jpi.init_solve_state(jpi._init_vectors((3, 12), 16))
    step = jax.jit(lambda s: jpi.step_chunk(jchunk, s, k=k, n_iters=n_iters,
                                            tol=tol))
    for _ in range(2):
        state = step(state)
    nxt = step(state)
    carry = bridge.solve_state_from_numpy(
        *(np.asarray(f) for f in (state.v, state.lam, state.resid,
                                  state.iters, state.done)))
    tchunk = tpi.make_chunk_probe(
        tpi.matvec_matrix_free(torch.from_numpy(x), precision), k)
    got = tpi.step_chunk(tchunk, carry, k=k, n_iters=n_iters, tol=tol)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(nxt.iters))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(nxt.done))
    _close(got.v.numpy(), nxt.v, precision)
    _close(got.lam.numpy(), nxt.lam, precision)
    assert got.iters.dtype == torch.int32 and got.done.dtype == torch.bool


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("tol", [0.0, 1e-2])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_power_iteration_matrix_free_matches_reference(precision, tol, lead):
    x = _slices(lead=lead, seed=2)
    kw = dict(n_iters=24, tol=tol, check_every=6, precision=precision)
    rl, rv, ri = jpi.power_iteration_matrix_free(jnp.asarray(x), **kw)
    tl, tv, ti = tpi.power_iteration_matrix_free(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert tuple(ti.shape) == lead
    _close(tl.numpy(), rl, precision)
    _close(tv.numpy(), rv, precision)
    if tol > 0 and not lead:
        assert int(ti) < 24  # the planted slices gate early


def test_init_vectors_with_c_valid_match_reference():
    for batch, cv in [(5, None), ((2, 3), 11), ((2, 3), np.array([[7], [16]]))]:
        ref = np.asarray(jpi._init_vectors(batch, 16, c_valid=cv))
        got = tpi._init_vectors(batch, 16, c_valid=cv).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_convergence_gate_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        lam = rng.uniform(0, 100, size=(4, 9)).astype(np.float32)
        resid = rng.uniform(0, 2, size=(4, 9)).astype(np.float32)
        for tol in (1e-3, 1e-2, 5e-2):
            ref = jpi.convergence_gate(jnp.asarray(lam), jnp.asarray(resid),
                                       tol)
            got = tpi.convergence_gate(torch.from_numpy(lam),
                                       torch.from_numpy(resid), tol)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_top_eigenpairs_dispatch():
    x = torch.from_numpy(_slices())
    cfg = MSCConfig(power_iters=12)
    lam, v, it = tpi.top_eigenpairs(x, cfg)
    lam_k, v_k, it_k = tpi.top_eigenpairs(x, cfg.with_(use_kernels=True))
    assert int(it) == int(it_k)
    torch.testing.assert_close(lam_k, lam, rtol=3e-5, atol=0)
    for use_kernels in (False, True):
        gram = cfg.with_(matrix_free=False, use_kernels=use_kernels)
        lam_g, v_g, it_g = tpi.top_eigenpairs(x, gram)
        want = tpi.power_iteration_gram(x, n_iters=12, tol=cfg.power_tol,
                                        check_every=cfg.power_check_every)
        assert int(it_g) == int(want[2])
        torch.testing.assert_close(lam_g, want[0], rtol=3e-5, atol=0)
    with pytest.raises(ValueError):
        tpi.compute_dtype("fp16")


@pytest.mark.parametrize("n_iters", [3, 300], ids=["early", "converged"])
def test_rayleigh_residual_is_the_references(n_iters):
    """`tests/test_msc_core.py:53`'s case: after 300 sweeps the residual is
    below 1e-3 in both packages (fp32 round-off there: its bits are not
    compared); after 3 it equals the reference's within 3e-5."""
    x = np.random.default_rng(2).normal(size=(6, 30, 25)).astype(np.float32)
    lam, v, _ = jpi.power_iteration_matrix_free(jnp.asarray(x),
                                                n_iters=n_iters)
    want = jpi.rayleigh_residual(jnp.asarray(x), lam, v)
    got = tpi.rayleigh_residual(torch.from_numpy(x),
                                torch.from_numpy(np.array(lam)),
                                torch.from_numpy(np.array(v)))
    if n_iters == 300:
        assert float(got.max()) < 1e-3 and float(jnp.max(want)) < 1e-3
    else:
        _close(got, want, "fp32")


@pytest.mark.parametrize("tol,n_iters", [(1e-2, 60), (0.0, 20)],
                         ids=["gated", "to_the_cap"])
def test_power_iterate_adaptive_oracle_is_the_references(tol, n_iters):
    """`tests/test_power_adaptive.py:179`'s oracle on planted slices: the
    same realized sweeps (the cap rounded up to the chunk), λ and v."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    x = _slices(b=10, r=24, c=24, gamma=30.0, seed=3)
    v0 = np.random.default_rng(4).normal(size=(10, 24)).astype(np.float32)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    lam_j, v_j, it_j = jref.power_iterate_adaptive(
        jnp.asarray(x), jnp.asarray(v0), n_iters, tol, 6)
    lam_t, v_t, it_t = tref.power_iterate_adaptive(
        torch.from_numpy(x), torch.from_numpy(v0), n_iters, tol, 6)
    assert it_t == it_j and (tol > 0 or it_t == 24)
    _close(lam_t, lam_j, "fp32")
    _close(v_t, v_j, "fp32")

