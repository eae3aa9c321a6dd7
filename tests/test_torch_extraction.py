"""The Theorem II.1 trim in closed form, against the loop it replaces.

`trim_to_theorem` finds the trim count in one sort on the device.  Here
it is held to a naive loop written in this file (the member-by-member
loop of the reference's `lax.while_loop`, with the port's fp32
`theorem_threshold` on 0-d tensors, one host read per step) over seeded
cases: ties at the cut, padding, caps, all-equal d, one or two members,
and spreads that sit exactly on the bound.  Masks and `n_iters` must be
identical.  `extract_cluster` is held to the reference's on the same
numpy d, and the batched finalize to a loop of single requests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import extraction as jext  # noqa: E402
from repro_torch.core import MSCConfig, ModeSchedule  # noqa: E402
from repro_torch.core import extraction as text  # noqa: E402
from repro_torch.core.stats import theorem_threshold  # noqa: E402

CASES_PER_KIND = 200
EPS = (1e-6, 3e-4, 1e-2, 0.3, 3.0)
KINDS = ("random", "ties", "padded", "capped", "all_equal", "one_or_two",
         "on_the_bound")


def naive_trim(d, init, eps, valid, max_iters):
    """Drop the argmin-d member while the spread exceeds the bound and
    more than one member is left, at most max_iters (0 → m) times."""
    cap = max_iters if max_iters > 0 else d.shape[0]
    n_valid = valid.to(torch.float32).sum()
    mask, it = init.clone(), 0
    while it < cap:
        l = mask.to(torch.float32).sum()
        spread = (torch.max(torch.where(mask, d, -1e30))
                  - torch.min(torch.where(mask, d, 1e30)))
        if not bool((spread > theorem_threshold(l, n_valid, eps))
                    & (l > 1.0)):
            break
        mask[torch.argmin(torch.where(mask, d, 1e30))] = False
        it += 1
    return mask, it


def _case(kind, rng):
    """(d, init, valid, eps, cap) of one seeded case of `kind`."""
    m = int(rng.integers(2, 41))
    eps = float(rng.choice(EPS))
    cap = 0
    valid = np.ones(m, bool)
    if kind == "ties":  # few distinct values: ties everywhere, at the cut too
        d = rng.integers(0, 4, size=m).astype(np.float32) * 0.5
    elif kind == "all_equal":
        d = np.full(m, float(rng.normal()), np.float32)
    else:
        d = (rng.normal(size=m) * rng.choice([0.1, 1.0, 10.0])).astype(
            np.float32)
    if kind == "padded":
        valid = rng.random(m) < 0.7
        valid[rng.integers(m)] = True
        d[~valid] = rng.choice([0.0, 1e3])  # padding never enters J
    if kind == "capped":
        cap = int(rng.integers(1, m + 1))
    init = valid & (rng.random(m) < rng.uniform(0.2, 1.0))
    if kind == "one_or_two":
        init = np.zeros(m, bool)
        init[rng.choice(np.flatnonzero(valid),
                        size=min(int(rng.integers(1, 3)), int(valid.sum())),
                        replace=False)] = True
    if kind == "on_the_bound":
        # the spread of the first l members equal to the bound at l, or
        # one fp32 step either side of it: the comparison's knife edge
        members = np.flatnonzero(init)
        if len(members) >= 2:
            l = int(rng.integers(2, len(members) + 1))
            b = float(theorem_threshold(torch.tensor(float(l)),
                                        torch.tensor(float(m)), eps))
            b = np.float32(b)
            b = [np.nextafter(b, np.float32(0)), b,
                 np.nextafter(b, np.float32(np.inf))][rng.integers(3)]
            keep = members[np.argsort(d[members], kind="stable")][-l:]
            d[keep] = np.float32(0.0)
            d[keep[-1]] = b
            d[np.setdiff1d(members, keep)] = -np.float32(b)
    if not init.any():
        init[np.flatnonzero(valid)[0]] = True
    return d, init, valid, eps, cap


@pytest.mark.parametrize("kind", KINDS)
def test_closed_form_trim_equals_the_loop(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    trimmed = 0
    for _ in range(CASES_PER_KIND):
        d, init, valid, eps, cap = (torch.from_numpy(np.array(x))
                                    if isinstance(x, np.ndarray) else x
                                    for x in _case(kind, rng))
        want, want_it = naive_trim(d, init, eps, valid, cap)
        got, got_it = text.trim_to_theorem(d, init, eps, valid, cap)
        assert got_it.dtype == torch.int32 and got_it.dim() == 0
        assert int(got_it) == want_it, (d, init, valid, eps, cap)
        assert torch.equal(got, want), (d, init, valid, eps, cap)
        trimmed += want_it > 0
    # the cases reach the loop's body (a constant d has no spread to trim)
    assert trimmed > 0 or kind == "all_equal"


def test_threshold_over_a_vector_repeats_the_scalar_bits():
    """The closed form evaluates the bound for every l at once: each
    element must carry the bits of the loop's 0-d call."""
    for n_valid in (2.0, 37.0, 1000.0, 4096.0):
        for eps in EPS:
            l = torch.arange(0, int(n_valid) + 1, dtype=torch.float32)
            vec = theorem_threshold(l, torch.tensor([n_valid]), eps)
            one = torch.stack([theorem_threshold(x, torch.tensor(n_valid),
                                                 eps) for x in l])
            assert torch.equal(vec, one), (n_valid, eps)


@pytest.mark.parametrize("m", [17, 60])
def test_extract_cluster_equals_the_reference(m):
    rng = np.random.default_rng(m)
    for i in range(60):
        d = rng.normal(1.0, 0.3, size=m).astype(np.float32)
        d[rng.choice(m, size=int(rng.integers(1, m // 3)),
                     replace=False)] += rng.uniform(0.5, 6.0)
        if i % 3 == 0:
            d = np.round(d, 1)  # ties
        valid = None
        if i % 4 == 1:
            valid = np.arange(m) < int(rng.integers(m // 2, m))
            d[~valid] = 0.0
        eps = float(EPS[i % len(EPS)])
        rmask, rit = jext.extract_cluster(
            jnp.asarray(d), eps, None if valid is None else jnp.asarray(valid))
        mask, it = text.extract_cluster(
            torch.from_numpy(d), eps,
            None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
        assert int(it) == int(rit), (i, d, valid, eps)


@pytest.mark.parametrize("max_iters", [0, 3])
def test_batched_finalize_equals_single_requests(max_iters):
    rng = np.random.default_rng(5)
    b, m = 5, 24
    d = rng.normal(1.0, 0.4, size=(b, m)).astype(np.float32)
    d[:, :4] += 4.0
    d[1] = np.round(d[1], 1)
    lens = np.array([24, 13, 1, 20, 7])
    valid = np.arange(m)[None, :] < lens[:, None]
    d[~valid] = 0.0
    iters = torch.tensor([[12], [18], [6], [60], [24]], dtype=torch.int32)
    sched = ModeSchedule(MSCConfig(epsilon=3e-4,
                                   max_extraction_iters=max_iters))
    td, tv = torch.from_numpy(d), torch.from_numpy(valid)
    lam = torch.ones(b, m)
    res = sched.finalize_mode_batched(td, lam, iters, tv)
    assert res.mask.shape == (b, m) and res.n_iters.shape == (b,)
    assert res.power_iters_run.tolist() == [12, 18, 6, 60, 24]
    for i in range(b):
        one = sched.finalize_mode(td[i], lam[i], iters[i], tv[i], m)
        assert torch.equal(res.mask[i], one.mask), i
        assert int(res.n_iters[i]) == int(one.n_iters), i
        mask, it = naive_trim(td[i], text.max_gap_init(td[i], tv[i]),
                              3e-4, tv[i], max_iters)
        assert torch.equal(res.mask[i], mask) and int(res.n_iters[i]) == it
