"""Port parity: types, statistics, metrics, extraction and synthetic data.

The same numpy inputs go through `repro.core` (JAX, CPU) and
`repro_torch.core`; masks and iteration counts must be identical and
fp32 values equal to a few ulps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import extraction as jext  # noqa: E402
from repro.core import metrics as jmet  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.core import synthetic as jsyn  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import extraction as text  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core import synthetic as tsyn  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402


def _planted_d(rng, m, l, gap=5.0, noise=0.3):
    d = rng.normal(1.0, noise, size=m).astype(np.float32)
    d[rng.choice(m, size=l, replace=False)] += gap
    return d


def _d_cases():
    rng = np.random.default_rng(0)
    cases = {
        "planted": (_planted_d(rng, 40, 4), None),
        "noise_only": (rng.normal(size=33).astype(np.float32), None),
        # ties: repeated values at the top, in the gap and at the bottom
        "ties": (np.array([3, 3, 1, 1, 1, 0.5, 3, 0.5, 2, 2], np.float32),
                 None),
        "all_equal": (np.ones(12, np.float32), None),
        "wide_spread": (np.linspace(0, 50, 30).astype(np.float32)[::-1]
                        .copy(), None),
    }
    d = _planted_d(rng, 30, 3)
    valid = np.arange(30) < 26
    d[~valid] = 0.0  # padding slices carry d = 0
    cases["padded"] = (d, valid)
    d = _planted_d(rng, 24, 2, gap=8.0)
    valid = np.ones(24, bool)
    valid[[3, 17]] = False
    d[~valid] = 100.0  # padding must never enter J, however large
    cases["padded_large"] = (d, valid)
    return cases


D_CASES = _d_cases()


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(D_CASES))
def test_max_gap_init_matches_reference(name):
    d, valid = D_CASES[name]
    ref = np.asarray(jext.max_gap_init(jnp.asarray(d), None if valid is None
                                       else jnp.asarray(valid)))
    got = text.max_gap_init(_t(d), _t(valid)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("eps", [1e-6, 1e-2, 3.0])
@pytest.mark.parametrize("name", sorted(D_CASES))
def test_extract_cluster_matches_reference(name, eps):
    d, valid = D_CASES[name]
    jv = None if valid is None else jnp.asarray(valid)
    rmask, rit = jext.extract_cluster(jnp.asarray(d), eps, jv)
    mask, it = text.extract_cluster(_t(d), eps, _t(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert it == int(rit)


@pytest.mark.parametrize("cap", [1, 2])
def test_trim_cap_matches_reference(cap):
    d = np.linspace(0, 50, 30).astype(np.float32)
    init = np.ones(30, bool)
    rmask, rit = jext.trim_to_theorem(jnp.asarray(d), jnp.asarray(init),
                                      1e-6, None, cap)
    mask, it = text.trim_to_theorem(_t(d), _t(init), 1e-6, None, cap)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert it == int(rit) == cap


def test_stats_match_reference():
    for m2, m3 in [(10, 10), (45, 60), (1000, 1000)]:
        for a, b in zip(jstats.wishart_mu_sigma(m2, m3),
                        tstats.wishart_mu_sigma(m2, m3)):
            np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
        np.testing.assert_allclose(float(tstats.tw_threshold(m2, m3, 0.95)),
                                   float(jstats.tw_threshold(m2, m3, 0.95)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(tstats.standardize_top_eig(5000.0, m2, m3)),
            float(jstats.standardize_top_eig(5000.0, m2, m3)), rtol=1e-5)
    for l, m, eps in [(1.0, 10.0, 1e-6), (4.0, 45.0, 1e-3), (9.0, 10.0, 0.5),
                      (100.0, 1000.0, 5.6e-7)]:
        np.testing.assert_allclose(
            float(tstats.theorem_threshold(l, m, eps)),
            float(jstats.theorem_threshold(l, m, eps)), rtol=1e-6)
        assert tstats.epsilon_ok(eps, m, l) == bool(
            jstats.epsilon_ok(eps, m, l))
    with pytest.raises(ValueError):
        tstats.tw_threshold(10, 10, 0.5)


def test_metrics_match_reference():
    rng = np.random.default_rng(1)
    true = [rng.random(20) < 0.3 for _ in range(3)]
    pred = [rng.random(20) < 0.3 for _ in range(3)]
    c_mats = [np.abs(rng.normal(size=(20, 20))).astype(np.float32)
              for _ in range(3)]
    ref = jmet.recovery_rate([jnp.asarray(x) for x in true],
                             [jnp.asarray(x) for x in pred])
    got = tmet.recovery_rate([_t(x) for x in true], [_t(x) for x in pred])
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    ref = jmet.similarity_index([jnp.asarray(c) for c in c_mats],
                                [jnp.asarray(x) for x in pred])
    got = tmet.similarity_index([_t(c) for c in c_mats],
                                [_t(x) for x in pred])
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_config_fields_and_defaults_match_reference():
    ref = dataclasses.asdict(jtypes.MSCConfig())
    assert dataclasses.asdict(ttypes.MSCConfig()) == ref
    cfg = jtypes.MSCConfig(epsilon=3e-4, precision="bf16_fp32",
                           use_kernels=True, block_r=64)
    assert dataclasses.asdict(
        bridge.config_from_fields(dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)
    with pytest.raises(ValueError, match="unknown"):
        bridge.config_from_fields({**ref, "mesh_axis": "x"})
    assert ttypes.PlantedSpec.paper(45, 70.0) == ttypes.PlantedSpec(
        **dataclasses.asdict(jtypes.PlantedSpec.paper(45, 70.0)))


def test_planted_masks_and_factors_match_reference():
    spec = jtypes.PlantedSpec.paper(30, 10.0)
    tspec = ttypes.PlantedSpec.paper(30, 10.0)
    sets = (np.array([1, 5, 7]), np.array([0, 2, 29]), np.array([3, 4, 9]))
    for ix in (None, sets):
        for a, b in zip(jsyn.planted_masks(spec, ix),
                        tsyn.planted_masks(tspec, ix)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jsyn.planted_factors(spec, ix),
                        tsyn.planted_factors(tspec, ix)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_planted_tensor_is_seeded_and_carries_the_signal():
    spec = ttypes.PlantedSpec.paper(30, 200.0)
    t1 = tsyn.make_planted_tensor(torch.Generator().manual_seed(3), spec)
    t2 = tsyn.make_planted_tensor(torch.Generator().manual_seed(3), spec)
    assert t1.shape == (30, 30, 30) and t1.dtype == torch.float32
    assert torch.equal(t1, t2)
    l = spec.cluster_sizes[0]
    block = t1[:l, :l, :l].mean().item()
    assert abs(block - 200.0 / l ** 1.5) < 0.5
    assert abs(t1[l:, l:, l:].mean().item()) < 0.05


def test_resolve_device():
    assert ttypes.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttypes.resolve_device("cuda")


def test_mode_result_helpers():
    r = ttypes.ModeResult(mask=torch.tensor([True, False, True]),
                          d=torch.zeros(3), lambdas=torch.zeros(3),
                          n_iters=0, power_iters_run=6)
    assert r.size == 2
    np.testing.assert_array_equal(r.indices, [0, 2])
