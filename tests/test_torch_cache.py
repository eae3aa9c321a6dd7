"""The port's result cache and warm starts, on the CPU, against the
reference's (`tests/test_msc_cache.py`'s cases).

Held here:
- fingerprints: `tensor_fingerprint`, `config_fingerprint` (and
  `MSCConfig.fingerprint`) and `result_cache_key` with an equal salt give
  the reference's digests on the same numpy inputs; keys are invariant
  to memory layout and device-side form, sensitive to content, shape and
  dtype, and drop the observational knobs; `cache_salt` mixes in the
  torch version, so it differs from the reference's; `spectral_sketch`
  equals the reference's to 1e-6 relative;
- `MSCResultCache`: LRU eviction, recency, replace-in-place accounting
  (the reference's byte counts on the same entries), the LSH buckets of
  a sketch, near hits and misses, persistence round trip, keep-last-1,
  stale salt dropped (a cache the reference persisted loads empty, by
  design), and the `.tmp` and orphan-shard reaping of the store's GC;
- the engine with a cache against the reference's engine (one-device
  mesh, its einsum path) on the same stream: an exact hit is served with
  no dispatch and the cold bits; a warm-started near-duplicate's masks
  and sweeps equal the reference's warm-started engine's (d within 3e-5
  of the largest reference entry), with the same warm counters; a cache
  leaves the cold path's bits unchanged.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import make_msc_mesh  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.core import fingerprint as jfp  # noqa: E402
from repro.serving import MSCContinuousEngine as JEngine  # noqa: E402
from repro.serving import MSCResultCache as JCache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.store import (gc_checkpoints,  # noqa: E402
                                          load_leaves, save_checkpoint,
                                          shard_filename)
from repro_torch.core import MSCConfig, msc_sequential  # noqa: E402
from repro_torch.core import fingerprint as fp  # noqa: E402
from repro_torch.core.types import ModeResult, MSCResult  # noqa: E402
from repro_torch.serving import (MSCContinuousEngine,  # noqa: E402
                                 MSCResultCache)

TOL = 3e-5
# the reference test's warm-start gate: tight enough that warm and cold
# solves exit on the same eigenvector
WARM_CFG = dict(epsilon=3e-4, power_tol=1e-4, power_iters=480,
                power_check_every=8)


def _tensor(seed=0, m=12, gamma=40.0):
    x = np.asarray(jplanted(jax.random.PRNGKey(seed), JSpec.paper(m, gamma)),
                   np.float32)
    x.setflags(write=False)
    return x


def _near(donor):
    rng = np.random.RandomState(3)
    return (donor + 0.003 * donor.std() * rng.standard_normal(
        donor.shape).astype(np.float32)).astype(np.float32)


def _result(m=4, sweeps=6):
    mode = ModeResult(mask=np.zeros(m, bool), d=np.zeros(m, np.float32),
                      lambdas=np.ones(m, np.float32),
                      n_iters=np.asarray(sweeps),
                      power_iters_run=np.asarray(sweeps))
    return MSCResult(modes=(mode, mode, mode))


def _jresult(m=4, sweeps=6):
    from repro.core.types import ModeResult as JMode
    from repro.core.types import MSCResult as JResult

    mode = JMode(mask=np.zeros(m, bool), d=np.zeros(m, np.float32),
                 lambdas=np.ones(m, np.float32), n_iters=np.asarray(sweeps),
                 power_iters_run=np.asarray(sweeps))
    return JResult(modes=(mode, mode, mode))


def _cfg(**kw):
    return bridge.config_from_fields(dataclasses.asdict(JConfig(**kw)))


# ------------------------------------------------------ fingerprints --

LAYOUTS = {
    "c": lambda a: a,
    "fortran": np.asfortranarray,
    "transposed_back": lambda a: a.transpose(2, 0, 1).transpose(1, 2, 0),
    "strided": lambda a: _strided(a),
    "torch": torch.from_numpy,
}


def _strided(a):
    big = np.zeros((a.shape[0], 2 * a.shape[1], a.shape[2]), a.dtype)
    big[:, ::2, :] = a
    return big[:, ::2, :]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tensor_fingerprint_is_the_references_in_any_layout(layout):
    a = _tensor()
    got = fp.tensor_fingerprint(LAYOUTS[layout](np.array(a)))
    assert got == jfp.tensor_fingerprint(a) == fp.tensor_fingerprint(a)


def test_tensor_fingerprint_sensitivity():
    a = _tensor()
    b = np.array(a)
    b[3, 4, 5] += 1e-6
    assert fp.tensor_fingerprint(b) != fp.tensor_fingerprint(a)
    assert fp.tensor_fingerprint(b) == jfp.tensor_fingerprint(b)
    for other in (a.reshape(-1), a.astype(np.float64)):
        assert fp.tensor_fingerprint(other) != fp.tensor_fingerprint(a)
        assert fp.tensor_fingerprint(other) == jfp.tensor_fingerprint(other)


CONFIGS = [dict(epsilon=3e-4), dict(epsilon=3e-4, power_tol=1e-2),
           dict(epsilon=1e-3, epilogue="ring"),
           dict(precision="bf16_fp32", use_kernels=True),
           dict(matrix_free=False, power_iters=120),
           dict(block_r=128, inner_overlap=True)]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_config_fingerprint_is_the_references(i):
    kw = CONFIGS[i]
    want = JConfig(**kw).fingerprint()
    assert MSCConfig(**kw).fingerprint() == want
    assert fp.config_fingerprint(MSCConfig(**kw)) == want
    assert fp.config_fingerprint(dataclasses.asdict(JConfig(**kw))) == want


def test_config_fingerprint_collapses_and_drops_like_the_reference():
    assert (MSCConfig(power_iters=60).fingerprint()
            == MSCConfig(power_iters=60.0).fingerprint())
    base = MSCConfig(epsilon=3e-4).fingerprint()
    for kw in ({"epsilon": 1e-3}, {"power_tol": 1e-4}, {"epilogue": "ring"},
               {"precision": "bf16_fp32"}, {"matrix_free": False},
               {"use_kernels": True}):
        assert MSCConfig(epsilon=3e-4).with_(**kw).fingerprint() != base
    # block hints and overlap are numerics-neutral: one cache entry
    assert MSCConfig(epsilon=3e-4, block_r=64).fingerprint() == base
    d = {"epsilon": 3e-4, "power_tol": 1e-2}
    noisy = dict(d, ckpt_every_chunks=4, max_retries=7, placement="stable",
                 refill_min_free=2)
    assert set(noisy) - set(d) <= fp.OBSERVATIONAL_KNOBS
    assert fp.OBSERVATIONAL_KNOBS == jfp.OBSERVATIONAL_KNOBS
    assert fp.config_fingerprint(noisy) == fp.config_fingerprint(d) == \
        jfp.config_fingerprint(noisy)
    swapped = {"power_tol": 1e-2, "epsilon": 3e-4}
    assert fp.config_fingerprint(swapped) == fp.config_fingerprint(d)


def test_result_cache_key_is_the_references_under_an_equal_salt():
    a = _tensor()
    cfg, jcfg = MSCConfig(epsilon=3e-4), JConfig(epsilon=3e-4)
    salt = "shared-salt"
    k = fp.result_cache_key(a, cfg, salt=salt)
    assert k == jfp.result_cache_key(a, jcfg, salt=salt)
    assert k == fp.result_cache_key(np.asfortranarray(a), cfg, salt=salt)
    assert k != fp.result_cache_key(a, cfg.with_(epsilon=1e-3), salt=salt)
    assert k != fp.result_cache_key(a, cfg, salt="other-code-version")
    # the code salt names torch, not jax: persisted reference caches miss
    assert fp.cache_salt() != jfp.cache_salt()
    assert len(fp.cache_salt()) == len(jfp.cache_salt()) == 16
    assert fp.result_cache_key(a, cfg).endswith(fp.cache_salt())


@pytest.mark.parametrize("shape,r", [((12, 12, 12), 4), ((9, 14, 5), 3),
                                     ((16, 7, 11), 1)])
def test_spectral_sketch_is_the_references(shape, r):
    a = np.asarray(jplanted(jax.random.PRNGKey(5),
                            JSpec(shape=shape, cluster_sizes=(2, 2, 2),
                                  gamma=30.0)), np.float32)
    want = jfp.spectral_sketch(a, r=r)
    got = fp.spectral_sketch(torch.from_numpy(np.array(a)), r=r)
    assert got.shape == want.shape == (r * sum(shape),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="3rd-order"):
        fp.spectral_sketch(a.reshape(-1), r=r)


# ------------------------------------------------------- cache units --

def test_lru_eviction_under_budget_with_the_references_accounting():
    r, jr = _result(), _jresult()
    cache, jcache = MSCResultCache(max_bytes=1), JCache(max_bytes=1)
    cache.put("a", r, shape=(4, 4, 4))
    jcache.put("a", jr, shape=(4, 4, 4))
    assert len(cache) == 1 and cache.nbytes == jcache.nbytes
    one = cache.nbytes
    cache = MSCResultCache(max_bytes=int(2.5 * one))
    for k in ("a", "b", "c"):
        cache.put(k, r, shape=(4, 4, 4))
    assert "a" not in cache and cache.evicted >= 1
    assert cache.nbytes <= cache.max_bytes


def test_get_refreshes_recency_and_counts():
    r = _result()
    cache = MSCResultCache()
    assert cache.get("nope") is None and cache.misses == 1
    cache.put("a", r, shape=(4, 4, 4))
    cache.put("b", r, shape=(4, 4, 4))
    got = cache.get("a")
    assert got is not None and cache.hits == 1
    # the port's host form: CPU tensors and ints
    assert isinstance(got[0].mask, torch.Tensor)
    assert got[0].power_iters_run == 6 and isinstance(got[0].n_iters, int)
    cache.max_bytes = cache.nbytes  # room for 2 of 3
    cache.put("c", r, shape=(4, 4, 4))
    assert "b" not in cache and "a" in cache and "c" in cache


def test_replace_in_place_accounting():
    cache = MSCResultCache()
    cache.put("a", _result(), shape=(4, 4, 4))
    n1 = cache.nbytes
    cache.put("a", _result(), shape=(4, 4, 4))
    assert len(cache) == 1 and cache.nbytes == n1


def _rich(cache, key, t, cls_result=_result):
    m = t.shape[0]
    vecs = tuple(np.ones((m, m), np.float32) for _ in range(3))
    sk = (fp if cache.__class__ is MSCResultCache else jfp).spectral_sketch(
        t, r=cache.sketch_r)
    cache.put(key, cls_result(m), shape=t.shape, vectors=vecs, sketch=sk)


def test_entry_bytes_and_lsh_buckets_are_the_references():
    a = _tensor(0)
    cache, jcache = MSCResultCache(), JCache()
    _rich(cache, "a", a)
    _rich(jcache, "a", a, _jresult)
    assert cache.nbytes == jcache.nbytes
    sk = fp.spectral_sketch(a, r=4)
    assert cache._bucket_keys(sk, a.shape) == jcache._bucket_keys(sk,
                                                                  a.shape)


def test_near_duplicate_hits_distinct_tensor_misses():
    a, b = _tensor(0), _tensor(1)
    near = _near(a)
    cache, jcache = MSCResultCache(), JCache()
    _rich(cache, "a", a)
    _rich(jcache, "a", a, _jresult)
    hit = cache.lookup_near(fp.spectral_sketch(near, r=4), near.shape)
    jhit = jcache.lookup_near(jfp.spectral_sketch(near, r=4), near.shape)
    assert hit is not None and hit.key == "a" == jhit.key
    assert hit.distance == pytest.approx(jhit.distance, rel=1e-5)
    assert hit.distance <= cache.sketch_tol and cache.near_hits == 1
    assert hit.donor_iters == (6, 6, 6)
    assert cache.lookup_near(fp.spectral_sketch(b, r=4), b.shape) is None
    other = _tensor(2, m=16)
    assert cache.lookup_near(fp.spectral_sketch(other, r=4),
                             other.shape) is None
    plain = MSCResultCache()
    plain.put("a", _result(a.shape[0]), shape=a.shape)  # tier 1 only
    assert plain.lookup_near(fp.spectral_sketch(a, r=4), a.shape) is None


def test_persist_round_trip_and_keep_last_one(tmp_path):
    d = str(tmp_path / "cache")
    a = _tensor(0)
    cache = MSCResultCache(persist_dir=d)
    cache.put("plain", _result(), shape=(4, 4, 4))
    _rich(cache, "rich", a)
    assert cache.persist() is not None
    cache.persist()
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 1
    fresh = MSCResultCache(persist_dir=d)
    assert len(fresh) == 2
    got = fresh.get("rich")
    for j in range(3):
        assert torch.equal(got[j].mask, torch.zeros(12, dtype=torch.bool))
    hit = fresh.lookup_near(fp.spectral_sketch(a, r=4), a.shape)
    assert hit is not None and hit.key == "rich"
    assert MSCResultCache().persist() is None


def test_stale_salt_dropped_at_load(tmp_path, monkeypatch):
    d = str(tmp_path / "cache")
    cache = MSCResultCache(persist_dir=d)
    cache.put("a", _result(), shape=(4, 4, 4))
    cache.persist()
    assert len(MSCResultCache(persist_dir=d)) == 1
    monkeypatch.setattr(fp, "CODE_VERSION", "msc-result-cache-v999")
    assert fp.cache_salt() != cache.salt
    assert len(MSCResultCache(persist_dir=d)) == 0


def test_caches_of_the_other_package_load_empty_by_design(tmp_path):
    """Each package reads the other's cache files (one store format), and
    drops every entry: the salts name different runtimes."""
    jd, d = str(tmp_path / "jcache"), str(tmp_path / "cache")
    jcache = JCache(persist_dir=jd)
    jcache.put("a", _jresult(), shape=(4, 4, 4))
    jcache.persist()
    cache = MSCResultCache(persist_dir=d)
    cache.put("a", _result(), shape=(4, 4, 4))
    cache.persist()
    leaves, extra = load_leaves(jd, 1)
    assert extra["kind"] == "msc_result_cache" and len(leaves) == 15
    assert len(MSCResultCache(persist_dir=jd)) == 0
    assert len(JCache(persist_dir=d)) == 0


def test_gc_reaps_tmp_dirs_and_orphan_shards(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, [np.arange(4, dtype=np.float32)])
    step = os.path.join(d, "step_00000001")
    orphan = shard_filename(0, 1, 0)
    np.save(os.path.join(step, orphan), np.zeros(2))
    with open(os.path.join(step, "shards_p001.json"), "w") as f:
        json.dump({"entries": [{"file": orphan}]}, f)
    with open(os.path.join(step, "shards_p002.json"), "w") as f:
        f.write("{not json")
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    os.makedirs(os.path.join(d, "step_00000001.old.tmp"))
    gc_checkpoints(d, 1)
    assert os.listdir(d) == ["step_00000001"]
    assert set(os.listdir(step)) == {"manifest.json", "leaf_00000.npy"}
    leaves, _ = load_leaves(d, 1)
    np.testing.assert_array_equal(leaves[0], np.arange(4, dtype=np.float32))
    # a step whose manifest does not parse is left alone
    bad = os.path.join(d, "step_00000003")
    os.makedirs(bad)
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        f.write("{broken")
    np.save(os.path.join(bad, shard_filename(0, 0, 0)), np.zeros(2))
    gc_checkpoints(d, 2)
    assert shard_filename(0, 0, 0) in os.listdir(bad)


# ------------------------------------------ the engine with a cache --

def _mesh():
    return make_msc_mesh("flat", devices=jax.devices()[:1])


def _host(res):
    return [(np.asarray(res[j].mask), np.asarray(res[j].d),
             int(res[j].power_iters_run)) for j in range(3)]


@functools.cache
def _reference():
    """The reference engine's runs: (cold, exact repeat, its stats
    delta) at the default gate; (donor, warm near-duplicate, the warm
    delta) under WARM_CFG."""
    t = _tensor(0, m=12, gamma=40.0)
    eng = JEngine(_mesh(), JConfig(epsilon=3e-4, power_tol=1e-2), slots=2,
                  result_cache=JCache())
    cold = eng.run([t])[0]
    before = eng.stats
    hot = eng.run([np.asfortranarray(t)])[0]
    hot_delta = dataclasses.asdict(eng.stats.delta(before))
    donor = _tensor(7, m=16, gamma=20.0)
    weng = JEngine(_mesh(), JConfig(**WARM_CFG), slots=2,
                   result_cache=JCache(), warm_start=True)
    wcold = weng.run([donor])[0]
    before = weng.stats
    warm = weng.run([_near(donor)])[0]
    warm_delta = dataclasses.asdict(weng.stats.delta(before))
    return (_host(cold), _host(hot), hot_delta, _host(wcold), _host(warm),
            warm_delta)


def _held(got, want):
    for j in range(3):
        mask, d, sweeps = want[j]
        np.testing.assert_array_equal(got[j].mask.numpy(), mask)
        assert got[j].power_iters_run == sweeps, j
        err = np.abs(got[j].d.numpy().astype(np.float64) - d).max()
        assert err <= TOL * max(np.abs(d).max(), 1e-30), j


def test_exact_hit_is_served_without_a_dispatch():
    cold_ref, hot_ref, hot_delta, *_ = _reference()
    t = _tensor(0, m=12, gamma=40.0)
    eng = MSCContinuousEngine(_cfg(epsilon=3e-4, power_tol=1e-2), slots=2,
                              device="cpu", result_cache=MSCResultCache())
    cold = eng.run([t])[0]
    before = eng.stats
    # the same values as a Fortran-ordered array: the key is the content
    hot = eng.run([np.asfortranarray(t)])[0]
    delta = eng.stats.delta(before)
    assert (delta.cache_hits, delta.cache_misses, delta.dispatches,
            delta.refills) == (1, 0, 0, 0)
    assert dataclasses.asdict(delta) == hot_delta
    _held(cold, cold_ref)
    for j in range(3):
        assert torch.equal(hot[j].mask, cold[j].mask)
        assert torch.equal(hot[j].d, cold[j].d)
        assert hot[j].power_iters_run == cold[j].power_iters_run


def test_warm_start_matches_the_references_warm_engine():
    *_, wcold_ref, warm_ref, warm_delta = _reference()
    cfg = _cfg(**WARM_CFG)
    eng = MSCContinuousEngine(cfg, slots=2, device="cpu",
                              result_cache=MSCResultCache(), warm_start=True)
    donor = _tensor(7, m=16, gamma=20.0)
    near = _near(donor)
    cold = eng.run([donor])[0]
    before = eng.stats
    warm = eng.run([near])[0]
    delta = eng.stats.delta(before)
    _held(cold, wcold_ref)
    _held(warm, warm_ref)
    assert delta.warm_starts == 1 and delta.cache_misses == 1
    assert delta.warm_sweeps_saved == warm_delta["warm_sweeps_saved"] > 0
    seq = msc_sequential(torch.from_numpy(near), cfg, device="cpu")
    for j in range(3):
        assert warm[j].power_iters_run <= cold[j].power_iters_run
        assert torch.equal(warm[j].mask, seq[j].mask)


def test_a_cache_leaves_the_cold_path_unchanged():
    t = _tensor(0, m=12, gamma=40.0)
    cfg = _cfg(epsilon=3e-4, power_tol=1e-2)
    plain = MSCContinuousEngine(cfg, slots=2, device="cpu").run([t])[0]
    cached = MSCContinuousEngine(cfg, slots=2, device="cpu",
                                 result_cache=MSCResultCache(),
                                 warm_start=True).run([t])[0]
    for j in range(3):
        assert torch.equal(plain[j].mask, cached[j].mask)
        assert torch.equal(plain[j].d, cached[j].d)
        assert plain[j].power_iters_run == cached[j].power_iters_run
    _held(plain, _reference()[0])
