"""The port's autotuner and "auto" config, held to the reference's on the
CPU.

- Units against `repro.core.autotune` (`tests/test_autotune.py`'s
  cases): keys equal to the reference's under a fixed salt, block
  candidates, `search_blocks` (payloads of candidates that can no longer
  win are dropped during the search), the cache's counters, persistence
  (a reload searches nothing; the reference reads the port's step),
  stale salts and the GC of an `autotune/` subdirectory; and the port's
  own `route_candidates`.
- The continuous engine on one CPU device, on the reference's 6-request
  stream through 2 slots: the all-auto engine (`epilogue="auto"`,
  `chunks_per_step="auto"`, `autotune=True`) gives the default engine's
  and the reference's all-auto engine's masks and `power_iters_run`
  (d within 3e-5 of the largest reference entry), with every
  `ServeStats` counter equal to the reference's (searches and hits per
  bucket among them); a reloaded cache searches nothing; a checkpoint of
  the autotuned engine is restored by the reference's engine; the static
  engine and the flat and batched builders resolve "auto" per shape.
- Over ranks: one spawn of a (2, 2) gloo mesh (join timeout) runs the
  all-auto engine (on q = 2 the models propose `inner_overlap`) against
  the reference's on 4 forced devices, run in a subprocess meanwhile.
"""
import dataclasses
import functools
import json
import os
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MSCConfig  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serving import MSCContinuousEngine, MSCServeEngine  # noqa: E402
from repro_torch.serving.msc_engine import ServeStats  # noqa: E402

TOL = 3e-5
SPAWN_TIMEOUT = 150
# the reference's CONTINUOUS_PARITY stream (tests/test_msc_continuous.py)
STREAM = ((21, 70.0), (23, 30.0), ((18, 23, 15), (2, 3, 2), 60.0),
          (17, 90.0), (24, 40.0), (22, 35.0))
STATS = [f.name for f in dataclasses.fields(ServeStats)]


def _cfg(**kw):
    return MSCConfig(epsilon=3e-4, power_tol=1e-2, **kw)


def _auto_kw():
    return dict(chunks_per_step="auto")


@functools.cache
def _stream():
    import jax

    from repro.core import PlantedSpec, make_planted_tensor

    out = []
    for i, s in enumerate(STREAM):
        spec = (PlantedSpec.paper(*s) if len(s) == 2 else
                PlantedSpec(shape=s[0], cluster_sizes=s[1], gamma=s[2]))
        x = np.asarray(make_planted_tensor(jax.random.PRNGKey(i), spec),
                       np.float32)
        x.setflags(write=False)
        out.append(x)
    return tuple(out)


def _jmesh():
    import jax

    from repro.core import make_msc_mesh

    return make_msc_mesh("flat", devices=jax.devices()[:1])


def _jcfg(**kw):
    from repro.core import MSCConfig as JConfig

    return JConfig(**dataclasses.asdict(_cfg(**kw)))


def _host(results):
    return [[(np.asarray(r[j].mask), np.asarray(r[j].d),
              int(r[j].power_iters_run)) for j in range(3)] for r in results]


def _held(got, want, exact_d=False):
    for g, w in zip(got, want):
        for (gm, gd, gi), (wm, wd, wi) in zip(g, w):
            np.testing.assert_array_equal(gm, wm)
            assert gi == wi
            err = (np.abs(gd.astype(np.float64) - wd).max()
                   / max(np.abs(wd).max(), 1e-30))
            assert err == 0.0 if exact_d else err <= TOL, err


# ------------------------------------------------------------- units --

KEY_CFGS = {
    "base": {}, "blocks": dict(block_r=512, block_i=64),
    "epsilon": dict(epsilon=1e-3), "ring": dict(epilogue="ring"),
    "kernels": dict(use_kernels=True), "bf16": dict(precision="bf16_fp32"),
}


@pytest.mark.parametrize("name", sorted(KEY_CFGS))
def test_keys_are_the_references(name):
    from repro.core import autotune as jat

    mesh = (("slice", 8), ("inner", 1))
    kw = dict(dict(epsilon=3e-4), **KEY_CFGS[name])
    for sig, m, salt in (((24, 24, 24, 8), mesh, "s1"),
                         ((24, 24, 16, 4), (("slice", 4), ("inner", 2)),
                          "s2")):
        got = at.autotune_key(sig, m, "float32", MSCConfig(**kw), salt=salt)
        want = jat.autotune_key(sig, m, "float32", _jcfg_raw(**kw),
                                salt=salt)
        assert got == want
    base = at.autotune_key((24, 24, 24, 8), mesh, "float32",
                           MSCConfig(epsilon=3e-4), salt="s1")
    mine = at.autotune_key((24, 24, 24, 8), mesh, "float32",
                           MSCConfig(**kw), salt="s1")
    # block knobs do not fragment the key space; numerics do
    assert (mine == base) == (name in ("base", "blocks"))


def _jcfg_raw(**kw):
    from repro.core import MSCConfig as JConfig

    return JConfig(**kw)


def test_block_candidates_are_the_references():
    from repro.core import autotune as jat

    assert at.DEFAULT_BLOCKS == jat.DEFAULT_BLOCKS
    assert (at.DEFAULT_MARGIN, at.VALIDATE_MARGIN, at.AUTOTUNE_KIND) == (
        jat.DEFAULT_MARGIN, jat.VALIDATE_MARGIN, jat.AUTOTUNE_KIND)
    for bucket in ((96, 96, 96), (512, 512, 512), (8, 8, 8), (200, 16, 300)):
        for k in (False, True):
            assert at.block_candidates(bucket, k) == \
                jat.block_candidates(bucket, k)
    assert len(at.block_candidates((512, 512, 512), True)) == 5


def test_route_candidates_cover_the_kernels_routes():
    blocks = dict(at.DEFAULT_BLOCKS)
    assert at.route_candidates((200, 200, 200), torch.float32, False) == [
        dict(blocks, power_route=None)]
    fp32 = at.route_candidates((200, 200, 200), torch.float32, True)
    assert [c["power_route"] for c in fp32] == [
        ("direct",) * 3, ("general",) * 3, ("ring",) * 3]
    assert all({k: c[k] for k in blocks} == blocks for c in fp32)
    bf16 = at.route_candidates((200, 200, 200), torch.bfloat16, True)
    assert bf16[0]["power_route"] == ("ring",) * 3 and len(bf16) == 3
    # rows not a multiple of 16 bytes take the general route only
    assert [c["power_route"] for c in
            at.route_candidates((8, 6, 6), torch.float32, True)] == [
        ("general",) * 3]
    # c = 2100 > MAX_COLS on modes 1 and 2: only mode 3 has a choice
    mixed = [c["power_route"] for c in
             at.route_candidates((16, 200, 2100), torch.float32, True)]
    assert mixed == [("general", "general", "direct"),
                     ("general", "general", "general"),
                     ("general", "general", "ring")]


def test_route_candidates_offer_the_resident_route_for_chunks():
    """With a gate chunk of several sweeps per launch the resident route
    is a candidate on every mode whose rows stream, and the pick where
    `power_iter.route` takes it (fp32 at these shapes; bf16 streams)."""
    blocks = dict(at.DEFAULT_BLOCKS)
    fp32 = at.route_candidates((200, 200, 200), torch.float32, True, 6)
    assert [c["power_route"] for c in fp32] == [
        ("resident",) * 3, ("general",) * 3, ("ring",) * 3,
        ("direct",) * 3]
    assert all({k: c[k] for k in blocks} == blocks for c in fp32)
    bf16 = at.route_candidates((200, 200, 200), torch.bfloat16, True, 8)
    assert [c["power_route"] for c in bf16] == [
        ("ring",) * 3, ("general",) * 3, ("direct",) * 3,
        ("resident",) * 3]
    # one pass a launch (an inner dim's power_matvec): never resident
    assert at.route_candidates((200, 200, 200), torch.float32, True, 1) \
        == at.route_candidates((200, 200, 200), torch.float32, True)
    # c = 2100 > MAX_COLS on modes 1 and 2: only mode 3 has a choice
    mixed = [c["power_route"] for c in
             at.route_candidates((16, 200, 2100), torch.float32, True, 6)]
    assert mixed == [("general", "general", "resident"),
                     ("general", "general", "general"),
                     ("general", "general", "ring"),
                     ("general", "general", "direct")]
    assert at.route_candidates((200, 200, 200), torch.float32, False, 6) == [
        dict(blocks, power_route=None)]


class _Payload:
    pass


SEARCH_CASES = {
    "fastest": ({256: 3.0, 128: 1.0, 512: 2.0}, 0.05, 128),
    "default_near_tie": ({256: 1.04, 128: 1.0, 512: 2.0}, 0.05, 256),
    "default_outside_margin": ({256: 1.2, 128: 1.0, 512: 2.0}, 0.1, 128),
    "last_wins": ({256: 3.0, 128: 2.0, 512: 1.0}, 0.05, 512),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_blocks_is_the_references(case):
    from repro.core import autotune as jat

    times, margin, want = SEARCH_CASES[case]
    cands = [{"block_r": 256}, {"block_r": 128}, {"block_r": 512}]
    alive = []

    def measure(c):
        # never more than two earlier payloads held while a candidate is
        # measured: the default and the best other one so far
        assert sum(r() is not None for r in alive) <= 2
        p = _Payload()
        alive.append(weakref.ref(p))
        return times[c["block_r"]], p

    win, payload, timings = at.search_blocks(cands, measure, margin=margin)
    jwin, _, jtimings = jat.search_blocks(
        cands, lambda c: (times[c["block_r"]], None), margin=margin)
    assert win == jwin == {"block_r": want} and timings == jtimings
    assert payload is alive[[c["block_r"] for c in cands].index(want)]()
    assert sum(r() is not None for r in alive) == 1  # only the winner's
    with pytest.raises(ValueError):
        at.search_blocks([], measure)


def _resolve(cache, key="k1", times=(2.0, 1.0)):
    cands = [{"block_r": 256, "block_i": 128, "block_j": 128},
             {"block_r": 128, "block_i": 128, "block_j": 128}]
    t = dict(zip((256, 128), times))
    return cache.resolve(key, cands, lambda c: (t[c["block_r"]], "live"))


def test_cache_search_then_hit_counters():
    ac = at.AutotuneCache(salt="s1")
    blocks, payload = _resolve(ac)
    assert blocks["block_r"] == 128 and payload == "live"
    assert (ac.searches, ac.hits) == (1, 0)
    blocks2, payload2 = _resolve(ac)
    assert blocks2["block_r"] == 128 and payload2 is None
    assert (ac.searches, ac.hits, len(ac), "k1" in ac) == (1, 1, 1, True)


def test_cache_round_trip_and_the_reference_reads_it(tmp_path):
    from repro.core import autotune as jat

    d = str(tmp_path / "autotune")
    ac = at.AutotuneCache(persist_dir=d, salt="s1")
    _resolve(ac)
    assert ac.persist() is not None
    ac2 = at.AutotuneCache(persist_dir=d, salt="s1")
    assert len(ac2) == 1 and ac2.entries() == ac.entries()
    blocks, payload = _resolve(ac2)
    assert blocks["block_r"] == 128 and payload is None
    assert (ac2.searches, ac2.hits) == (0, 1)
    # one store format: the reference's cache reads the port's step
    jac = jat.AutotuneCache(persist_dir=d, salt="s1")
    assert jac.entries() == ac.entries()


def test_cache_stale_salt_unreadable_dir_and_gc(tmp_path):
    from repro_torch.checkpoint.store import (gc_checkpoints,
                                              restorable_steps,
                                              save_checkpoint)

    d = str(tmp_path / "autotune")
    ac = at.AutotuneCache(persist_dir=d, salt="s1")
    _resolve(ac)
    ac.persist()
    stale = at.AutotuneCache(persist_dir=d, salt="s2")
    assert len(stale) == 0
    _resolve(stale)
    stale.persist()
    assert len(at.AutotuneCache(persist_dir=d, salt="s2")) == 1
    assert len(at.AutotuneCache(persist_dir=d, salt="s1")) == 0
    junk = tmp_path / "junk"
    junk.mkdir()
    (junk / "garbage.json").write_text("not a ckpt")
    assert len(at.AutotuneCache(persist_dir=str(junk))) == 0
    parent, sub = str(tmp_path / "ckpt"), str(tmp_path / "ckpt" / "autotune")
    for step in (1, 2, 3):
        save_checkpoint(parent, step, [], extra={"kind": "engine"})
        save_checkpoint(sub, step, [], extra={"kind": at.AUTOTUNE_KIND,
                                              "salt": "s", "entries": {}})
    gc_checkpoints(parent, 2)
    assert restorable_steps(parent, verify_sha=False) == [3, 2]
    assert restorable_steps(sub, verify_sha=False) == [3]


# ------------------------------------------------ one CPU device -----

@functools.cache
def _reference_auto(tmp):
    """The reference's all-auto engine over the stream (a persisted
    autotune cache under `tmp`), then a second engine reloading it."""
    from repro.core.autotune import AutotuneCache as JCache
    from repro.serving import MSCContinuousEngine as JEngine

    import jax.numpy as jnp

    xs = [jnp.asarray(x) for x in _stream()]
    out = []
    for _ in range(2):
        eng = JEngine(_jmesh(), _jcfg(epilogue="auto"), slots=2,
                      autotune_cache=JCache(persist_dir=tmp), **_auto_kw())
        res = _host(eng.run(xs))
        out.append((res, dataclasses.asdict(eng.stats)))
    return out


def _auto_engine(tmp, **kw):
    return MSCContinuousEngine(
        _cfg(epilogue="auto"), slots=2, device="cpu",
        autotune_cache=at.AutotuneCache(persist_dir=tmp), **_auto_kw(), **kw)


def test_all_auto_engine_matches_default_and_reference(tmp_path):
    """Cold then reloaded: masks and sweeps of the default engine, the
    reference's results and every counter; the reload searches nothing
    and hits once per bucket."""
    (ref, ref_stats), (ref2, ref2_stats) = _reference_auto(
        str(tmp_path / "ref"))
    default = _host(MSCContinuousEngine(_cfg(), slots=2, device="cpu").run(
        list(_stream())))
    eng = _auto_engine(str(tmp_path / "port"))
    got = _host(eng.run(list(_stream())))
    _held(got, default, exact_d=True)
    _held(got, ref)
    assert {k: dataclasses.asdict(eng.stats)[k] for k in STATS} == \
        {k: ref_stats[k] for k in STATS}
    assert eng.stats.autotune_searches == 2  # one per bucket
    assert eng.graphs == 0 and eng.autotune_cache.searches == 2
    assert sorted(os.listdir(tmp_path / "port")) == ["step_00000002"]
    again = _auto_engine(str(tmp_path / "port"))
    _held(_host(again.run(list(_stream()))), default, exact_d=True)
    assert (again.stats.autotune_searches, again.stats.autotune_cache_hits) \
        == (0, 2)
    assert {k: dataclasses.asdict(again.stats)[k] for k in STATS} == \
        {k: ref2_stats[k] for k in STATS}
    # warm: neither a search nor a build
    before = again.stats
    again.run(list(_stream()))
    warm = again.stats.delta(before)
    assert (warm.compiles, warm.autotune_searches,
            warm.autotune_cache_hits) == (0, 0, 0)


def test_autotuned_checkpoint_restores_in_both(tmp_path):
    """A mid-solve checkpoint of the autotuned engine (its cache under
    `<checkpoint_dir>/autotune`): the reference's engine restores it and
    serves what the port serves uninterrupted; the port's restore hits
    the persisted winners (no search)."""
    from repro.serving import MSCContinuousEngine as JEngine

    want = _host(MSCContinuousEngine(_cfg(), slots=2, device="cpu").run(
        list(_stream())))
    eng = MSCContinuousEngine(_cfg(epilogue="auto"), slots=2, device="cpu",
                              autotune=True, checkpoint_dir=str(tmp_path),
                              ckpt_every_chunks=0, **_auto_kw())
    assert eng.autotune_cache.persist_dir == str(tmp_path / "autotune")
    rids = [eng.submit(x) for x in _stream()]
    got = {}
    for _ in range(3):
        got.update(eng.step())
    eng.checkpoint()
    searches = eng.stats.autotune_searches
    port = MSCContinuousEngine.restore(str(tmp_path), device="cpu")
    assert (port.stats.autotune_searches,
            port.stats.autotune_cache_hits) == (searches, searches)
    pgot = dict(got)
    while port.has_work():
        pgot.update(port.step())
    _held(_host([pgot[r] for r in rids]), want, exact_d=True)
    # the reference's cache drops the port's winners (another salt) and
    # searches anew
    jeng = JEngine.restore(str(tmp_path), mesh=_jmesh())
    assert jeng._autotune and jeng._chunks_param == "auto"
    jgot = dict(got)
    while jeng.has_work():
        jgot.update(jeng.step())
    _held(_host([jgot[r] for r in rids]), want)


def test_static_engine_and_builders_resolve_auto_per_shape():
    """relayout="auto" and epilogue="auto" on one device resolve to the
    reference's picks (gspmd, allgather) per bucket and serve the default
    engine's bits; the flat and batched builders likewise."""
    from repro.core.parallel import _resolve_auto as jresolve
    from repro_torch.core import build_msc_parallel_flat
    from repro_torch.core.parallel import _resolve_auto, build_msc_batched

    xs = list(_stream())[:3]
    cfg = MSCConfig(epsilon=3e-4)
    auto = MSCServeEngine(cfg.with_(epilogue="auto"), max_batch=2,
                          device="cpu", relayout="auto")
    plain = MSCServeEngine(cfg, max_batch=2, device="cpu")
    _held(_host(auto.run(xs)), _host(plain.run(xs)), exact_d=True)
    assert auto.stats == plain.stats
    for shape in ((24, 24, 24), (24, 24, 16)):
        rcfg, rlay = _resolve_auto(cfg.with_(epilogue="auto"), shape, "auto",
                                   device="cpu", B=2)
        jcfg, jlay = jresolve(_jmesh(), _jcfg_raw(epsilon=3e-4,
                                                  epilogue="auto"), shape,
                              "auto", None, None, B=2)
        assert (rcfg.epilogue, rlay) == (jcfg.epilogue, jlay)
    flat = build_msc_parallel_flat(cfg.with_(epilogue="auto"),
                                   relayout="auto", device="cpu")
    one = build_msc_parallel_flat(cfg, device="cpu")
    x = torch.from_numpy(np.array(xs[0]))
    _held(_host([flat(x)]), _host([one(x)]), exact_d=True)
    batch = torch.zeros((2, 24, 24, 24))
    batch[0, :21, :21, :21] = x
    dims = torch.tensor([[21, 21, 21], [1, 1, 1]], dtype=torch.int32)
    a = build_msc_batched(cfg, relayout="auto", device="cpu")(batch, dims)
    b = build_msc_batched(cfg, device="cpu")(batch, dims)
    for j in range(3):
        assert torch.equal(a[j].mask, b[j].mask)
        assert torch.equal(a[j].power_iters_run, b[j].power_iters_run)


# ------------------------------------------------------ over ranks ---

def _rank_worker(device, in_path, out_dir):
    """One rank of the (2, 2) mesh: the all-auto autotuned engine over the
    stream; its results and counters to a file."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    inputs = dict(np.load(in_path))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("slice", "inner"))
    eng = MSCContinuousEngine(_cfg(epilogue="auto"), slots=2, device="cpu",
                              mesh=mesh, autotune=True, **_auto_kw())
    res = _host(eng.run([inputs[f"x{i}"] for i in range(len(STREAM))]))
    out = {"stats": json.dumps(dataclasses.asdict(eng.stats)),
           "entries": json.dumps(eng.autotune_cache.entries(),
                                 sort_keys=True, default=str)}
    for i, r in enumerate(res):
        for j, (m, d, it) in enumerate(r):
            out[f"{i}/{j}/mask"], out[f"{i}/{j}/d"] = m, d
            out[f"{i}/{j}/iters"] = np.asarray(it)
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)


REFERENCE = r"""
import dataclasses, json
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import MSCConfig
from repro.core.autotune import AutotuneCache
from repro.serving import MSCContinuousEngine
inputs = dict(np.load({in_path!r}))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("slice", "inner"))
eng = MSCContinuousEngine(mesh, MSCConfig(epsilon=3e-4, power_tol=1e-2,
                                          epilogue="auto"), slots=2,
                          chunks_per_step="auto",
                          autotune_cache=AutotuneCache())
res = eng.run([inputs["x%d" % i] for i in range({n})])
out = {{"stats": json.dumps(dataclasses.asdict(eng.stats))}}
for i, r in enumerate(res):
    for j in range(3):
        out["%d/%d/mask" % (i, j)] = np.asarray(r[j].mask)
        out["%d/%d/d" % (i, j)] = np.asarray(r[j].d)
        out["%d/%d/iters" % (i, j)] = np.asarray(int(r[j].power_iters_run))
proposed = [e for e in eng.autotune_cache.entries().values()
            if e["inner_overlap"]]
out["proposed"] = np.asarray(len(proposed))
np.savez({out_path!r}, **out)
print("OK")
"""


def _unpack(d):
    return [[(d[f"{i}/{j}/mask"], d[f"{i}/{j}/d"], int(d[f"{i}/{j}/iters"]))
             for j in range(3)] for i in range(len(STREAM))]


def test_all_auto_engine_over_2x2_gloo_ranks(tmp_path, subproc):
    """Every rank: the reference's masks and sweeps (d within 3e-5), every
    counter equal to the reference's (2 x candidates compiles per search,
    the inner_overlap proposal validated on q = 2), and the same winners
    on every rank."""
    in_path = str(tmp_path / "inputs.npz")
    np.savez(in_path, **{f"x{i}": x for i, x in enumerate(_stream())})
    ref_path = str(tmp_path / "reference.npz")
    err = []

    def reference():
        try:
            subproc(REFERENCE.format(in_path=in_path, out_path=ref_path,
                                     n=len(STREAM)), 4, timeout=300)
        except BaseException as e:  # noqa: BLE001 - raised below
            err.append(e)

    thread = threading.Thread(target=reference, daemon=True)
    thread.start()
    out = tmp_path / "ranks"
    out.mkdir()
    tmesh.spawn(_rank_worker, 4, out / "store", in_path, str(out),
                device_type="cpu",
                timeout=tmesh.datetime.timedelta(seconds=120),
                join_timeout=SPAWN_TIMEOUT)
    thread.join(320)
    assert not thread.is_alive(), "the reference did not end"
    if err:
        raise err[0]
    ref = dict(np.load(ref_path))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    want = json.loads(str(ref["stats"]))
    assert int(ref["proposed"]) >= 0
    for r in ranks:
        _held(_unpack(r), _unpack(ref))
        got = json.loads(str(r["stats"]))
        assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}
        assert str(r["entries"]) == str(ranks[0]["entries"])
    entries = json.loads(str(ranks[0]["entries"]))
    assert len(entries) == want["autotune_searches"] > 0
    # the inner_overlap proposal was put up and measured on q = 2
    assert all(len(e["timings"]) == 2 and e["searched"]
               for e in entries.values())
