"""The port's SLO scheduler, on the CPU, against the reference's
(`tests/test_msc_scheduler.py`'s cases).

Held here:
- the policy's pure functions: `roofline.expected_queue_wait` and
  `power_iter.predict_remaining_sweeps` equal the reference's over a
  seeded grid;
- the per-class queues of `_SlotTable`: `pop_best`'s urgent-first
  order, aging overtake, FIFO within a class and the tie to the more
  urgent class, and the same pops as the reference's table on seeded
  random queues; the per-class starvation bound;
- the engine's policy: submit validation, shedding before any solve,
  deadline misses (advisory), idle-bucket ticks (0 at refill_min_free 1,
  counted under refill batching);
- preempt-to-host on the reference's two-class schedule (near-noise
  class-1 residents, a seeded cap-runner histogram, fast class-0
  arrivals): every request's masks, sweeps and d are bit-identical to
  the same schedule without preemption, masks and sweeps equal the
  reference engine's (d within 3e-5 of the largest reference entry), and
  every `ServeStats` counter (preemptions, resumes, deadline misses, SLO
  sheds, idle-bucket ticks, the waits' p50 / p99 …) equals the reference
  engine's on the same tick schedule; a warm-started victim saves the
  same sweeps as when it is not preempted;
- `bucket_policy="all"` against `"weighted"` on a two-bucket mix: the
  same results, and each policy's counters equal the reference's.
The reference engine runs on a one-device mesh, einsum path.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import make_msc_mesh  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.core.power_iter import \
    predict_remaining_sweeps as jpredict  # noqa: E402
from repro.roofline import expected_queue_wait as jwait  # noqa: E402
from repro.serving import MSCContinuousEngine as JEngine  # noqa: E402
from repro.serving import MSCResultCache as JCache  # noqa: E402
from repro.serving.msc_engine import _SlotTable as JTable  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.power_iter import predict_remaining_sweeps  # noqa: E402
from repro_torch.roofline import expected_queue_wait  # noqa: E402
from repro_torch.serving import (LoadShedError,  # noqa: E402
                                 MSCContinuousEngine, MSCResultCache)
from repro_torch.serving.msc_engine import _SlotTable  # noqa: E402

TOL = 3e-5
# a cap-runner histogram: every resident slot predicts a long tail, so a
# strictly more urgent waiter preempts deterministically
FORCED_TAIL = (60, 60, 54, 48)


def _planted(seed, m, gamma):
    x = np.asarray(jplanted(jax.random.PRNGKey(seed), JSpec.paper(m, gamma)),
                   np.float32)
    x.setflags(write=False)
    return x


def _jcfg():
    return JConfig(epsilon=3e-4, power_tol=1e-2)


def _cfg():
    return bridge.config_from_fields(dataclasses.asdict(_jcfg()))


def _mesh():
    return make_msc_mesh("flat", devices=jax.devices()[:1])


def _engine(**kw):
    return MSCContinuousEngine(_cfg(), device="cpu", **kw)


def _jengine(**kw):
    return JEngine(_mesh(), _jcfg(), **kw)


def _host(res):
    return [(np.asarray(res[j].mask), np.asarray(res[j].d),
             int(res[j].power_iters_run)) for j in range(3)]


def _held(got, want, exact=False):
    for j in range(3):
        mask, d, sweeps = want[j]
        np.testing.assert_array_equal(np.asarray(got[j].mask), mask)
        assert int(got[j].power_iters_run) == sweeps, j
        gd = np.asarray(got[j].d, np.float64)
        if exact:
            np.testing.assert_array_equal(gd, d)
        else:
            assert np.abs(gd - d).max() <= TOL * max(np.abs(d).max(), 1e-30)


# ------------------------------------------------- the pure functions --

def test_expected_queue_wait_is_the_references():
    rng = np.random.RandomState(0)
    for _ in range(200):
        ahead, free = rng.randint(0, 12), rng.randint(0, 6)
        B, per = rng.randint(1, 9), float(rng.choice([0.5, 1.0, 4.0, 7.5]))
        assert expected_queue_wait(ahead, free, B, per) == \
            jwait(ahead, free, B, per)
    assert expected_queue_wait(3, 0, 2, 6.0) == pytest.approx(12.0)
    assert expected_queue_wait(2, 3, 8, 4.0) == 0.0
    with pytest.raises(ValueError, match="B"):
        expected_queue_wait(1, 0, 0, 4.0)


def test_predict_remaining_sweeps_is_the_references():
    rng = np.random.RandomState(1)
    for _ in range(200):
        hist = list(rng.choice([6, 12, 18, 48, 54, 60],
                               size=rng.randint(0, 9)))
        cur, k = int(rng.randint(0, 66)), int(rng.choice([1, 6, 8]))
        assert predict_remaining_sweeps(hist, cur, cap=60, check_every=k) \
            == jpredict(hist, cur, cap=60, check_every=k)


# ------------------------------------------------ per-class queues ----

def _tables():
    jeng = _jengine()
    jtb = JTable((16, 16, 16), None, None, 4, np.float32,
                 jeng._plan.mode_shapes((16, 16, 16), 4))
    return _SlotTable((16, 16, 16), 4, None), jtb


@pytest.mark.parametrize("entries,tick,want", [
    # urgent class first: eff(0) = -2/16 beats eff(1) = 1 - 12/16
    ([(1, (11, 0, -1)), (0, (22, 10, -1))], 12, [22, 11]),
    # aging overtake: eff(1) = 1 - 30/16 beats eff(0) = -2/16
    ([(1, (11, 0, -1)), (0, (22, 28, -1))], 30, [11, 22]),
    # submitted aging_chunks apart: an exact tie goes to the urgent class
    ([(1, (11, 0, -1)), (0, (22, 16, -1))], 40, [22, 11]),
    # FIFO within a class
    ([(0, (1, 0, -1)), (0, (2, 0, -1))], 5, [1, 2]),
])
def test_pop_best_order(entries, tick, want):
    tb, _ = _tables()
    for pr, e in entries:
        tb.queue_for(pr).append(e)
    assert [tb.pop_best(tick, 16)[1] for _ in want] == want
    assert tb.pop_best(tick, 16) is None


def test_pop_best_pops_as_the_references_table():
    rng = np.random.RandomState(2)
    for _ in range(20):
        tb, jtb = _tables()
        for rid in range(rng.randint(1, 12)):
            pr, sub = int(rng.randint(0, 3)), int(rng.randint(0, 40))
            dl = int(rng.choice([-1, 50]))
            tb.queue_for(pr).append((rid, sub, dl))
            jtb.queue_for(pr).append((rid, sub, dl))
        assert tb.queued() == jtb.queued() and tb.queue_len() == \
            jtb.queue_len()
        aging = int(rng.choice([1, 4, 16]))
        tick = int(rng.randint(40, 80))
        while True:
            got, want = tb.pop_best(tick, aging), jtb.pop_best(tick, aging)
            assert got == want
            if got is None:
                break
            tick += 1


def test_starvation_bound_is_per_class():
    eng = _engine(slots=4, refill_min_free=4, max_queue_chunks=4)
    tb, _ = _tables()
    tb.slot_req = [1, 2, 3, None]
    eng._tick = 10
    tb.queue_for(0).append((7, 9, -1))      # waited 1 tick: no
    assert not eng._should_admit(tb, 1)
    tb.queue_for(3).append((8, 6, -1))      # class 3 waited 4: yes
    assert eng._should_admit(tb, 1)


def test_low_class_served_behind_a_stream_despite_batching():
    ts = [_planted(i, 14, g)
          for i, g in enumerate((30.0, 70.0, 90.0, 40.0, 60.0))]
    kw = dict(slots=2, refill_min_free=2, max_queue_chunks=2, aging_chunks=4)
    eng, jeng = _engine(**kw), _jengine(**kw)
    outs = eng.run(ts, priorities=[1, 0, 0, 0, 0])
    jouts = jeng.run(ts, priorities=[1, 0, 0, 0, 0])
    for o, jo in zip(outs, jouts):
        _held(o, _host(jo))
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    assert eng.stats.evictions == 5


# ------------------------------------------------------ engine policy --

def test_submit_validates_its_arguments():
    eng = _engine()
    t = _planted(0, 14, 70.0)
    with pytest.raises(ValueError, match="priority"):
        eng.submit(t, priority=-1)
    with pytest.raises(ValueError, match="deadline_chunks"):
        eng.submit(t, deadline_chunks=0)
    with pytest.raises(ValueError, match="bucket_policy"):
        _engine(bucket_policy="round-robin")


def test_slo_shed_before_solving():
    eng = _engine(slots=1, slo_chunks=0)
    ts = [_planted(i, 14, 70.0) for i in range(2)]
    rid = eng.submit(ts[0])
    with pytest.raises(LoadShedError, match="SLO"):
        eng.submit(ts[1])
    s = eng.stats
    assert (s.slo_sheds, s.shed_requests, s.dispatches) == (1, 1, 0)
    got = {}
    while eng.has_work():
        got.update(eng.step())
    assert rid in got


@pytest.mark.parametrize("gamma,deadline,misses", [(70.0, 1, 1),
                                                   (90.0, 512, 0)])
def test_deadline_misses_are_counted_and_advisory(gamma, deadline, misses):
    eng = _engine(slots=1)
    (res,) = eng.run([_planted(0, 14, gamma)], deadline_chunks=[deadline])
    assert res is not None and eng.stats.deadline_misses == misses


def test_idle_bucket_ticks():
    ts = [_planted(i, 14, g) for i, g in enumerate((30.0, 70.0, 90.0, 40.0))]
    eng = _engine(slots=2)  # refill_min_free 1 admits at every free slot
    eng.run(ts)
    assert eng.stats.idle_bucket_ticks == 0
    # a half-empty table stepping past its queue (refill batching)
    kw = dict(slots=2, refill_min_free=2, max_queue_chunks=64, preempt=False)
    stats = []
    for e in (_engine(**kw), _jengine(**kw)):
        e.submit(_planted(0, 14, 2.0))
        e.step()
        e.submit(_planted(1, 14, 90.0))
        while e.has_work():
            e.step()
        stats.append(dataclasses.asdict(e.stats))
    assert stats[0]["idle_bucket_ticks"] > 0
    assert stats[0] == stats[1]


# ---------------------------------------------------- preempt-to-host --

def _preempt_tensors():
    specs = [(14, 2.0), (14, 2.0), (14, 150.0), (14, 150.0)]
    return [_planted(40 + i, m, g) for i, (m, g) in enumerate(specs)]


def _drive(eng, tensors):
    """Slow class-1 pair resident, a cap-runner histogram, then the fast
    class-0 pair: the reference test's preempt→resume schedule, with a
    deadline on every request.  Returns ({input index: result}, stats)."""
    rids = {eng.submit(tensors[i], priority=1, deadline_chunks=12): i
            for i in range(2)}
    got = {}
    for _ in range(3):
        got.update(eng.step())
    eng._sweep_hist.extend(FORCED_TAIL)
    rids.update({eng.submit(tensors[i], priority=0, deadline_chunks=4): i
                 for i in (2, 3)})
    while eng.has_work():
        got.update(eng.step())
    return {i: got[r] for r, i in rids.items()}, eng.stats


@functools.cache
def _reference_preempt():
    res, stats = _drive(_jengine(slots=2, preempt_min_remaining_chunks=1),
                        _preempt_tensors())
    return {i: _host(r) for i, r in res.items()}, dataclasses.asdict(stats)


def test_preempt_resume_is_bit_identical_and_counts_as_the_reference():
    tensors = _preempt_tensors()
    ref, ref_stats = _reference_preempt()
    got, stats = _drive(_engine(slots=2, preempt_min_remaining_chunks=1),
                        tensors)
    plain, _ = _drive(_engine(slots=2, preempt=False), tensors)
    assert stats.preemptions >= 1 and stats.resumes == stats.preemptions
    assert stats.deadline_misses > 0
    for i in range(4):
        _held(got[i], _host(plain[i]), exact=True)
        _held(got[i], ref[i])
    assert dataclasses.asdict(stats) == ref_stats


def test_class_waits_split_the_wait_histogram():
    eng = _engine(slots=2, preempt_min_remaining_chunks=1)
    _drive(eng, _preempt_tensors())
    waits = eng.class_waits()
    assert set(waits) == {0, 1}
    assert sum(w["n"] for w in waits.values()) == len(eng._wait_hist)
    for w in waits.values():
        assert 0.0 <= w["p50"] <= w["p99"]


def _warm_victim(engine_cls, cache_cls, cfg, interfere, **mesh):
    donor = _planted(7, 14, 2.0)
    rng = np.random.RandomState(3)
    near = (donor + 0.2 * donor.std() * rng.standard_normal(
        donor.shape).astype(np.float32)).astype(np.float32)
    fast = _planted(8, 14, 150.0)
    eng = engine_cls(cfg=cfg, slots=1, preempt_min_remaining_chunks=1,
                     result_cache=cache_cls(max_bytes=64 << 20,
                                            sketch_tol=0.6),
                     warm_start=True, **mesh)
    eng.run([donor])
    base = eng.stats
    rid = eng.submit(near, priority=1)
    got = eng.step()
    if interfere:
        eng._sweep_hist.extend(FORCED_TAIL)
        eng.submit(fast, priority=0)
    while eng.has_work():
        got.update(eng.step())
    return got[rid], eng.stats.delta(base)


def test_preempted_warm_start_saves_the_same_sweeps():
    res_a, d_a = _warm_victim(MSCContinuousEngine, MSCResultCache, _cfg(),
                              False, device="cpu")
    res_b, d_b = _warm_victim(MSCContinuousEngine, MSCResultCache, _cfg(),
                              True, device="cpu")
    jres, jd = _warm_victim(JEngine, JCache, _jcfg(), True, mesh=_mesh())
    assert d_b.preemptions >= 1 and d_b.resumes >= 1
    assert d_a.warm_sweeps_saved == d_b.warm_sweeps_saved == \
        jd.warm_sweeps_saved > 0
    assert d_a.warm_starts == d_b.warm_starts == 1
    _held(res_b, _host(res_a), exact=True)
    _held(res_b, _host(jres))


# --------------------------------------------------- bucket policies --

@functools.cache
def _mixed():
    sizes = (14, 21, 15, 22, 16)
    return tuple(_planted(i, m, 70.0) for i, m in enumerate(sizes))


@functools.cache
def _reference_policy(policy):
    eng = _jengine(slots=2, bucket_policy=policy)
    out = eng.run(list(_mixed()), priorities=[0, 1, 0, 1, 0])
    return [_host(r) for r in out], dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("policy", ["weighted", "all"])
def test_bucket_policy_against_the_reference(policy):
    eng = _engine(slots=2, bucket_policy=policy)
    assert len({eng.bucket_of(t.shape) for t in _mixed()}) == 2
    out = eng.run(list(_mixed()), priorities=[0, 1, 0, 1, 0])
    ref, ref_stats = _reference_policy(policy)
    for o, r in zip(out, ref):
        _held(o, r)
    assert dataclasses.asdict(eng.stats) == ref_stats
    other = _engine(slots=2, bucket_policy="all" if policy == "weighted"
                    else "weighted").run(list(_mixed()),
                                         priorities=[0, 1, 0, 1, 0])
    for o, r in zip(out, other):  # results do not depend on the policy
        _held(o, _host(r), exact=True)
