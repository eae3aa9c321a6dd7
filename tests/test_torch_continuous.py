"""The continuous-batching engine of the port, on the CPU, against the
reference's.

On the CPU `MSCContinuousEngine` runs its two programs per bucket (the
chunk step and the refill) eagerly: the code a card captures as CUDA
graphs.  Held here:
- on the reference's 6-request stream (`tests/test_msc_continuous.py`'s
  CONTINUOUS_PARITY: queue longer than the 2 slots, skewed convergence,
  one non-cube request) in its three interleavings (order, placement,
  refill_min_free), both epilogues and both kernel settings (the port's
  kernels as their plain versions; the reference on its einsum path,
  on a 1-device mesh), the port's engine answers as the reference's
  does: masks and `power_iters_run` identical, d and λ within 3e-5 of
  the largest reference entry, and every `ServeStats` counter equal;
- per request, the continuous engine equals the port's static engine
  and `msc_sequential` (fp32); under bf16_fp32, requests admitted by a
  mid-stream refill answer as a fresh engine serving each alone (a
  compute-dtype copy of the blocks taken before the refill would not);
- `MSCChunkPlan`'s step and refill, from a state carried across, equal
  the reference plan's: carries, finished flags, finalized results;
- the engine's policy units, `msc_serve --continuous` and
  `simulate_continuous`'s arrivals (and per-class draws), each serving
  tier knob and the scheduler's submit arguments against the reference
  engine with the same knob (results and every counter), and the flags
  and arguments the engine refuses (multi-host outputs, bad knobs).
The engine's CUDA graphs are held on the card by
`tests/test_torch_graphs.py` (`pytest -m gpu`).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.core.parallel import MSCChunkPlan as JPlan  # noqa: E402
from repro.core.parallel import make_msc_mesh  # noqa: E402
from repro.launch import msc_serve as jserve  # noqa: E402
from repro.serving import MSCContinuousEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import MSCChunkPlan, MSCConfig, msc_sequential  # noqa: E402
from repro_torch.launch import msc_serve  # noqa: E402
from repro_torch.serving import (MSCContinuousEngine,  # noqa: E402
                                 MSCServeEngine)
from repro_torch.serving.msc_engine import _SlotTable  # noqa: E402

TOL = 3e-5
SPECS = (JSpec.paper(21, 70.0), JSpec.paper(23, 30.0),
         JSpec(shape=(18, 23, 15), cluster_sizes=(2, 3, 2), gamma=60.0),
         JSpec.paper(17, 90.0), JSpec.paper(24, 40.0), JSpec.paper(22, 35.0))
# (order, placement, refill_min_free): the reference test's three runs
RUNS = (([0, 1, 2, 3, 4, 5], "compact", 1), ([5, 4, 3, 2, 1, 0], "stable", 1),
        ([2, 0, 5, 1, 4, 3], "compact", 2))


def _planted(i, spec):
    x = np.array(jplanted(jax.random.PRNGKey(i), spec))
    x.setflags(write=False)
    return x


@functools.cache
def _stream():
    return tuple(_planted(i, s) for i, s in enumerate(SPECS))


def _jcfg(**kw):
    return JConfig(epsilon=3e-4, power_tol=1e-2, **kw)


def _cfg(**kw):
    return bridge.config_from_fields(dataclasses.asdict(_jcfg(**kw)))


def _mesh():
    return make_msc_mesh("flat", devices=jax.devices()[:1])


@functools.cache
def _reference(epilogue):
    """The reference engine over the three runs: per run, the results in
    that run's order and the cumulative stats after it."""
    eng = JEngine(_mesh(), _jcfg(epilogue=epilogue), slots=2)
    out = []
    for order, placement, rmf in RUNS:
        eng.placement, eng.refill_min_free = placement, rmf
        res = eng.run([jnp.asarray(_stream()[i]) for i in order])
        host = [[(np.asarray(r[j].mask), np.asarray(r[j].d),
                  np.asarray(r[j].lambdas), int(r[j].power_iters_run))
                 for j in range(3)] for r in res]
        out.append((host, dataclasses.asdict(eng.stats)))
    return out


def _close(got, want):
    want = np.asarray(want, np.float64)
    err = (np.abs(np.asarray(got, np.float64) - want).max()
           / max(np.abs(want).max(), 1e-30))
    assert err <= TOL, err


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
@pytest.mark.parametrize("epilogue", ["allgather", "ring"])
def test_engine_matches_reference_engine(epilogue, use_kernels):
    eng = MSCContinuousEngine(
        _cfg(epilogue=epilogue).with_(use_kernels=use_kernels), slots=2,
        device="cpu")
    for (order, placement, rmf), (ref, ref_stats) in zip(
            RUNS, _reference(epilogue)):
        eng.placement, eng.refill_min_free = placement, rmf
        out = eng.run([_stream()[i] for i in order])
        for pos, i in enumerate(order):
            for j in range(3):
                mask, d, lam, sweeps = ref[pos][j]
                got = out[pos][j]
                assert got.mask.shape == (_stream()[i].shape[j],)
                np.testing.assert_array_equal(
                    got.mask.numpy(), mask, err_msg=f"{order} {i} {j}")
                assert got.power_iters_run == sweeps, (order, i, j)
                _close(got.d.numpy(), d)
                _close(got.lambdas.numpy(), lam)
        assert dataclasses.asdict(eng.stats) == ref_stats
    s = eng.stats
    assert (s.compiles, s.evictions, s.requests) == (4, 18, 18), s


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
def test_engine_matches_static_engine_and_sequential(use_kernels):
    cfg = _cfg().with_(use_kernels=use_kernels)
    xs = list(_stream())
    cont = MSCContinuousEngine(cfg, slots=2, device="cpu").run(xs)
    static = MSCServeEngine(cfg, max_batch=2, device="cpu").run(xs)
    for i, x in enumerate(xs):
        seq = msc_sequential(bridge.tensor_from_numpy(x), cfg, device="cpu")
        for j in range(3):
            for want in (static[i][j], seq[j]):
                assert torch.equal(cont[i][j].mask, want.mask), (i, j)
                assert cont[i][j].power_iters_run == int(
                    want.power_iters_run), (i, j)
            torch.testing.assert_close(
                cont[i][j].d, static[i][j].d, rtol=0,
                atol=TOL * float(static[i][j].d.abs().max()))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
def test_bf16_refill_rewrites_the_operand_copy(use_kernels):
    """Four requests of one bucket through 2 slots: the last two are
    admitted by refills while others run.  Each must answer as a fresh
    engine serving it alone, and as the static engine (the same batched
    operands, B = 2) does."""
    cfg = _cfg(precision="bf16_fp32").with_(use_kernels=use_kernels)
    xs = [_planted(10 + i, JSpec.paper(m, g)) for i, (m, g) in
          enumerate(((20, 30.0), (22, 90.0), (21, 60.0), (19, 40.0)))]
    eng = MSCContinuousEngine(cfg, slots=2, device="cpu")
    got = eng.run(xs)
    assert eng.stats.refills >= 3 and len({eng.bucket_of(x.shape)
                                           for x in xs}) == 1
    for x, res in zip(xs, got):
        (alone,) = MSCContinuousEngine(cfg, slots=2, device="cpu").run([x])
        (static,) = MSCServeEngine(cfg, max_batch=2, device="cpu").run([x])
        for j in range(3):
            for want in (alone[j], static[j]):
                assert torch.equal(res[j].mask, want.mask), j
                assert res[j].power_iters_run == want.power_iters_run, j
                torch.testing.assert_close(
                    res[j].d, want.d, rtol=0,
                    atol=1e-2 * float(want.d.abs().max()))


# ---------------------------------------------------- the chunk plan --

def _ref_state(jplan, bucket, B, xs):
    """A reference slot table with xs admitted and stepped twice, as
    numpy: (blocks, carries as dicts, dims)."""
    zero = jnp.zeros((B,), bool)
    stage = jplan.rebuild_blocks(bucket, B, np.float32, xs)
    blocks, carries = jplan.init_state(bucket, B, np.float32)
    dims = np.array([x.shape for x in xs], np.int32)
    zres = jplan.zero_resume(bucket, B)
    blocks, carries, _ = jax.jit(jplan.build_refill())(
        blocks, carries, np.ones((B, 3), np.int32), stage, dims,
        np.ones(B, bool), np.zeros(B, bool), np.arange(B, dtype=np.int32),
        jplan.zero_warm(bucket, B), zero, *zres, zero)
    step = jax.jit(jplan.build_step())
    for _ in range(2):
        carries, _ = step(blocks, carries)
    return blocks, carries, dims


def _to_port(jcarries):
    return tuple(bridge.solve_state_from_numpy(
        c.v, c.lam, c.resid, np.asarray(c.iters)[:, 0],
        np.asarray(c.done)[:, 0]) for c in jcarries)


def _same_carries(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.iters.numpy(),
                                      np.asarray(r.iters)[:, 0])
        np.testing.assert_array_equal(p.done.numpy(), np.asarray(r.done)[:, 0])
        for name in ("v", "lam", "resid"):
            _close(getattr(p, name).numpy(), getattr(r, name))


@pytest.mark.parametrize("admission", ["cold", "warm", "resume"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["einsum", "kernels"])
def test_plan_step_and_refill_match_reference_plan(use_kernels, admission):
    bucket, B = (24, 24, 16), 2
    xs = [_planted(3, JSpec(shape=(18, 23, 15), cluster_sizes=(2, 3, 2),
                            gamma=60.0)),
          _planted(4, JSpec(shape=(20, 24, 16), cluster_sizes=(2, 2, 2),
                            gamma=6.0))]
    jplan = JPlan(_mesh(), _jcfg())
    plan = MSCChunkPlan(_cfg().with_(use_kernels=use_kernels), device="cpu")
    assert plan.mode_shapes(bucket, B) == jplan.mode_shapes(bucket, B)
    jblocks, jcarries, dims = _ref_state(jplan, bucket, B, xs)
    blocks = tuple(bridge.tensor_from_numpy(b) for b in jblocks)
    carries = _to_port(jcarries)
    _same_carries(carries, jcarries)

    jcarries, jfin = jax.jit(jplan.build_step())(jblocks, jcarries)
    carries, fin = plan.build_step()(blocks, carries)
    _same_carries(carries, jcarries)
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))

    # evict slot 0, move slot 1 to the front and admit a new request
    new = _planted(5, JSpec(shape=(24, 17, 9), cluster_sizes=(3, 2, 2),
                            gamma=50.0))
    nb = jplan.rebuild_blocks(bucket, B, np.float32, [None, new])
    new_dims = np.array([[1, 1, 1], new.shape], np.int32)
    take, new_done = np.array([False, True]), np.array([True, False])
    perm = np.array([1, 0], np.int32)
    # the new request's carry: cold, warm-started from given iterates, or
    # resumed from a given state (iterate taken verbatim)
    rng = np.random.RandomState(6)
    warm_v = tuple(rng.standard_normal(sh).astype(np.float32)
                   for sh in jplan.warm_shapes(bucket, B))
    res_lam = tuple(rng.standard_normal(sh).astype(np.float32)
                    for sh in jplan.resume_shapes(bucket, B))
    res_resid = tuple(np.abs(x) for x in res_lam)
    res_iters = np.array([[0, 0, 0], [16, 8, 24]], np.int32)
    res_done = np.array([[False] * 3, [False, True, False]])
    use = np.array([False, True])
    no = np.zeros(B, bool)
    inputs = {"cold": (tuple(np.zeros_like(w) for w in warm_v), no,
                       tuple(np.zeros_like(x) for x in res_lam),
                       tuple(np.zeros_like(x) for x in res_lam),
                       np.zeros((B, 3), np.int32), np.zeros((B, 3), bool),
                       no),
              "warm": (warm_v, use, *jplan.zero_resume(bucket, B), no),
              "resume": (warm_v, no, res_lam, res_resid, res_iters, res_done,
                         use)}[admission]
    jblocks, jcarries, jres = jax.jit(jplan.build_refill())(
        jblocks, jcarries, dims, nb, new_dims, take, new_done, perm,
        *inputs)
    port_inputs = [tuple(torch.from_numpy(np.array(x)) for x in a)
                   if isinstance(a, tuple) else np.asarray(a)
                   for a in inputs]
    blocks, carries, res = plan.build_refill()(
        blocks, carries, dims, tuple(bridge.tensor_from_numpy(b) for b in nb),
        new_dims, take, new_done, perm, *port_inputs)
    _same_carries(carries, jcarries)
    if admission == "resume":  # the iterate verbatim, not re-normalized
        for j, c in enumerate(carries):
            m = c.v.shape[1]
            np.testing.assert_array_equal(c.v[1].numpy(), warm_v[j][1, :m])
            assert int(c.iters[1]) == res_iters[1, j]
    for p, r in zip(blocks, jblocks):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for p, r in zip(res.modes, jres.modes):
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(r.mask))
        np.testing.assert_array_equal(np.asarray(p.power_iters_run),
                                      np.asarray(r.power_iters_run))
        _close(p.d.numpy(), r.d)
        _close(p.lambdas.numpy(), r.lambdas)


def test_plan_state_and_export_round_trip():
    bucket, B = (16, 24, 8), 3
    plan = MSCChunkPlan(_cfg(), device="cpu")
    jplan = JPlan(_mesh(), _jcfg())
    blocks, carries = plan.init_state(bucket, B, torch.float32)
    jblocks, jcarries = jplan.init_state(bucket, B, np.float32)
    for p, r in zip(blocks, jblocks):
        assert tuple(p.shape) == r.shape and not p.any()
    _same_carries(carries, jcarries)
    x = _planted(1, JSpec(shape=(13, 20, 7), cluster_sizes=(2, 2, 1),
                          gamma=40.0))
    for p, r in zip(plan.rebuild_blocks(bucket, B, torch.float32,
                                        [None, x, None]),
                    jplan.rebuild_blocks(bucket, B, np.float32,
                                         [None, x, None])):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    state = _to_port(_ref_state(jplan, bucket, 2, [x, x])[1])
    host = plan.export_carries(bucket, state)
    back = plan.import_carries(bucket, host)
    for a, b in zip(back, state):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    (m0, m1, m2) = plan.export_slot(bucket, state, 1)
    assert m0.v.shape == (16, 8) and m1.v.shape == (24, 8)
    assert m2.v.shape == (8, 24)
    assert m0.iters == int(state[0].iters[1]) and m0.done is bool(
        state[0].done[1])


# ------------------------------------------------------- engine units --

def _engine(**kw):
    return MSCContinuousEngine(_cfg(), device="cpu", **kw)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(slots=0), ValueError, "slots"),
    (dict(placement="shuffle"), ValueError, "placement"),
    (dict(bucket_policy="rr"), ValueError, "bucket_policy"),
    (dict(chunks_per_step=0), ValueError, "chunks_per_step"),
    (dict(bucket_quantum=0), ValueError, "bucket_quantum"),
])
def test_engine_rejects(kw, exc, match):
    with pytest.raises(exc, match=match):
        _engine(**kw)


def test_engine_takes_replicate_outputs():
    """The reference's flag for a mesh across processes: preemption
    forced off, and recorded in the plan."""
    eng = _engine(replicate_outputs=True, preempt=True)
    assert eng.preempt is False and eng._plan.replicate_outputs is True
    assert _engine().preempt is True


# the tier knobs the engine takes, as the reference's; a directory knob
# is given the test's temporary directory
TIER_KNOBS = {
    "preempt": dict(preempt=True, preempt_min_remaining_chunks=1),
    "slo_chunks": dict(slo_chunks=64),
    "bucket_policy_all": dict(bucket_policy="all"),
    "checkpoint_dir": dict(checkpoint_dir="{tmp}", ckpt_every_chunks=1),
    "warm_start": dict(warm_start=True),
}


def _knob(name, tmp, cache_cls):
    kw = {k: (v.format(tmp=tmp) if isinstance(v, str) and "{" in v else v)
          for k, v in TIER_KNOBS[name].items()}
    if name == "warm_start":
        kw["result_cache"] = cache_cls()
    return kw


@pytest.mark.parametrize("name", sorted(TIER_KNOBS))
def test_engine_tier_knob_serves_as_the_reference(name, tmp_path):
    """Each tier knob the port used to refuse: the stream's masks and
    sweeps as the reference engine's with the same knob (d within 3e-5
    of the largest reference entry), and every counter equal."""
    from repro.serving import MSCResultCache as JCache
    from repro_torch.serving import MSCResultCache

    xs = [_stream()[i] for i in (0, 3, 5)]
    jeng = JEngine(_mesh(), _jcfg(), slots=2,
                   **_knob(name, tmp_path / "ref", JCache))
    ref = jeng.run([jnp.asarray(x) for x in xs])
    eng = _engine(slots=2, **_knob(name, tmp_path / "port", MSCResultCache))
    got = eng.run(xs)
    for r, g in zip(ref, got):
        for j in range(3):
            np.testing.assert_array_equal(g[j].mask.numpy(),
                                          np.asarray(r[j].mask))
            assert g[j].power_iters_run == int(r[j].power_iters_run)
            _close(g[j].d.numpy(), r[j].d)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    if name == "checkpoint_dir":
        assert eng.stats.checkpoints_written > 0
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "ref"))


@pytest.mark.parametrize("cfg_kw,match", [
    (dict(power_tol=0.0), "power_tol"),
    (dict(matrix_free=False), "matrix_free"),
])
def test_engine_rejects_config(cfg_kw, match):
    with pytest.raises(ValueError, match=match):
        MSCContinuousEngine(_cfg().with_(**cfg_kw), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(priority=-1), "priority"),
    (dict(deadline_chunks=0), "deadline_chunks"),
])
def test_submit_rejects_the_schedulers_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(slots=2).submit(_stream()[0], **kw)


@pytest.mark.parametrize("kw", [dict(priority=1), dict(deadline_chunks=8)],
                         ids=["priority", "deadline_chunks"])
def test_submit_takes_the_schedulers_arguments(kw):
    """A priority class or a deadline per request, as the reference's
    engine takes them: the same results and counters on the stream."""
    xs = [_stream()[i] for i in (0, 3, 5)]
    jeng = JEngine(_mesh(), _jcfg(), slots=2)
    eng = _engine(slots=2)
    got = {}
    for e, wrap in ((jeng, jnp.asarray), (eng, lambda x: x)):
        rids = [e.submit(wrap(x), **(kw if i == 1 else {}))
                for i, x in enumerate(xs)]
        out = {}
        while e.has_work():
            out.update(e.step())
        got[e is eng] = [out[r] for r in rids]
    for r, g in zip(got[False], got[True]):
        for j in range(3):
            np.testing.assert_array_equal(g[j].mask.numpy(),
                                          np.asarray(r[j].mask))
            assert g[j].power_iters_run == int(r[j].power_iters_run)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)


def test_starvation_bound_admits_despite_refill_batching():
    eng = _engine(slots=2, refill_min_free=2, max_queue_chunks=2)
    xs = [_planted(i, JSpec.paper(14, g))
          for i, g in enumerate((30.0, 70.0, 90.0, 40.0))]
    assert all(o is not None for o in eng.run(xs))
    assert (eng.stats.evictions, eng.stats.requests) == (4, 4)
    jeng = JEngine(_mesh(), _jcfg(), slots=2, refill_min_free=2,
                   max_queue_chunks=2)
    jeng.run([jnp.asarray(x) for x in xs])
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)


def test_streaming_submit_step_api():
    eng = _engine(slots=2)
    rids = [eng.submit(_planted(i, JSpec.paper(14, 70.0))) for i in range(3)]
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert sorted(done) == sorted(rids)
    assert eng.stats.occupancy > 0


def test_results_in_input_order_across_buckets():
    sizes = (14, 33, 15, 21)
    eng = _engine(slots=2)
    outs = eng.run([_planted(i, JSpec.paper(m, 70.0))
                    for i, m in enumerate(sizes)])
    assert [res[0].mask.shape[0] for res in outs] == list(sizes)


def test_permutation_compact_vs_stable():
    eng = _engine(slots=4)
    tb = _SlotTable((8, 8, 8), 4, None)
    tb.slot_req = [None, 7, None, 9]
    assert list(eng._permutation(tb)) == [1, 3, 0, 2]
    eng.placement = "stable"
    assert list(eng._permutation(tb)) == [0, 1, 2, 3]


def test_distinct_buckets_compile_two_each_and_none_warm():
    eng = _engine(slots=2)
    xs = [_planted(i, JSpec.paper(m, 70.0))
          for i, m in enumerate((10, 14, 18, 22))]
    eng.run(xs)
    assert eng.stats.compiles == 4  # buckets 16³ and 24³, 2 programs each
    before = eng.stats
    eng.run(xs)
    delta = eng.stats.delta(before)
    assert delta.compiles == 0 and delta.refills > 0 and delta.chunk_steps > 0
    assert eng.graphs == 0  # nothing captured on the CPU
    eng.close()
    assert not eng.has_work() and eng.memory_reckoning() == (0, 0)


# ---------------------------------------------------- msc_serve CLI --

SMALL = ["--device", "cpu", "--sizes", "9,14", "--requests", "6",
         "--max-batch", "2", "--slow-every", "3", "--no-loop-compare"]


def test_msc_serve_continuous_prints_the_reference_lines(capsys):
    out = msc_serve.run(msc_serve.parse_args(
        SMALL + ["--continuous", "--arrival-rate", "1.5", "--slots", "2"]))
    text = capsys.readouterr().out
    for line in ("continuous decode loop: Poisson arrivals 1.5/tick, "
                 "slow-every=3", "streamed 6 results over", "  occupancy ",
                 "  scheduler: 0 preemptions", "  fault tolerance: ",
                 "  req 0: sweeps=", "  req 5: sweeps="):
        assert line in text, line
    cont = out["continuous"]
    assert sorted(cont["results"]) == list(range(6))
    assert cont["stats_stream"].compiles == 0
    assert cont["stats_stream"].evictions == 6
    for i, res in enumerate(out["results"]):  # as the static engine
        for j in range(3):
            assert torch.equal(cont["results"][i][j].mask, res[j].mask)
    out["engine"].close()
    cont["engine"].close()


@pytest.mark.parametrize("flag,exc,match", [
    (["--no-donate"], ValueError, "in place"),
    (["--chunks-per-step", "0"], ValueError, "chunks_per_step"),
])
def test_msc_serve_continuous_refuses(flag, exc, match):
    with pytest.raises(exc, match=match):
        msc_serve.main(SMALL + ["--continuous", *flag])


class _Recorder:
    """An engine that serves each request at the tick after it arrives
    and records the tick of every submit."""

    def __init__(self):
        self.ticks, self.submits, self.queued = 0, [], []

    def submit(self, tensor, priority=0, deadline_chunks=None):
        self.submits.append((self.ticks, priority, deadline_chunks))
        self.queued.append(len(self.submits) - 1)
        return len(self.submits) - 1

    def has_work(self):
        return bool(self.queued)

    def step(self):
        self.ticks += 1
        done = {rid: rid for rid in self.queued}
        self.queued = []
        return done


@pytest.mark.parametrize("rate,seed", [(2.0, 0), (0.7, 3)])
def test_simulate_continuous_arrivals_are_the_references(rate, seed):
    got, want = _Recorder(), _Recorder()
    p = msc_serve.simulate_continuous(got, list(range(9)),
                                      arrival_rate=rate, seed=seed)
    r = jserve.simulate_continuous(want, list(range(9)),
                                   arrival_rate=rate, seed=seed)
    assert got.submits == want.submits
    assert (p[0], p[1], p[3]) == (r[0], r[1], r[3])
    # per-class rates and a deadline: the reference's class draws
    mix = {0: rate, 1: 2.0 * rate}
    got, want = _Recorder(), _Recorder()
    p = msc_serve.simulate_continuous(got, list(range(9)), arrival_rate=0.1,
                                      seed=seed, priority_rates=mix,
                                      deadline_chunks=5)
    r = jserve.simulate_continuous(want, list(range(9)), arrival_rate=0.1,
                                   seed=seed, priority_rates=mix,
                                   deadline_chunks=5)
    assert got.submits == want.submits
    assert {pr for _, pr, _ in got.submits} <= {0, 1}
    assert (p[0], p[1], p[3]) == (r[0], r[1], r[3])
