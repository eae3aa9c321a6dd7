"""The port's spans and counters (`repro_torch.spans`) on the CPU.

Off (no profiler recording) a span is one shared no-op that records and
allocates nothing.  Under `torch.profiler` a flat solve records the
tree msc.solve → msc.mode → msc.unfold, msc.eigensolve (its gate chunks
and reads), msc.epilogue, msc.extract, one `msc.gate_reads` a read, each
span also a profiler range of its name; a one-rank gloo mesh adds the
solve's collectives by kind; the continuous engine records one
serve.request and one serve.queued per request, keyed by its id; each
profiled window sees only its own spans.  Device time (`device_s`) is a
card's and None here.
"""
import itertools
import tracemalloc
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import (MSCConfig, PlantedSpec,  # noqa: E402
                              build_msc_parallel, make_planted_tensor)

M = 24


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return MSCConfig(epsilon=0.5 / (M - 2) ** 2, max_extraction_iters=M,
                     **kw)


def _tensor(seed=0, m=M, gamma=float(M)):
    return make_planted_tensor(torch.Generator().manual_seed(seed),
                               PlantedSpec.paper(m, gamma))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, spans.recorded()


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    solve = build_msc_parallel(_cfg(), device="cpu")
    t = _tensor()
    before = spans.recorded()
    first = spans.span("msc.solve", shape=(1, 2, 3))
    assert first is spans.span("msc.epilogue")
    with first as sp:
        sp.set(shape=(1,))
    solve(t)
    after = spans.recorded()
    assert len(after.spans) == len(before.spans)
    assert after.counters == before.counters


class _Plain:
    """A do-nothing context and functions: what the loop costs without
    spans (the interpreter's own bound methods of a `with`)."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def span(self, name):
        return self

    def count(self, name):
        pass

    def open(self, name, key):
        pass

    def close(self, name, key):
        pass


def _peak_bytes(api) -> tuple:
    """(bytes held after, most bytes held during) 2000 rounds of the four
    calls through `api`, over what was held before."""
    def calls():
        for _ in itertools.repeat(None, 2000):  # no int objects made
            with api.span("msc.gate_chunk"):
                api.count("msc.gate_reads")
            api.open("serve.request", 1)
            api.close("serve.request", 1)

    calls()  # warm: first-call caches
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        calls()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - base, peak - base


def test_off_nothing_is_allocated():
    held, peak = _peak_bytes(spans)
    plain_held, plain_peak = _peak_bytes(_Plain())
    assert held == plain_held == 0
    # what a `with` costs the interpreter, once, and nothing per call
    assert peak <= plain_peak < 1024


def test_a_profiled_solve_records_the_span_tree_and_the_reads():
    cfg = _cfg()
    solve = build_msc_parallel(cfg, device="cpu")
    t = _tensor()
    solve(t)
    result, prof, rec = _profiled(lambda: solve(t))
    by_id = {s.id: s for s in rec.spans}
    names = Counter(s.name for s in rec.spans)
    k = cfg.power_check_every
    sweeps = [int(mr.power_iters_run) for mr in result.modes]
    chunks = sum(s // k for s in sweeps)
    assert names == {"msc.solve": 1, "msc.mode": 3, "msc.unfold": 3,
                     "msc.eigensolve": 3, "msc.epilogue": 3,
                     "msc.extract": 3, "msc.gate_chunk": chunks,
                     "msc.gate_read": chunks + 3}
    assert rec.counters == {"msc.gate_reads": sum(s // k + 1
                                                  for s in sweeps)}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    (top,) = [s for s in rec.spans if s.name == "msc.solve"]
    assert top.parent is None and top.attrs == {"shape": (M, M, M)}
    modes = [s for s in rec.spans if s.name == "msc.mode"]
    assert [s.attrs["mode"] for s in modes] == [0, 1, 2]
    for s in rec.spans:
        want = {"msc.solve": None, "msc.mode": "msc.solve",
                "msc.gate_chunk": "msc.eigensolve",
                "msc.gate_read": "msc.eigensolve"}.get(s.name, "msc.mode")
        assert parent(s) == want, s
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
        assert s.device_s is None
    # each mode's children lie inside it, in the body's order
    for mode in modes:
        kids = [s.name for s in rec.spans if s.parent == mode.id]
        assert kids == ["msc.unfold", "msc.eigensolve", "msc.epilogue",
                        "msc.extract"]
    # the spans are the profiler's ranges too
    ranges = Counter(e.name for e in prof.events())
    for name, n in names.items():
        assert ranges[name] == n


def test_the_explicit_gram_route_records_its_reads():
    cfg = _cfg(matrix_free=False)
    solve = build_msc_parallel(cfg, device="cpu")
    t = _tensor(1)
    result, _, rec = _profiled(lambda: solve(t))
    k = cfg.power_check_every
    assert rec.counters["msc.gate_reads"] == sum(
        int(mr.power_iters_run) // k + 1 for mr in result.modes)
    assert len([s for s in rec.spans if s.name == "msc.eigensolve"]) == 3


def test_each_profiled_window_sees_only_its_own_spans():
    solve = build_msc_parallel(_cfg(), device="cpu")
    fast, slow = _tensor(2, gamma=200.0), _tensor(3, gamma=2.0)
    ra, _, a = _profiled(lambda: solve(fast))
    rb, _, b = _profiled(lambda: solve(slow))
    assert spans.recorded().spans == b.spans
    for res, rec in ((ra, a), (rb, b)):
        assert sum(s.name == "msc.solve" for s in rec.spans) == 1
        k = _cfg().power_check_every
        assert rec.counters["msc.gate_reads"] == sum(
            int(mr.power_iters_run) // k + 1 for mr in res.modes)
    assert {s.id for s in a.spans}.isdisjoint(s.id for s in b.spans)


@pytest.mark.parametrize("relayout,kinds", [
    ("gspmd", {"gate_all_reduce", "lam_all_reduce", "all_gather",
               "gather"}),
    ("collective", {"gate_all_reduce", "lam_all_reduce", "all_gather",
                    "gather", "all_to_all"})])
def test_a_mesh_solve_records_its_collectives_by_kind(relayout, kinds,
                                                      tmp_path):
    from repro_torch.launch import mesh as tmesh

    tmesh.join("cpu", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        solve = build_msc_parallel(
            _cfg(), mesh=tmesh.make_msc_mesh("flat", None, "cpu"),
            relayout=relayout)
        t = _tensor(4)
        solve(t)
        _, _, rec = _profiled(lambda: solve(t))
    finally:
        tmesh.leave()
    got = Counter(s.attrs["kind"] for s in rec.spans
                  if s.name == "msc.collective")
    assert set(got) == kinds
    # one λ all-reduce, one all-gather of V and one gather of d a mode
    assert got["lam_all_reduce"] == got["all_gather"] == got["gather"] == 3
    assert got["gate_all_reduce"] == sum(
        s.name == "msc.gate_chunk" for s in rec.spans)
    assert sum(s.name == "msc.unfold" for s in rec.spans) == 3


def test_a_request_has_one_span_of_each_kind_under_its_id():
    from repro_torch.serving import MSCContinuousEngine

    m = 16
    cfg = MSCConfig(epsilon=3e-4, power_tol=3e-3, power_iters=48,
                    power_check_every=8)
    eng = MSCContinuousEngine(cfg, slots=2, device="cpu")
    tensors = [make_planted_tensor(
        torch.Generator().manual_seed(i),
        PlantedSpec.paper(m, 2.0 if i % 3 == 0 else 300.0))
        for i in range(6)]
    eng.run(tensors[:2])

    def serve():
        rids = [eng.submit(t) for t in tensors]
        done = {}
        while len(done) < len(rids):
            done.update(eng.step())
        return rids

    rids, _, rec = _profiled(serve)
    eng.close()
    for name in ("serve.request", "serve.queued"):
        keyed = Counter(s.key for s in rec.spans if s.name == name)
        assert keyed == {rid: 1 for rid in rids}, name
    req = {s.key: s for s in rec.spans if s.name == "serve.request"}
    for q in (s for s in rec.spans if s.name == "serve.queued"):
        assert req[q.key].start_ns <= q.start_ns <= q.end_ns \
            <= req[q.key].end_ns
    names = Counter(s.name for s in rec.spans)
    assert names["serve.submit"] == len(rids)
    assert names["serve.tick"] >= names["serve.chunk"] >= 1
    refills = [s for s in rec.spans if s.name == "serve.refill"]
    assert sum(s.attrs["admitted"] for s in refills) == len(rids)
    assert sum(s.attrs["evicted"] for s in refills) == len(rids)
    ticks = {s.id for s in rec.spans if s.name == "serve.tick"}
    assert all(s.parent in ticks for s in refills)
    assert all(s.device_s is None for s in rec.spans)
