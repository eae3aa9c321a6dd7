"""Spans and counters at the port's layer boundaries, recorded while a
`torch.profiler` session records.

    with torch.profiler.profile(activities=[...]):
        solve(tensor)
    rec = spans.recorded()
    [(s.name, s.seconds, s.device_s) for s in rec.spans]
    rec.counters["msc.gate_reads"]

Tracing is on exactly while a profiler session records
(`torch.autograd.profiler._is_profiler_enabled`, a Python attribute
read); there is no flag of its own.  Off, `span` returns one shared
no-op context and `count`, `open` and `close` return at once: nothing is
allocated and nothing recorded.

On, each `span` records its name, its host start and end
(`time.perf_counter_ns`), the span it ran in and its attributes, and is
also a `record_function` range of the same name, so it lies on the
profiler's timeline beside the kernels it launched.  Once CUDA is in
use, a span also records two CUDA events on the current stream (none
while the stream captures a graph): `recorded()` resolves them to
`device_s`, the stream's time from the span's start to its end, which
counts the stream's idle time inside the span.  No span synchronises.
`open(name, key)` / `close(name, key)` record a span that outlives one
call (a serving request, keyed by its id); `count` adds to a counter.

A recording starts, with empty buffers, the first time a call finds the
profiler on after a call (or `recorded()`) found it off, so it holds one
profiled window; it stays in memory until the next one starts.

The spans (PERF.md lists the metric each feeds):

  msc.solve       a flat-schedule solve (`core/parallel.py`), attr shape
  msc.mode        one of its three modes, attr mode
  msc.unfold      a rank's block of the mode's unfolding, copied
  msc.eigensolve  the planned eigensolve, run (the gram's formation on
                  the explicit-gram route included)
  msc.gate_chunk  one gate chunk of the gated loop
  msc.gate_read   the loop's host read of the gate, once a chunk; each
                  also counts `msc.gate_reads`
  msc.epilogue    λ-max normalisation and the similarity epilogue
  msc.extract     d and λ gathered, and the cluster extraction
  msc.collective  a collective of the solve, attr kind
  serve.submit    `MSCContinuousEngine.submit`
  serve.tick      `MSCContinuousEngine.step`, attr tick
  serve.refill    evictions, admissions, the refill program and the
                  results copied to the host, attrs evicted, admitted
  serve.chunk     the chunk-step program and its per-tick read, attr live
  serve.request   (keyed) a request from submit to the tick that returns it
  serve.queued    (keyed) a request from submit to its admission
  lm.prefill      `ServeEngine.generate`'s prefill, attrs rows, length
  lm.prefill_slice  one row slice of it (`cfg.prefill_tokens`), attrs
                  rows, start
  lm.ssd          one Mamba layer's chunked SSD scan inside a prefill
                  (`models/ssm.py:ssd_prefill`), attrs rows, length
  lm.moe          one MoE layer inside a prefill (`models/transformer.py`)
  lm.decode       a call's decode steps (graph replays on a card), attr
                  steps

The counters: `msc.gate_reads` (the gated loop's host reads),
`kernels.power_resident` (power kernel launches on its resident route,
eager or under capture, `kernels/power_iter.py`), `lm.prefill_slices`
(the engine's prefill slices) and `lm.decode_steps` (its decode steps).
No LM span opens inside a decode step's capture: the model's spans are
the prefill's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass
class Span:
    """A closed span.  `parent` is the `id` of the span it ran in (None
    for a keyed span and at the top); times are `perf_counter_ns`."""

    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0
    key: object = None
    attrs: dict = dataclasses.field(default_factory=dict)
    device_s: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Recording:
    """The closed spans (in the order they closed) and the counters of
    one recording."""

    spans: list
    counters: dict


class _Recorder:
    """The process's buffers (the profiler it follows is per process)."""

    def __init__(self):
        self.live = False
        self.spans = []
        self.counters = {}
        self.open = {}  # (name, key) → Span
        self.next_id = 0
        self.events = []  # CUDA event pairs, reused by later recordings
        self.used = 0
        self.local = threading.local()  # .stack: the open spans' ids

    def begin(self) -> None:
        self.live = True
        self.spans, self.counters, self.open = [], {}, {}
        self.used = 0
        self.local.stack = []

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event_pair(self):
        if self.used == len(self.events):
            self.events.append((torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)))
        pair = self.events[self.used]
        self.used += 1
        return pair


_rec = _Recorder()


def _on() -> bool:
    """Is a profiler session recording?  Starts a recording at the first
    call that finds it on after one found it off."""
    if _profiler._is_profiler_enabled:
        if not _rec.live:
            _rec.begin()
        return True
    _rec.live = False
    return False


class _NoSpan:
    """The shared context `span` returns while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _LiveSpan:
    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _rec.stack()
        self.span = Span(self.name, _rec.next_id,
                         stack[-1] if stack else None, 0, attrs=self.attrs)
        _rec.next_id += 1
        stack.append(self.span.id)
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            self.span.events = _rec.event_pair()
            self.span.events[0].record()
        self.span.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.span.end_ns = time.perf_counter_ns()
        if self.span.events is not None:
            self.span.events[1].record()
        self.range.__exit__(exc_type, exc, tb)
        stack = _rec.stack()
        if stack and stack[-1] == self.span.id:
            stack.pop()
        _rec.spans.append(self.span)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager: a span of `name` over its body while tracing is
    on; `.set(**attrs)` on what it returns adds attributes."""
    if not _on():
        return _NO_SPAN
    return _LiveSpan(name, attrs)


def open(name: str, key, **attrs) -> None:  # noqa: A001 - the span's verb
    """Open the span (`name`, `key`) that `close` ends, perhaps in a later
    call: a request's spans share its id as `key`."""
    if not _on():
        return
    _rec.open[(name, key)] = Span(name, _rec.next_id, None,
                                  time.perf_counter_ns(), key=key,
                                  attrs=attrs)
    _rec.next_id += 1


def close(name: str, key) -> None:
    """Close the span (`name`, `key`); nothing if it was not opened in
    this recording."""
    if not _on():
        return
    s = _rec.open.pop((name, key), None)
    if s is not None:
        s.end_ns = time.perf_counter_ns()
        _rec.spans.append(s)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if not _on():
        return
    _rec.counters[name] = _rec.counters.get(name, 0) + n


def recorded() -> Recording:
    """The closed spans and the counters of the current or most recent
    recording, not cleared; each span's `device_s` resolved (waiting for
    its end event on the device if it has not been reached)."""
    _on()
    for s in _rec.spans:
        if s.events is not None and s.device_s is None:
            start, end = s.events
            end.synchronize()
            s.device_s = start.elapsed_time(end) / 1e3
    return Recording(spans=list(_rec.spans), counters=dict(_rec.counters))
