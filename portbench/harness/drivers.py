"""The measured windows: how a cell's traffic drives the system.

Two drivers, chosen by the mix's "driver":

  solve   a closed loop of one client: solve the next pool tensor, bring
          its answer to the host, repeat until the window has lasted
          `seconds`; on a mesh rank 0's clock decides for every rank.
  serve   a closed loop of `clients` clients on the continuous engine:
          each submits its next tensor when its last one comes back;
          the window ends at the first tick past `seconds`; the requests
          still in flight are then served to the end (`drain`, outside
          the window: compared, not counted).

Both return a `Window`: the answers with the pool index each request
sent, the times, and what the per-layer metrics read.  A third driver,
"lm_generate", serves the language-model cells (`harness/lm.py`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from harness import systems
from harness.trace import span

DRAIN_S = 60.0


@dataclasses.dataclass
class Window:
    seconds: float
    answers: list  # [(pool index, [ModeAnswer] * 3)] in the window
    late: list  # answers of requests still in flight at the close
    attempted: int
    missing: int
    latencies: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


def solve_window(solve, pool, order, seconds: float, traced: bool,
                 decide=None) -> Window:
    """The closed loop of one client; `decide(done)` makes every rank of
    a mesh stop on rank 0's verdict."""
    answers = []
    t0 = time.perf_counter()
    while True:
        idx = int(order[len(answers)])
        with span("portbench.solve", traced):
            answers.append((idx, solve(pool[idx])))
        done = time.perf_counter() - t0 >= seconds
        if decide is not None:
            done = decide(done)
        if done:
            break
    wall = time.perf_counter() - t0
    return Window(seconds=wall, answers=answers, late=[],
                  attempted=len(answers), missing=0)


def serve_window(eng, pool, order, seconds: float, clients: int,
                 traced: bool):
    """The closed loop of `clients` clients on the engine.  Returns the
    window and `drain()`, which serves what is still in flight."""
    sent = {}  # rid → (pool index, submit time)
    cursor = [0]

    def submit():
        idx = int(order[cursor[0]])
        cursor[0] += 1
        t = time.perf_counter()
        with span("portbench.submit", traced):
            sent[eng.submit(pool[idx])] = (idx, t)

    before = systems.engine_counters(eng)
    t0 = time.perf_counter()
    for _ in range(clients):
        submit()
    answers, lat = [], []
    while True:
        with span("portbench.step", traced):
            done = eng.step()
        now = time.perf_counter()
        closed = now - t0 >= seconds
        for rid, res in done.items():
            idx, t = sent.pop(rid)
            lat.append(now - t)
            answers.append((idx, systems.host_answers(res)))
            if not closed:
                submit()
        if closed:
            break
    wall = now - t0
    after = systems.engine_counters(eng)
    counters = {k: after[k] - before[k] for k in after}
    window = Window(seconds=wall, answers=answers, late=[],
                    attempted=len(answers) + len(sent), missing=len(sent),
                    latencies=lat, counters=counters)
    return window, lambda: _drain(eng, sent, window)


def _drain(eng, sent: dict, window: Window) -> None:
    """Serve the requests still in flight at the close to the end (at
    most DRAIN_S more): their answers are compared, not counted."""
    limit = time.perf_counter() + DRAIN_S
    while sent and time.perf_counter() < limit:
        for rid, res in eng.step().items():
            window.late.append((sent.pop(rid)[0], systems.host_answers(res)))
    window.missing = len(sent)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
