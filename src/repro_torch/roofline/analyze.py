"""Roofline analysis — counterpart of `repro/roofline/analyze.py`.

Holds only `expected_queue_wait`, the queue-wait model the continuous
engine's SLO shedding reads.  The rest of the reference's file (the
hardware spec, the eigensolve and serving models, the "auto" relayout,
epilogue and chunk choosers) is ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations


def expected_queue_wait(queued_ahead: int, free_slots: int, B: int,
                        chunks_per_request: float) -> float:
    """Predicted queue wait, in gate chunks, of a request joining a
    B-slot continuous table behind `queued_ahead` requests served before
    it, with `free_slots` free: 0 if the free slots cover everyone ahead
    and it; else the table frees B slots per `chunks_per_request` chunks,
    so position (queued_ahead − free_slots + 1) waits that many turnovers
    over B."""
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    if queued_ahead < free_slots:
        return 0.0
    return ((queued_ahead - free_slots + 1)
            * max(1.0, float(chunks_per_request)) / B)
