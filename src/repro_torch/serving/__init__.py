"""Serving on one device — counterpart of `repro.serving`: many MSC
requests through the static batched engine (`MSCServeEngine`), and
greedy LM generation (`ServeEngine`)."""
from .msc_engine import MSCServeEngine, ServeStats
from .engine import ServeEngine
