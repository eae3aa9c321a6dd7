"""Serving on one device or a mesh of ranks — counterpart of
`repro.serving`: many MSC requests through the static batched engine
(`MSCServeEngine`) or the continuous-batching engine
(`MSCContinuousEngine`), and greedy LM generation (`ServeEngine`)."""
from .msc_engine import MSCContinuousEngine, MSCServeEngine, ServeStats
from .engine import ServeEngine
