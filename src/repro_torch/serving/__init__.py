"""Serving on one device or a mesh of ranks — counterpart of
`repro.serving`: many MSC requests through the static batched engine
(`MSCServeEngine`) or the continuous-batching engine
(`MSCContinuousEngine`, with its result cache, SLO scheduler and fault
tolerance), and greedy LM generation (`ServeEngine`)."""
from .msc_engine import MSCContinuousEngine, MSCServeEngine, ServeStats
from .engine import ServeEngine, build_serve_steps
from .faults import (DistKillPlan, FaultInjector, FaultPlan, InjectedFault,
                     LoadShedError, corrupt_checkpoint_leaf,
                     corrupt_checkpoint_shard, fail_all_from)
from .result_cache import MSCResultCache, NearHit
