"""Serving of many MSC requests — counterpart of `repro.serving` (the
static batched engine on one device)."""
from .msc_engine import MSCServeEngine, ServeStats
