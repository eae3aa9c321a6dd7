"""Roofline models — counterpart of `repro.roofline`: for now only the
queue-wait model the continuous engine's shedding policy reads."""
from .analyze import expected_queue_wait
