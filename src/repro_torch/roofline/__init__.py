"""Roofline models — counterpart of `repro.roofline`: the hardware specs,
the analytic MSC models and the "auto" choosers, and reports from a
step traced on fake tensors (`trace`, where the reference's `hlo.py`
reads XLA text)."""
from .hw import CHIPS_PER_POD, H100, V5E, HwSpec, target_hw
from .analyze import (RELAYOUTS, RooflineReport, active_param_count,
                      choose_chunk_steps, choose_epilogue, choose_relayout,
                      continuous_serving_model, eigensolve_model,
                      epilogue_model, expected_queue_wait, model_flops,
                      relayout_model, report_from_compiled, save_report,
                      serving_model)
