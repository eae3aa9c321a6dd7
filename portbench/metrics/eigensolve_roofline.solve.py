"""eigensolve_roofline.solve: the least time of each mode's eigensolve and
epilogue (`costs/msc.py:mode_s`) over the CUDA-event time of the port's
stage entry `core/schedule.py:build_mode_runner` on that mode's unfolding
of the cell's first pool tensor, summed over the three modes, in %.
It times whatever implements the stage.  Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    if not rec.stages:
        return None
    least = sum(rec.costs.mode_s(s["shape"], s["sweeps"], rec.k,
                                 rec.matrix_free) for s in rec.stages)
    return 100.0 * least / sum(s["seconds"] for s in rec.stages)
