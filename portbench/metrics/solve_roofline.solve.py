"""solve_roofline.solve: the least time of the window's solves over its
wall time, in %.  The least time counts the work each solve's gate
needed (`costs/msc.py:solve_s`: per mode, T read once a gate chunk and
the epilogue's |V Vᵀ|, at 3.35 TB/s and 67 TFLOP/s fp32), from the
tensor's shape and the sweeps each mode ran; nothing from kernel names.
Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    if not rec.solves or rec.window.seconds <= 0:
        return None
    least = sum(rec.costs.solve_s(s["shape"], s["sweeps"], rec.k,
                                  rec.matrix_free) for s in rec.solves)
    return 100.0 * least / rec.window.seconds
