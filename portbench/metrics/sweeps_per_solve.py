"""sweeps_per_solve: the mean over the window's solves of the power
iteration's sweeps, averaged over the three modes (each answer's
`power_iters_run`).  Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    if not rec.solves:
        return None
    return sum(sum(s["sweeps"]) / 3.0 for s in rec.solves) / len(rec.solves)
