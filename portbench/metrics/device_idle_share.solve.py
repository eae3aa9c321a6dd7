"""device_idle_share.solve: the share of the traced window in which no
kernel, memcpy or memset ran on the device (rank 0's on a mesh), in %.
Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
