"""collective_share.flat4: rank 0's device seconds in NCCL's own kernels
(names with "nccl") over its device seconds in the traced window, in %.
Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    t = rec.trace
    if not t:
        return None
    total = sum(t["device_ops"].values())
    if total <= 0 or t["nccl_s"] <= 0:
        return None
    return 100.0 * t["nccl_s"] / total
