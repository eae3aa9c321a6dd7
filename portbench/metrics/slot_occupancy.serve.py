"""slot_occupancy.serve: the engine's `ServeStats.occupancy` over the
window, in %: live slot-chunks over the slot-chunks dispatched
(`busy_slot_chunks` / `slot_chunks`, counted by the engine).  Moves
requests_per_s."""
MOVES = "requests_per_s"


def read(rec):
    c = rec.counters
    if not c or not c.get("slot_chunks"):
        return None
    return 100.0 * c["busy_slot_chunks"] / c["slot_chunks"]
