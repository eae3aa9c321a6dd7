"""host_reads_per_solve: the gated loop's host reads of its gate over
the window (the program's `msc.gate_reads` counter, `repro_torch.spans`:
one a gate chunk and one last read a mode) over the window's completed
solves.  None for a program that records no spans.  Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = spans.recorded()
    if not got.spans or not rec.solves:
        return None
    return got.counters.get("msc.gate_reads", 0) / len(rec.solves)
