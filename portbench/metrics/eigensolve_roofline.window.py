"""eigensolve_roofline.window: the least time of every mode's eigensolve
and epilogue over the window's solves (`costs/msc.py:mode_s` from each
solve's shape and sweeps, summed by `solve_s`) over the device time of
the program's `msc.eigensolve` and `msc.epilogue` spans in the window
(`repro_torch.spans`: CUDA events on the stream around each), in %.
None off a card or without spans.  Moves solve_ms."""
MOVES = "solve_ms"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = [s.device_s for s in spans.recorded().spans
           if s.name in ("msc.eigensolve", "msc.epilogue")]
    if not got or None in got or not rec.solves or sum(got) <= 0:
        return None
    least = sum(rec.costs.solve_s(s["shape"], s["sweeps"], rec.k,
                                  rec.matrix_free) for s in rec.solves)
    return 100.0 * least / sum(got)
