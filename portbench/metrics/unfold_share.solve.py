"""unfold_share.solve: the device time of the program's `msc.unfold`
spans (`repro_torch.spans`: a rank's block of a mode's unfolding copied,
CUDA events on the stream around it) summed over the window, over the
window's wall time, in %.  None off a card or without spans.  Moves
solve_ms."""
MOVES = "solve_ms"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = [s.device_s for s in spans.recorded().spans
           if s.name == "msc.unfold"]
    if not got or None in got or rec.window.seconds <= 0:
        return None
    return 100.0 * sum(got) / rec.window.seconds
