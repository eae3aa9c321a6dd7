"""refill_share.serve: the device time of the engine's `serve.refill`
spans (`repro_torch.spans`: evictions, admissions' writes, the refill
program and its results copied to the host; CUDA events on the stream
around each) summed over the window, over the window's wall time, in %.
None off a card or without spans.  Moves requests_per_s."""
MOVES = "requests_per_s"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = [s.device_s for s in spans.recorded().spans
           if s.name == "serve.refill"]
    if not got or None in got or rec.window.seconds <= 0:
        return None
    return 100.0 * sum(got) / rec.window.seconds
