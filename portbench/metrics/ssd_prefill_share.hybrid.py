"""ssd_prefill_share.hybrid: of the device time of the window's prefills
(the program's `lm.prefill` spans, `repro_torch.spans`: a call's
prefill, every row slice; CUDA events on the stream around it), the
share in the chunked SSD scans of its Mamba layers (the `lm.ssd` spans
inside them: dt, the chunks' quadratic term, their states and the
carry between chunks, the states written to the cache), in %.  None off
a card or without spans.  Moves lm_tokens_per_s."""
MOVES = "lm_tokens_per_s"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = spans.recorded().spans
    ssd = [s.device_s for s in got if s.name == "lm.ssd"]
    pre = [s.device_s for s in got if s.name == "lm.prefill"]
    if not ssd or not pre or None in ssd + pre or sum(pre) <= 0:
        return None
    return 100.0 * sum(ssd) / sum(pre)
