"""device_idle_share.lm: the share of the traced generation window in
which no kernel, memcpy or memset ran on the device, in %.  None off a
card.  Moves lm_tokens_per_s."""
MOVES = "lm_tokens_per_s"


def read(rec):
    t = rec.trace
    if not rec.cuda or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
