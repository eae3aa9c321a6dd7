"""mfu.lm: the published model's operations for the window's completed
calls (`costs/lm.py`: every prompt position and generated token through
the layers with its k experts and attention over its context, the head
where logits are used; no padding or dispatch slot counted) over the
window's wall time × 989 TFLOP/s (dense bf16, one H100), in %.  None off
a card.  Moves lm_tokens_per_s."""
MOVES = "lm_tokens_per_s"


def read(rec):
    if not rec.cuda or not rec.calls or rec.window.seconds <= 0:
        return None
    c = rec.costs
    flops = sum(c.prefill_flops(rec.conf, k["batch"], k["length"])
                + c.decode_flops(rec.conf, k["batch"], k["length"],
                                 k["new_tokens"]) for k in rec.calls)
    return 100.0 * flops / (rec.window.seconds * c.PEAK_BF16)
