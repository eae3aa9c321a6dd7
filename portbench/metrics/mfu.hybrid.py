"""mfu.hybrid: the published GraniteMoeHybrid model's operations for the
window's completed calls (`costs/granite_hybrid.py`: every prompt
position and generated token through the Mamba-2 projections, conv and
recurrence, the attention layers' projections and attention over the
context, the router, its k experts and the shared MLP, the head where
logits are used; no padding or dispatch slot counted) over the window's
wall time × 989 TFLOP/s (dense bf16, one H100), in %.  None off a card.
Moves lm_tokens_per_s."""
from costs import granite_hybrid as costs

MOVES = "lm_tokens_per_s"


def read(rec):
    if not rec.cuda or not rec.calls or rec.window.seconds <= 0:
        return None
    flops = sum(costs.prefill_flops(rec.conf, k["batch"], k["length"])
                + costs.decode_flops(rec.conf, k["batch"], k["length"],
                                     k["new_tokens"]) for k in rec.calls)
    return 100.0 * flops / (rec.window.seconds * costs.PEAK_BF16)
