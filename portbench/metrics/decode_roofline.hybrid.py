"""decode_roofline.hybrid: the least time of the window's decode steps
(`costs/granite_hybrid.py:decode_least_s`: the new_tokens − 1 steps a
call needs, each step's weights in bf16, every expert of a layer, the
fp32 SSM and conv states read and written and the KV cache at 3.35
TB/s, or its operations at 989 TFLOP/s, the larger) over the engine's
own CUDA-event time of its decode (`ServeEngine.timings["decode_ms"]`,
every step it runs), in %.  None off a card.  Moves lm_tokens_per_s."""
from costs import granite_hybrid as costs

MOVES = "lm_tokens_per_s"


def read(rec):
    if not rec.cuda or not rec.calls:
        return None
    took = sum(k["decode_ms"] for k in rec.calls) / 1e3
    if took <= 0:
        return None
    least = sum(costs.decode_least_s(rec.conf, k["batch"], k["length"],
                                     k["new_tokens"]) for k in rec.calls)
    return 100.0 * least / took
