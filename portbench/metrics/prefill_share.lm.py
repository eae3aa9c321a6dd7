"""prefill_share.lm: of the engine's time in the window's calls, the
share in prefill: Σ `prefill_ms` over Σ (`prefill_ms` + `decode_ms`) of
`ServeEngine.timings` (CUDA events on a card, the host clock on the
CPU), in %.  Moves lm_tokens_per_s."""
MOVES = "lm_tokens_per_s"


def read(rec):
    pre = sum(k["prefill_ms"] for k in rec.calls)
    total = pre + sum(k["decode_ms"] for k in rec.calls)
    if total <= 0:
        return None
    return 100.0 * pre / total
