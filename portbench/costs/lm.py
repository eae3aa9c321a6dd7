"""The work a language model's generation needs, from the configuration's
published keys: parameters, operations and bytes, and the least time on
one H100.

Counted as the published model needs it, whatever the program does:

  a token through the layers   2 × the active parameters of a layer
                               (attention projections, router, the k
                               experts it is routed to, norms) × layers,
                               plus attention over its context:
                               4 × heads × head_dim × (keys it sees) a
                               layer (the scores and the weighted values)
  the head                     2 × hidden × vocab for each token whose
                               logits are used: the last prompt position
                               at prefill, every decode step's token
  a call of n new tokens       the prefill, which gives the first, and
                               n − 1 decode steps, each giving one more
                               (a step whose token is never returned is
                               the program's waste, not counted)

Padding, the dispatch slots of a capacity and the experts a token is not
routed to are not counted.  A decode step's least bytes: every weight in
bf16 once (each expert is read when the step's batch × k routings could
reach every expert; the tied embedding as the head), the KV cache read
at the step's context and the new position's keys and values written.
Peaks: 989 TFLOP/s dense bf16 and 3.35 TB/s (NVIDIA's H100 SXM data
sheet).
"""
from __future__ import annotations

from reference.lm import dims as _n

PEAK_BF16 = 989e12  # FLOP/s, dense
HBM_BYTES_S = 3.35e12
BF16 = 2


def layer_params(conf: dict, experts: int | None = None) -> int:
    """Parameters of one layer with `experts` experts (all by default)."""
    n = _n(conf)
    e = n["E"] if experts is None else experts
    attn = n["D"] * (2 * n["H"] + 2 * n["K"]) * n["dh"]
    return attn + n["D"] * n["E"] + e * 3 * n["D"] * n["F"] + 2 * n["D"]


def active_layer_params(conf: dict) -> int:
    """Parameters one token uses in a layer: its k experts."""
    return layer_params(conf, _n(conf)["k"])


def total_params(conf: dict) -> int:
    """Every parameter: the layers, the embedding (tied head), the final
    norm."""
    n = _n(conf)
    return n["L"] * layer_params(conf) + n["V"] * n["D"] + n["D"]


def active_params(conf: dict) -> int:
    """Parameters one token uses: its experts' layers and the embedding
    (the head, tied)."""
    n = _n(conf)
    return n["L"] * active_layer_params(conf) + n["V"] * n["D"] + n["D"]


def _attn_flops(conf: dict, keys: int) -> float:
    """Attention's operations a token over `keys` keys, all layers."""
    n = _n(conf)
    return 4.0 * n["H"] * n["dh"] * keys * n["L"]


def _head_flops(conf: dict) -> float:
    n = _n(conf)
    return 2.0 * n["D"] * n["V"]


def prefill_flops(conf: dict, batch: int, length: int) -> float:
    """A prompt of `length` a sequence: every position through the layers,
    position p over p + 1 keys, and the last position's head."""
    n = _n(conf)
    layers = 2.0 * n["L"] * active_layer_params(conf) * length
    attn = _attn_flops(conf, length * (length + 1) // 2)
    return batch * (layers + attn + _head_flops(conf))


def decode_flops(conf: dict, batch: int, length: int,
                 new_tokens: int) -> float:
    """The decode steps of `new_tokens` after a prompt of `length`: step
    j < new_tokens − 1 takes token length + j over length + j + 1 keys,
    and its head."""
    n = _n(conf)
    steps = new_tokens - 1
    keys = steps * (length + 1) + steps * (steps - 1) // 2
    per = 2.0 * n["L"] * active_layer_params(conf) + _head_flops(conf)
    return batch * (steps * per + _attn_flops(conf, keys))


def kv_bytes(conf: dict, batch: int, positions: int) -> float:
    """bf16 keys and values of `positions` positions a sequence, all
    layers."""
    n = _n(conf)
    return 2.0 * n["L"] * batch * positions * n["K"] * n["dh"] * BF16


def decode_step_bytes(conf: dict, batch: int, context: int) -> float:
    """A decode step's least bytes at `context` positions filled before
    it: the weights it must read in bf16, the cache read, the new
    position written."""
    n = _n(conf)
    experts = min(n["E"], batch * n["k"])
    weights = (n["L"] * layer_params(conf, experts) + n["V"] * n["D"]
               + n["D"])
    return (weights * BF16 + kv_bytes(conf, batch, context)
            + kv_bytes(conf, batch, 1))


def decode_least_s(conf: dict, batch: int, length: int,
                   new_tokens: int) -> float:
    """The least time of the decode steps of `new_tokens` after a prompt
    of `length` (new_tokens − 1 of them): each step's bytes at 3.35 TB/s
    or its operations at 989 TFLOP/s, the larger."""
    n = _n(conf)
    per = 2.0 * n["L"] * active_layer_params(conf) + _head_flops(conf)
    out = 0.0
    for j in range(new_tokens - 1):
        flops = batch * (per + _attn_flops(conf, length + j + 1))
        out += max(decode_step_bytes(conf, batch, length + j) / HBM_BYTES_S,
                   flops / PEAK_BF16)
    return out
