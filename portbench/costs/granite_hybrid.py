"""The work a GraniteMoeHybrid model's generation needs
(granite-4.0-h-small), from the configuration's published keys:
parameters, operations and bytes, and the least time on one H100.

Counted as the published model needs it, whatever the program does:

  a Mamba layer, a token      2 × its projections (`in_proj`,
                              `out_proj`), the conv (2 × width × conv
                              channels) and the recurrence: the state's
                              decay, its update dt·x ⊗ B and the readout
                              C, three multiply-adds over the H·P·N state
  an attention layer, a token 2 × its projections, plus 4 × heads ×
                              head_dim × (keys it sees) (the scores and
                              the weighted values); no positional
                              encoding
  the MoE, a token            2 × (the router, the k experts it is
                              routed to, the shared MLP)
  the head                    2 × hidden × vocab for each token whose
                              logits are used: the last prompt position
                              at prefill, every decode step's token
  a call of n new tokens      the prefill, which gives the first, and
                              n − 1 decode steps, each giving one more

Norms, activations and padding, the dispatch slots of a capacity and the
experts a token is not routed to are not counted.  A decode step's least
bytes: every weight in bf16 once (each expert is read when the step's
batch × k routings could reach every expert; the tied embedding as the
head), each sequence's SSM and conv states read and written in fp32, the
KV cache of the attention layers read at the step's context and the new
position's keys and values written in bf16.  Peaks: 989 TFLOP/s dense
bf16 and 3.35 TB/s (NVIDIA's H100 SXM data sheet).
"""
from __future__ import annotations

from reference.granite_hybrid import dims as _n

PEAK_BF16 = 989e12  # FLOP/s, dense
HBM_BYTES_S = 3.35e12
BF16, FP32 = 2, 4


def _kinds(conf: dict) -> tuple:
    """(Mamba layers, attention layers)."""
    kinds = _n(conf)["kinds"]
    return kinds.count("mamba"), len(kinds) - kinds.count("mamba")


def _mamba_proj(conf: dict) -> int:
    n = _n(conf)
    return n["D"] * (2 * n["inner"] + 2 * n["N"] + n["Hs"]) \
        + n["inner"] * n["D"]


def mamba_params(conf: dict) -> int:
    """A Mamba layer's mixer and its pre-norm: the projections, the conv
    and its bias, A_log, D, dt_bias, the gated norm."""
    n = _n(conf)
    return (_mamba_proj(conf) + (n["W"] + 1) * n["conv"] + 3 * n["Hs"]
            + n["inner"] + n["D"])


def attn_params(conf: dict) -> int:
    """An attention layer's projections and its pre-norm."""
    n = _n(conf)
    return n["D"] * (2 * n["H"] + 2 * n["K"]) * n["dh"] + n["D"]


def moe_params(conf: dict, experts: int | None = None) -> int:
    """A layer's MoE with `experts` experts (all by default), the shared
    MLP and the norm before them."""
    n = _n(conf)
    e = n["E"] if experts is None else experts
    return (n["D"] * n["E"] + e * 3 * n["D"] * n["F"]
            + 3 * n["D"] * n["Fs"] + n["D"])


def _params(conf: dict, experts: int | None) -> int:
    n = _n(conf)
    m, a = _kinds(conf)
    return (m * mamba_params(conf) + a * attn_params(conf)
            + n["L"] * moe_params(conf, experts) + n["V"] * n["D"] + n["D"])


def total_params(conf: dict) -> int:
    """Every parameter: the layers, the embedding (tied head), the final
    norm."""
    return _params(conf, None)


def active_params(conf: dict) -> int:
    """Parameters one token uses: its k experts in every layer."""
    return _params(conf, _n(conf)["k"])


def token_flops(conf: dict) -> float:
    """A token's operations through the layers, but attention over its
    context."""
    n = _n(conf)
    m, a = _kinds(conf)
    mamba = (2.0 * _mamba_proj(conf) + 2.0 * n["W"] * n["conv"]
             + 6.0 * n["Hs"] * n["P"] * n["N"])
    attn = 2.0 * n["D"] * (2 * n["H"] + 2 * n["K"]) * n["dh"]
    moe = 2.0 * (n["D"] * n["E"] + n["k"] * 3 * n["D"] * n["F"]
                 + 3 * n["D"] * n["Fs"])
    return m * mamba + a * attn + n["L"] * moe


def _attn_flops(conf: dict, keys: int) -> float:
    """Attention's operations a token over `keys` keys, all attention
    layers."""
    n = _n(conf)
    return 4.0 * n["H"] * n["dh"] * keys * _kinds(conf)[1]


def _head_flops(conf: dict) -> float:
    n = _n(conf)
    return 2.0 * n["D"] * n["V"]


def prefill_flops(conf: dict, batch: int, length: int) -> float:
    """A prompt of `length` a sequence: every position through the layers,
    position p over p + 1 keys, and the last position's head."""
    return batch * (token_flops(conf) * length
                    + _attn_flops(conf, length * (length + 1) // 2)
                    + _head_flops(conf))


def decode_flops(conf: dict, batch: int, length: int,
                 new_tokens: int) -> float:
    """The decode steps of `new_tokens` after a prompt of `length`: step
    j < new_tokens − 1 takes token length + j over length + j + 1 keys,
    and its head."""
    steps = new_tokens - 1
    keys = steps * (length + 1) + steps * (steps - 1) // 2
    per = token_flops(conf) + _head_flops(conf)
    return batch * (steps * per + _attn_flops(conf, keys))


def state_bytes(conf: dict, batch: int) -> float:
    """The fp32 SSM and conv states of `batch` sequences, all Mamba
    layers."""
    n = _n(conf)
    per = n["Hs"] * n["P"] * n["N"] + (n["W"] - 1) * n["conv"]
    return float(_kinds(conf)[0] * batch * per * FP32)


def kv_bytes(conf: dict, batch: int, positions: int) -> float:
    """bf16 keys and values of `positions` positions a sequence, all
    attention layers."""
    n = _n(conf)
    return (2.0 * _kinds(conf)[1] * batch * positions * n["K"] * n["dh"]
            * BF16)


def decode_step_bytes(conf: dict, batch: int, context: int) -> float:
    """A decode step's least bytes at `context` positions filled before
    it: the weights it must read in bf16, the states read and written,
    the KV cache read, the new position written."""
    n = _n(conf)
    weights = _params(conf, min(n["E"], batch * n["k"]))
    return (weights * BF16 + 2 * state_bytes(conf, batch)
            + kv_bytes(conf, batch, context) + kv_bytes(conf, batch, 1))


def decode_least_s(conf: dict, batch: int, length: int,
                   new_tokens: int) -> float:
    """The least time of the decode steps of `new_tokens` after a prompt
    of `length` (new_tokens − 1 of them): each step's bytes at 3.35 TB/s
    or its operations at 989 TFLOP/s, the larger."""
    per = token_flops(conf) + _head_flops(conf)
    out = 0.0
    for j in range(new_tokens - 1):
        flops = batch * (per + _attn_flops(conf, length + j + 1))
        out += max(decode_step_bytes(conf, batch, length + j) / HBM_BYTES_S,
                   flops / PEAK_BF16)
    return out
