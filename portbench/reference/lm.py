"""Plain reference of a GraniteMoe language model (model_type
"granitemoe", e.g. ibm-granite/granite-3.0-1b-a400m-base): the full
forward pass over whole sequences in plain `torch`, fp32 with TF32 off.

It follows the published GraniteMoe description (Hugging Face
`modeling_granitemoe.py`): token embedding times `embedding_multiplier`;
per layer a pre-norm RMSNorm, grouped-query self-attention with
rotate-half RoPE (θ = `rope_theta`) and scores scaled by
`attention_multiplier`, its output added times `residual_multiplier`; a
second RMSNorm and the MoE block: router logits over every expert, the
top `num_experts_per_tok` taken, their softmax as the gates (the same as
the softmax over all experts renormalised over the top k), and each
chosen expert's SwiGLU, silu(x W1) * (x W3) W2, summed with its gate and
added times `residual_multiplier`; a last RMSNorm, the tied embedding
as the head, the logits divided by `logits_scaling`.  Every token goes
to its top k experts: no capacity, no dropped token, no cache, no
batching trick; attention is the materialised causal softmax.

Departures, each stated: the RMSNorm weights are named `scale` after
the port's leaves but hold the published multiplier (the port's norm
multiplies by 1 + its `scale`, so the harness hands it weight − 1); the
expert's gate and up projections are two tensors (`w1`, `w3`) where the
published checkpoint packs them as one `input_linear`; router ties,
which fp32 makes all but impossible, go to `torch.topk`'s choice.

The forward pass here always applies the published multipliers.
`without_multipliers` writes the same model without them, the form the
port's model takes: the harness rewrites the program's copy of the
weights with it, never the reference's.

The weights are those of `weight_specs`, made by the harness from the
run's seed (`harness/lm.py:weights`) and read here by name: stacked
over the layers, "layers.attn.wq" (L, D, H, dh) and so on.  It imports
nothing of the program.

`operand`, where given, rounds both inputs of every matrix product
(projections, scores, attention over values, router, experts, head):
the control computes so with `fp8`, one precision below the
configuration's bf16.
"""
from __future__ import annotations

import torch


def dims(conf: dict) -> dict:
    """The model's sizes from the configuration file's published keys."""
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"L": conf["num_hidden_layers"], "D": d, "H": h,
            "K": conf["num_key_value_heads"],
            "dh": conf.get("head_dim") or d // h,
            "F": conf["intermediate_size"], "E": conf["num_local_experts"],
            "k": conf["num_experts_per_tok"], "V": conf["vocab_size"]}


def weight_specs(conf: dict) -> dict:
    """name → (shape, init, std) of every weight; names under "layers."
    are stacked over the layers.  init "normal" draws N(0, std²),
    "one_plus" 1 + N(0, std²) (a norm's multiplier).

    The embedding is drawn at `initializer_range` / `embedding_multiplier`,
    so the residual stream starts at `initializer_range`.  At
    `initializer_range` itself, the token's own embedding times 12 would
    outweigh every layer of a random model: such a model repeats its
    input token at every position, with margins no precision or fault
    could move, and a check on it could not fail."""
    n = dims(conf)
    L, D, H, K, dh, F, E, V = (n[x] for x in "L D H K dh F E V".split())
    return {
        "embed": ((V, D), "normal",
                  conf["initializer_range"] / conf["embedding_multiplier"]),
        "layers.ln1.scale": ((L, D), "one_plus", 0.1),
        "layers.attn.wq": ((L, D, H, dh), "normal", D ** -0.5),
        "layers.attn.wk": ((L, D, K, dh), "normal", D ** -0.5),
        "layers.attn.wv": ((L, D, K, dh), "normal", D ** -0.5),
        "layers.attn.wo": ((L, H, dh, D), "normal", (H * dh) ** -0.5),
        "layers.ln2.scale": ((L, D), "one_plus", 0.1),
        "layers.moe.router": ((L, D, E), "normal", D ** -0.5),
        "layers.moe.w1": ((L, E, D, F), "normal", D ** -0.5),
        "layers.moe.w3": ((L, E, D, F), "normal", D ** -0.5),
        "layers.moe.w2": ((L, E, F, D), "normal", F ** -0.5),
        "final_norm.scale": ((D,), "one_plus", 0.1),
    }


def without_multipliers(w: dict, conf: dict) -> float:
    """Rewrite `w` in place as the same model without the four
    multipliers, and return the RMSNorm epsilon it then takes.

    With c the embedding multiplier, the residual stream x is c·y, where
    y starts as the embedding row itself.  An RMSNorm reads from y,
    with epsilon eps / c², exactly what it reads from x with eps.  A
    branch added to x times r is added to y times r / c: its last
    product (`wo`, each expert's `w2`) is scaled by r / c.  Scores
    scaled by a instead of head_dim^-0.5 scale `wq` by a·head_dim^0.5
    (RoPE is linear).  Logits divided by s scale the final norm's
    multiplier by 1 / s.  The embedding, which is also the tied head,
    is unchanged.  So the forward pass with multipliers 1, 1 and 1,
    scores at head_dim^-0.5 and the returned epsilon gives `w`'s
    published logits, up to rounding."""
    dh = dims(conf)["dh"]
    c, r = conf["embedding_multiplier"], conf["residual_multiplier"]
    w["layers.attn.wq"].mul_(conf["attention_multiplier"] * dh ** 0.5)
    w["layers.attn.wo"].mul_(r / c)
    w["layers.moe.w2"].mul_(r / c)
    w["final_norm.scale"].div_(conf["logits_scaling"])
    return conf["rms_norm_eps"] / c ** 2


class NoTF32:
    """TF32 off for matrix products and convolutions inside the block,
    the previous settings restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under one per-tensor scale (its largest
    magnitude to 448, as fp8 inference scales a tensor), back in fp32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(a, b, operand):
    return a @ b if operand is None else operand(a) @ operand(b)


def _rmsnorm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _rope(x, theta):
    """Rotate-half RoPE over positions 0…S−1.  x: (B, S, heads, dh)."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(w, i, x, n, conf, operand):
    b, s, d = x.shape
    H, K, dh = n["H"], n["K"], n["dh"]
    flat = x.reshape(b * s, d)
    q = _mm(flat, w["layers.attn.wq"][i].reshape(d, H * dh), operand)
    k = _mm(flat, w["layers.attn.wk"][i].reshape(d, K * dh), operand)
    v = _mm(flat, w["layers.attn.wv"][i].reshape(d, K * dh), operand)
    q = _rope(q.reshape(b, s, H, dh), conf["rope_theta"]).transpose(1, 2)
    k = _rope(k.reshape(b, s, K, dh), conf["rope_theta"]).transpose(1, 2)
    v = v.reshape(b, s, K, dh).transpose(1, 2)
    # query head h reads kv head h // (H / K)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scores = _mm(q, k.transpose(-1, -2), operand) \
        * conf["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = _mm(torch.softmax(scores, dim=-1), v, operand)      # (B, H, S, dh)
    out = out.transpose(1, 2).reshape(b * s, H * dh)
    return _mm(out, w["layers.attn.wo"][i].reshape(H * dh, d),
               operand).reshape(b, s, d)


def _moe(w, i, x, n, operand):
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = _mm(flat, w["layers.moe.router"][i], operand)   # (N, E)
    top, idx = torch.topk(logits, n["k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(flat)
    for e in range(n["E"]):
        chose = idx == e                                      # (N, k)
        rows = chose.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = flat[rows]
        h = torch.nn.functional.silu(_mm(xe, w["layers.moe.w1"][i, e],
                                         operand)) \
            * _mm(xe, w["layers.moe.w3"][i, e], operand)
        out = _mm(h, w["layers.moe.w2"][i, e], operand)
        gate = (gates * chose)[rows].sum(dim=-1, keepdim=True)
        y.index_add_(0, rows, gate * out)
    return y.reshape(b, s, d)


def hidden(w: dict, tokens: torch.Tensor, conf: dict,
           operand=None) -> torch.Tensor:
    """Final hidden states (B, S, D) fp32 of token ids (B, S)."""
    n = dims(conf)
    eps, res = conf["rms_norm_eps"], conf["residual_multiplier"]
    x = w["embed"].float()[tokens.long()] * conf["embedding_multiplier"]
    for i in range(n["L"]):
        h = _rmsnorm(x, w["layers.ln1.scale"][i], eps)
        x = x + res * _attention(w, i, h, n, conf, operand)
        h = _rmsnorm(x, w["layers.ln2.scale"][i], eps)
        x = x + res * _moe(w, i, h, n, operand)
    return _rmsnorm(x, w["final_norm.scale"], eps)


def logits(w: dict, hid: torch.Tensor, conf: dict,
           operand=None) -> torch.Tensor:
    """Logits (…, V) fp32 of final hidden states (…, D): the tied
    embedding as the head, divided by `logits_scaling`."""
    return _mm(hid, w["embed"].float().T, operand) / conf["logits_scaling"]
