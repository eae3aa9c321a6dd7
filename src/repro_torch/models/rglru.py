"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
counterpart of `repro/models/rglru.py`.

Gated diagonal linear recurrence
    r_t = σ(W_a x_t + b_a)          (recurrence gate)
    i_t = σ(W_i x_t + b_i)          (input gate)
    log a_t = −c · r_t · softplus(Λ)            (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

No-cache path: a log-depth (Hillis–Steele) scan over (a, b) pairs in
fp32, where the reference runs `jax.lax.associative_scan`.  Cache path:
one recurrence step per token over a (B, rnn_width) state, as the
reference's `lax.scan`; it writes the states into the cache's own
tensors, so a captured decode step replays over fixed buffers.

Block structure (Griffin recurrent block): two branches from the input —
a GeLU gate branch and a conv1d → RG-LRU branch — merged multiplicatively
and projected back to d_model.

On a (data, model) mesh the recurrence's channels ("rnn") are cut over
"model": each rank runs the gate and x branches, the depthwise conv and
the recurrence on its own channels (its blocks of the 1-D leaves), so
the cache's states are the rank's shards as they stand.  `w_a` and `w_i`
are ("rnn", "rnn") and a mesh dim cuts one dim of a leaf, so only their
contraction dim is cut: each rank's product is a partial sum over the
channels, reduce-scattered back to the rank's own channels.  `w_out`
contracts over the channels, so its product is summed over "model".
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.activation import (current, on_model,
                                             psum_model, to_model, use,
                                             use_block)

from .config import ModelConfig
from .params import ParamDef
from .ssm import _causal_conv, _softplus

_C = 8.0


def rglru_defs(cfg: ModelConfig):
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "w_gate": ParamDef((d, w), ("embed", "rnn")),
        "w_x": ParamDef((d, w), ("embed", "rnn")),
        "conv_w": ParamDef((cfg.conv_width, w), ("conv", "rnn"), scale=0.5),
        "conv_b": ParamDef((w,), ("rnn",), init="zeros"),
        "w_a": ParamDef((w, w), ("rnn", "rnn"), scale=0.01),
        "b_a": ParamDef((w,), ("rnn",), init="zeros"),
        "w_i": ParamDef((w, w), ("rnn", "rnn"), scale=0.01),
        "b_i": ParamDef((w,), ("rnn",), init="zeros"),
        "lam": ParamDef((w,), ("rnn",), init="ones"),
        "w_out": ParamDef((w, d), ("rnn", "embed")),
    }


def _gate_in(p, name: str, xr) -> torch.Tensor:
    """xr @ w (w a ("rnn", "rnn") leaf): with its rows cut over "model" a
    partial sum, reduce-scattered to this rank's channels."""
    y = xr @ use(p[name]).float()
    if on_model(p[name], 0):
        y = current().reduce_scatter(y, -1, "model")
    return y


def _gates(p, xr, cut: bool = False):
    """a_t and the gated input b_t.  xr: (B,S,W) fp32 (this rank's
    channels when `cut`)."""
    r = torch.sigmoid(_gate_in(p, "w_a", xr)
                      + use_block(p["b_a"], 0, cut).float())
    i = torch.sigmoid(_gate_in(p, "w_i", xr)
                      + use_block(p["b_i"], 0, cut).float())
    log_a = -_C * r * _softplus(use_block(p["lam"], 0, cut).float())
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xr)
    return a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t−1} + b_t from h_{−1} = 0, over dim 1, in ⌈log2 S⌉
    doubling steps: after the step of offset d each position holds the
    composition of the d·2 pairs ending there (the pair (a1, b1) then
    (a2, b2) composes to (a2 a1, a2 b1 + b2))."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_cache_shape(cfg: ModelConfig, batch: int):
    """Decode cache: (conv_state (B,W−1,rnn), h_state (B,rnn)) shapes."""
    return ((batch, cfg.conv_width - 1, cfg.rnn_width),
            (batch, cfg.rnn_width))


def rglru_block(p, x, cfg: ModelConfig, cache: Tuple = None):
    """x: (B,S,D) → ((B,S,D), cache).  cache=None → the log-depth scan;
    else the step loop, the cache's states overwritten in place."""
    cd = cfg.cdtype
    cut = on_model(p["w_x"], 1)
    x = to_model(x, p["w_x"], 1)
    gate = F.gelu(x @ use(p["w_gate"]).to(cd), approximate="tanh")
    xr = x @ use(p["w_x"]).to(cd)
    xr, tail = _causal_conv(xr, use(p["conv_w"]).to(cd),
                            use_block(p["conv_b"], 0, cut).to(cd),
                            None if cache is None else cache[0])
    a, b = _gates(p, xr.float(), cut)

    if cache is None:
        h = linear_scan(a, b)
    else:
        hs = cache[1].float()
        hh = []
        for t in range(a.shape[1]):
            hs = a[:, t] * hs + b[:, t]
            hh.append(hs)
        h = torch.stack(hh, dim=1)
        cache[0].copy_(tail)
        cache[1].copy_(hs)

    y = (gate.float() * h).to(cd) @ use(p["w_out"]).to(cd)
    return psum_model(y, p["w_out"], 0), cache
