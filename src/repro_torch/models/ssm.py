"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) — counterpart
of `repro/models/ssm.py`.

No-cache path (`ssd_train`): the chunked SSD algorithm, an intra-chunk
quadratic attention-like term and an inter-chunk state recurrence; O(S·Q)
time with chunk Q, constant state.  Cache path (`ssd_decode`): the O(1)
per-token recurrence over a (H, P, N) state, one step per new token; as
in the reference, the prefill takes it too (it passes a cache).  The
decode path writes its states into the cache's own tensors, so a captured
decode step replays over fixed buffers.

Shapes: d_inner = H·P (H = ssm_heads, P = ssm_head_dim), N = ssm_state,
conv_dim = d_inner + 2N (x, B and C all pass the causal conv).

On a (data, model) mesh `in_proj`'s output dim ("ssm_inner": the z, xBC
and dt segments side by side) is cut in contiguous blocks over "model",
which mix the segments.  So each rank computes its block, the blocks are
gathered whole, and the conv, the scan and the gated norm run whole on
every model rank (the conv weight gathered likewise, the cache's states
read whole and written back as the rank's shards); `out_proj`, whose
rows are cut over "model", takes the rank's block of the normed output
and its product is summed over the model ranks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.roofline.trace import scan_steps
from repro_torch.sharding.activation import (current, model_part,
                                             on_model, psum_model, to_model,
                                             use, use_whole)

from .config import ModelConfig
from .layers import cache_store, cache_view
from .params import ParamDef


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, conv_dim


def ssm_defs(cfg: ModelConfig):
    d = cfg.d_model
    h, n = cfg.ssm_heads, cfg.ssm_state
    d_inner, conv_dim = _dims(cfg)
    d_proj = 2 * d_inner + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": ParamDef((d, d_proj), ("embed", "ssm_inner")),
        "conv_w": ParamDef((cfg.conv_width, conv_dim), ("conv", "ssm_inner"),
                           scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="ones"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamDef((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((d_inner, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B,S,C), w: (W,C).  state: (B,W−1,C) tail
    of the previous segment (decode); returns (silu(y), new tail)."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else None
    return F.silu(y + b[None, None, :]), new_state


def _softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split(p, x, cfg: ModelConfig):
    d_inner, _ = _dims(cfg)
    n, h = cfg.ssm_state, cfg.ssm_heads
    zxbcdt = to_model(x, p["in_proj"], 1) @ use(p["in_proj"]).to(cfg.cdtype)
    if on_model(p["in_proj"], 1):
        zxbcdt = current().gather(zxbcdt, -1, "model")
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)
    return z, xbc, dt


def _post(p, y, z, cfg: ModelConfig):
    """Gated RMSNorm + out projection.  y, z: (B,S,d_inner)."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * use_whole(p["norm"], 0).float()
    cut = on_model(p["out_proj"], 0)
    y = model_part(y.to(cfg.cdtype), -1, cut)
    return psum_model(y @ use(p["out_proj"]).to(cfg.cdtype), p["out_proj"], 0)


def _conv_split(p, xbc, cfg: ModelConfig, state=None):
    """The causal conv over x, B, C, then split: (xs, B, C, new tail)."""
    d_inner, _ = _dims(cfg)
    cd = cfg.cdtype
    xbc, tail = _causal_conv(xbc, use_whole(p["conv_w"], 1).to(cd),
                             use_whole(p["conv_b"], 0).to(cd), state)
    xs, bm, cm = torch.split(xbc, [d_inner, cfg.ssm_state, cfg.ssm_state],
                             dim=-1)
    return xs, bm, cm, tail


def _dt_and_a(p, dt_raw):
    """softplus(dt + bias) (B,S,H) and the negative decay rates a (H,)."""
    dt = _softplus(dt_raw.float() + use_whole(p["dt_bias"], 0).float())
    return dt, -torch.exp(use_whole(p["a_log"], 0).float())


def ssd_train(p, x, cfg: ModelConfig):
    """Chunked SSD forward.  x: (B,S,D) → (B,S,D)."""
    b, s0, d = x.shape
    h, n, pd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s0)
    s = -(-s0 // q) * q
    if s != s0:  # causal: zero-pad the tail, slice it off at the end
        x = F.pad(x, (0, 0, 0, s - s0))
    nc = s // q
    d_inner, _ = _dims(cfg)

    z, xbc, dt_raw = _split(p, x, cfg)
    xs, bmat, cmat, _ = _conv_split(p, xbc, cfg)
    xs = xs.reshape(b, nc, q, h, pd).float()
    bm = bmat.reshape(b, nc, q, n).float()
    cm = cmat.reshape(b, nc, q, n).float()
    dt, a = _dt_and_a(p, dt_raw)
    dt = dt.reshape(b, nc, q, h)
    da = dt * a                                       # (b,nc,q,h)
    cum = torch.cumsum(da, dim=2)                     # within-chunk cumsum

    # intra-chunk (the "attention-like" quadratic term):
    # L[i,j] = exp(cum_i − cum_j) for i ≥ j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,nc,i,j,h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask in log space BEFORE exp: the i<j half has seg>0 and would
    # overflow
    seg = torch.where(tri[None, None, :, :, None], seg,
                      torch.full((), -torch.inf, device=x.device))
    l_mat = torch.exp(seg)
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)              # (b,nc,i,j)
    # the scalar factors folded into one (b,nc,i,j,h) gate before xs, as
    # in the reference (no (b,nc,i,j,h,p) intermediate)
    gate = cb[..., None] * l_mat * dt[:, :, None, :, :]       # (b,nc,i,j,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", gate, xs)

    # chunk summary states and the inter-chunk recurrence
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)            # (b,nc,q,h)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                          decay_out * dt, bm, xs)             # (b,nc,h,p,n)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (b,nc,h)
    carry = torch.zeros((b, h, pd, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):  # the state *before* each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                           # (b,nc,h,p,n)

    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cm, prev, torch.exp(cum))
    y = y_diag + y_off + use_whole(p["d_skip"], 0).float()[
        None, None, None, :, None] * xs
    y = y.reshape(b, s, d_inner)[:, :s0]
    return _post(p, y, z[:, :s0], cfg)


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    """Decode cache: (conv_state, ssm_state) shapes."""
    _, conv_dim = _dims(cfg)
    return (
        (batch, cfg.conv_width - 1, conv_dim),
        (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
    )


def ssd_decode(p, x, cache: Tuple, cfg: ModelConfig):
    """The recurrence over S new tokens (S = 1 in steady decode; the
    prompt's length in a prefill).

    cache: (conv_state (B,W−1,conv_dim), ssm_state (B,H,P,N)), both
    overwritten in place with the states after the last token.  Returns
    (y (B,S,D), cache).
    """
    b, s, d = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    d_inner, _ = _dims(cfg)
    conv_local, ssm_local = cache
    # on a mesh: the states whole but for their batch cut
    conv_state, ssm_state = cache_view(conv_local, ()), \
        cache_view(ssm_local, ())

    z, xbc, dt_raw = _split(p, x, cfg)
    xs, bm, cm, tail = _conv_split(p, xbc, cfg, conv_state)
    xs = xs.reshape(b, s, h, pd).float()
    bm, cm = bm.float(), cm.float()
    dt, a = _dt_and_a(p, dt_raw)                      # (b,s,h), (h,)

    def token(st, t):
        dt_t = dt[:, t]                                         # (b,h)
        decay = torch.exp(dt_t * a[None, :])
        upd = (dt_t[:, :, None, None] * bm[:, t, None, None, :]
               * xs[:, t, :, :, None])                          # (b,h,p,n)
        st = st * decay[:, :, None, None] + upd
        return st, torch.einsum("bn,bhpn->bhp", cm[:, t], st)

    st, y = scan_steps(token, ssm_state.float(), s)             # (b,s,h,p)
    y = y + use_whole(p["d_skip"], 0).float()[None, None, :, None] * xs
    y = y.reshape(b, s, d_inner)
    conv_state.copy_(tail)
    ssm_state.copy_(st)
    cache_store(conv_local, conv_state, ())
    cache_store(ssm_local, ssm_state, ())
    return _post(p, y, z, cfg), cache
