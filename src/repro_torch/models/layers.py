"""Shared transformer layers — counterpart of `repro/models/layers.py`.

Functions of (params, x, cfg, ...) → y as in the reference; `p` is a
`ParamTree` read like the reference's dict.  Under
`sharding/activation.py:activation_sharding` (one rank of an LM serving
mesh) `p` holds local shards and the layers run the collectives where
GSPMD places them: each parameter gathered over "data" where it is used,
the heads and the FFN cut over "model" (the products over them summed),
a KV projection cut over its head dim gathered whole, and a KV cache
cut over its time or head dim gathered for the step and written back to
the rank's shard.  The reference's `constrain` points are kept.  Outside
it every one of those is the identity.

Attention implementations (cfg.attn_impl), dispatched under the
reference's three conditions (`attention` below):
  full    — materialized scores.
  chunked — online softmax over KV chunks in plain PyTorch, GQA grouped
            so repeated KV is never materialized.
  pallas  — the hand-written CUDA kernel (`kernels/flash_attention.py`),
            taken only without a KV cache: the encoder's self-attention
            (with an int position offset) and the cross-attention of an
            encoder–decoder model; on the CPU the kernel's plain
            version.

`moe` is the reference's grouped top-k MoE with capacity.  On a mesh it
is expert parallel, as the reference's dataflow: the router's logits are
gathered whole over the experts (softmax and top-k see every expert),
each model rank dispatches to its own experts only, and the token-space
combine is summed over "model".

Under autograd (the train step) the same code runs with the moves'
adjoints (`sharding/activation.py`): the input of every product cut over
"model" (`to_model`) sums its gradient over the model ranks, so every
tensor a rank holds carries its whole gradient.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.activation import (constrain, current, held_of,
                                             hold, is_model, model_part,
                                             on_model, psum_model, to_model,
                                             use)

from .config import ModelConfig
from .params import ParamDef

_NEG = -1e30


# ---------------------------------------------------------------- norms ----
def rmsnorm_defs(d: int):
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + use(p["scale"]).float())).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (B, S, H, dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freq[None, :]   # (S, half)
        ang = ang[None, :, None, :]                        # (1,S,1,half)
    else:
        ang = positions[..., None].float() * freq          # (B,S,half)
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def padded_heads(cfg: ModelConfig) -> int:
    """Query-head count including the reference's TP padding
    (cfg.head_pad); padded heads carry zero-masked outputs."""
    return max(cfg.n_heads, cfg.head_pad or 0)


def attention_defs(cfg: ModelConfig, cross: bool = False):
    d, k, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    h = padded_heads(cfg)
    defs = {
        "wq": ParamDef((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, k, dh), ("embed", "kv_heads", "kv_head_dim")),
        "wv": ParamDef((d, k, dh), ("embed", "kv_heads", "kv_head_dim")),
        "wo": ParamDef((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs |= {
            "bq": ParamDef((h, dh), ("heads", "head_dim"), init="zeros"),
            "bk": ParamDef((k, dh), ("kv_heads", "kv_head_dim"), init="zeros"),
            "bv": ParamDef((k, dh), ("kv_heads", "kv_head_dim"), init="zeros"),
        }
    return defs


def _grouped(q, h_kv):
    """(B,S,H,dh) → (B,S,K,G,dh): group query heads by their kv head."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, h_kv, h // h_kv, dh)


def _mask(qpos, kpos, causal, window, kv_len):
    """(…Sq, Sk) boolean mask from position vectors."""
    m = (kpos[None, :] < kv_len).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _scores(qf, k, scale, softcap):
    """fp32 scores (B,K,G,S,T) of grouped q (B,S,K,G,dh) over k (B,T,K,dh)."""
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _attn_full(q, k, v, *, scale, causal, window, softcap, qpos, kv_len,
               kpos_vec=None):
    # q: (B,S,K,G,dh); k/v: (B,T,K,dh)
    s = _scores(q.float(), k, scale, softcap)
    kpos = (torch.arange(k.shape[1], device=k.device) if kpos_vec is None
            else kpos_vec)
    m = _mask(qpos, kpos, causal, window, kv_len)
    s = torch.where(m, s, torch.full((), _NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float())


def _attn_chunked(q, k, v, *, scale, causal, window, softcap, qpos, kv_len,
                  chunk, kpos_vec=None):
    """Online softmax over KV chunks (the flash dataflow in PyTorch)."""
    b, sq, hk, g, dh = q.shape
    t = k.shape[1]
    chunk = min(chunk, t)
    qf = q.float()
    acc = torch.zeros((b, hk, g, sq, dh), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hk, g, sq), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=q.device)
    neg = torch.full((), _NEG, device=q.device)
    for c0 in range(0, t, chunk):
        # the reference pads the last chunk to full width; its padded
        # keys are masked and add exp(-1e30 - m) = 0, so a narrower last
        # chunk gives the same sums
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _scores(qf, k_c, scale, softcap)
        kpos = (torch.arange(c0, c0 + k_c.shape[1], device=q.device)
                if kpos_vec is None else kpos_vec[c0:c0 + chunk])
        msk = _mask(qpos, kpos, causal, window, kv_len)
        s = torch.where(msk, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, v_c.float())
        m = m_new
    out = acc / (l[..., None] + 1e-30)           # (B,K,G,S,dh)
    return out.permute(0, 3, 1, 2, 4)            # (B,S,K,G,dh)


def _attn_pallas(q, k, v, *, scale, causal, window, softcap, q_offset):
    from repro_torch.kernels import ops as kops

    b, sq, hk, g, dh = q.shape
    t = k.shape[1]
    # expand kv to one per q head; flatten (B,K,G) into the kernel batch
    kx = k[:, :, :, None].expand(b, t, hk, g, dh)
    vx = v[:, :, :, None].expand(b, t, hk, g, dh)
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * hk * g, sq, dh).contiguous()
    kf = kx.permute(0, 2, 3, 1, 4).reshape(b * hk * g, t, dh).contiguous()
    vf = vx.permute(0, 2, 3, 1, 4).reshape(b * hk * g, t, dh).contiguous()
    o = kops.flash_attention(qf, kf, vf, causal=causal, scale=scale,
                             q_offset=q_offset, window=window,
                             softcap=softcap)
    return o.reshape(b, hk, g, sq, dh).permute(0, 3, 1, 2, 4)


def _cache_want(held, keep=(2,)):
    """The layout a cache leaf is read in for a step: its batch cut and
    the "model" cuts of the dims in `keep` kept (a KV cache's kv heads),
    every other cut gathered."""
    return (held[0],) + tuple(
        h if d in keep and is_model(h) else None
        for d, h in enumerate(held) if d > 0)


def cache_view(t: torch.Tensor, keep=(2,)) -> torch.Tensor:
    """A cache leaf in the layout a step computes in (`_cache_want`): the
    local shard itself when nothing else is cut."""
    ctx, held = current(), held_of(t)
    if ctx is None or held is None:
        return t
    return ctx.reshard(t, held, _cache_want(held, keep))


def cache_store(local: torch.Tensor, view: torch.Tensor,
                keep=(2,)) -> None:
    """Write the rank's shard of a step's cache view back (nothing when the
    view is the shard)."""
    if view is not local:
        held = held_of(local)
        local.copy_(current().reshard(view, _cache_want(held, keep), held))


def _as_cache(t: torch.Tensor, held_now) -> torch.Tensor:
    """A whole-time (B, T, K, dh) projection as a cache leaf: the rank's
    shard under the cache spec of its global shape, marked with it."""
    ctx = current()
    if ctx is None or ctx.cache_spec is None:  # no cache kept (training)
        return t
    spec = ctx.cache_spec(ctx.global_shape(t, held_now))
    return hold(ctx.reshard(t, held_now, spec).contiguous(), spec)


def _kv_for_heads(k, v, h_loc: int, h0: int, cfg: ModelConfig):
    """k, v (B, T, K', dh) narrowed to the kv heads of this rank's query
    heads h0 … h0 + h_loc − 1 (query head h reads kv head h // G).  Returns
    (k, v) with h_loc a multiple of their head count, heads in order."""
    g = padded_heads(cfg) // cfg.n_kv_heads
    if k.shape[2] * g == h_loc:  # the rank's kv heads are its groups'
        return k, v
    # k and v are whole over "model" and each rank reads its heads' part:
    # their gradients are summed over the model ranks
    k, v = current().to_model(k), current().to_model(v)
    idx = torch.div(h0 + torch.arange(h_loc, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def attention(p, x, cfg: ModelConfig, *, kind: str = "attn",
              pos_offset=0, kv_cache: Optional[Tuple] = None,
              cache_len=None, kv_source: Optional[torch.Tensor] = None,
              static_kv: Optional[Tuple] = None, causal: bool = True):
    """GQA attention.  x: (B, S, D) → (out (B, S, D), new kv_cache).

    kind: 'attn'/'global' = full causal; 'local' = sliding window.
    Scores scale by cfg.attention_multiplier (head_dim^-0.5 at its
    default 0); with cfg.use_rope False q and k are not rotated (NoPE).
    kv_cache: optional (k, v) buffers (B, T, K, dh) — decode path: new kv
      written at positions [cache_len, cache_len+S), in place (the
      counterpart of the reference's donated buffers).  cache_len is a
      Python int or a 0-d int tensor on x's device; either way no device
      value is read, so a decode step can be captured as a CUDA graph.
    kv_source: cross-attention source (encoder output); no cache, no rope;
      the computed (k, v) is returned so prefill can cache it.
    static_kv: precomputed (k, v) to attend over read-only (cross-attn at
      decode: the cached encoder projections are never rewritten).
    """
    b, s, d = x.shape
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    h = padded_heads(cfg)
    cd = cfg.cdtype
    dev = x.device
    ctx = current()
    xq = to_model(x, p["wq"], 1)
    q = torch.einsum("bsd,dhe->bshe", xq, use(p["wq"]).to(cd))
    h_loc = q.shape[2]  # this rank's query heads: h0 … h0 + h_loc − 1
    h0 = ctx.model_index() * h_loc if on_model(p["wq"], 1) else 0
    is_cross = kv_source is not None or static_kv is not None
    if static_kv is not None:
        k, v = (cache_view(t) for t in static_kv)
    else:
        src = x if kv_source is None else kv_source
        if on_model(p["wk"], 1) or on_model(p["wk"], 2):
            # column-parallel: the kv heads (or their dims) cut over "model"
            src = xq if src is x and xq is not x else \
                current().to_model(src)
        k = torch.einsum("bsd,dhe->bshe", src, use(p["wk"]).to(cd))
        v = torch.einsum("bsd,dhe->bshe", src, use(p["wv"]).to(cd))
    if cfg.qkv_bias:
        q = q + use(p["bq"]).to(cd)
        if static_kv is None:
            k = k + use(p["bk"]).to(cd)
            v = v + use(p["bv"]).to(cd)
    kv_held = None
    if ctx is not None and static_kv is None:
        # kv heads the model dim does not divide: the projection is cut
        # over its head dim, gathered whole before rope and the cache
        kv_held = (ctx.batch_entry, None,
                   "model" if on_model(p["wk"], 1) else None,
                   "model" if on_model(p["wk"], 2) else None)
        k = constrain(k, ("batch", None, "model", None), kv_held)
        v = constrain(v, ("batch", None, "model", None), kv_held)
        kv_held = kv_held[:3] + (None,)

    if not is_cross:
        qpos_vec = pos_offset + torch.arange(s, device=dev)
        if cfg.use_rope:
            q = rope(q, qpos_vec, cfg.rope_theta)
            k = rope(k, qpos_vec, cfg.rope_theta)

    kpos_vec = None
    if is_cross:
        # prefill caches the encoder projections (the rank's shards)
        new_cache = ((k, v) if kv_held is None else
                     (_as_cache(k, kv_held), _as_cache(v, kv_held)))
        kv_len = k.shape[1]
        qpos = torch.arange(s, device=dev)
    elif kv_cache is not None:
        ck_local, cv_local = kv_cache
        ck, cv = cache_view(ck_local), cache_view(cv_local)
        w_buf = ck.shape[1]
        ring = (kind == "local" and cfg.local_window is not None
                and w_buf == cfg.local_window)
        if ring:
            # ring buffer for sliding-window layers: the cache holds only
            # the last `window` keys (slot = pos % W).  Decode attends
            # over the ring with reconstructed absolute positions; the
            # window mask kills unwritten/evicted slots.  Prefill writes
            # the ring (wrapping) but attends over the in-flight k/v.
            pos = cache_len + torch.arange(s, device=dev)
            slots = pos % w_buf
            # write only the last ≤W keys: earlier ones would be
            # overwritten in the same write
            tail = max(s - w_buf, 0)
            ck[:, slots[tail:]] = k[:, tail:].to(ck.dtype)
            cv[:, slots[tail:]] = v[:, tail:].to(cv.dtype)
            new_cache = (ck_local, cv_local)
            qpos = cache_len + torch.arange(s, device=dev)
            if s == 1:
                j = torch.arange(w_buf, device=dev)
                last = cache_len  # abs position of the newest token
                pabs = last - torch.remainder(last - j, w_buf)
                written = (j <= last) | (last + 1 >= w_buf)
                kpos_vec = torch.where(
                    written, pabs, torch.full((), -1_000_000_000,
                                              device=dev))
                k, v = ck, cv
                kv_len = cache_len + 1  # upper bound; mask uses kpos_vec
            else:
                kv_len = cache_len + s  # attend in-flight (prefill)
        else:
            pos = cache_len + torch.arange(s, device=dev)
            ck.index_copy_(1, pos, k.to(ck.dtype))
            cv.index_copy_(1, pos, v.to(cv.dtype))
            k, v = ck, cv
            new_cache = (ck_local, cv_local)
            kv_len = cache_len + s
            qpos = cache_len + torch.arange(s, device=dev)
    else:
        new_cache = None
        kv_len = k.shape[1]
        qpos = qpos_vec

    if kv_cache is not None and not is_cross:
        cache_store(ck_local, ck)
        cache_store(cv_local, cv)
    k, v = _kv_for_heads(k, v, h_loc, h0, cfg)
    qg = _grouped(q, k.shape[2])
    scale = cfg.attention_multiplier or dh ** -0.5
    window = cfg.local_window if kind == "local" else None
    softcap = cfg.attn_softcap
    causal = causal and not is_cross

    impl = cfg.attn_impl
    # the kernel takes its causal offset from the host: a self-attention
    # with a device-tensor offset takes the chunked route; cross-attention
    # reads no offset, so it keeps the kernel whatever pos_offset is
    if impl == "pallas" and kv_cache is None and (
            is_cross or isinstance(pos_offset, int)):
        out = _attn_pallas(qg, k, v, scale=scale, causal=causal,
                           window=window, softcap=softcap,
                           q_offset=0 if is_cross else pos_offset)
    elif impl == "full":
        out = _attn_full(qg, k, v, scale=scale, causal=causal, window=window,
                         softcap=softcap, qpos=qpos, kv_len=kv_len,
                         kpos_vec=kpos_vec)
    else:
        out = _attn_chunked(qg, k, v, scale=scale, causal=causal,
                            window=window, softcap=softcap, qpos=qpos,
                            kv_len=kv_len, chunk=cfg.attn_chunk,
                            kpos_vec=kpos_vec)
    out = out.reshape(b, s, h_loc, dh)
    if h > cfg.n_heads:
        # zero the TP-padding heads (grouped layout: the first
        # n_heads//n_kv_heads slots of each kv group are the real heads)
        g_real = cfg.n_heads // hk
        heads = h0 + torch.arange(h_loc, device=dev)
        hmask = torch.remainder(heads, h // hk) < g_real
        out = out * hmask[None, None, :, None].to(out.dtype)
    out = out.to(cd)
    y = torch.einsum("bshe,hed->bsd", out, use(p["wo"]).to(cd))
    return psum_model(y, p["wo"], 0), new_cache


# ------------------------------------------------------------------ mlp ----
def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None, gated: bool = True):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {
        "w1": ParamDef((d, f), ("embed", "ffn")),
        "w2": ParamDef((f, d), ("ffn", "embed")),
    }
    if gated:
        defs["w3"] = ParamDef((d, f), ("embed", "ffn"))
    return defs


def _act(x, name):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if name == "gelu" else F.silu(x)


def mlp(p, x, cfg: ModelConfig):
    cd = cfg.cdtype
    x = to_model(x, p["w1"], 1)
    h = _act(x @ use(p["w1"]).to(cd), cfg.act)
    if "w3" in p:
        h = h * (x @ use(p["w3"]).to(cd))
    ctx = current()
    if ctx is not None:
        h = constrain(h, ("batch",) + (None,) * (h.dim() - 2) + ("model",),
                      (ctx.batch_entry,) + (None,) * (h.dim() - 2)
                      + ("model" if on_model(p["w1"], 1) else None,))
    return psum_model(h @ use(p["w2"]).to(cd), p["w2"], 0)


# ------------------------------------------------------------------ moe ----
def padded_experts(cfg: ModelConfig) -> int:
    """Expert count including EP padding (cfg.expert_pad; router-masked)."""
    return max(cfg.n_experts, cfg.expert_pad or 0)


def moe_defs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_expert
    e = padded_experts(cfg)
    defs = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "w1": ParamDef((e, d, f), ("experts", "embed", "expert_ffn")),
        "w2": ParamDef((e, f, d), ("experts", "expert_ffn", "embed")),
        "w3": ParamDef((e, d, f), ("experts", "embed", "expert_ffn")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg,
                                  d_ff=cfg.n_shared_experts * cfg.d_expert)
    return defs


def moe_groups(n: int, cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, group size, capacity) for n tokens: the group size is the
    largest divisor of n that fits cfg.moe_group_size; the capacity is
    sized by the REAL expert count (padded experts receive no tokens and
    must not dilute it), at least 4, a multiple of 4 and at most the
    group size."""
    gs = min(cfg.moe_group_size, n)
    while n % gs:
        gs -= 1
    cap = int(math.ceil(gs * cfg.experts_per_token * cfg.capacity_factor
                        / cfg.n_experts))
    cap = min(max(4, -(-cap // 4) * 4), gs)
    return n // gs, gs, cap


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of integer-valued `idx` by comparison with an arange
    (`F.one_hot` reads its indices back to check them, which a captured
    step cannot do); an index outside [0, n) gives a zero row, as
    `jax.nn.one_hot`."""
    return (idx[..., None] == torch.arange(n, device=idx.device,
                                           dtype=idx.dtype)).float()


def moe_route(p, xt: torch.Tensor, cfg: ModelConfig, cap: int) -> dict:
    """The routing of grouped tokens xt (g, gs, D), as the reference
    routes them: router logits in the compute dtype, padded experts
    masked to -1e30, an fp32 softmax, the top k renormalised.  Ties go to
    the lower expert index, as `jax.lax.top_k` breaks them (a stable
    descending sort; `torch.topk` promises no order among ties on CUDA).
    Each (token, choice) takes its place in its expert's queue by an
    exclusive cumsum in (s-major, k-minor) order and is kept when that
    place is below `cap`.

    On a mesh whose "model" dim cuts the experts, each rank's logits for
    its experts are gathered whole (an exact concatenation), so every
    rank routes every token alike.  Inside `record_routes` each call's
    topi and keep are appended to its list.

    Returns probs (g, gs, E), topv and topi (g, gs, k), onehot, pos and
    keep (g, gs, k, E), all fp32 but topi."""
    e, k = padded_experts(cfg), cfg.experts_per_token
    g, gs, _ = xt.shape
    logits = to_model(xt, p["router"], 1) @ use(p["router"]).to(cfg.cdtype)
    if on_model(p["router"], 1):
        logits = current().gather(logits, 2, "model")
    if e > cfg.n_experts:   # EP padding: fake experts are never routed
        emask = torch.arange(e, device=xt.device) < cfg.n_experts
        logits = torch.where(emask, logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=xt.device))
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :k], idx[..., :k]
    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    onehot = _one_hot(topi, e)                                # (g, gs, k, e)
    flat = onehot.reshape(g, gs * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, gs, k, e)
    keep = onehot * (pos < cap)
    if _ROUTES is not None:
        _ROUTES.append((topi.detach().clone(), keep.detach().clone()))
    return {"probs": probs, "topv": topv, "topi": topi, "onehot": onehot,
            "pos": pos, "keep": keep}


def moe(p, x, cfg: ModelConfig):
    """GShard-style grouped top-k MoE with capacity.  x: (B,S,D) → (y, aux).

    Tokens are split into groups (`moe_groups`), routed within each group
    (`moe_route`), and dispatched to and combined from the experts by
    dense einsums over (E, cap), as in the reference.  aux is the Switch
    load-balance loss over the real experts.

    On a mesh the groups are the reference's, made from the global batch:
    when they fall within a rank's rows the rank routes its own groups;
    when a group spans the ranks of the batch dims, the ranks' tokens are
    gathered, every rank runs every group and keeps its rows.  With the
    experts cut over "model" each rank runs its own experts and the
    combine is summed over the model ranks.
    """
    b, s, d = x.shape
    ctx = current()
    rows = 1 if ctx is None else ctx.size(ctx.batch_entry)
    _, gs, cap = moe_groups(b * s * rows, cfg)
    spans = rows > 1 and (b * s) % gs != 0
    if spans:  # a group spans the batch ranks: route the whole batch
        x = _GatherRows.apply(x, ctx)
        b = x.shape[0]
    y, aux = _moe_groups(p, x.reshape(b * s // gs, gs, d), cfg, cap)
    y = y.reshape(b, s, d)
    if spans:
        y = _TakeRows.apply(y, ctx)
    return y, aux


def _moe_groups(p, xt, cfg: ModelConfig, cap: int):
    """The MoE over grouped tokens xt (g, gs, D) → (y (g, gs, D), aux)."""
    cd = cfg.cdtype
    r = moe_route(p, xt, cfg, cap)
    gate = r["topv"][..., None] * r["keep"]                   # (g, gs, k, e)
    # Each (token, expert) pair is chosen by at most one k-slot, so the
    # k axis folds out BEFORE the cap one-hot, as in the reference: the
    # (g, gs, k, e, cap) dispatch tensor would be k times larger.
    gate_e = torch.sum(gate, dim=2)                           # (g, gs, e)
    pos_e = torch.sum(r["pos"] * r["keep"], dim=2)            # (g, gs, e)
    sel_e = torch.sum(r["keep"], dim=2)                       # (g, gs, e) 0/1
    pos_oh = _one_hot(pos_e, cap) * sel_e[..., None]          # (g, gs, e, cap)
    combine = (gate_e[..., None] * pos_oh).to(cd)
    dispatch = pos_oh.to(cd)

    # expert parallel: this model rank's experts only, the combine summed
    # over "model" (the reference's EP dataflow)
    ep = on_model(p["w1"], 0)
    combine = model_part(combine, 2, ep)
    dispatch = model_part(dispatch, 2, ep)
    xe = to_model(xt, p["w1"], 0)
    xin = torch.einsum("gsec,gsd->gecd", dispatch, xe)        # (g, e, cap, d)
    h = _act(torch.einsum("gecd,edf->gecf", xin, use(p["w1"]).to(cd)),
             cfg.act)
    h = h * torch.einsum("gecd,edf->gecf", xin, use(p["w3"]).to(cd))
    xout = torch.einsum("gecf,efd->gecd", h, use(p["w2"]).to(cd))
    y = psum_model(torch.einsum("gsec,gecd->gsd", combine, xout),
                   p["w2"], 0)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt, cfg)

    # load-balance aux loss (Switch): e·Σ_e f_e·P_e (real expert count;
    # padded experts have f = P = 0)
    frac_tokens = torch.mean(r["onehot"].sum(2), dim=1)       # (g, e)
    frac_probs = torch.mean(r["probs"], dim=1)                # (g, e)
    aux = cfg.n_experts * torch.mean(torch.sum(frac_tokens * frac_probs,
                                               dim=-1))
    return y, aux


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of x (B_local, ...) gathered over the batch dims
    (adjoint: the gradients of the whole batch summed over those ranks,
    this rank's rows kept)."""

    @staticmethod
    def forward(ctx_, x, shards):
        ctx_.shards = shards
        return shards._all_gather(x, 0, shards.batch_entry)

    @staticmethod
    def backward(ctx_, g):
        s = ctx_.shards
        return s._reduce_scatter(g, 0, s.batch_entry), None


class _TakeRows(torch.autograd.Function):
    """This rank's rows of a tensor every batch rank computed whole
    (adjoint: the gradient of those rows, zero elsewhere)."""

    @staticmethod
    def forward(ctx_, y, shards):
        ctx_.shards, ctx_.shape = shards, y.shape
        return shards._part(y, 0, shards.batch_entry).clone()

    @staticmethod
    def backward(ctx_, g):
        s = ctx_.shards
        _, n, i = s.role(s.batch_entry)
        out = g.new_zeros(ctx_.shape)
        out.narrow(0, i * g.shape[0], g.shape[0]).copy_(g)
        return out, None


_ROUTES = None


@contextlib.contextmanager
def record_routes():
    """Collect every `moe_route` call's (topi, keep) in the yielded list
    (the routing decisions, for holding two runs to each other)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev
