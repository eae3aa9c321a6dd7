"""Model assembly — counterpart of `repro/models/transformer.py`.

One `Model` facade per ModelConfig provides:
  defs()            — declarative param tree (ParamDef leaves)
  init              — random parameters from a torch.Generator
  prefill / decode  — serving paths with per-family caches

Layers are grouped into super-blocks of the config's pattern period, as
in the reference (dense: 1, gemma2 local/global: 2).  Where the reference
stacks full super-blocks and drives them with `lax.scan`, the port keeps
one module per super-block in an `nn.ModuleList` and loops over them;
leftover layers ("tail") run after, as in the reference.  Caches mirror
the layer structure: a list of per-super-block dicts under "layers" and
a tuple under "tail", written in place by the decode step.

On this path the attention kernel runs in the encoder's self-attention
and in every cross-attention (prefill and decode); the decoder's
self-attention has a KV cache and takes the chunked route
(`layers.attention`).  Under `sharding/activation.py:activation_sharding`
the model runs as one rank of an LM serving mesh: the embedding looks
its tokens up in the rank's vocab rows (summed over "model"), the caches
are made as the rank's shards (`init_cache`) and the logits are gathered
whole over the vocab.  The training side (`lm_loss`, `loss_fn`), the SSM
and RG-LRU blocks and MoE are not ported yet (ROADMAP.md, queue 1 item
12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.activation import (constrain, current, hold,
                                             on_model, use)

from .config import ModelConfig
from .params import ParamDef, init_params, stack_defs
from . import layers as L

TODO = ("is not ported yet: ROADMAP.md, queue 1 item 12 (the port serves "
        "dense attention and encoder-decoder models)")


# ------------------------------------------------------------- defs ----
def _block_defs(cfg: ModelConfig, kind: str, cross: bool = False):
    if kind in ("ssm", "rglru"):
        raise NotImplementedError(f"the {kind} block {TODO}")
    if cfg.n_experts:
        raise NotImplementedError(f"the MoE block {TODO}")
    d: Dict[str, Any] = {
        "ln1": L.rmsnorm_defs(cfg.d_model),
        "attn": L.attention_defs(cfg),
        "ln2": L.rmsnorm_defs(cfg.d_model),
    }
    if cross:
        d["lnx"] = L.rmsnorm_defs(cfg.d_model)
        d["xattn"] = L.attention_defs(cfg)
    d["mlp"] = L.mlp_defs(cfg)
    return d


def _pattern(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    """(layer kinds, n_scan_superblocks, n_leftover_layers)."""
    kinds = cfg.layer_kinds()
    period = _period(cfg)
    if not cfg.scan_layers:
        return kinds, 0, cfg.n_layers
    n_scan = cfg.n_layers // period
    return kinds, n_scan, cfg.n_layers - n_scan * period


def _period(cfg: ModelConfig) -> int:
    return len(cfg.block_pattern) or cfg.global_every or 1


def model_defs(cfg: ModelConfig):
    kinds, n_scan, n_rest = _pattern(cfg)
    period = _period(cfg)
    cross = cfg.is_encdec
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=0.02),
        "final_norm": L.rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    if n_scan:
        sb = {f"k{j}": _block_defs(cfg, kinds[j], cross)
              for j in range(period)}
        defs["layers"] = stack_defs(sb, n_scan)
    if n_rest:
        defs["tail"] = tuple(
            _block_defs(cfg, kinds[n_scan * period + j], cross)
            for j in range(n_rest))
    if cfg.is_encdec:
        defs["enc_layers"] = stack_defs(_block_defs(cfg, "attn"),
                                        cfg.n_enc_layers)
        defs["enc_norm"] = L.rmsnorm_defs(cfg.d_model)
        defs["enc_pos"] = ParamDef((cfg.enc_context, cfg.d_model),
                                   ("enc", "embed"), scale=0.02)
    return defs


# ------------------------------------------------------------ caches ----
def _block_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                        max_len: int, cross: bool):
    if kind in ("ssm", "rglru"):
        raise NotImplementedError(f"the {kind} cache {TODO}")
    k, dh = cfg.n_kv_heads, cfg.head_dim
    # sliding-window layers keep a ring buffer of exactly `window` slots
    # (slot = pos % W — layers.attention); full-attention layers keep the
    # full-length buffer
    length = max_len
    if kind == "local" and cfg.local_window and cfg.local_window < max_len:
        length = cfg.local_window
    d = {"attn": ((batch, length, k, dh), (batch, length, k, dh))}
    if cross:
        d["xattn"] = ((batch, cfg.enc_context, k, dh),
                      (batch, cfg.enc_context, k, dh))
    return d


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Cache shapes mirroring the layer structure; every buffer has the
    compute dtype."""
    kinds, n_scan, n_rest = _pattern(cfg)
    period = _period(cfg)
    cross = cfg.is_encdec
    out: Dict[str, Any] = {}
    if n_scan:
        sb = {f"k{j}": _block_cache_shapes(cfg, kinds[j], batch, max_len,
                                           cross)
              for j in range(period)}
        out["layers"] = [sb] * n_scan
    if n_rest:
        out["tail"] = tuple(
            _block_cache_shapes(cfg, kinds[n_scan * period + j], batch,
                                max_len, cross)
            for j in range(n_rest))
    return out


def _zeros_like_shapes(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _zeros_like_shapes(v, dtype, device)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_shapes(v, dtype, device) for v in tree]
    if tree and isinstance(tree[0], int):  # one shape
        return torch.zeros(tree, dtype=dtype, device=device)
    return tuple(_zeros_like_shapes(v, dtype, device) for v in tree)


def _shard_leaves(tree, ctx):
    """Under a mesh, each cache leaf's global shape → (local shape, its
    cache spec)."""
    if isinstance(tree, dict):
        return {k: _shard_leaves(v, ctx) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_leaves(v, ctx) for v in tree]
    if tree and isinstance(tree[0], int):
        spec = ctx.cache_spec(tree)
        return ("leaf", ctx.local_shape(tree, spec), spec)
    return tuple(_shard_leaves(v, ctx) for v in tree)


def _zeros_of(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _zeros_of(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_of(v, dtype, device) for v in tree]
    if tree and tree[0] == "leaf":
        return hold(torch.zeros(tree[1], dtype=dtype, device=device),
                    tree[2])
    return tuple(_zeros_of(v, dtype, device) for v in tree)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """A zero cache for `batch` sequences; under a mesh `batch` is the
    rank's rows and each leaf is the rank's shard of the global cache
    (marked with its spec)."""
    ctx = current()
    if ctx is None:
        return _zeros_like_shapes(cache_shapes(cfg, batch, max_len),
                                  cfg.cdtype, device)
    shapes = cache_shapes(cfg, batch * ctx.size(ctx.batch_entry), max_len)
    return _zeros_of(_shard_leaves(shapes, ctx), cfg.cdtype, device)


# ----------------------------------------------------------- blocks ----
def _apply_block(p, x, cfg: ModelConfig, kind: str, *, cache=None,
                 cache_len=None, enc_out=None, pos_offset=0, causal=True):
    """One residual block.  Returns (x, new_cache)."""
    new_cache = dict(cache) if cache is not None else None
    h = constrain(L.rmsnorm(p["ln1"], x, cfg.norm_eps), ("batch", None, None))
    y, kvc = L.attention(
        p["attn"], h, cfg, kind=kind, pos_offset=pos_offset,
        kv_cache=cache["attn"] if cache is not None else None,
        cache_len=cache_len, causal=causal)
    if cache is not None:
        new_cache["attn"] = kvc
    x = x + y
    if "xattn" in p:
        h = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
        if enc_out is not None:
            # prefill: project encoder output and cache it
            y, xkv = L.attention(p["xattn"], h, cfg, kv_source=enc_out,
                                 causal=False)
            if cache is not None:
                new_cache["xattn"] = xkv
        else:
            # decode: attend read-only over the cached encoder projections
            y, _ = L.attention(p["xattn"], h, cfg,
                               static_kv=cache["xattn"], causal=False)
        x = x + y
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg), new_cache


def _superblock(p_sb, x, cfg, kinds_period, *, cache=None, cache_len=None,
                enc_out=None, pos_offset=0):
    new_cache = {} if cache is not None else None
    for j, kind in enumerate(kinds_period):
        key = f"k{j}"
        c = cache[key] if cache is not None else None
        x, nc = _apply_block(p_sb[key], x, cfg, kind, cache=c,
                             cache_len=cache_len, enc_out=enc_out,
                             pos_offset=pos_offset)
        if cache is not None:
            new_cache[key] = nc
    return x, new_cache


# ---------------------------------------------------------- forward ----
def forward(params, tokens, cfg: ModelConfig, *, prefix_embed=None,
            enc_frames=None, cache=None, cache_len=None):
    """Token ids → final hidden states.

    tokens: (B, S) int.  prefix_embed: (B, P, D) VLM patch stub —
    replaces the embeddings of the first P positions.  enc_frames:
    (B, T_enc, D) audio frame stub (whisper) — runs the encoder and
    cross-attends.  cache/cache_len: the serving path (cache_len a
    Python int, or a 0-d int tensor on the device for a step that reads
    nothing back to the host).  Returns (hidden (B,S,D), new_cache); the reference's
    third output, the MoE aux loss, has no source in the port.
    """
    kinds, n_scan, n_rest = _pattern(cfg)
    period = _period(cfg)
    cd = cfg.cdtype
    x = _embed(params["embed"], tokens).to(cd)
    x = constrain(x, ("batch", None, None))
    if prefix_embed is not None:
        pfx = prefix_embed.to(cd)
        x = torch.cat([pfx, x[:, pfx.shape[1]:]], dim=1)

    enc_out = None
    if cfg.is_encdec and enc_frames is not None:
        e = enc_frames.to(cd) + use(params["enc_pos"]).to(cd)[None]
        for p_layer in params["enc_layers"]:
            e, _ = _apply_block(p_layer, e, cfg, "attn", causal=False)
        enc_out = L.rmsnorm(params["enc_norm"], e, cfg.norm_eps)

    pos_offset = 0 if cache_len is None else cache_len
    kinds_period = tuple(kinds[:period])

    new_layers = []
    for i in range(n_scan):
        c_sb = cache["layers"][i] if cache is not None else None
        x, nc = _superblock(params["layers"][i], x, cfg, kinds_period,
                            cache=c_sb, cache_len=cache_len,
                            enc_out=enc_out, pos_offset=pos_offset)
        x = constrain(x, ("batch", None, None))
        new_layers.append(nc)

    new_tail = []
    for j in range(n_rest):
        kind = kinds[n_scan * period + j]
        c = cache["tail"][j] if cache is not None else None
        x, nc = _apply_block(params["tail"][j], x, cfg, kind, cache=c,
                             cache_len=cache_len, enc_out=enc_out,
                             pos_offset=pos_offset)
        new_tail.append(nc)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {}
        if n_scan:
            new_cache["layers"] = new_layers
        if n_rest:
            new_cache["tail"] = tuple(new_tail)
    return x, new_cache


def _embed(emb, tokens):
    """The token embeddings.  With the vocab cut over "model" each rank
    looks up the tokens in its rows (zeros for the others) and the ranks'
    rows are summed: exact, each token's row is found on one rank."""
    w = use(emb)
    if not on_model(emb, 0):
        return F.embedding(tokens, w)
    ctx = current()
    rows = w.shape[0]
    local = tokens - ctx.model_index() * rows
    inside = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), w) * inside[..., None]
    return ctx.psum(x, "model")


def _head_weight(params, cfg):
    """(the head weight (D, V), its vocab dim cut over "model")."""
    if cfg.tie_embeddings:
        return use(params["embed"]).T, on_model(params["embed"], 0)
    return use(params["lm_head"]), on_model(params["lm_head"], 1)


def logits_last(params, hidden, cfg: ModelConfig):
    """Decode-time logits for the final position only, fp32 (whole over
    the vocab on every rank of a mesh)."""
    w, cut = _head_weight(params, cfg)
    logits = (hidden[:, -1] @ w.to(cfg.cdtype)).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cut:
        ctx = current()
        logits = ctx.reshard(logits, (ctx.batch_entry, "model"),
                             (ctx.batch_entry, None))
    return logits


# ------------------------------------------------------------ facade ----
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def defs(self):
        return model_defs(self.cfg)

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device."""
        return init_params(self.defs(), generator)

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, params, batch, max_len: int):
        """Prompt → (next-token logits, warmed cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
        hidden, cache = forward(
            params, tokens, cfg, cache=cache, cache_len=0,
            prefix_embed=batch.get("patches"),
            enc_frames=batch.get("frames"))
        return logits_last(params, hidden, cfg), cache

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, cache_len):
        """One token per sequence.  tokens: (B, 1) → (logits, cache),
        the cache updated in place.  cache_len: the positions filled, a
        Python int or a 0-d int tensor on the device (the same logits,
        bit for bit; the tensor form captures as one CUDA graph)."""
        hidden, cache = forward(params, tokens, self.cfg, cache=cache,
                                cache_len=cache_len)
        return logits_last(params, hidden, self.cfg), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
