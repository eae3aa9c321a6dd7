"""Model assembly for all 10 architecture families — counterpart of
`repro/models/transformer.py`.

One `Model` facade per ModelConfig provides:
  defs()            — declarative param tree (ParamDef leaves)
  init              — random parameters from a torch.Generator
  prefill / decode  — serving paths with per-family caches

Layers are grouped into super-blocks of the config's pattern period, as
in the reference (dense: 1, gemma2 local/global: 2, recurrentgemma
rglru/rglru/local: 3).  Where the reference stacks full super-blocks and
drives them with `lax.scan`, the port keeps one module per super-block
in an `nn.ModuleList` and loops over them; leftover layers ("tail", 26 =
8·3 + 2 on recurrentgemma) run after, as in the reference.  Caches
mirror the layer structure: a list of per-super-block dicts under
"layers" and a tuple under "tail", each leaf a buffer of its own dtype
(KV caches in the compute dtype, SSM and RG-LRU states in fp32, as the
reference keeps them), written in place by the decode step.

On this path the attention kernel runs wherever a self-attention has no
KV cache (the encoder's, and a no-cache `forward` with
`attn_impl="pallas"`) and in every cross-attention (prefill and
decode); a self-attention with a KV cache takes the chunked route
(`layers.attention`).  Under `sharding/activation.py:activation_sharding`
the model runs as one rank of an LM serving mesh: the embedding looks
its tokens up in the rank's vocab rows (summed over "model"), the caches
are made as the rank's shards (`init_cache`) and the logits are gathered
whole over the vocab.

Training (`Model.loss_fn`, `lm_loss`): the chunked softmax cross-entropy
recomputes each chunk's logits in the backward (`torch.utils.checkpoint`,
the reference's `jax.checkpoint`), and with `cfg.remat` each super-block
is recomputed in the backward too; on a mesh the recompute runs the
chunk's and the block's collectives again, in the same order on every
rank.  With the vocab cut over "model" each rank makes the logits of its
vocab block: the logsumexp takes its max and its sum over the model
ranks, and the gold logit comes from the rank that holds the label's
row.  On a mesh the loss a rank returns is its share of the global one
(its rows' NLL over the global token count, its MoE aux over the batch
ranks), so the shares summed over the batch ranks are the loss of the
whole batch, and so are their gradients.  The attention kernel has no
backward (nor has the reference's Pallas kernel), so `loss_fn` with
`attn_impl="pallas"` raises under autograd.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.sharding.activation import (constrain, current, hold,
                                             on_model, use, vocab_logsumexp)

from .config import ModelConfig
from .params import ParamDef, abstract_params, init_params, stack_defs
from . import layers as L
from . import rglru as R
from . import ssm as S


# ------------------------------------------------------------- defs ----
def _block_defs(cfg: ModelConfig, kind: str, cross: bool = False):
    if kind == "ssm":
        d = {"ln1": L.rmsnorm_defs(cfg.d_model), "ssm": S.ssm_defs(cfg)}
        if cfg.n_experts:  # granite-4.0-h: the mixer, then the MoE
            d |= {"ln2": L.rmsnorm_defs(cfg.d_model), "moe": L.moe_defs(cfg)}
        return d
    if kind == "rglru":
        return {"ln1": L.rmsnorm_defs(cfg.d_model), "rnn": R.rglru_defs(cfg),
                "ln2": L.rmsnorm_defs(cfg.d_model), "mlp": L.mlp_defs(cfg)}
    d: Dict[str, Any] = {
        "ln1": L.rmsnorm_defs(cfg.d_model),
        "attn": L.attention_defs(cfg),
        "ln2": L.rmsnorm_defs(cfg.d_model),
    }
    if cross:
        d["lnx"] = L.rmsnorm_defs(cfg.d_model)
        d["xattn"] = L.attention_defs(cfg)
    if cfg.n_experts and kind in ("attn", "global", "local"):
        d["moe"] = L.moe_defs(cfg)
    else:
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
@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """One cache buffer's shape and dtype (the reference's
    ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _block_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                        max_len: int, cross: bool):
    if kind == "ssm":
        return {"ssm": tuple(CacheLeaf(sh, torch.float32)
                             for sh in S.ssm_cache_shape(cfg, batch))}
    if kind == "rglru":
        return {"rnn": tuple(CacheLeaf(sh, torch.float32)
                             for sh in R.rglru_cache_shape(cfg, batch))}
    k, dh, cd = cfg.n_kv_heads, cfg.head_dim, cfg.cdtype
    # sliding-window layers keep a ring buffer of exactly `window` slots
    # (slot = pos % W — layers.attention); full-attention layers keep the
    # full-length buffer
    length = max_len
    if kind == "local" and cfg.local_window and cfg.local_window < max_len:
        length = cfg.local_window
    kv = CacheLeaf((batch, length, k, dh), cd)
    d = {"attn": (kv, kv)}
    if cross:
        xkv = CacheLeaf((batch, cfg.enc_context, k, dh), cd)
        d["xattn"] = (xkv, xkv)
    return d


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """`CacheLeaf`s mirroring the layer structure: KV caches in the
    compute dtype, SSM and RG-LRU states in fp32."""
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


def map_cache(tree, fn):
    """fn applied to every leaf of a cache tree (dicts, lists and tuples
    of `CacheLeaf`s or tensors), the structure kept."""
    if isinstance(tree, dict):
        return {k: map_cache(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_cache(v, fn) for v in tree)
    return fn(tree)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """A zero cache for `batch` sequences; under a mesh `batch` is the
    rank's rows and each leaf is the rank's shard of the global cache
    (marked with its spec)."""
    ctx = current()
    if ctx is None:
        return map_cache(cache_shapes(cfg, batch, max_len),
                         lambda l: torch.zeros(l.shape, dtype=l.dtype,
                                               device=device))

    def shard(leaf):
        spec = ctx.cache_spec(leaf.shape)
        return hold(torch.zeros(ctx.local_shape(leaf.shape, spec),
                                dtype=leaf.dtype, device=device), spec)

    return map_cache(cache_shapes(cfg, batch * ctx.size(ctx.batch_entry),
                                  max_len), shard)


# ----------------------------------------------------------- blocks ----
def _residual(x, y, cfg: ModelConfig):
    """x + y · residual_multiplier (x + y at the default 1: no launch)."""
    r = cfg.residual_multiplier
    return x + y if r == 1.0 else x + y * r


def _moe(p, h, cfg: ModelConfig, prefill: bool):
    """The MoE (and its shared MLP) of a block; an `lm.moe` span in a
    prefill."""
    with spans.span("lm.moe") if prefill else contextlib.nullcontext():
        return L.moe(p["moe"], h, cfg)


def _apply_block(p, x, cfg: ModelConfig, kind: str, *, cache=None,
                 cache_len=None, enc_out=None, pos_offset=0, causal=True,
                 prefill=False):
    """One residual block.  Returns (x, new_cache, aux), aux 0.0 but for
    an MoE block (a 0-d tensor): a block without MoE adds no launch.
    `prefill`: the block runs in `Model.prefill` (the chunked SSD into
    the cache; the `lm.moe` span)."""
    aux = 0.0
    new_cache = dict(cache) if cache is not None else None
    if kind == "ssm":
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        if cache is None:
            y = S.ssd_train(p["ssm"], h, cfg)
        elif prefill:
            y, new_cache["ssm"] = S.ssd_prefill(p["ssm"], h, cache["ssm"],
                                                cfg)
        else:
            y, new_cache["ssm"] = S.ssd_decode(p["ssm"], h, cache["ssm"], cfg)
        x = _residual(x, y, cfg)
        if "moe" not in p:
            return x, new_cache, aux
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, aux = _moe(p, h, cfg, prefill)
        return _residual(x, y, cfg), new_cache, aux
    if kind == "rglru":
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        y, rc = R.rglru_block(p["rnn"], h, cfg,
                              cache["rnn"] if cache is not None else None)
        if cache is not None:
            new_cache["rnn"] = rc
        x = _residual(x, y, cfg)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return _residual(x, L.mlp(p["mlp"], h, cfg), cfg), new_cache, aux

    h = constrain(L.rmsnorm(p["ln1"], x, cfg.norm_eps), ("batch", None, None))
    y, kvc = L.attention(
        p["attn"], h, cfg, kind=kind, pos_offset=pos_offset,
        kv_cache=cache["attn"] if cache is not None else None,
        cache_len=cache_len, causal=causal)
    if cache is not None:
        new_cache["attn"] = kvc
    x = _residual(x, y, cfg)
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
        x = _residual(x, y, cfg)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = _moe(p, h, cfg, prefill)
    else:
        y = L.mlp(p["mlp"], h, cfg)
    return _residual(x, y, cfg), new_cache, aux


def _superblock(p_sb, x, cfg, kinds_period, *, cache=None, cache_len=None,
                enc_out=None, pos_offset=0, prefill=False):
    aux = 0.0
    new_cache = {} if cache is not None else None
    for j, kind in enumerate(kinds_period):
        key = f"k{j}"
        c = cache[key] if cache is not None else None
        x, nc, a = _apply_block(p_sb[key], x, cfg, kind, cache=c,
                                cache_len=cache_len, enc_out=enc_out,
                                pos_offset=pos_offset, prefill=prefill)
        if cache is not None:
            new_cache[key] = nc
        aux = aux + a
    return x, new_cache, aux


# ---------------------------------------------------------- forward ----
def forward(params, tokens, cfg: ModelConfig, *, prefix_embed=None,
            enc_frames=None, cache=None, cache_len=None, prefill=False):
    """Token ids → final hidden states.

    tokens: (B, S) int.  prefix_embed: (B, P, D) VLM patch stub —
    replaces the embeddings of the first P positions.  enc_frames:
    (B, T_enc, D) audio frame stub (whisper) — runs the encoder and
    cross-attends.  cache/cache_len: the serving path (cache_len a
    Python int, or a 0-d int tensor on the device for a step that reads
    nothing back to the host).  prefill: the call is `Model.prefill`'s.
    Returns (hidden (B,S,D), new_cache, aux_loss), aux_loss the sum of
    the MoE layers' load-balance losses (a 0-d fp32 zero without MoE).
    """
    kinds, n_scan, n_rest = _pattern(cfg)
    period = _period(cfg)
    cd = cfg.cdtype
    x = _embed(params["embed"], tokens)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    x = x.to(cd)
    x = constrain(x, ("batch", None, None))
    if prefix_embed is not None:
        pfx = prefix_embed.to(cd)
        x = torch.cat([pfx, x[:, pfx.shape[1]:]], dim=1)

    enc_out = None
    if cfg.is_encdec and enc_frames is not None:
        e = enc_frames.to(cd) + use(params["enc_pos"]).to(cd)[None]
        for p_layer in params["enc_layers"]:
            e, _, _ = _apply_block(p_layer, e, cfg, "attn", causal=False)
        enc_out = L.rmsnorm(params["enc_norm"], e, cfg.norm_eps)

    pos_offset = 0 if cache_len is None else cache_len
    kinds_period = tuple(kinds[:period])
    aux_total = 0.0

    # training recomputes each super-block in the backward (the
    # reference's jax.checkpoint of its scan body)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    new_layers = []
    for i in range(n_scan):
        c_sb = cache["layers"][i] if cache is not None else None
        run = functools.partial(_superblock, params["layers"][i], cfg=cfg,
                                kinds_period=kinds_period, cache=c_sb,
                                cache_len=cache_len, enc_out=enc_out,
                                pos_offset=pos_offset, prefill=prefill)
        x, nc, a = (checkpoint(run, x, use_reentrant=False) if remat
                    else run(x))
        x = constrain(x, ("batch", None, None))
        aux_total = aux_total + a
        new_layers.append(nc)

    new_tail = []
    for j in range(n_rest):
        kind = kinds[n_scan * period + j]
        c = cache["tail"][j] if cache is not None else None
        x, nc, a = _apply_block(params["tail"][j], x, cfg, kind, cache=c,
                                cache_len=cache_len, enc_out=enc_out,
                                pos_offset=pos_offset, prefill=prefill)
        aux_total = aux_total + a
        new_tail.append(nc)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {}
        if n_scan:
            new_cache["layers"] = new_layers
        if n_rest:
            new_cache["tail"] = tuple(new_tail)
    if not torch.is_tensor(aux_total):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux_total


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


# ------------------------------------------------------------- loss ----
PALLAS_NO_GRAD = (
    "attn_impl='pallas' has no backward: the attention kernel "
    "(kernels/csrc/flash_attention.cu) is forward only, as the reference's "
    "Pallas kernel is (jax.grad through it fails), so training takes "
    "attn_impl='chunked' or 'full'")


def lm_loss(params, hidden, labels, cfg: ModelConfig,
            mask: Optional[torch.Tensor] = None):
    """Chunked softmax cross-entropy: the (B, S, V) logits are never
    materialised.  Each seq chunk's logits (B, chunk, V) are made in the
    compute dtype, taken to fp32 (softcapped with cfg.final_softcap) for
    a logsumexp and the gold logit, and recomputed in the backward
    instead of saved.  The NLL sum and the token count accumulate over
    the chunks in order; returns their quotient (fp32, 0-d).

    On a mesh the token count is the global one (summed over the batch
    ranks), so the quotient is this rank's share of the global mean; with
    the vocab cut over "model" the hidden states enter the head as the
    input of a column-parallel product."""
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} is not a multiple of the loss chunk "
                         f"{chunk}")
    w, cut = _head_weight(params, cfg)
    ctx = current()
    if cut:
        hidden = ctx.to_model(hidden)
    w = w.to(cfg.cdtype)
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        m_c = None if mask is None else mask[:, c0:c0 + chunk].float()
        nll = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk], w,
                         labels[:, c0:c0 + chunk], cfg.final_softcap, cut,
                         cfg.logits_scaling, use_reentrant=False)
        if m_c is None:
            tot = tot + nll.sum()
            cnt = cnt + nll.numel()
        else:
            tot = tot + (nll * m_c).sum()
            cnt = cnt + m_c.sum()
    if ctx is not None and ctx.batch_entry is not None:
        with torch.no_grad():
            cnt = ctx.psum(cnt, ctx.batch_entry)
    return tot / torch.clamp(cnt, min=1.0)


def _chunk_nll(h_c, w, l_c, softcap, cut=False, scaling=1.0):
    """Per-token NLL (B, chunk) of one seq chunk, fp32, the logits
    divided by `scaling`; with `cut` the head's vocab is this model
    rank's block of it."""
    logits = (h_c @ w).float()
    if scaling != 1.0:
        logits = logits / scaling
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if not cut:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_c[..., None])[..., 0]
        return lse - gold
    ctx = current()
    rows = logits.shape[-1]
    local = l_c - ctx.model_index() * rows
    inside = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])
    gold = torch.where(inside, gold[..., 0],
                       torch.zeros((), device=gold.device))
    return vocab_logsumexp(logits) - ctx.psum(gold, "model")


def logits_last(params, hidden, cfg: ModelConfig):
    """Decode-time logits for the final position only, fp32 (whole over
    the vocab on every rank of a mesh)."""
    w, cut = _head_weight(params, cfg)
    logits = (hidden[:, -1] @ w.to(cfg.cdtype)).float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
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

    def abstract(self):
        """The parameter tree on the `meta` device (no allocation)."""
        return abstract_params(self.defs())

    # ---- training ----
    def loss_fn(self, params, batch):
        """batch: {tokens, labels[, patches | frames, loss_mask]} →
        (loss + 0.01·aux, aux), both fp32 0-d tensors; on a mesh this
        rank's share of the first (`lm_loss`) and its own aux."""
        if self.cfg.attn_impl == "pallas" and torch.is_grad_enabled():
            raise NotImplementedError(PALLAS_NO_GRAD)
        hidden, _, aux = forward(
            params, batch["tokens"], self.cfg,
            prefix_embed=batch.get("patches"),
            enc_frames=batch.get("frames"))
        loss = lm_loss(params, hidden, batch["labels"], self.cfg,
                       batch.get("loss_mask"))
        ctx = current()
        if ctx is not None:  # this rank's share of the batch ranks' mean
            return loss + 0.01 * (aux / ctx.size(ctx.batch_entry)), aux
        return loss + 0.01 * aux, aux

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, params, batch, max_len: int, cache=None):
        """Prompt → (next-token logits, warmed cache).  `cache`: a zero
        cache for the batch's rows (views of a larger one's rows too),
        filled in place; a new one when None."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cache is None:
            cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
        hidden, cache, _ = forward(
            params, tokens, cfg, cache=cache, cache_len=0,
            prefix_embed=batch.get("patches"),
            enc_frames=batch.get("frames"), prefill=True)
        return logits_last(params, hidden, cfg), cache

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, cache_len):
        """One token per sequence.  tokens: (B, 1) → (logits, cache),
        the cache updated in place.  cache_len: the positions filled, a
        Python int or a 0-d int tensor on the device (the same logits,
        bit for bit; the tensor form captures as one CUDA graph)."""
        hidden, cache, _ = forward(params, tokens, self.cfg, cache=cache,
                                   cache_len=cache_len)
        return logits_last(params, hidden, self.cfg), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
