"""Unified model configuration — counterpart of `repro/models/config.py`.

One frozen dataclass parameterizes every family (dense / moe / vlm /
audio-encdec / hybrid / ssm) with the reference's fields and defaults,
so a reference config carries across field for field
(`bridge.lm_config_from_fields`).  `repro_torch.configs.<arch>` holds the
published configs; tests use `reduced()` versions of the same family.

`attn_impl` keeps the reference's values: `full` (materialized scores),
`chunked` (online softmax over kv chunks in plain PyTorch) and `pallas`,
which in the port names the hand-written CUDA kernel
(`kernels/csrc/flash_attention.cu`) — the route the reference sends to
its Pallas kernel.  `cdtype` / `pdtype` are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 → d_model // n_heads

    # attention details
    head_pad: int = 0       # pad n_heads → this count for TP divisibility
                            # (padded heads are output-masked: exact
                            # semantics, sharding-friendly; §Perf fix)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_softcap: Optional[float] = None     # gemma2
    final_softcap: Optional[float] = None    # gemma2
    local_window: Optional[int] = None       # sliding-window size
    use_rope: bool = True    # False: NoPE attention (granite-4.0-h)
    global_every: int = 0    # 0 = all-global; k = every k-th layer global,
                             # others local (gemma2: 2 → alternate)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    d_expert: int = 0
    moe_group_size: int = 1024
    capacity_factor: float = 1.25
    expert_pad: int = 0     # pad n_experts → this count for EP divisibility
                            # (padded experts are router-masked to -inf:
                            # never routed, zero grads; §Perf)

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (recurrentgemma): block types, cycled over layers
    block_pattern: Tuple[str, ...] = ()      # e.g. ("rglru","rglru","local")
    rnn_width: int = 0                       # RG-LRU lru_width

    # encoder-decoder (whisper): decoder uses the top-level fields
    n_enc_layers: int = 0
    enc_context: int = 0                     # stub frontend positions

    # vlm (internvl): visual prefix token count (stub patch embeddings)
    n_patches: int = 0

    # GraniteMoe / GraniteMoeHybrid multipliers; the defaults are the
    # identity and add no launch
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0        # score scale; 0 → head_dim^-0.5
    residual_multiplier: float = 1.0         # each block's branch times it
    logits_scaling: float = 1.0              # logits divided by it

    norm_eps: float = 1e-6
    act: str = "silu"                        # mlp activation
    tie_embeddings: bool = False
    param_dtype: str = "float32"             # master weights
    compute_dtype: str = "bfloat16"
    use_pallas: bool = False                 # route attention via kernels/
    attn_impl: str = "chunked"               # full | chunked | pallas
                                             # (pallas: the CUDA kernel)
    attn_chunk: int = 1024                   # kv-chunk for chunked attention
    prefill_tokens: int = 0                  # ServeEngine: 0 = one prefill
                                             # of the batch; n = row slices
                                             # of at most n tokens
    loss_chunk: int = 512                    # seq-chunk for the xent loss
    microbatches: int = 0                    # grad-accum override (0 = auto
                                             # from the activation budget)
    remat: bool = True                       # remat each layer in train
    scan_layers: bool = True                 # lax.scan over stacked layers
    zero_shard: bool = True                  # FSDP params over "data"

    def __post_init__(self):
        # a pattern read from JSON arrives as a list
        object.__setattr__(self, "block_pattern", tuple(self.block_pattern))
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports long-context decode (long_500k cell):
        SSM / hybrid archs have O(1)-state or windowed sequence mixing."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'local' | 'global' | 'rglru' | 'ssm'."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.global_every:
            # gemma2 convention: layer i is local unless (i+1) % k == 0
            return tuple(
                "global" if (i + 1) % self.global_every == 0 else "local"
                for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def reduced(self, **over) -> "ModelConfig":
        """Family-preserving reduced config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if not self.block_pattern
                         else len(self.block_pattern)),
            d_model=128,
            head_pad=0,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            moe_group_size=64,
            loss_chunk=64,
            attn_chunk=64,
            scan_layers=False,
            zero_shard=False,
        )
        if self.n_experts:
            small.update(n_experts=4, n_shared_experts=min(self.n_shared_experts, 1),
                         experts_per_token=2, d_expert=64, expert_pad=0)
        if self.ssm_heads:
            small.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16, ssm_chunk=16)
        if self.rnn_width:
            small.update(rnn_width=128)
        if self.local_window:
            small.update(local_window=32)
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_context=16)
        if self.n_patches:
            small.update(n_patches=8)
        small.update(over)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that apply to an arch (skips noted in DESIGN.md §4):
    long_500k only for sub-quadratic archs (SSM / hybrid)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)
