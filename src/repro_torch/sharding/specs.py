"""Logical-axis → mesh-dim sharding rules — counterpart of
`repro/sharding/specs.py`.

Every parameter dim carries a logical name (`models/params.py:ParamDef`).
The rules map each logical name to an ordered list of candidate mesh-dim
tuples; for a concrete (shape, mesh) each dim takes, in order, the first
candidate whose dims are (a) in the mesh, (b) not used by an earlier dim
of the same parameter and (c) divide the dim's size.  The reference's
fallbacks follow from that one rule:

  * kv_heads that the model dim does not divide replicate, and
    "kv_head_dim" takes the model dim instead;
  * a vocab that the model dim does not divide replicates, and the
    "embed" dim takes "data";
  * with `zero_shard`, 2-D+ weights also shard an embed-like dim over
    "data" (FSDP); 1-D parameters (norm scales) stay whole.

A spec is a tuple with one entry per tensor dim: a mesh-dim name, a
tuple of names, or None (whole).  Every function here is pure: it reads
only the mesh's dim names and sizes (a `DeviceMesh`, a {name: size}
dict, or anything with the reference's `.shape` mapping), so the specs
can be held against the reference's for meshes no machine here has.

`msc_axes` gives the MSC roles (slice and inner dims) of an MSC mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.models.params import ParamDef, map_defs
from repro_torch.sharding.activation import spec_entry

Axes = Tuple[str, ...]
Candidates = Tuple[Axes, ...]
Spec = Tuple


def mesh_dims(mesh) -> Dict[str, int]:
    """{dim name: size} of a DeviceMesh, a dict, or an object with the
    reference's `.shape` mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical name → ordered candidate mesh-dim tuples (() = whole)."""
    table: Dict[str, Candidates]
    batch_axes: Axes = ("pod", "data")

    def candidates(self, logical: Optional[str]) -> Candidates:
        if logical is None:
            return ((),)
        return self.table.get(logical, ((),))


def _mk(zero: bool) -> Dict[str, Candidates]:
    fsdp: Candidates = ((("data",),) if zero else ()) + ((),)
    return {
        "embed": fsdp,
        "ffn": (("model",),) + fsdp,
        "heads": (("model",),) + fsdp,
        "kv_heads": (("model",),),  # no fallback: kv_head_dim covers
        "kv_head_dim": (("model",), ()),
        "head_dim": ((),),
        "vocab": (("model",),),  # fallback: the embed dim takes data
        "experts": (("model",), ()),
        "expert_ffn": (("model",),) + fsdp,
        "rnn": (("model",),) + fsdp,
        "ssm_inner": (("model",),) + fsdp,
        "ssm_heads": (("model",), ()),
        "ssm_state": ((),),
        "conv": ((),),
        "layers": ((),),
        "enc": ((),),
    }


DEFAULT_RULES = ShardingRules(table=_mk(zero=True))
NO_ZERO_RULES = ShardingRules(table=_mk(zero=False))


def _train_table(zero: bool):
    t = dict(_mk(zero))
    # training replicates KV projections the model dim cannot take
    t["kv_head_dim"] = ((),)
    return t


TRAIN_RULES = ShardingRules(table=_train_table(zero=True))
TRAIN_NO_ZERO_RULES = ShardingRules(table=_train_table(zero=False))


def rules_for(zero_shard: bool, serve: bool = False) -> ShardingRules:
    if serve:
        return DEFAULT_RULES if zero_shard else NO_ZERO_RULES
    return TRAIN_RULES if zero_shard else TRAIN_NO_ZERO_RULES


def spec_for_def(d: ParamDef, mesh, rules: ShardingRules) -> Spec:
    """One ParamDef's spec under `mesh`."""
    dims = mesh_dims(mesh)
    used = set()
    parts = []
    vector = len([s for s in d.shape if s > 1]) <= 1  # 1-D stays whole
    for size, logical in zip(d.shape, d.logical):
        picked: Axes = ()
        if not vector or logical in ("vocab",):
            for cand in rules.candidates(logical):
                if any(a not in dims or a in used for a in cand):
                    continue
                denom = math.prod(dims[a] for a in cand) if cand else 1
                if cand and size % denom != 0:
                    continue
                picked = cand
                break
        used.update(picked)
        parts.append(spec_entry(picked))
    return tuple(parts)


def param_specs(defs, mesh, rules: ShardingRules = DEFAULT_RULES):
    """Tree of ParamDefs → tree of specs, shaped as the reference's: a
    `Stacked` block is one dict of specs with the leading "layers" dim
    (never sharded), as `stack_defs` makes it."""
    return map_defs(lambda d: spec_for_def(d, mesh, rules), defs)


def batch_spec(mesh, rules: ShardingRules = DEFAULT_RULES) -> Spec:
    """Spec of the leading batch dim: over every batch dim present."""
    dims = mesh_dims(mesh)
    return (spec_entry(a for a in rules.batch_axes if a in dims),)


def batch_axes_for(n: int, mesh, rules: ShardingRules = DEFAULT_RULES
                   ) -> Axes:
    """Largest contiguous run of batch dims whose product divides n (none
    for B = 1: the caller shards another dim over the leftover ones)."""
    dims = mesh_dims(mesh)
    axes = tuple(a for a in rules.batch_axes if a in dims)
    for k in range(len(axes), 0, -1):
        for i in range(len(axes) - k + 1):
            cand = axes[i:i + k]
            if n % math.prod(dims[a] for a in cand) == 0:
                return cand
    return ()


# ---------------------------------------------------------------- MSC ----
# The MSC tensor's logical dims (the reference's table):
#   "msc_slice" — the slice index of the current unfolding, over "slice";
#   "msc_inner" — the row dim of a slice, over "inner" when the mesh has
#                 it (2-D within-slice sharding);
#   "msc_col"   — the eigenvector dim c: never cut (the eigensolve and
#                 the |V Vᵀ| epilogue need whole rows of V);
#   "msc_mode"  — the grouped schedule's unfolding index, over "mode".
MSC_TABLE: Dict[str, Candidates] = {
    "msc_slice": (("slice",),),
    "msc_inner": (("inner",), ()),
    "msc_col": ((),),
    "msc_mode": (("mode",),),
}
MSC_RULES = ShardingRules(table=MSC_TABLE, batch_axes=("slice",))


def msc_axes(mesh, inner_axis: Optional[str] = "inner",
             mode_axis: str = "mode") -> Tuple[Axes, Axes]:
    """(slice_axes, inner_axes) of an MSC mesh.

    The inner dim is taken when the mesh names it; every other dim except
    the grouped schedule's mode dim makes up the slice role, in the
    mesh's order, so a production (data, model) mesh shards the slice
    index over both, row-major (`launch/mesh.py:axes_group`).
    """
    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh_dims(mesh))
    inner: Axes = (inner_axis,) if inner_axis and inner_axis in names else ()
    slices = tuple(a for a in names if a not in inner and a != mode_axis)
    return slices, inner
