"""Declarative parameter construction — counterpart of `repro/models/params.py`.

Every model parameter is declared once as a `ParamDef` (shape, logical
axis names, init), with the reference's shapes.  A tree of defs is a
nested dict (a block), a tuple (unstacked layers) or a `Stacked` (the
reference's `stack_defs`: n layers of one block).  `init_params` turns
the tree into modules:

  dict     → `ParamTree`, an `nn.Module` whose parameters and children
             are the dict's entries, read as `p["wq"]`, `"w3" in p`
  Stacked  → `LayerStack`, an `nn.ModuleList` of n `ParamTree`s (the
             reference's leading layer dim, unstacked: layers run in a
             Python loop)
  tuple    → `nn.ModuleList`

Parameters are built without gradient, for serving; `trainable` turns
them on for training.  `map_params` builds a tree of the same structure
(AdamW's moments, the compression residual) and `abstract_params` one on
the `meta` device (shapes and dtypes, no allocation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones
    scale: Optional[float] = None       # stddev; None → 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


@dataclasses.dataclass(frozen=True)
class Stacked:
    """n layers of the block `defs` (the reference stacks them)."""
    defs: Any
    n: int


def stack_defs(defs, n: int) -> Stacked:
    return Stacked(defs, n)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def stacked_def(d: ParamDef, n: int) -> ParamDef:
    """The reference's `stack_defs` leaf: a leading "layers" dim of n."""
    return dataclasses.replace(d, shape=(n,) + d.shape,
                               logical=("layers",) + d.logical)


def map_defs(fn: Callable[[ParamDef], Any], defs, _stack: int = 0):
    """fn over every def of a tree, shaped as the reference's tree: a
    `Stacked` block is one dict whose defs carry the leading "layers"
    dim, as the reference's `stack_defs` makes it."""
    if is_def(defs):
        return fn(stacked_def(defs, _stack) if _stack else defs)
    if isinstance(defs, Stacked):
        return map_defs(fn, defs.defs, defs.n)
    if isinstance(defs, tuple):
        return tuple(map_defs(fn, d, _stack) for d in defs)
    return {k: map_defs(fn, v, _stack) for k, v in defs.items()}


class ParamTree(nn.Module):
    """One block of parameters, read like the reference's dict."""

    def __init__(self, items: dict):
        super().__init__()
        for k, v in items.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_parameter(k, v)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class LayerStack(nn.ModuleList):
    """n layers of one block: the reference stacks each of their leaves
    into one array with a leading layer dim (its checkpoints hold them
    so, `checkpoint/store.py:tree_leaves`)."""


def _fan_in(shape) -> int:
    return shape[0] if len(shape) == 1 else math.prod(shape[:-1])


def _init_one(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=gen.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=gen.device)
    scale = d.scale if d.scale is not None else \
        1.0 / math.sqrt(max(_fan_in(d.shape), 1))
    return (torch.randn(d.shape, generator=gen, device=gen.device) *
            scale).to(d.dtype)


def build(defs, leaf: Callable[[ParamDef, Tuple], torch.Tensor],
          path: Tuple = ()):
    """Modules for a tree of defs; `leaf(def, path)` gives each value.

    `path` holds the dict keys and, under a `Stacked` or a tuple, the
    layer index, from the root down."""
    if isinstance(defs, ParamDef):
        return nn.Parameter(leaf(defs, path), requires_grad=False)
    if isinstance(defs, Stacked):
        return LayerStack(build(defs.defs, leaf, path + (i,))
                          for i in range(defs.n))
    if isinstance(defs, tuple):
        return nn.ModuleList(build(d, leaf, path + (i,))
                             for i, d in enumerate(defs))
    return ParamTree({k: build(v, leaf, path + (k,))
                      for k, v in defs.items()})


def init_params(defs, generator: torch.Generator):
    """Random weights on the generator's device, drawn in the order of
    the tree (the reference's values differ: jax.random is another
    generator)."""
    return build(defs, lambda d, _: _init_one(d, generator))


def abstract_params(defs):
    """The parameter tree on the `meta` device: shapes and dtypes with no
    storage (the reference's ShapeDtypeStruct view)."""
    return build(defs, lambda d, _: torch.empty(d.shape, dtype=d.dtype,
                                                device="meta"))


def map_params(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """A new tree of the structure of `tree` (a `ParamTree`, a
    `LayerStack` or a `ModuleList`) whose leaf is fn(leaf), without
    gradient; a leaf's mesh layout mark (`sharding/activation.py:hold`)
    carries over."""
    if isinstance(tree, nn.Parameter):
        out = nn.Parameter(fn(tree), requires_grad=False)
        if hasattr(tree, "_held"):
            out._held = tree._held
        return out
    if isinstance(tree, nn.ModuleList):
        return type(tree)(map_params(fn, t) for t in tree)
    return ParamTree({k: map_params(fn, tree[k]) for k in _keys(tree)})


def _keys(tree: ParamTree):
    return list(tree._parameters) + list(tree._modules)


def tree_leaves(tree) -> list:
    """The leaves of a tree in the reference's `jax.tree.flatten` order:
    NamedTuple fields, lists and tuples in order, dict and `ParamTree`
    keys sorted, None without leaves; each leaf a tensor (or any other
    value) or, for a `LayerStack`, the list of one leaf's tensors across
    its layers (the reference's stacked leaf)."""
    out: list = []
    _walk(tree, out)
    return out


def _walk(tree, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, LayerStack):
        for group in zip(*(tree_leaves(layer) for layer in tree)):
            out.append(list(group))
    elif isinstance(tree, nn.ModuleList):
        for t in tree:
            _walk(t, out)
    elif isinstance(tree, ParamTree):
        for k in sorted(_keys(tree)):
            _walk(tree[k], out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _walk(t, out)
    else:
        out.append(tree)


def trainable(tree, on: bool = True):
    """`tree` with gradients on (or off) for every leaf; returns it."""
    for p in tree.parameters():
        p.requires_grad_(on)
    return tree


def count_params(defs) -> int:
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    if isinstance(defs, Stacked):
        return defs.n * count_params(defs.defs)
    if isinstance(defs, tuple):
        return sum(count_params(d) for d in defs)
    return sum(count_params(d) for d in defs.values())
