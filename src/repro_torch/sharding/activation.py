"""Sharded LM activations — counterpart of `repro/sharding/activation.py`.

The reference states layouts and lets GSPMD place the collectives; here
every rank of a (data, model) mesh holds local shards and the model's
layers run the collectives themselves, at the points where GSPMD puts
them.  A layout ("held") is a tuple with one entry per tensor dim: the
mesh dims that dim is cut over (a name, a tuple of names, or None).

`activation_sharding(shards)` is entered by the serving steps
(`serving/engine.py`) around the model's prefill and decode step; the
layers read it through `current()`.  Outside it every helper here is the
identity, so the one-device path and the MSC paths are untouched.  Under
it:

* a parameter (a local shard, its layout in `held_of`) is gathered over
  every dim but "model" where it is used (`use`): FSDP's gather inside
  the step, the "model" cut left in place (tensor parallelism);
* a contraction over a dim cut over "model" is summed over it (`psum`);
* `constrain(x, dims, held)` reshards an activation to the reference's
  symbolic layout: "batch" expands to the mesh's batch dims, "model" to
  the model dim, each only where it divides the dim (the reference's
  rule), and the move is an all_gather where a cut goes and a local slice
  where one comes.

Gathers over several mesh dims follow their ranks in row-major order,
as a composite mesh axis does (`launch/mesh.py:axes_group`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_TLS = threading.local()

Held = Tuple


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh dims of one layout entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(axes):
    """A layout entry for mesh dims: None, a name, or a tuple of names."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def is_model(entry) -> bool:
    """True when a layout entry is the "model" dim alone."""
    return spec_axes(entry) == ("model",)


class LMShards:
    """What a rank of an LM serving mesh needs to run its shard.

    mesh: the DeviceMesh; batch_axes: the mesh dims the batch is cut over
    (`serve_batch_axes`); cache_spec(global leaf shape) → the cache leaf's
    layout (`serving/engine.py:_cache_leaf_spec`: the leftover data dims
    cut its time dim).
    """

    def __init__(self, mesh, batch_axes: Sequence[str],
                 cache_spec: Optional[Callable] = None):
        from repro_torch.sharding.specs import mesh_dims

        self.mesh = mesh
        self.dims: Dict[str, int] = mesh_dims(mesh)
        self.batch_axes = tuple(a for a in batch_axes if a in self.dims)
        self.cache_spec = cache_spec

    # ---- mesh facts ---------------------------------------------------
    def size(self, entry) -> int:
        return math.prod(self.dims[a] for a in spec_axes(entry))

    def role(self, entry):
        """(group, size, index) of the mesh dims of one layout entry."""
        from repro_torch.launch.mesh import axes_group

        return axes_group(self.mesh, spec_axes(entry))

    @property
    def batch_entry(self):
        return spec_entry(self.batch_axes)

    def model_index(self) -> int:
        return self.role("model")[2] if "model" in self.dims else 0

    # ---- moves --------------------------------------------------------
    def gather(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """x's shards along `dim` from every rank of `entry`'s dims, in
        rank order (one all_gather)."""
        import torch.distributed as dist

        group, n, _ = self.role(entry)
        if group is None:
            return x
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, xs, group=group)
        return out.movedim(0, dim)

    def part(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """This rank's shard of x along `dim` over `entry`'s dims."""
        _, n, i = self.role(entry)
        if n == 1:
            return x
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)

    def reshard(self, x: torch.Tensor, held: Held, want: Held
                ) -> torch.Tensor:
        """x from layout `held` to layout `want`: per dim, an all_gather
        where a cut goes, then a slice where one comes."""
        for d, (h, w) in enumerate(zip(held, want)):
            if spec_axes(h) != spec_axes(w):
                if h is not None:
                    x = self.gather(x, d, h)
                if w is not None:
                    x = self.part(x, d, w)
        return x

    def psum(self, x: torch.Tensor, entry="model") -> torch.Tensor:
        """all_reduce(SUM) over `entry`'s dims, in place."""
        import torch.distributed as dist

        group, n, _ = self.role(entry)
        if group is not None:  # a dim of one rank too: the same program
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    # ---- layouts ------------------------------------------------------
    def resolve(self, dims: Sequence, shape: Sequence[int]) -> Held:
        """The reference's symbolic dims on a global shape: "batch" the
        batch dims, a name or tuple those dims; each only where its
        product divides the dim (the longest dividing prefix), and a
        mesh dim used once."""
        parts = []
        for token, n in zip(dims, shape):
            if token is None:
                parts.append(())
                continue
            axes = self.batch_axes if token == "batch" else spec_axes(token)
            axes = tuple(a for a in axes if a in self.dims)
            while axes and n % self.size(axes) != 0:
                axes = axes[:-1]
            parts.append(axes)
        seen, out = set(), []
        for axes in parts:
            if any(a in seen for a in axes):
                out.append(None)
                continue
            seen.update(axes)
            out.append(spec_entry(axes))
        return tuple(out)

    def global_shape(self, x: torch.Tensor, held: Held):
        return tuple(n * self.size(h) for n, h in zip(x.shape, held))

    def local_shape(self, shape, held: Held):
        return tuple(n // self.size(h) for n, h in zip(shape, held))


@contextlib.contextmanager
def activation_sharding(shards: LMShards):
    """Run the enclosed model code as one rank of `shards`' mesh."""
    prev = current()
    _TLS.ctx = shards
    try:
        yield shards
    finally:
        _TLS.ctx = prev


def current() -> Optional[LMShards]:
    return getattr(_TLS, "ctx", None)


def held_of(t: torch.Tensor) -> Optional[Held]:
    """The layout a local shard was made with (None: a whole tensor)."""
    return getattr(t, "_held", None)


def hold(t: torch.Tensor, held: Held) -> torch.Tensor:
    """Mark t as a local shard of layout `held`; returns t."""
    t._held = tuple(held)
    return t


def use(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a layer uses it: gathered over every mesh dim but
    "model" (the FSDP gather, inside the step)."""
    ctx, held = current(), held_of(p)
    if ctx is None or held is None:
        return p
    want = tuple(h if is_model(h) else None for h in held)
    return ctx.reshard(p, held, want)


def on_model(p: torch.Tensor, dim: int) -> bool:
    """True when the parameter's dim `dim` is cut over "model" (so a
    contraction over it sums over the model dim)."""
    held = held_of(p)
    return (current() is not None and held is not None
            and is_model(held[dim]))


def psum_model(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed over "model" when it contracted p's dim `dim` and that
    dim is cut over it: the row-parallel product's all_reduce."""
    if on_model(p, dim):
        return current().psum(x, "model")
    return x


def constrain(x: torch.Tensor, dims: Sequence, held: Optional[Held] = None
              ) -> torch.Tensor:
    """x (a local shard of layout `held`, by default cut over the batch
    dims only) resharded to the reference's symbolic layout `dims`; the
    identity outside `activation_sharding`, or when the rank differs."""
    ctx = current()
    if ctx is None or len(dims) != x.dim():
        return x
    if held is None:
        held = (ctx.batch_entry,) + (None,) * (x.dim() - 1)
    want = ctx.resolve(dims, ctx.global_shape(x, held))
    return ctx.reshard(x, held, want)
