"""Sharded LM activations — counterpart of `repro/sharding/activation.py`.

The reference states layouts and lets GSPMD place the collectives; here
every rank of a (data, model) mesh holds local shards and the model's
layers run the collectives themselves, at the points where GSPMD puts
them.  A layout ("held") is a tuple with one entry per tensor dim: the
mesh dims that dim is cut over (a name, a tuple of names, or None).

`activation_sharding(shards)` is entered by the serving steps
(`serving/engine.py`) and the train step (`training/steps.py`) around the
model; the layers read it through `current()`.  Outside it every helper
here is the identity, so the one-device path and the MSC paths are
untouched.  Under it:

* a parameter (a local shard, its layout in `held_of`) is gathered over
  every dim but "model" where it is used (`use`): FSDP's gather inside
  the step, the "model" cut left in place (tensor parallelism);
* a contraction over a dim cut over "model" is summed over it (`psum`);
* `constrain(x, dims, held)` reshards an activation to the reference's
  symbolic layout: "batch" expands to the mesh's batch dims, "model" to
  the model dim, each only where it divides the dim (the reference's
  rule), and the move is an all_gather where a cut goes and a local slice
  where one comes.

Every move is an autograd Function with its adjoint (`LMShards`), so the
train step differentiates through them: the gather of a parameter over
"data" reduce-scatters its gradient into the shard, the row-parallel sum
passes the gradient through, the input of a column-parallel product sums
its gradient over "model" (`to_model`), and a gather over "model" and a
slice are adjoint to each other.

Gathers over several mesh dims follow their ranks in row-major order,
as a composite mesh axis does (`launch/mesh.py:axes_group`).
"""
from __future__ import annotations

import collections
import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# the rank's LMShards while model code runs under `activation_sharding`:
# process-wide, not per thread, because on a card the autograd engine
# runs the backward (and a remat recompute in it) on its own device
# thread
_CTX: list = [None]

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
    """What a rank of an LM mesh needs to run its shard.

    mesh: the DeviceMesh; batch_axes: the mesh dims the batch is cut over
    (`serve_batch_axes`, or every batch dim of the train rules);
    cache_spec(global leaf shape) → the cache leaf's layout
    (`serving/engine.py:_cache_leaf_spec`: the leftover data dims cut its
    time dim).

    `counts` tallies the collectives issued since it was cleared, by kind
    ("all_gather", "reduce_scatter", "all_reduce"), forward and backward
    alike; `grad_counts` the ones of them that reduce a parameter's
    gradient over the batch dims.  A train step clears both at its start.
    `memo` holds, while a train microbatch runs, each parameter gathered
    over its "data" cut (`gather_params`), so a parameter is gathered once
    per microbatch however often the model uses it.
    """

    def __init__(self, mesh, batch_axes: Sequence[str],
                 cache_spec: Optional[Callable] = None):
        from repro_torch.sharding.specs import mesh_dims

        self.mesh = mesh
        self.dims: Dict[str, int] = mesh_dims(mesh)
        self.batch_axes = tuple(a for a in batch_axes if a in self.dims)
        self.cache_spec = cache_spec
        self.counts: collections.Counter = collections.Counter()
        self.grad_counts: collections.Counter = collections.Counter()
        self.memo: Optional[Dict[int, torch.Tensor]] = None

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

    # ---- the collectives (no autograd) ---------------------------------
    # Both move x's blocks as they lie in memory: x is made contiguous,
    # the collective reads or writes whole blocks along a leading dim,
    # and a dim other than the first costs one strided copy, on the side
    # where the blocks are interleaved (none among one rank).  Results
    # are contiguous, as the one-device tensor they stand for.
    def _all_gather(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        import torch.distributed as dist

        group, n, _ = self.role(entry)
        if group is None:
            return x
        xs = x.contiguous()
        out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, xs, group=group)
        self.counts["all_gather"] += 1
        if dim == 0 or n == 1:
            return out
        # the blocks lie one after another: interleave them along dim
        return out.view((n,) + tuple(xs.shape)).movedim(0, dim).flatten(
            dim, dim + 1)

    def _reduce_scatter(self, x: torch.Tensor, dim: int, entry,
                        grad: bool = False) -> torch.Tensor:
        """The sum over `entry`'s ranks of x, this rank's block of it
        along `dim`."""
        import torch.distributed as dist

        group, n, _ = self.role(entry)
        if group is None:
            return x
        shape = list(x.shape)
        shape[dim] //= n
        xs = x.contiguous() if dim == 0 or n == 1 else \
            x.unflatten(dim, (n, shape[dim])).movedim(dim, 0).contiguous() \
            .flatten(0, 1)  # the blocks one after another
        out = x.new_empty(shape)
        scatter = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        scatter(out, xs, op=dist.ReduceOp.SUM, group=group)
        self.counts["reduce_scatter"] += 1
        if grad:
            self.grad_counts["reduce_scatter"] += 1
        return out

    def _all_reduce(self, x: torch.Tensor, entry, op: str = "sum",
                    grad: bool = False) -> torch.Tensor:
        """all_reduce over `entry`'s dims, out of place (x is kept)."""
        import torch.distributed as dist

        group, _, _ = self.role(entry)
        if group is None:  # a dim of one rank too: the same program
            return x
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        self.counts["all_reduce"] += 1
        if grad:
            self.grad_counts["all_reduce"] += 1
        return out

    def _part(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        _, n, i = self.role(entry)
        if n == 1:
            return x
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)

    # ---- moves (autograd Functions) -------------------------------------
    # Under autograd every tensor a rank holds carries the whole gradient
    # of its shard (a tensor whole over "model" has the same gradient on
    # every model rank).  A gather over "model" is then adjoint to a
    # slice, a slice to a gather, the row-parallel sum (`psum`) to the
    # identity, and the input of a product cut over "model" takes the
    # sum of the ranks' gradients (`to_model`).  Parameters are gathered
    # over "data" by `gather_params`, whose adjoint is the reduce-scatter.
    def gather(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """x's shards along `dim` from every rank of `entry`'s dims, in
        rank order (one all_gather; adjoint: this rank's block)."""
        if self.role(entry)[0] is None:
            return x
        return _Gather.apply(x, self, dim % x.dim(), entry)

    def part(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """This rank's shard of x along `dim` over `entry`'s dims
        (adjoint: the gather of the shards' gradients)."""
        if self.role(entry)[1] == 1:
            return x
        return _Part.apply(x, self, dim % x.dim(), entry)

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
        """The sum over `entry`'s ranks (all_reduce; adjoint: the
        identity)."""
        if self.role(entry)[0] is None:
            return x
        return _Psum.apply(x, self, entry)

    def reduce_scatter(self, x: torch.Tensor, dim: int, entry="model"
                       ) -> torch.Tensor:
        """The sum over `entry`'s ranks, this rank's block along `dim`
        (adjoint: the all_gather)."""
        if self.role(entry)[0] is None:
            return x
        return _ReduceScatter.apply(x, self, dim % x.dim(), entry)

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """x, whole over "model", as the input of work cut over "model":
        the identity, its gradient summed over "model" in the backward."""
        if not (torch.is_grad_enabled() and x.requires_grad) or \
                self.role("model")[0] is None:
            return x
        return _ToModel.apply(x, self)

    # ---- parameters of a train step ---------------------------------
    def gather_params(self, params) -> None:
        """Fill `memo`: each parameter (a local shard, marked by `hold`)
        gathered over its cuts by the batch dims, its gradient in the
        backward reduce-scattered back into the shard (and summed over
        the batch dims that do not cut it)."""
        self.memo = {id(p): _GatherParam.apply(p, self, held_of(p))
                     for p in params}

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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards, dim, entry):
        ctx.shards, ctx.dim, ctx.entry = shards, dim, entry
        return shards._all_gather(x, dim, entry)

    @staticmethod
    def backward(ctx, g):
        return ctx.shards._part(g, ctx.dim, ctx.entry), None, None, None


class _Part(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards, dim, entry):
        ctx.shards, ctx.dim, ctx.entry = shards, dim, entry
        return shards._part(x, dim, entry)

    @staticmethod
    def backward(ctx, g):
        return (ctx.shards._all_gather(g, ctx.dim, ctx.entry), None, None,
                None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards, entry):
        return shards._all_reduce(x, entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards, dim, entry):
        ctx.shards, ctx.dim, ctx.entry = shards, dim, entry
        return shards._reduce_scatter(x, dim, entry)

    @staticmethod
    def backward(ctx, g):
        return (ctx.shards._all_gather(g, ctx.dim, ctx.entry), None, None,
                None)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shards._all_reduce(g, "model"), None


class _GatherParam(torch.autograd.Function):
    """A parameter's shard → the parameter whole over its "data"-like
    cuts (FSDP's gather); backward: the gradient reduce-scattered over
    those cuts and summed over the batch dims the parameter is whole
    over (the ranks of those dims saw other rows of the batch)."""

    @staticmethod
    def forward(ctx, p, shards, held):
        ctx.shards, ctx.held = shards, held
        x = p
        for d, h in enumerate(held):
            if h is not None and not is_model(h):
                x = shards._all_gather(x, d, h)
        return x if x is not p else p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        shards, held = ctx.shards, ctx.held
        cut = set()
        for d, h in enumerate(held):
            if h is not None and not is_model(h):
                g = shards._reduce_scatter(g, d, h, grad=True)
                cut.update(spec_axes(h))
        rest = tuple(a for a in shards.batch_axes if a not in cut)
        if rest:
            g = shards._all_reduce(g, spec_entry(rest), grad=True)
        return g, None, None


class _VocabLSE(torch.autograd.Function):
    """logsumexp over the last dim of logits cut over "model", in
    `torch.logsumexp`'s operations (max, |max| = inf → 0, sum of exp,
    log, + max) with the max and the sum taken over the model ranks;
    backward: grad · exp(x − lse), `logsumexp`'s own."""

    @staticmethod
    def forward(ctx, x, shards):
        m = shards._all_reduce(torch.amax(x, dim=-1, keepdim=True),
                               "model", op="max")
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = shards._all_reduce(torch.sum(torch.exp(x - m), dim=-1),
                               "model")
        out = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * torch.exp(x - out[..., None]), None


@contextlib.contextmanager
def activation_sharding(shards: LMShards):
    """Run the enclosed model code as one rank of `shards`' mesh."""
    prev = current()
    _CTX[0] = shards
    try:
        yield shards
    finally:
        _CTX[0] = prev


def current() -> Optional[LMShards]:
    return _CTX[0]


def held_of(t: torch.Tensor) -> Optional[Held]:
    """The layout a local shard was made with (None: a whole tensor)."""
    return getattr(t, "_held", None)


def hold(t: torch.Tensor, held: Held) -> torch.Tensor:
    """Mark t as a local shard of layout `held`; returns t."""
    t._held = tuple(held)
    return t


def use(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a layer uses it: gathered over every mesh dim but
    "model" (the FSDP gather, inside the step; in a train microbatch the
    one `gather_params` made)."""
    ctx, held = current(), held_of(p)
    if ctx is None or held is None:
        return p
    if ctx.memo is not None and id(p) in ctx.memo:
        return ctx.memo[id(p)]
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


def to_model(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """x as the input of a product with p whose dim `dim` is cut over
    "model" (a column-parallel product): its gradient summed over the
    model ranks in the backward; x itself otherwise."""
    if on_model(p, dim):
        return current().to_model(x)
    return x


def use_whole(p: torch.Tensor, dim: int) -> torch.Tensor:
    """A parameter as `use` gives it, its dim `dim` gathered whole when it
    is cut over "model" (a layer that runs whole over the model ranks;
    a stacked 1-D leaf is cut like its block's matrices)."""
    w = use(p)
    return current().gather(w, dim, "model") if on_model(p, dim) else w


def use_block(p: torch.Tensor, dim: int, cut: bool) -> torch.Tensor:
    """A parameter as `use` gives it, reduced to this model rank's block
    of dim `dim` when `cut` (the layer runs on the rank's block of that
    dim); a leaf whose spec already cuts it there is the block."""
    w = use(p)
    return w if on_model(p, dim) or not cut else model_part(w, dim, cut)


def model_part(x: torch.Tensor, dim: int, cut: bool) -> torch.Tensor:
    """This model rank's block of x along `dim` when `cut`, else x."""
    return current().part(x, dim, "model") if cut else x


def vocab_logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim of logits whose vocab is cut over
    "model" (each rank holds its block of the vocab)."""
    ctx = current()
    return _VocabLSE.apply(logits, ctx)


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
