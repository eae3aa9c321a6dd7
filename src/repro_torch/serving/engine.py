"""Batched LM serving on one device or a (data, model) mesh — counterpart
of `repro/serving/engine.py`.

`ServeEngine` runs greedy batched generation: one prefill over the
prompt (and, for an encoder–decoder model, the encoder over the frames),
then one decode step per token against the KV cache, which each step
updates in place (the counterpart of the reference's donated cache
buffers).  The next token is the `argmax` of the logits, taken on the
device (ties go to the first maximal index, as `jnp.argmax` breaks
them); nothing is read back to the host until the end.

The decode step is one program, as the reference jits it: the engine
owns the KV cache at (batch, max_len) (the prefill's cache is copied
into it), the current token, the position filled (a 0-d device tensor)
and a (batch, max_len) output, and on a card captures one step (the
model's decode step, the argmax, the token written at its device
position, both positions advanced) as a CUDA graph, replayed once per
token and kept for later `generate` calls.  On the CPU the same step
runs eagerly.  The prefill runs eagerly: one forward over the batch,
or, with `cfg.prefill_tokens` = n on one device, one forward a row
slice of at most n tokens (at least one row), each written into its
rows of the engine's cache, zeroed first.  Rows are independent where
the MoE drops no token (capacity = group size), so the slices give the
whole batch's prefill at a bounded peak; a model whose routing could
drop a token, in the whole batch or a slice, is refused.

Spans (`repro_torch.spans`, while a profiler records): `lm.prefill`
(rows, length) over a call's prefill, `lm.prefill_slice` (rows, start)
over each slice, `lm.decode` (steps) over its decode steps; counters
`lm.prefill_slices` and `lm.decode_steps`.

On a mesh (`ServeEngine(..., mesh=…)`, the reference's (data, model) or
(pod, data, model) meshes of `launch/mesh.py`) every rank holds only the
parameter and cache shards the specs give it (`param_specs` under the
serve rules, `cache_specs`): the batch is cut over the batch dims that
divide it (`serve_batch_axes`), the leftover data dims cut the cache's
time dim (B = 1), and the model runs under `activation_sharding`
(`sharding/activation.py`), with the FSDP gathers inside the steps.
Every rank passes the same whole batch to `generate` and gets the same
whole (B, n) tokens back; on a card the decode step stays one CUDA graph,
its collectives inside.  Every family serves on a mesh: the MoE experts
cut over "model" (expert parallel), the SSM and RG-LRU blocks as
`models/ssm.py` and `models/rglru.py` cut them.  The cache specs are the
reference's, which read a (B, H, P, N) SSM state as a (B, T, K, dh) KV
cache (P over "model" where it divides, else N; H over the leftover data
dims when B = 1); a block reads each state in the layout it computes in
and writes the rank's shard back (`models/layers.py:cache_view`).
"""
from __future__ import annotations

import functools
import math
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import spans
from repro_torch.models import Model, cache_shapes, init_cache, map_cache
from repro_torch.models.layers import moe_groups
from repro_torch.models.params import build
from repro_torch.serving.graphs import Step, warm_up
from repro_torch.sharding.activation import (LMShards, activation_sharding,
                                             held_of, hold, spec_entry)
from repro_torch.sharding.specs import (batch_axes_for, mesh_dims,
                                        param_specs, rules_for)


class _Clock:
    """Marks on the device's timeline: CUDA events on a card (read after
    the final sync), the host clock on the CPU, where every op is done
    when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _drops(cfg, n: int) -> bool:
    """Whether the MoE's routing of n tokens could drop one: its capacity
    is below its group size (`layers.moe_groups`)."""
    _, gs, cap = moe_groups(n, cfg)
    return cap < gs


def _leaves(tree):
    """The tensors of a cache tree, in its (deterministic) order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


def _cache_leaf_spec(shape, mesh, bs, time_axes: tuple = ()) -> tuple:
    """Spec of one cache leaf by its rank and shape.

    attn kv (B, T, K, dh): the batch, and kv heads over "model" where it
    divides them, else the head dim; when the batch cannot take every
    data dim (B = 1) the leftover ones cut the time dim T instead.  (B, W,
    C) and (B, W) leaves (the SSM and RG-LRU states of the reference) cut
    their last dim over "model" where it divides it.
    """
    dims = mesh_dims(mesh)
    model_ok = "model" in dims

    def modelable(n):
        return model_ok and n % dims["model"] == 0

    def div(n, axes):
        return axes and n % math.prod(dims[a] for a in axes) == 0

    if len(shape) == 4:
        t = spec_entry(time_axes) if div(shape[1], time_axes) else None
        if modelable(shape[2]):
            return (bs, t, "model", None)
        if modelable(shape[3]):
            return (bs, t, None, "model")
        return (bs, t)
    if len(shape) == 3:
        return (bs, None, "model") if modelable(shape[2]) else (bs,)
    if len(shape) == 2:
        return (bs, "model") if modelable(shape[1]) else (bs,)
    return (bs,)


def serve_batch_axes(batch: int, mesh, rules):
    """(batch dims, leftover data dims) honouring divisibility (B = 1)."""
    used = batch_axes_for(batch, mesh, rules)
    dims = mesh_dims(mesh)
    rest = tuple(a for a in rules.batch_axes if a in dims and a not in used)
    return used, rest


def cache_specs(model: Model, mesh, batch: int, max_len: int):
    """The cache's specs, shaped as the reference's: a stacked "layers"
    block's leaves carry its leading layer dim (never cut), the "tail"
    leaves none."""
    rules = rules_for(model.cfg.zero_shard, serve=True)
    used, time_axes = serve_batch_axes(batch, mesh, rules)
    bs = spec_entry(used)
    shapes = cache_shapes(model.cfg, batch, max_len)

    def spec(leaf):
        return tuple(_cache_leaf_spec(leaf.shape, mesh, bs, time_axes))

    out = {}
    if "layers" in shapes:  # one super-block's leaves, with the layer dim
        out["layers"] = map_cache(shapes["layers"][0],
                                  lambda leaf: (None,) + spec(leaf))
    if "tail" in shapes:
        out["tail"] = map_cache(shapes["tail"], spec)
    return out


def _spec_at(specs, path):
    """The spec of the parameter at `path` (dict keys and layer indices)
    in a `param_specs` tree; a stacked block's leaf drops its layer dim."""
    node, stacked = specs, False
    for key in path:
        if isinstance(key, int) and isinstance(node, dict):
            stacked = True  # a stacked block: one spec for every layer
        else:
            node = node[key]
    return tuple(node[1:]) if stacked else tuple(node)


def _slices(shape, spec, shards: LMShards):
    """The index of this rank's shard of a tensor of `shape` under `spec`."""
    idx = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        _, k, i = shards.role(entry)
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(idx)


def shard_params(model: Model, params, shards: LMShards, specs, device):
    """This rank's parameter modules: the shard of each of `params` (the
    whole parameter modules, or a function (def, path) → whole array) that
    its spec gives the rank, marked with the spec
    (`sharding/activation.py:held_of`)."""
    held = {}

    def leaf(d, path):
        if not isinstance(params, torch.nn.Module):
            full = params(d, path)
        else:
            full = params
            for key in path:
                full = full[key]
        spec = _spec_at(specs, path)
        held[".".join(map(str, path))] = spec
        part = full[_slices(full.shape, spec, shards)]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.array(part, dtype=np.float32))
        # a copy: a view would keep the whole tensor's storage alive
        return part.to(device, d.dtype, copy=True).contiguous()

    out = build(model.defs(), leaf)
    for name, p in out.named_parameters():
        hold(p, held[name])
    return out


def build_serve_steps(model: Model, mesh, batch: int, max_len: int):
    """(prefill_fn, decode_fn, cache_specs, batch_specs, param_specs, the
    rank's LMShards): the reference's steps as this rank runs them.
    prefill_fn(params, batch) and decode_fn(params, tokens, cache,
    cache_len) take the rank's parameter shards and its rows of the batch
    (`ServeEngine` cuts them) and return logits whole over the vocab for
    those rows, and the rank's cache shards."""
    cfg = model.cfg
    rules = rules_for(cfg.zero_shard, serve=True)
    used, time_axes = serve_batch_axes(batch, mesh, rules)
    bs = spec_entry(used)
    p_specs = param_specs(model.defs(), mesh, rules)
    c_specs = cache_specs(model, mesh, batch, max_len)
    b_specs = {"tokens": (bs, None)}
    if cfg.family == "vlm" and cfg.n_patches:
        b_specs["patches"] = (bs, None, None)
    if cfg.is_encdec:
        b_specs["frames"] = (bs, None, None)
    shards = LMShards(mesh, used, functools.partial(
        _leaf_spec_padded, mesh=mesh, bs=bs, time_axes=time_axes))

    def prefill(params, batch, max_len=max_len):
        with activation_sharding(shards):
            return model.prefill(params, batch, max_len=max_len)

    def decode(params, tokens, cache, cache_len):
        with activation_sharding(shards):
            return model.decode_step(params, tokens, cache, cache_len)

    return prefill, decode, c_specs, b_specs, p_specs, shards


def _leaf_spec_padded(shape, mesh, bs, time_axes):
    """A cache leaf's spec with one entry per dim (the reference's trailing
    whole dims spelled out)."""
    spec = _cache_leaf_spec(shape, mesh, bs, time_axes)
    return tuple(spec) + (None,) * (len(shape) - len(spec))


class ServeEngine:
    """Greedy batched generation on the device that holds `params`, or on
    this rank's device of `mesh`.

    On a mesh `params` may be the whole parameter modules, a function
    (def, path) → whole array (as `bridge.lm_params_from_numpy` reads the
    reference's), or
    the rank's shards already (`shard_params`); the engine keeps only the
    shards.  `batch` is the global batch size."""

    def __init__(self, model: Model, params, batch: int, max_len: int,
                 mesh=None):
        self.model = model
        self.batch = batch
        self.max_len = max_len
        self.mesh = mesh
        self.shards = None
        self._prefill_fn, self._decode_fn = model.prefill, model.decode_step
        if mesh is None:
            self.params = params
            self.device = params["embed"].device
        else:
            from repro_torch.launch.mesh import mesh_device

            (self._prefill_fn, self._decode_fn, self.cache_specs,
             self.batch_specs, self.param_specs, self.shards) = \
                build_serve_steps(model, mesh, batch, max_len)
            self.device = mesh_device(mesh)
            if isinstance(params, torch.nn.Module) and \
                    held_of(params["embed"]) is not None:
                self.params = params
            else:
                self.params = shard_params(model, params, self.shards,
                                           self.param_specs, self.device)
        self.timings: Dict[str, float] = {}
        # the decode step's buffers, made by the first generate
        self._cache = self._tok = self._pos = self._at = self._out = None
        self._decode = None  # the decode Step (a CUDA graph on a card)
        self.logits = None  # the last decode step's logits (rows, vocab)

    def close(self) -> None:
        """Drop the decode graph and the step's buffers (a later
        `generate` makes them anew).  On a mesh, close an engine before
        the process group goes: its graph holds the communicators."""
        self._decode = None
        self._cache = self._tok = self._pos = self._at = self._out = None
        self.logits = None

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a whole batch (the batch itself on one
        device), on the engine's device."""
        if self.shards is None:
            return {k: v.to(self.device) for k, v in batch.items()}
        return {k: v[_slices(v.shape, self.batch_specs[k], self.shards)].to(
            self.device) for k, v in batch.items()}

    @property
    def captures(self) -> int:
        """Decode steps captured as CUDA graphs (0 or 1; 0 on the CPU)."""
        return int(self._decode is not None and self._decode.captured)

    def _step(self) -> None:
        """One greedy decode step on the engine's buffers."""
        self._out.index_copy_(1, self._at.view(1), self._tok)
        logits, _ = self._decode_fn(self.params, self._tok, self._cache,
                                    self._pos)
        self.logits = logits  # on a card, the captured step's output
        self._tok.copy_(torch.argmax(logits, dim=-1)[:, None])
        self._pos += 1
        self._at += 1

    def _buffers(self, cache, tok: torch.Tensor, s: int) -> None:
        """The step's buffers: `cache` and `tok` become its cache and
        token, the position is s."""
        self._cache, self._tok = cache, tok
        self._pos = torch.tensor(s, dtype=torch.int64, device=self.device)
        self._at = torch.zeros((), dtype=torch.int64, device=self.device)
        self._out = torch.zeros((tok.shape[0], self.max_len),
                                dtype=torch.int32, device=self.device)

    def _load(self, cache, tok: torch.Tensor, s: int) -> None:
        """The prefill's cache and first token into the step's buffers."""
        if self._cache is None:  # the first prefill's buffers become them
            self._buffers(cache, tok, s)
            return
        for dst, src in zip(_leaves(self._cache), _leaves(cache)):
            dst.copy_(src)
        self._tok.copy_(tok)
        self._pos.fill_(s)
        self._at.zero_()

    def _prefill_slices(self, batch: Dict[str, Any], s: int) -> None:
        """The prefill in row slices of at most `cfg.prefill_tokens`
        tokens, each written into its rows of the step's cache (zeroed
        first) and its first tokens into the step's token."""
        cfg = self.model.cfg
        if self.shards is not None:
            raise ValueError("a prefill in slices (prefill_tokens) runs on "
                             "one device")
        b = batch["tokens"].shape[0]
        rows = max(1, cfg.prefill_tokens // s)
        sizes = {b, rows, b % rows} - {0}
        if cfg.n_experts and any(_drops(cfg, r * s) for r in sizes):
            raise ValueError("a prefill in slices (prefill_tokens) needs "
                             "routing that drops no token (capacity = "
                             "group size): a slice routes in other groups")
        if self._cache is None:
            self._buffers(init_cache(self.model.cfg, b, self.max_len,
                                     self.device),
                          torch.zeros((b, 1), dtype=torch.int32,
                                      device=self.device), s)
        for r0 in range(0, b, rows):
            part = {k: v[r0:r0 + rows] for k, v in batch.items()}
            with spans.span("lm.prefill_slice", rows=len(part["tokens"]),
                            start=r0):
                cache = map_cache(self._cache,
                                  lambda t: t[r0:r0 + rows].zero_())
                logits, _ = self._prefill_fn(self.params, part,
                                             max_len=self.max_len,
                                             cache=cache)
                self._tok[r0:r0 + rows].copy_(
                    torch.argmax(logits, dim=-1)[:, None])
            spans.count("lm.prefill_slices")
        self._pos.fill_(s)
        self._at.zero_()

    def generate(self, batch: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Greedy-decode n_tokens after the prompt.  Returns (B, n) int32
        ids on the device (on a mesh, the ranks' rows gathered: the same on
        every rank).  Waits for the device once, at the end, and
        fills `timings` with `prefill_ms` (prompt and encoder, the first
        token's argmax and the copy into the step's buffers) and
        `decode_ms` (all n_tokens decode steps; on the first call on a
        card, one eager step and the capture among them)."""
        prompt = batch["tokens"]
        b, s = prompt.shape
        if b != self.batch or s + n_tokens > self.max_len:
            raise ValueError(f"engine built for batch {self.batch} and "
                             f"{self.max_len} positions, got batch {b} "
                             f"with {s} + {n_tokens}")
        batch = self.local_batch(batch)
        s = batch["tokens"].shape[1]
        clock = _Clock(self.device)
        clock.mark()
        with spans.span("lm.prefill", rows=b, length=s):
            if self.model.cfg.prefill_tokens:
                self._prefill_slices(batch, s)
            else:
                logits, cache = self._prefill_fn(self.params, batch,
                                                  max_len=self.max_len)
                self._load(cache, torch.argmax(logits, dim=-1)[:, None].to(
                    torch.int32), s)
        clock.mark()
        left = n_tokens
        with spans.span("lm.decode", steps=n_tokens):
            if self._decode is None and left:
                if self.device.type == "cuda":
                    # the first step, eagerly: a capture wants its kernels
                    # loaded and its library handles made
                    warm_up([self._step], self.device)
                    left -= 1
                self._decode = Step(self._step, self.device)
            for _ in range(left):
                self._decode()
        spans.count("lm.decode_steps", n_tokens)
        clock.mark()
        out = self._out[:, :n_tokens].clone()
        if self.shards is not None and self.shards.batch_entry is not None:
            out = self.shards.gather(out, 0, self.shards.batch_entry)
        if clock.cuda:
            torch.cuda.synchronize(self.device)
        self.timings = {"prefill_ms": clock.ms(0, 1),
                        "decode_ms": clock.ms(1, 2)}
        return out
