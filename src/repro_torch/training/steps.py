"""The train step — counterpart of `repro/training/steps.py`.

`build_train_step(model, mesh, opt_cfg)` returns (step_fn, state specs,
batch specs), as the reference's does.  The step runs eagerly: gradients
by autograd through `Model.loss_fn` (remat and the chunked loss recompute
in the backward), accumulated in fp32 over microbatches in a Python loop
(the reference's `lax.scan`), divided by the count, loss and aux
averaged; then top-k compression with error feedback when asked, then
AdamW, both in place (the reference donates the state).  The spec trees
are the reference's, through `sharding/specs.py:param_specs`.

`mesh` None is one device.  On a (data, model) DeviceMesh of ranks
(`launch/mesh.py:make_local_mesh`) every rank holds only the shards of
the parameters, moments and residual that `state_specs` gives it
(`make_train_state(..., mesh=)`) and steps on its rows of the batch
(`batch_specs`, `data/pipeline.py:device_put_batch`).  In each
microbatch the model runs under `activation_sharding`: every parameter
is gathered over its "data" cut once (FSDP), whose backward
reduce-scatters the gradient into the rank's shard (ZeRO: one
reduce-scatter a microbatch per "data"-cut leaf, the fp32 accumulator
cut like the parameters; a leaf the batch dims do not cut is summed over
them instead), and tensor and expert parallelism over "model" run the
collectives of `sharding/activation.py`.  The loss and aux are the
global batch's; `global_norm` counts each element once across the mesh,
and the compression's threshold is the whole leaf's.  `step.shards`
holds the rank's `LMShards` (its collective counts cover the last step)
and `step.accumulator` the last step's accumulated gradients.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import Model
from repro_torch.models.params import trainable
from repro_torch.optim import (AdamWConfig, AdamWState, CompressionState,
                               adamw_init, adamw_update, compress_init,
                               topk_compress_update)
from repro_torch.optim.adamw import leaves
from repro_torch.sharding.activation import (LMShards, activation_sharding,
                                             hold)
from repro_torch.sharding.specs import (batch_spec, mesh_dims, param_specs,
                                        rules_for)

# the dims of the reference's one-device mesh (make_local_mesh on 1 device)
ONE_DEVICE = {"data": 1, "model": 1}


class TrainState(NamedTuple):
    params: Any
    opt: Any
    compress: Optional[Any]


def _dims(mesh) -> dict:
    return dict(ONE_DEVICE) if mesh is None else mesh_dims(mesh)


def _over_ranks(mesh) -> bool:
    """Whether `mesh` is a DeviceMesh of ranks (None, or a {dim: size}
    dict of one device, is one device; a dict of more raises: the spec
    functions take one, a step needs the ranks)."""
    if mesh is None:
        return False
    if hasattr(mesh, "get_group"):
        return True
    if math.prod(_dims(mesh).values()) > 1:
        raise TypeError(f"a train step over {_dims(mesh)} needs a "
                        "DeviceMesh of that many ranks "
                        "(launch/mesh.py:make_local_mesh)")
    return False


def train_shards(model: Model, mesh) -> LMShards:
    """The rank's `LMShards` for training on `mesh`: the batch cut over
    every batch dim of the train rules."""
    return LMShards(mesh, rules_for(model.cfg.zero_shard).batch_axes)


def shard_train_state(model: Model, state: "TrainState",
                      mesh) -> "TrainState":
    """The rank's shards of a whole state under `state_specs` (on one
    device, the state itself)."""
    from repro_torch.launch.mesh import mesh_device

    if not _over_ranks(mesh):
        return state
    from repro_torch.serving.engine import shard_params

    specs = state_specs(model, mesh, compress=state.compress is not None)
    shards = train_shards(model, mesh)
    dev = mesh_device(mesh)

    def cut(tree):
        return shard_params(model, tree, shards, specs.params, dev)

    return TrainState(
        params=trainable(cut(state.params)),
        opt=AdamWState(step=state.opt.step.to(dev), m=cut(state.opt.m),
                       v=cut(state.opt.v)),
        compress=None if state.compress is None else CompressionState(
            residual=cut(state.compress.residual)))


def make_train_state(model: Model, generator: torch.Generator,
                     compress: bool = False, mesh=None) -> TrainState:
    """Random parameters (with gradients on) from `generator`, on its
    device, zero AdamW moments and, with `compress`, a zero residual.
    With a mesh of ranks, this rank's shards of that state (the same
    draws as one device's, cut by `state_specs`)."""
    params = trainable(model.init(generator))
    state = TrainState(params=params, opt=adamw_init(params),
                       compress=compress_init(params) if compress else None)
    return shard_train_state(model, state, mesh)


def abstract_train_state(model: Model, compress: bool = False,
                         mesh=None) -> TrainState:
    """The state's shapes and dtypes on the `meta` device (no storage),
    whole; with a mesh each parameter leaf is marked with its spec
    (`sharding/activation.py:hold`), so a restore cuts each rank's
    shard."""
    params = trainable(model.abstract())
    if mesh is not None:
        from repro_torch.serving.engine import _spec_at

        specs = param_specs(model.defs(), _dims(mesh),
                            rules_for(model.cfg.zero_shard))
        for name, p in params.named_parameters():
            hold(p, _spec_at(specs, [int(k) if k.isdigit() else k
                                     for k in name.split(".")]))
    return TrainState(params=params, opt=adamw_init(params),
                      compress=compress_init(params) if compress else None)


def state_specs(model: Model, mesh, compress: bool = False) -> TrainState:
    """Spec tree congruent with the reference's TrainState (a dict of
    specs per parameter block, a stacked block's with its "layers" dim)."""
    pspecs = param_specs(model.defs(), _dims(mesh),
                         rules_for(model.cfg.zero_shard))
    return TrainState(
        params=pspecs, opt=AdamWState(step=(), m=pspecs, v=pspecs),
        compress=CompressionState(residual=pspecs) if compress else None)


def batch_specs(model: Model, mesh, kind: str = "train"):
    bs = batch_spec(_dims(mesh), rules_for(model.cfg.zero_shard))
    specs = {"tokens": bs + (None,), "labels": bs + (None,)}
    if model.cfg.family == "vlm" and model.cfg.n_patches:
        specs["patches"] = bs + (None, None)
    if model.cfg.is_encdec:
        specs["frames"] = bs + (None, None)
    if kind != "train":
        specs.pop("labels")
    return specs


ACT_BUDGET_BYTES = 4 * 2**30   # per-device activation budget for auto-µbatch
_ACT_FACTOR = 2.5              # the reference's calibration


def auto_microbatches(cfg, global_batch: int, seq: int, mesh) -> int:
    """Smallest power-of-2 microbatch count keeping the per-device remat
    carry (n_layers × B_local × S × D × 2 B × factor) under budget, the
    per-microbatch batch divisible by the data dims.  A pure function of
    the mesh's dims (None: one device)."""
    dims = _dims(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= dims.get(a, 1)
    b_local = max(global_batch // dp, 1)
    est = cfg.n_layers * b_local * seq * cfg.d_model * 2 * _ACT_FACTOR
    k = 1
    while (est / k > ACT_BUDGET_BYTES and k < global_batch
           and global_batch % (2 * k) == 0
           and (global_batch // (2 * k)) % dp == 0):
        k *= 2
    return k


def _grads(model: Model, params, batch, shards: Optional[LMShards] = None):
    """(loss, aux, grads): grads in the parameters' order, a zero for a
    parameter the loss does not reach (as jax.grad gives).  With `shards`
    the model runs as this rank of the mesh: grads are the rank's shards
    of the global batch's gradients, loss and aux the global batch's."""
    plist = leaves(params)
    if shards is None:
        loss, aux = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
    else:
        with activation_sharding(shards):
            shards.gather_params(plist)
            try:
                loss, aux = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, plist, allow_unused=True)
            finally:
                shards.memo = None
            with torch.no_grad():
                if shards.batch_entry is not None:
                    loss = shards.psum(loss.detach(), shards.batch_entry)
                    aux = shards.psum(aux.detach(), shards.batch_entry) / \
                        shards.size(shards.batch_entry)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(plist, grads)]
    return loss.detach(), aux.detach(), grads


def _whole_rows(batch, shards: LMShards):
    """The global batch from every rank's rows (all_gather over the batch
    dims): microbatch i is the global rows i·B/n … (i+1)·B/n, as the
    reference's reshape of the global batch makes it, and each rank takes
    its block of those."""
    if shards.batch_entry is None:
        return batch
    with torch.no_grad():
        return {k: shards.gather(v, 0, shards.batch_entry)
                for k, v in batch.items()}


def build_train_step(model: Model, mesh, opt_cfg: AdamWConfig,
                     compress_frac: Optional[float] = None,
                     donate: bool = True, microbatches: Optional[int] = None,
                     global_batch: Optional[int] = None,
                     seq_len: Optional[int] = None):
    """Returns (step, state specs, batch specs); step(state, batch) →
    (state, metrics {loss, aux, grad_norm, lr}, 0-d fp32 tensors).

    The step updates the state's tensors in place and returns them (the
    reference donates the state); donate=False raises ValueError.
    microbatches: the gradient-accumulation factor; None →
    cfg.microbatches, else the activation-budget heuristic when
    (global_batch, seq_len) are known, else 1.  On a mesh of ranks the
    state is the rank's shards and the batch its rows (module doc)."""
    shards = train_shards(model, mesh) if _over_ranks(mesh) else None
    if not donate:
        raise ValueError("the train step updates the state in place "
                         "(donate=True)")
    sspecs = state_specs(model, mesh, compress=compress_frac is not None)
    bspecs = batch_specs(model, mesh)
    if microbatches is None:
        if model.cfg.microbatches:
            microbatches = model.cfg.microbatches
        elif global_batch is not None and seq_len is not None:
            microbatches = auto_microbatches(model.cfg, global_batch,
                                             seq_len, mesh)
        else:
            microbatches = 1
    n_mb = max(int(microbatches), 1)

    def step(state: TrainState, batch):
        if shards is not None:
            shards.counts.clear()
            shards.grad_counts.clear()
        if n_mb == 1:
            loss, aux, grads = _grads(model, state.params, batch, shards)
        else:
            grads, losses, auxes = None, [], []
            whole = batch if shards is None else _whole_rows(batch, shards)
            rows = whole["tokens"].shape[0]
            if shards is not None and (
                    rows % n_mb
                    or rows // n_mb % shards.size(shards.batch_entry)):
                raise ValueError(
                    f"a batch of {rows} rows in {n_mb} microbatches does not "
                    f"divide over the batch dims {shards.batch_axes} of the "
                    f"mesh {shards.dims}")
            for i in range(n_mb):
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in whole.items()}
                if shards is not None:  # this rank's rows of microbatch i
                    mb = {k: shards.part(v, 0, shards.batch_entry)
                          for k, v in mb.items()}
                l, a, g = _grads(model, state.params, mb, shards)
                if grads is None:
                    grads = [gi.float() for gi in g]
                else:
                    for s, gi in zip(grads, g):
                        s.add_(gi.float())
                losses.append(l)
                auxes.append(a)
                del g
            grads = [g / n_mb for g in grads]
            loss = torch.mean(torch.stack(losses))
            aux = torch.mean(torch.stack(auxes))
        step.accumulator = grads
        new_comp = state.compress
        if compress_frac is not None and state.compress is not None:
            grads, new_comp = topk_compress_update(grads, state.compress,
                                                   compress_frac, shards)
        params, opt, metrics = adamw_update(grads, state.opt, state.params,
                                            opt_cfg, shards)
        metrics = dict(metrics, loss=loss, aux=aux)
        return TrainState(params, opt, new_comp), metrics

    step.shards = shards
    step.accumulator = None
    return step, sspecs, bspecs
