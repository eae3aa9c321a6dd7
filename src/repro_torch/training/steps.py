"""The train step — counterpart of `repro/training/steps.py`.

`build_train_step(model, mesh, opt_cfg)` returns (step_fn, state specs,
batch specs), as the reference's does.  The step runs eagerly on one
device: gradients by autograd through `Model.loss_fn` (remat and the
chunked loss recompute in the backward), accumulated in fp32 over
microbatches in a Python loop (the reference's `lax.scan`), divided by
the count, loss and aux averaged; then top-k compression with error
feedback when asked, then AdamW, both in place (the reference donates
the state).  The spec trees are the reference's, through
`sharding/specs.py:param_specs`, for the mesh that training over ranks
will use: a mesh of more than one rank raises NotImplementedError here
(ROADMAP.md queue 1 item 12 (d)).
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
from repro_torch.sharding.specs import (batch_spec, mesh_dims, param_specs,
                                        rules_for)

TRAIN_MESH_TODO = (
    "trains on one device only: training over ranks (ZeRO over 'data', "
    "the model axis, collectives that carry gradients) is ROADMAP.md "
    "queue 1 item 12 (d)")
# the dims of the reference's one-device mesh (make_local_mesh on 1 device)
ONE_DEVICE = {"data": 1, "model": 1}


class TrainState(NamedTuple):
    params: Any
    opt: Any
    compress: Optional[Any]


def _dims(mesh) -> dict:
    return dict(ONE_DEVICE) if mesh is None else mesh_dims(mesh)


def require_one_device(mesh) -> None:
    """Raise NotImplementedError for a mesh of more than one rank."""
    if math.prod(_dims(mesh).values()) > 1:
        raise NotImplementedError(f"TrainLoop {TRAIN_MESH_TODO}; mesh "
                                  f"{_dims(mesh)}")


def make_train_state(model: Model, generator: torch.Generator,
                     compress: bool = False) -> TrainState:
    """Random parameters (with gradients on) from `generator`, on its
    device, zero AdamW moments and, with `compress`, a zero residual."""
    params = trainable(model.init(generator))
    return TrainState(params=params, opt=adamw_init(params),
                      compress=compress_init(params) if compress else None)


def abstract_train_state(model: Model, compress: bool = False) -> TrainState:
    """The state's shapes and dtypes on the `meta` device (no storage)."""
    params = trainable(model.abstract())
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


def _grads(model: Model, params, batch):
    """(loss, aux, grads): grads in the parameters' order, a zero for a
    parameter the loss does not reach (as jax.grad gives)."""
    plist = leaves(params)
    loss, aux = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(plist, grads)]
    return loss.detach(), aux.detach(), grads


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
    (global_batch, seq_len) are known, else 1."""
    require_one_device(mesh)
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
        if n_mb == 1:
            loss, aux, grads = _grads(model, state.params, batch)
        else:
            grads, losses, auxes = None, [], []
            for i in range(n_mb):
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, a, g = _grads(model, state.params, mb)
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
        new_comp = state.compress
        if compress_frac is not None and state.compress is not None:
            grads, new_comp = topk_compress_update(grads, state.compress,
                                                   compress_frac)
        params, opt, metrics = adamw_update(grads, state.opt, state.params,
                                            opt_cfg)
        metrics = dict(metrics, loss=loss, aux=aux)
        return TrainState(params, opt, new_comp), metrics

    return step, sspecs, bspecs
