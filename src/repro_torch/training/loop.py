"""Fault-tolerant training loop — counterpart of `repro/training/loop.py`.

  * auto-resume: on start, restore the newest checkpoint that verifies
    (a corrupt one falls back to the previous step, none to a fresh
    state);
  * periodic and final checkpoints, written off the step path
    (`CheckpointManager`: the state is copied to the host before the
    next step updates it in place);
  * step watchdog: an EMA of step wall time; a step slower than
    `straggler_factor` × EMA is logged as a straggler event;
  * failure injection (`fail_at_step`) for the crash → restart →
    bitwise-resume path, and `restart_s`: seconds from each caught
    failure to the end of the first step after it;
  * metrics: loss / aux / grad-norm / lr / step time per step, on the
    host.

One device (`device`, the card by default), or a (data, model) mesh of
ranks (`mesh`, a DeviceMesh: every rank runs the loop in lockstep on its
device, `training/steps.py`).  On a mesh the fresh state is made as the
rank's shards, a resume cuts the rank's shards of the newest checkpoint
for the mesh live now, each rank steps on its rows of every batch, the
checkpoints gather whole leaves on the step path and the mesh's first
rank writes them (`CheckpointManager(shards=…)`), the watchdog reads
rank 0's step time (a broadcast), and an injected failure raises on
every rank at the same step, so they restart together.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig

from .steps import (TrainState, abstract_train_state, build_train_step,
                    make_train_state)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    log_every: int = 10
    compress_frac: Optional[float] = None
    fail_at_step: Optional[int] = None  # failure injection (tests)


class _InjectedFailure(RuntimeError):
    pass


class TrainLoop:
    def __init__(self, model: Model, mesh, opt_cfg: AdamWConfig,
                 loop_cfg: TrainLoopConfig, dataset: SyntheticLMDataset,
                 seed: int = 0, device="cuda"):
        self.model = model
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.cfg = loop_cfg
        self.dataset = dataset
        self.seed = seed
        self.step_fn, self.state_specs, self.batch_specs = \
            build_train_step(model, mesh, opt_cfg,
                             compress_frac=loop_cfg.compress_frac)
        self.shards = self.step_fn.shards
        if self.shards is not None:
            from repro_torch.launch.mesh import mesh_device

            self.device = mesh_device(mesh)
        else:
            self.device = resolve_device(device)
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep,
                                      async_save=loop_cfg.async_ckpt,
                                      shards=self.shards)
        self.metrics: List[Dict[str, float]] = []
        self.straggler_events: List[int] = []
        self.restart_s: List[float] = []
        self._failed_at: Optional[float] = None

    # ---- state ----
    def fresh_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return make_train_state(self.model, gen,
                                compress=self.cfg.compress_frac is not None,
                                mesh=self.mesh if self.shards else None)

    def resume_or_init(self):
        """(start_step, state): the newest checkpoint that restores, else
        step 0 and a fresh state."""
        like = abstract_train_state(
            self.model, compress=self.cfg.compress_frac is not None,
            mesh=self.mesh if self.shards else None)
        try:
            step, tree, _ = self.ckpt.restore_latest(like, self.device)
        except Exception:
            step = None  # corrupt checkpoint: fall through to fresh
        if step is None:
            return 0, self.fresh_state()
        return step, tree

    # ---- loop ----
    def run(self, state: Optional[TrainState] = None,
            start_step: Optional[int] = None) -> TrainState:
        if state is None:
            start_step, state = self.resume_or_init()
        ema = None
        saved = None
        for step in range(start_step, self.cfg.total_steps):
            if self.cfg.fail_at_step is not None and \
                    step == self.cfg.fail_at_step:
                raise _InjectedFailure(f"injected failure at step {step}")
            batch = device_put_batch(self.dataset.batch(step), self.device,
                                     self.batch_specs, self.shards)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = self._rank0(time.perf_counter() - t0)
            if self._failed_at is not None:
                self.restart_s.append(time.perf_counter() - self._failed_at)
                self._failed_at = None
            if ema is not None and dt > self.cfg.straggler_factor * ema:
                self.straggler_events.append(step)
            ema = dt if ema is None else \
                (1 - self.cfg.ema_alpha) * ema + self.cfg.ema_alpha * dt
            metrics["step_time_s"] = dt
            self.metrics.append(metrics)
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
                saved = step + 1
        if saved != self.cfg.total_steps:  # else just saved, same state
            self.ckpt.save(self.cfg.total_steps, state)
        self.ckpt.wait()
        return state

    def _rank0(self, dt: float) -> float:
        """Rank 0's step time on every rank of a mesh (dt alone off one)."""
        if self.shards is None:
            return dt
        import torch.distributed as dist

        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t)

    def run_with_restarts(self, max_restarts: int = 3) -> TrainState:
        """Crash-resilient driver: restart from the newest checkpoint on an
        injected failure (the single-host analogue of a pod-level restart
        controller)."""
        attempts = 0
        while True:
            try:
                return self.run()
            except _InjectedFailure:
                self._failed_at = time.perf_counter()
                attempts += 1
                self.cfg.fail_at_step = None  # the failure was transient
                if attempts > max_restarts:
                    raise
