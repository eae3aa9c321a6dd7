"""Batched LM serving on one device — counterpart of `repro/serving/engine.py`.

`ServeEngine` runs greedy batched generation: one prefill over the
prompt (and, for an encoder–decoder model, the encoder over the frames),
then one decode step per token against the KV cache, which each step
updates in place (the counterpart of the reference's donated cache
buffers).  The next token is the `argmax` of the logits, taken on the
device (ties go to the first maximal index, as `jnp.argmax` breaks
them); nothing is read back to the host until the end.

The reference's mesh, parameter and cache shardings (`cache_specs`,
`build_serve_steps`) are not ported: the port serves on one device
(ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from repro_torch.models import Model


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


class ServeEngine:
    """Greedy batched generation on the device that holds `params`."""

    def __init__(self, model: Model, params, batch: int, max_len: int):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = params["embed"].device
        self.timings: Dict[str, float] = {}

    def generate(self, batch: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Greedy-decode n_tokens after the prompt.  Returns (B, n) int32
        ids on the device.  Waits for the device once, at the end, and
        fills `timings` with `prefill_ms` (prompt and encoder, and the
        first token's argmax) and `decode_ms` (all n_tokens decode
        steps)."""
        prompt = batch["tokens"]
        b, s = prompt.shape
        if b != self.batch or s + n_tokens > self.max_len:
            raise ValueError(f"engine built for batch {self.batch} and "
                             f"{self.max_len} positions, got batch {b} "
                             f"with {s} + {n_tokens}")
        batch = {k: v.to(self.device) for k, v in batch.items()}
        clock = _Clock(self.device)
        clock.mark()
        logits, cache = self.model.prefill(self.params, batch,
                                           max_len=self.max_len)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        clock.mark()
        outs = []
        cache_len = s
        for _ in range(n_tokens):
            outs.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, cache,
                                                   cache_len)
            cache_len += 1
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        clock.mark()
        out = torch.cat(outs, dim=1)
        if clock.cuda:
            torch.cuda.synchronize(self.device)
        self.timings = {"prefill_ms": clock.ms(0, 1),
                        "decode_ms": clock.ms(1, 2)}
        return out
