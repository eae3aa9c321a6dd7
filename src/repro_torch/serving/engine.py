"""Batched LM serving on one device — counterpart of `repro/serving/engine.py`.

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
runs eagerly.  The prefill runs eagerly.

The reference's mesh, parameter and cache shardings (`cache_specs`,
`build_serve_steps`, `serve_batch_axes`) are not ported: the port serves
on one device (ROADMAP.md, queue 1 item 9 (rest)).
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from repro_torch.models import Model
from repro_torch.serving.graphs import Step, warm_up


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


def _leaves(tree):
    """The tensors of a cache tree, in its (deterministic) order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


class ServeEngine:
    """Greedy batched generation on the device that holds `params`."""

    def __init__(self, model: Model, params, batch: int, max_len: int):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = params["embed"].device
        self.timings: Dict[str, float] = {}
        # the decode step's buffers, made by the first generate
        self._cache = self._tok = self._pos = self._at = self._out = None
        self._decode = None  # the decode Step (a CUDA graph on a card)
        self.logits = None  # the last decode step's logits (B, vocab)

    @property
    def captures(self) -> int:
        """Decode steps captured as CUDA graphs (0 or 1; 0 on the CPU)."""
        return int(self._decode is not None and self._decode.captured)

    def _step(self) -> None:
        """One greedy decode step on the engine's buffers."""
        self._out.index_copy_(1, self._at.view(1), self._tok)
        logits, _ = self.model.decode_step(self.params, self._tok,
                                           self._cache, self._pos)
        self.logits = logits  # on a card, the captured step's output
        self._tok.copy_(torch.argmax(logits, dim=-1)[:, None])
        self._pos += 1
        self._at += 1

    def _load(self, cache, tok: torch.Tensor, s: int) -> None:
        """The prefill's cache and first token into the step's buffers."""
        if self._cache is None:  # the first prefill's buffers become them
            self._cache, self._tok = cache, tok
            self._pos = torch.tensor(s, dtype=torch.int64, device=self.device)
            self._at = torch.zeros((), dtype=torch.int64, device=self.device)
            self._out = torch.zeros((self.batch, self.max_len),
                                    dtype=torch.int32, device=self.device)
            return
        for dst, src in zip(_leaves(self._cache), _leaves(cache)):
            dst.copy_(src)
        self._tok.copy_(tok)
        self._pos.fill_(s)
        self._at.zero_()

    def generate(self, batch: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Greedy-decode n_tokens after the prompt.  Returns (B, n) int32
        ids on the device.  Waits for the device once, at the end, and
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
        batch = {k: v.to(self.device) for k, v in batch.items()}
        clock = _Clock(self.device)
        clock.mark()
        logits, cache = self.model.prefill(self.params, batch,
                                           max_len=self.max_len)
        self._load(cache, torch.argmax(logits, dim=-1)[:, None].to(
            torch.int32), s)
        clock.mark()
        left = n_tokens
        if self._decode is None and left:
            if self.device.type == "cuda":
                # the first step, eagerly: a capture wants its kernels
                # loaded and its library handles made
                warm_up([self._step], self.device)
                left -= 1
            self._decode = Step(self._step, self.device)
        for _ in range(left):
            self._decode()
        clock.mark()
        out = self._out[:, :n_tokens].clone()
        if clock.cuda:
            torch.cuda.synchronize(self.device)
        self.timings = {"prefill_ms": clock.ms(0, 1),
                        "decode_ms": clock.ms(1, 2)}
        return out
