"""Deterministic data pipeline — counterpart of `repro/data/pipeline.py`.

* `SyntheticLMDataset`: a token stream with a learnable structure
  (repeating n-gram templates + noise), so a few hundred train steps show
  a falling loss.  Every batch is a pure function of (seed, step), drawn
  with the reference's numpy `RandomState` calls in its order, so the
  batches are the reference's bit for bit, and a resumed run regenerates
  exactly the batches it needs: no data state to checkpoint.
* `TensorChunkLoader`: mode-1 slabs of the paper's planted tensor, made
  on the device that owns them (`core/synthetic.py`, a torch.Generator).
* `device_put_batch`: host → device copy of a batch (on a mesh of ranks,
  this rank's rows under the batch specs).
* `Prefetcher`: a thread builds the next host batches while a step runs;
  the copy to the device happens in the caller's thread, on its stream,
  when the batch is taken (no pinned buffer is reused under a copy).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.core.synthetic import make_planted_tensor_chunked
from repro_torch.core.types import PlantedSpec


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_templates: int = 64
    template_len: int = 16
    noise: float = 0.05

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        self.templates = rs.randint(
            1, self.vocab_size,
            size=(self.n_templates, self.template_len)).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) → {tokens, labels}, int32 numpy."""
        rs = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        reps = -(-self.seq_len // self.template_len) + 1
        ids = rs.randint(0, self.n_templates,
                         size=(self.global_batch, reps))
        seqs = self.templates[ids].reshape(self.global_batch, -1)
        flip = rs.rand(*seqs.shape) < self.noise
        noise_tok = rs.randint(1, self.vocab_size, size=seqs.shape)
        seqs = np.where(flip, noise_tok, seqs).astype(np.int32)
        tokens = seqs[:, :self.seq_len]
        labels = seqs[:, 1:self.seq_len + 1]
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class TensorChunkLoader:
    """Planted-tensor slabs for the MSC driver (paper §IV data model), made
    on `device` from a generator seeded with `seed`."""
    spec: PlantedSpec
    n_chunks: int
    seed: int = 0
    device: Any = "cuda"

    def __iter__(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        yield from make_planted_tensor_chunked(gen, self.spec, self.n_chunks)

    def full_tensor(self) -> torch.Tensor:
        rows = sorted(self, key=lambda t: t[0])
        return torch.cat([s for _, s in rows], dim=0)


def device_put_batch(batch: Dict[str, Any], device="cuda", specs=None,
                     shards=None) -> Dict[str, torch.Tensor]:
    """Each array of the batch as a tensor on `device` (a copy).  With
    `specs` ({name: spec}, `training/steps.py:batch_specs`) and `shards`
    (the rank's `LMShards`), each array is cut to this rank's block first
    (the reference's `device_put` onto batch shardings)."""
    if specs is not None and shards is not None:
        from repro_torch.serving.engine import _slices

        for k, v in batch.items():
            for n, entry in zip(np.shape(v), specs[k]):
                if n % shards.size(entry):
                    raise ValueError(
                        f"batch {k!r} of shape {np.shape(v)} does not "
                        f"divide over {entry!r} of the mesh {shards.dims}")
        batch = {k: np.asarray(v)[_slices(np.shape(v), specs[k], shards)]
                 for k, v in batch.items()}
    return {k: torch.tensor(np.ascontiguousarray(v), device=device)
            for k, v in batch.items()}


class Prefetcher:
    """Background host batches, `depth` ahead: a thread draws them from
    `it` while the caller's step runs, and `next` copies the oldest to
    `device` in the caller's thread (None: host batches as they are)."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = device
        self._it = it
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        for item in self._it:
            self._q.put(item)
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if self._device is None:
            return item
        return device_put_batch(item, self._device)
