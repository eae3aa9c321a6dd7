"""One captured program per step: the port's counterpart of `jax.jit`.

On a card a `Step` captures its function once into a CUDA graph and
replays it; on the CPU, which the caller asks for explicitly, the same
function is called each time.  Between replays nothing reads the host:
the graph's inputs and outputs sit at fixed device addresses (static
buffers the caller writes in place, and tensors the capture allocated
from the graph's memory pool, `Step.out`).  A capture that fails raises;
nothing falls back to eager launches.

On a mesh of NCCL ranks a step holds the ranks' collectives, captured
as graph nodes: every rank captures and replays the same steps in the
same order.  The caller's warm-up runs each function once eagerly on the
capture stream first, which also makes each communicator (a first NCCL
call inside a capture fails).  gloo collectives cannot be captured; on
the CPU the steps run eagerly.

Launch counts: a kernel wrapper called under capture adds to its
module's `captured` count and launches nothing; each replay adds the
launches its capture recorded to the module's `launches`, so the counts
are those of kernels that reached the device.
"""
from __future__ import annotations

import functools
import inspect
import weakref
from typing import Callable, Sequence

import torch


def _kernel_modules():
    from repro_torch.kernels import flash_attention, gram, power_iter, ring

    return (power_iter, ring, gram, flash_attention)


def capture_stream(device) -> "torch.cuda.Stream":
    """The process's one stream for warm-ups and captures on `device`.

    PyTorch keeps a cuBLAS workspace per stream for the life of the
    process, so a new stream per capture would leave one behind each
    time.  The workspace is made here, once, by a small product on the
    stream: a caller that sets the stream up before it takes a memory
    baseline sees none of it."""
    dev = torch.device(device)
    return _capture_stream(torch.cuda.current_device() if dev.index is None
                           else dev.index)


@functools.cache
def _capture_stream(index: int) -> "torch.cuda.Stream":
    stream = torch.cuda.Stream(index)
    with torch.cuda.stream(stream):
        a = torch.ones((8, 8), device=index)
        (a @ a) + (a.bfloat16() @ a.bfloat16()).float()
    stream.synchronize()
    return stream


def warm_up(fns: Sequence[Callable], device: torch.device) -> None:
    """Call each of fns once, eagerly, on the capture stream: a capture
    wants its kernels loaded and its library handles made beforehand."""
    if device.type != "cuda":
        return
    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream(device).wait_stream(side)


class Step:
    """fn(*args) as one program on `device`: captured into a CUDA graph
    (in the memory pool `pool`, shared by the steps of one caller) and
    replayed on a card, called on the CPU.  `out` is what the capture
    returned; `pool_bytes` the device memory the capture added to the
    pools; `launches` the kernel launches of one replay, by module.

    A bound method is held weakly: its object usually holds the step, and
    a cycle would keep a dropped owner's graph (and on a mesh the
    communicators it captured) alive until a garbage collection."""

    def __init__(self, fn: Callable, device: torch.device, pool=None,
                 args: tuple = ()):
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self._args = tuple(args)
        self.graph = None
        self.out = None
        self.pool_bytes = 0
        self.launches = {}
        if device.type != "cuda":
            return
        mods = _kernel_modules()
        before = [m.captured for m in mods]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph, pool=pool,
                                  stream=capture_stream(device)):
                reserved = torch.cuda.memory_reserved(device)
                self.out = fn(*self._args)
                self.pool_bytes = (torch.cuda.memory_reserved(device)
                                   - reserved)
        self.launches = {m: m.captured - b for m, b in zip(mods, before)
                         if m.captured != b}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self):
        """Replay (a card) or call (the CPU); returns the step's output."""
        if self.graph is None:
            return self._fn()(*self._args)
        self.graph.replay()
        for mod, n in self.launches.items():
            mod.launches += n
        return self.out
