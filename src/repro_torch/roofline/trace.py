"""One rank's step traced on fake tensors — the port's counterpart of
`repro/roofline/hlo.py`.

The reference reads its roofline terms from XLA's compiled HLO text.  The
port has no compiler: a step is eager PyTorch.  So the dry run
(`launch/dryrun.py`) runs the step itself, as one rank of a fake process
group, on fake tensors (`FakeTensorMode`: shapes, dtypes and devices, no
storage, no kernel), and `StepTrace` records what it ran:

  * FLOPs from `FlopCounterMode` with `FLOP_FORMULAS` added: the
    matrix-vector and vector-vector products it counts as 0 (the
    reference's analyzer counts every `dot`);
  * the HBM traffic model: Σ (operand bytes + output bytes) over every
    operation the step dispatches, collectives included, views and
    queries excepted.  The reference's model
    sums the same over the top-level instructions after XLA's fusion, so
    a fused chain there reads its inputs once; eager PyTorch does not
    fuse, and this is an upper bound for a fused step;
  * every collective the step runs on the fake group (`c10d` ops): its
    kind under the reference's names, operand and output bytes and group
    size, and the reference's ring model of the bytes each device sends
    over its links (`CollectiveStat.link_bytes`);
  * memory: the bytes of the step's arguments (handed in), of its
    outputs (and the part of those that are arguments updated in place:
    the reference's donated aliases), and the peak of the bytes the step
    allocated and held at once (the reference's temp).

A trace runs every Python loop the step takes but the per-token
recurrences, which step through `scan_steps`: on fake tensors under the
recorder it runs the step once and multiplies what that step did by the
trip count (the reference's `known_trip_count` multiplier), so a
32768-token prefill traces one token a layer.  Every count is this
rank's; `ranks` scales them to the mesh.  Nothing here touches a device:
a traced op allocates no storage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, k = a_shape
    return 2 * m * k


def _addmv_flop(self_shape, a_shape, b_shape, *args, out_shape=None,
                **kwargs) -> int:
    return _mv_flop(a_shape, b_shape)


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


# the products FlopCounterMode's own registry leaves out, passed through
# its `custom_mapping` (torch's global registry is left as it is)
FLOP_FORMULAS = {aten.mv: _mv_flop, aten.addmv: _addmv_flop,
                 aten.dot: _dot_flop, aten.vdot: _dot_flop}


def flop_counter():
    """A `FlopCounterMode` that counts every product of the step."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)


# the c10d ops the port calls → the reference's collective kinds
# (`hlo.py:COLLECTIVE_OPS`); a recv is the other end of a send, counted
# there.  Any other c10d op raises: it is not modelled.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "broadcast_": "collective-broadcast",
}
_NO_TRAFFIC = {"recv_", "barrier"}
# the c10d ops whose first two arguments are the outputs and the inputs
_OUT_IN = {"allgather_", "_allgather_base_", "_reduce_scatter_base_",
           "alltoall_base_"}
# ops that make a tensor without moving data: allocations, and the
# reshape of a contiguous result that matmul's decomposition takes
_NO_DATA = {"empty", "empty_like", "new_empty", "empty_strided",
            "_unsafe_view"}


@dataclasses.dataclass
class CollectiveStat:
    """One collective the step ran (the reference's record)."""
    kind: str
    operand_bytes: float
    output_bytes: float
    ranks: tuple              # the group's global ranks
    count: float = 1.0        # executed count (trip-multiplied)

    @property
    def group_size(self) -> int:
        return len(self.ranks)

    @property
    def link_bytes(self) -> float:
        """Ring-model per-device link traffic for ONE execution (the
        reference's `hlo.py:CollectiveStat.link_bytes`)."""
        g = max(self.group_size, 1)
        if g == 1:
            return 0.0
        f = (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * self.operand_bytes * f
        if self.kind == "all-gather":
            return self.output_bytes * f
        if self.kind in ("reduce-scatter", "all-to-all"):
            return self.operand_bytes * f
        if self.kind == "collective-broadcast":
            return self.output_bytes
        return self.operand_bytes


@dataclasses.dataclass
class StepTrace:
    """What one rank's traced step did (see the module doc)."""
    ranks: int
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collectives: List[CollectiveStat] = dataclasses.field(
        default_factory=list)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    peak_bytes: float = 0.0

    @property
    def collective_operand_bytes(self) -> float:
        return sum(c.operand_bytes * c.count for c in self.collectives)

    @property
    def collective_link_bytes(self) -> float:
        return sum(c.link_bytes * c.count for c in self.collectives)

    def by_kind(self) -> Dict[str, Dict[str, float]]:
        """{kind: count, operand_bytes, output_bytes, link_bytes}, the
        reference's `HloAnalysis.by_kind`."""
        out: Dict[str, Dict[str, float]] = {}
        for c in self.collectives:
            d = out.setdefault(c.kind, {"count": 0.0, "operand_bytes": 0.0,
                                        "output_bytes": 0.0,
                                        "link_bytes": 0.0})
            d["count"] += c.count
            d["operand_bytes"] += c.operand_bytes * c.count
            d["output_bytes"] += c.output_bytes * c.count
            d["link_bytes"] += c.link_bytes * c.count
        return out

    def counts(self) -> Dict[str, int]:
        """Collectives by kind in `LMShards.counts`' names."""
        return {k.replace("-", "_"): int(v["count"])
                for k, v in self.by_kind().items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of a tree of tensors, modules (their parameters and
    buffers), dicts, lists and tuples."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _group_ranks(args) -> tuple:
    """The global ranks of the process group among a c10d op's arguments
    (a ScriptObject that boxes it)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(a)))
    raise ValueError("a collective without a process group")


class _Recorder(TorchDispatchMode):
    """Bytes, collectives and live storages of every dispatched op."""

    def __init__(self, trace: StepTrace, held: set, counter,
                 trip_count: bool):
        super().__init__()
        self.trace = trace
        self.held = held        # storages of the arguments
        self.counter = counter  # the step's FlopCounterMode
        self.trip_count = trip_count  # `scan_steps` traces one step
        self.live: Dict[int, int] = {}
        self.now = 0
        self.high = 0           # the most held since `scan` last set it

    def _release(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.held or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.now += st.nbytes()
            weakref.finalize(st, self._release, key)
        self.high = max(self.high, self.now)
        self.trace.peak_bytes = max(self.trace.peak_bytes, self.now)

    def scan(self, step, box: list, length: int):
        """`scan_steps` traced: step 0 run once on the carry in `box`,
        what it did counted `length` times (see there)."""
        trace, flops = self.trace, self.counter.flop_counts["Global"]
        flops0, traffic0 = dict(flops), trace.traffic_bytes
        n0 = len(trace.collectives)
        start = self.high = self.now
        carry, y = step(box.pop(), 0)
        rise = self.high - start    # a step's high above what it started on
        more = length - 1
        for op, n in list(flops.items()):
            flops[op] = n + more * (n - flops0.get(op, 0))
        trace.traffic_bytes += more * (trace.traffic_bytes - traffic0)
        for c in trace.collectives[n0:]:
            c.count *= length
        # the unrolled loop keeps each step's y for the stack: its last
        # step starts on `more - 1` more of them than the first step left
        y_bytes = storage_bytes(y)
        trace.peak_bytes = max(trace.peak_bytes,
                               self.now + (more - 1) * y_bytes + rise)
        self.now += more * y_bytes
        # the stack: its whole output allocated, `length` ys read and the
        # output written (one allocation here, not `length` views and a
        # cat of `length` inputs)
        ys = y.new_empty(tuple(y.shape[:1]) + (length,) + tuple(y.shape[1:]))
        trace.traffic_bytes += length * _nbytes(y) + _nbytes(ys)
        self.now -= more * y_bytes
        return carry, ys

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        outs = _tensors(out)
        if ns == "c10d":
            kind = _C10D_KINDS.get(name)
            if kind is None and name not in _NO_TRAFFIC:
                raise NotImplementedError(f"collective {func} not modelled")
            if kind is not None:
                c = self._collective(kind, name, args)
                self.trace.collectives.append(c)
                self.trace.traffic_bytes += c.operand_bytes + c.output_bytes
            return out
        if not outs:        # a query (`t.device`, a size): no data moves
            return out
        if not func.is_view and name not in _NO_DATA:
            self.trace.traffic_bytes += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        self._track(outs)
        return out

    @staticmethod
    def _collective(kind: str, name: str, args) -> CollectiveStat:
        ranks = _group_ranks(args)
        out_b = sum(map(_nbytes, _tensors(args[0])))
        # (outputs, inputs, group, ...), or in place: (tensors, group, ...)
        in_b = sum(map(_nbytes, _tensors(args[1]))) if name in _OUT_IN \
            else out_b
        return CollectiveStat(kind, float(in_b), float(out_b), ranks)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank `rank` of a fake process group of
    `world_size` ranks (torch's "fake" backend: every collective returns
    at once and moves nothing).  Torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _recorder() -> Optional[_Recorder]:
    """The `_Recorder` of the `trace_step` that runs this code, if any."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _Recorder):
            return mode
    return None


def scan_steps(step, carry, length: int):
    """(carry, ys): `carry, y = step(carry, t)` for t in range(length),
    the ys stacked on dim 1 — a per-token recurrence.

    On real tensors this is that Python loop and `torch.stack`, op for op.
    Traced on fake tensors (`trace_step`) it runs step 0 alone and counts
    it `length` times: its FLOPs (FlopCounterMode's totals, by op), its
    traffic bytes and its collectives; toward the peak, the ys the
    unrolled loop holds; and the stack reads `length` ys and writes the
    whole output, as the unrolled stack does.  The carry it returns is
    step 0's (a fake tensor of the carry's shape)."""
    rec = _recorder()
    if rec is not None and rec.trip_count and length > 1:
        carry = [carry]  # so that step 0's input is freed as in the loop
        return rec.scan(step, carry, length)
    ys = []
    for t in range(length):
        carry, y = step(carry, t)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def trace_step(fn, args, ranks: int = 1, unroll: bool = False):
    """(StepTrace, out): fn(*args) run and recorded as one rank of
    `ranks`, `args` being the step's state and batch (a tree of tensors
    and modules).  Run it inside a `FakeTensorMode` (or on real tensors:
    the counts are the same, every loop run).  `unroll` runs every step
    of a `scan_steps` on fake tensors too (the tests hold the trip count
    to it)."""
    from torch._guards import detect_fake_mode

    trace = StepTrace(ranks=ranks, argument_bytes=float(storage_bytes(args)))
    held = {_storage_key(t) for t in _tensors(args)}
    counter = flop_counter()
    trip_count = not unroll and detect_fake_mode() is not None
    with counter, _Recorder(trace, held, counter, trip_count):
        out = fn(*args)
    trace.flops = float(counter.get_total_flops())
    seen, alias = {}, {}
    for t in _tensors(out):
        k = _storage_key(t)
        seen[k] = t.untyped_storage().nbytes()
        if k in held:
            alias[k] = seen[k]
    trace.output_bytes = float(sum(seen.values()))
    trace.alias_bytes = float(sum(alias.values()))
    return trace, out
