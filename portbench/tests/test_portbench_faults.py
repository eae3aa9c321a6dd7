"""A run with the timed path broken underneath comes out not `correct`.

Each test skips the look for a chip (`run_cell` on the CPU, at a small
size) and breaks the program where it produces its answer:

  unchanged   a gate chunk returns its state unchanged (the iterate
              does not move; the gate reads a zero residual)
  half        the epilogue sums |V Vᵀ| over half of V's rows and doubles
              it: half of the batch left out, the mean taken over the rest
  altered     the extraction flips one member of every cluster
  exchange    across ranks, the all-gather of V is left out: each rank
              sums over its own rows only (flat4, four gloo ranks)
"""
import contextlib
import dataclasses
import json
import multiprocessing
import time

import pytest
import torch

from harness.runner import run_cell
from small import small


@contextlib.contextmanager
def broken(fault: str):
    import repro_torch.core.power_iter as pi
    import repro_torch.core.schedule as sched
    import repro_torch.kernels.power_iter as kpi
    import repro_torch.kernels.ring as ring

    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "unchanged":
        def still(v):
            z = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
            return v, z, z

        patch(kpi, "power_iterate_chunk", lambda s, v, k, **kw: still(v))
        patch(pi, "make_chunk_probe", lambda matvec, k: still)
    elif fault == "half":
        rowsum = ring.abs_rowsum

        def half(a, b, acc=None, **kw):
            n = b.shape[-2]
            out = 2.0 * rowsum(a, b[..., :max(1, n // 2), :].contiguous(), None,
                               **kw)
            return out if acc is None else acc + out

        patch(ring, "abs_rowsum", half)
    elif fault == "altered":
        extract = sched.extract_cluster

        def flipped(d, *a, **kw):
            mask, n = extract(d, *a, **kw)
            mask = mask.clone()
            mask[..., 0] = ~mask[..., 0]
            return mask, n

        patch(sched, "extract_cluster", flipped)
    elif fault == "exchange":
        patch(sched, "_all_gather_rows", lambda x, group: x)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


ONE_CHIP = ["msc-m1000.solve", "msc-m1000.gram", "msc-serve-m400.skewed"]


@pytest.mark.parametrize("name", ONE_CHIP)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_fault_is_caught(name, fault):
    cell = small(name)
    with broken(fault) if fault else contextlib.nullcontext():
        res = run_cell(cell, 2**31 + 17, 0.3, False, device="cpu",
                       start_wall=time.time())
    assert res["correct"] is (fault is None), res["checks"]


def flat4(cell):
    """The solve cell on the (4,) mesh of `traffic/flat4.json` under
    `limits/msc-m1000.flat4.json` (a cell not in BENCHMARK.json yet)."""
    here = cell.root / "portbench"
    tr = json.loads((here / "traffic" / "flat4.json").read_text())
    tr.update(pool=cell.traffic["pool"], gamma=cell.traffic["gamma"])
    limits = json.loads(
        (here / "limits" / "msc-m1000.flat4.json").read_text())
    return dataclasses.replace(cell, name="msc-m1000.flat4", chips=4,
                               traffic=tr, limits=limits)


def _rank(rank, store, fault, queue):
    """One gloo rank of the four (spawned: the parent's path comes
    along)."""
    torch.set_num_threads(1)
    with broken(fault) if fault else contextlib.nullcontext():
        res = run_cell(flat4(small("msc-m1000.solve", m=16)), 2**31 + 19,
                       0.3, False, device="cpu", start_wall=time.time(),
                       rank=rank, world=4, store=store)
    if rank == 0:
        queue.put(res["correct"])


@pytest.mark.parametrize("fault", [None, "exchange", "altered"])
def test_mesh_fault_is_caught(fault, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank,
                         args=(r, str(tmp_path / "store"), fault, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        correct = queue.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs)
    assert correct is (fault is None)
