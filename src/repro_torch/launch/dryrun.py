"""Multi-pod dry run — counterpart of `repro/launch/dryrun.py`.

For every (architecture × input shape) cell this entry point:
  1. joins this process to a fake process group as rank 0 of 256 (one
     pod) or 512 (two pods) ranks and builds the production mesh on it
     (`launch/mesh.py:make_production_mesh`: 16 x 16 or 2 x 16 x 16);
  2. runs the cell's step (the train step for train_4k, the prefill or
     decode serve step for the inference cells) as that rank, on fake
     tensors (`roofline/trace.py`): nothing is allocated and no CUDA call
     is made, so it runs on a machine with no card as on the card's host;
  3. records the step's FLOPs, bytes, collectives and memory
     (`roofline/trace.py:StepTrace`), where the reference compiles and
     reads the HLO: a sharding mismatch or a collective that does not
     fit fails here, which is the point;
  4. prints the memory and cost lines and the roofline summary, and
     writes one `RooflineReport` JSON a cell into --out-dir, against the
     H100 spec (`roofline/hw.py:H100`).

The paper's own workload, the flat MSC step, runs the same way with
--msc M, on an m³ fp32 tensor, with the gate off (`power_tol=0`: the gate's
host read has no answer in a trace), so every mode runs `power_iters`
sweeps, the most any request runs.  Two stages of that step trace
alone as well, the counterparts of the reference benchmarks' compiled
stages: `lower_epilogue` (the similarity epilogue: collectives, link
bytes, landing buffer) and `lower_mode_stage` (one mode's eigensolve and
epilogue on a rank's block: argument and temp bytes, all-reduces).

The link term charges `H100.ici_bw` (NVLink) for every group, as the
reference's models charge one rate; a 16 x 16 mesh spans 32 hosts and a
group that crosses hosts runs at the network's rate, which no model here
holds.

The fake tensors and the mesh sit on the CPU device.  A fake `cuda`
tensor would need a CUDA build to run autograd's backward (a CPU-only
build has no CUDA device guard), and on the card's host that backward
would set up the card.  The traced path (the model at
attn_impl="chunked", use_kernels=False, as the configs default and the
reference traces it; the train step, AdamW, the MSC schedule) runs the
same operations on either device, which chip_smoke.py phase 19 holds:
the traced FLOPs and argument bytes equal a real step's on the card.
One choice does read the device: "auto" in the MSC schedule resolves on
the spec of the device it runs on (`core/parallel.py:_resolve_auto`,
V5E on the CPU), so `lower_msc` resolves "auto" on `H100` itself.

Unlike the reference, importing this sets nothing in the environment: the
fake group exists only while a cell runs.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
  python -m repro_torch.launch.dryrun --all --pods both
  python -m repro_torch.launch.dryrun --msc 1024 --msc-gram --pods multi
"""
from __future__ import annotations

import argparse
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ALIASES, ARCH_NAMES, get_config
from repro_torch.configs.inputs import input_specs
from repro_torch.launch.mesh import chips as mesh_chips
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models import ShapeConfig, build_model, shapes_for
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import (H100, model_flops, report_from_compiled,
                                  save_report)
from repro_torch.roofline.analyze import RooflineReport
from repro_torch.roofline.trace import fake_world, trace_step

OUT_DIR = os.path.join("experiments", "dryrun_torch")
LINK_NOTE = "link term at NVLink rate for every group"
DEVICE = torch.device("cpu")


def _fake(spec: torch.Tensor, shape=None) -> torch.Tensor:
    """A tensor of a stand-in's dtype and `shape` (by default the
    stand-in's): fake inside the fake mode."""
    return torch.empty(spec.shape if shape is None else shape,
                       dtype=spec.dtype, device=DEVICE)


def _rows(specs, shards, layout):
    """This rank's rows of each whole stand-in under `layout` (the step's
    batch specs), as fake tensors."""
    return {k: _fake(v, shards.local_shape(v.shape, tuple(layout[k])
                                           + (None,) * v.dim()))
            for k, v in specs.items()}


def _whole(params):
    """Fake whole parameters of a `meta` tree's shapes and dtypes."""
    from repro_torch.models import map_params

    return map_params(_fake, params)


def train_args(model, mesh, shape: ShapeConfig):
    """(step, state, batch): the train step on `mesh` and this rank's
    shard of the abstract state (`abstract_train_state`, cut by
    `state_specs`) and of the batch, as fake tensors.  mesh None is one
    device.  Call inside the fake mode."""
    from repro_torch.optim import adamw_init
    from repro_torch.models.params import trainable
    from repro_torch.training.steps import (TrainState,
                                            abstract_train_state,
                                            build_train_step,
                                            shard_train_state)

    step, _, b_specs = build_train_step(
        model, mesh, AdamWConfig(), global_batch=shape.global_batch,
        seq_len=shape.seq_len)
    params = trainable(_whole(abstract_train_state(model).params))
    state = shard_train_state(
        model, TrainState(params, adamw_init(params), None), mesh)
    specs = input_specs(model.cfg, shape)
    if step.shards is None:
        return step, state, {k: _fake(v) for k, v in specs.items()}
    return step, state, _rows(specs, step.shards, b_specs)


def _serve_params(model, shards, p_specs):
    """This rank's serving weights in the compute dtype (bf16), as the
    reference's: a leaf of two dims or more (a stacked block's leaves
    counted with their layer dim) is cast, 1-D leaves (norm scales) stay
    f32."""
    from repro_torch.models.params import LayerStack
    from repro_torch.serving.engine import shard_params
    from repro_torch.sharding.activation import hold

    params = shard_params(model, lambda d, path: torch.empty(
        d.shape, dtype=d.dtype, device=DEVICE), shards, p_specs, DEVICE)
    stacked = {id(p) for m in params.modules() if isinstance(m, LayerStack)
               for p in m.parameters()}
    for mod in params.modules():
        for k, p in list(mod._parameters.items()):
            if p.dim() + (id(p) in stacked) >= 2:
                mod._parameters[k] = hold(torch.nn.Parameter(
                    p.to(model.cfg.cdtype), requires_grad=False), p._held)
    return params


def serve_args(model, mesh, shape: ShapeConfig):
    """(fn, args, LMShards): the prefill or decode step of `shape.kind` on
    `mesh`, its arguments (this rank's weights, rows and cache, fake) and
    the rank's shards.  Call inside the fake mode."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.serving.engine import build_serve_steps
    from repro_torch.sharding.activation import activation_sharding

    prefill, decode, _, b_specs, p_specs, shards = build_serve_steps(
        model, mesh, shape.global_batch, shape.seq_len)
    params = _serve_params(model, shards, p_specs)
    specs = input_specs(model.cfg, shape)
    if shape.kind == "prefill":
        return prefill, (params, _rows(specs, shards, b_specs)), shards
    tokens = _rows({"tokens": specs["tokens"]}, shards, b_specs)["tokens"]
    with activation_sharding(shards):
        cache = init_cache(model.cfg, tokens.shape[0], shape.seq_len,
                           DEVICE)
    return (decode, (params, tokens, cache, _fake(specs["cache_len"])),
            shards)


def _ranks(mesh) -> int:
    return 1 if mesh is None else mesh_chips(mesh)


def lower_cell(arch: str, shape: ShapeConfig, mesh, cfg=None):
    """Trace one (arch × shape) cell as this rank of `mesh` (a DeviceMesh
    over a fake process group; None: one device, train cells only).
    Returns (StepTrace, cfg, shards): `shards` is the rank's `LMShards`
    (None on one device), its counts the traced step's.  `cfg` overrides
    the arch's config (a reduced one in tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    with FakeTensorMode():
        if shape.kind == "train":
            step, state, batch = train_args(model, mesh, shape)
            args, shards = (state, batch), step.shards
        else:
            step, args, shards = serve_args(model, mesh, shape)
        if shards is not None:
            shards.counts.clear()
        trace, _ = trace_step(step, args, _ranks(mesh))
    return trace, cfg, shards


def lower_msc(m: int, mesh, *, matrix_free: bool = True,
              power_iters: int = 60, relayout: str = "gspmd"):
    """Trace the parallel MSC step (the paper's workload) as this rank of
    `mesh` on an m³ fp32 tensor, the gate off, relayout="auto" resolved
    on the H100's spec.  Returns (StepTrace, cfg)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import MSCConfig
    from repro_torch.core.parallel import (_resolve_auto,
                                           build_msc_parallel_flat)

    cfg = MSCConfig(power_iters=power_iters, power_tol=0.0,
                    matrix_free=matrix_free, max_extraction_iters=m)
    cfg, relayout = _resolve_auto(cfg, (m, m, m), relayout, mesh,
                                  device=DEVICE, hw=H100)
    with FakeTensorMode():
        run = build_msc_parallel_flat(cfg, mesh, relayout=relayout,
                                      device=DEVICE)
        tensor = torch.empty((m, m, m), dtype=torch.float32, device=DEVICE)
        trace, _ = trace_step(run, (tensor,), _ranks(mesh))
    return trace, cfg


# the collective each epilogue runs (the reference's HLO kinds)
EPILOGUE_KINDS = {"allgather": "all-gather", "ring": "collective-permute"}


def lower_epilogue(m: int, c: int, mesh, cfg, axis_name=None):
    """Trace the similarity epilogue alone (`core/schedule.py:
    build_epilogue_rowsum` under cfg.epilogue) as this rank of `mesh` on
    its rows of an (m, c) fp32 V, padded to even shards.  Returns the
    StepTrace: its collectives by kind (`by_kind`: counts and link bytes)
    and the epilogue's landing buffer (`landing_bytes`).  The counterpart
    of the reference's compiled epilogue in benchmarks/ring_epilogue.py."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.schedule import build_epilogue_rowsum, pad_to

    stage = build_epilogue_rowsum(mesh, cfg, axis_name)
    rows = pad_to(m, stage.shards) // stage.shards
    with FakeTensorMode():
        v = torch.empty((rows, c), dtype=torch.float32, device=DEVICE)
        trace, _ = trace_step(stage, (v,), _ranks(mesh))
    return trace


def landing_bytes(trace, epilogue: str) -> float:
    """The largest buffer one of the epilogue's collectives writes on this
    rank: the whole gathered V for "allgather", one chunk for "ring" (the
    reference's measured_buffer_bytes)."""
    kind = EPILOGUE_KINDS[epilogue]
    return max((c.output_bytes for c in trace.collectives if c.kind == kind),
               default=0.0)


def lower_mode_stage(m: int, mesh, cfg):
    """Trace one mode's eigensolve + epilogue stage (`core/schedule.py:
    build_mode_runner`) as this rank of `mesh` (the flat schedule's roles:
    "inner" shards rows when the mesh has it) on its block of an m³ fp32
    tensor's unfolding, (m_pad/p, r_pad/q, m), and its slice mask, the
    gate off (`power_tol=0`: the gate's host read has no answer in a
    trace, so every slice runs `power_iters` sweeps).  Returns the
    StepTrace: `argument_bytes` is the block's and the mask's bytes (the
    reference's measured_block_bytes, in benchmarks/inner_shard.py),
    `peak_bytes` the stage's temp, `by_kind()["all-reduce"]` the λ max
    and the inner sums."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.parallel import _flat_schedule
    from repro_torch.core.schedule import build_mode_runner

    sched = _flat_schedule(cfg.with_(power_tol=0.0), mesh)
    m_pad, r_pad = sched.pad_amounts(m, m)
    run = build_mode_runner(sched)
    with FakeTensorMode():
        block = torch.empty((m_pad // sched.slice_shards,
                             r_pad // sched.inner_shards, m),
                            dtype=torch.float32, device=DEVICE)
        valid = torch.empty((m_pad // sched.slice_shards,),
                            dtype=torch.bool, device=DEVICE)
        trace, _ = trace_step(run, (block, valid), _ranks(mesh))
    return trace


def msc_model_flops(m: int, power_iters: int, matrix_free: bool) -> float:
    """Useful FLOPs of one MSC run on an m³ tensor (3 modes).

    matrix-free: per mode, m slices × iters × two m×m matvecs (4m² flops)
    + the m×m similarity row-sums (2m³).  gram: + the one-time m×m×m gram
    per slice (2m³ each) with cheap m×m matvec iterations."""
    if matrix_free:
        return 3.0 * (m * power_iters * 4.0 * m * m + 2.0 * m**3)
    return 3.0 * (m * 2.0 * m**3 + m * power_iters * 2.0 * m * m + 2.0 * m**3)


def _print_memory(trace, extra: str = "") -> None:
    print(f"    memory_analysis: args={trace.argument_bytes/2**30:.3f}GiB "
          f"temp={trace.peak_bytes/2**30:.3f}GiB" + extra)


def _finish(rep: RooflineReport, out_dir: str, cell: str) -> RooflineReport:
    print("    " + rep.summary())
    save_report(rep, os.path.join(out_dir, cell + ".json"))
    return rep


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
             out_dir: str = OUT_DIR) -> RooflineReport:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mname = mesh_name(mesh)
        t0 = time.time()
        trace, cfg, _ = lower_cell(arch, shape, mesh)
        t1 = time.time()
        chips = mesh_chips(mesh)
    print(f"--- {arch} {shape.name} mesh={mname} (trace {t1-t0:.1f}s)")
    _print_memory(trace, f" out={trace.output_bytes/2**30:.3f}GiB  per "
                  f"device (HBM {H100.hbm_bytes/2**30:.0f}GiB)")
    print(f"    cost_analysis:   flops={trace.flops:.3e} "
          f"bytes={trace.traffic_bytes:.3e}  (per device, the per-token "
          f"recurrences trip-counted)")
    rep = report_from_compiled(
        trace, arch=arch, shape_name=shape.name, mesh_name=mname,
        chips=chips, model_fl=model_flops(cfg, shape, shape.kind), hw=H100,
        note=LINK_NOTE)
    return _finish(rep, out_dir, f"{arch}_{shape.name}_{mname}")


def run_msc_cell(m: int, *, multi_pod: bool, out_dir: str = OUT_DIR,
                 matrix_free: bool = True, power_iters: int = 60,
                 relayout: str = "gspmd") -> RooflineReport:
    variant = ("mf" if matrix_free else "gram") \
        + ("-coll" if relayout == "collective" else "")
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mname = mesh_name(mesh)
        t0 = time.time()
        trace, _ = lower_msc(m, mesh, matrix_free=matrix_free,
                             power_iters=power_iters, relayout=relayout)
        t1 = time.time()
        chips = mesh_chips(mesh)
    print(f"--- msc-{variant} m={m} mesh={mname} (trace {t1-t0:.1f}s)")
    _print_memory(trace)
    rep = report_from_compiled(
        trace, arch=f"msc-{variant}", shape_name=f"msc_{m}",
        mesh_name=mname, chips=chips,
        model_fl=msc_model_flops(m, power_iters, matrix_free), hw=H100,
        note=f"sweeps at the cap ({power_iters}); {LINK_NOTE}")
    return _finish(rep, out_dir, f"msc-{variant}_{m}_{mname}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", help="shape cell name (train_4k, ...)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × applicable shape)")
    ap.add_argument("--msc", type=int, nargs="*",
                    help="MSC dry-run tensor sizes (cube m)")
    ap.add_argument("--msc-gram", action="store_true",
                    help="also run the paper-faithful gram variant")
    ap.add_argument("--msc-collective", action="store_true",
                    help="also run the explicit-all_to_all relayout variant")
    ap.add_argument("--pods", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--save-hlo", action="store_true",
                    help="the reference's HLO dump; the port has no HLO")
    args = ap.parse_args(argv)
    if args.save_hlo:
        raise SystemExit("--save-hlo: the port compiles no HLO (a dry run "
                         "traces eager PyTorch); the reports hold the "
                         "traced counts")

    os.makedirs(args.out_dir, exist_ok=True)
    pods = {"single": (False,), "multi": (True,),
            "both": (False, True)}[args.pods]

    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in shapes_for(get_config(arch)):
                cells.append((arch, shape))
    elif args.arch:
        shape = SHAPES_BY_NAME[args.shape or "train_4k"]
        cells.append((args.arch, shape))

    failures = []
    reports = []
    for multi_pod in pods:
        for arch, shape in cells:
            try:
                reports.append(run_cell(arch, shape, multi_pod=multi_pod,
                                        out_dir=args.out_dir))
            except Exception as e:  # a failing cell is a bug in the system
                failures.append((arch, shape.name, multi_pod, repr(e)))
                traceback.print_exc()
        for m in (args.msc or []):
            variants = [dict(matrix_free=True, relayout="gspmd")]
            if args.msc_gram:
                variants.append(dict(matrix_free=False, relayout="gspmd"))
            if args.msc_collective:
                variants.append(dict(matrix_free=True,
                                     relayout="collective"))
                if args.msc_gram:
                    variants.append(dict(matrix_free=False,
                                         relayout="collective"))
            for kw in variants:
                try:
                    reports.append(run_msc_cell(
                        m, multi_pod=multi_pod, out_dir=args.out_dir, **kw))
                except Exception as e:
                    failures.append(("msc", str(m), multi_pod, repr(e)))
                    traceback.print_exc()

    print(f"\n=== dry-run complete: {len(reports)} cells ok, "
          f"{len(failures)} failed ===")
    for f in failures:
        print("FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
