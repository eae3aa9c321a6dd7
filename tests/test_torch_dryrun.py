"""The port's dry run on the CPU: `configs/inputs.py`'s stand-ins,
`roofline/trace.py`'s traced counts (the per-token recurrences
trip-counted, held to the unrolled trace), `report_from_compiled` and
`launch/dryrun.py`, held to the reference and to real runs; and the
port's package exports against the reference's.

The reference's dry-run pieces run only in one subprocess with 4 forced
XLA devices (`repro.launch.dryrun` itself is never imported: it sets
XLA_FLAGS at import).  Every trace here is a reduced arch or a small MSC
tensor on a fake process group of at most 8 ranks.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs import inputs as tinputs  # noqa: E402
from repro_torch.configs.inputs import make_batch  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import _mesh  # noqa: E402
from repro_torch.models import ShapeConfig, build_model, shapes_for  # noqa: E402,E501
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.roofline import (H100, V5E, choose_relayout,  # noqa: E402
                                  report_from_compiled)
from repro_torch.roofline.trace import (fake_world, flop_counter,  # noqa: E402,E501
                                        storage_bytes, trace_step)
from repro_torch.training.steps import (build_train_step,  # noqa: E402
                                        make_train_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MSC_M = 32
# one reduced arch of each family
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-tiny", "vlm": "internvl2-26b"}
TRAIN = ShapeConfig("train_small", 32, 4, "train")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- (a) --
_JAX_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
               "float32": torch.float32}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_the_reference(arch):
    from repro.configs import get_config as jget
    from repro.configs import inputs as jinputs
    from repro.models import shapes_for as jshapes_for

    cfg, jcfg = get_config(arch), jget(arch)
    shapes = shapes_for(cfg)
    assert [s.name for s in shapes] == [s.name for s in jshapes_for(jcfg)]
    for shape, jshape in zip(shapes, jshapes_for(jcfg)):
        got, want = tinputs.input_specs(cfg, shape), \
            jinputs.input_specs(jcfg, jshape)
        assert list(got) == list(want), shape.name
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (shape.name, k)
            assert got[k].dtype == _JAX_DTYPES[str(v.dtype)], (shape.name, k)
        fn = {"train": (tinputs.train_specs, jinputs.train_specs),
              "prefill": (tinputs.prefill_specs, jinputs.prefill_specs),
              "decode": (tinputs.decode_specs, jinputs.decode_specs)}
        t_fn, j_fn = fn[shape.kind]
        assert list(t_fn(cfg, shape)) == list(j_fn(jcfg, jshape))
    extras = tinputs._extras_specs(cfg, 3)
    jextras = jinputs._extras_specs(jcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in extras.items()} == \
        {k: (tuple(v.shape), _JAX_DTYPES[str(v.dtype)])
         for k, v in jextras.items()}


# ---------------------------------------------------------------- (b) --
def _real_train_flops(cfg, shape):
    model = build_model(cfg)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    step, _, _ = build_train_step(model, None, AdamWConfig(),
                                  global_batch=shape.global_batch,
                                  seq_len=shape.seq_len)
    batch = make_batch(cfg, shape.global_batch, shape.seq_len, device="cpu")
    args_bytes = storage_bytes((state, batch))
    with flop_counter() as fc:
        step(state, batch)
    return fc.get_total_flops(), args_bytes


@pytest.mark.parametrize("family", list(FAMILIES))
def test_traced_train_step_counts_the_real_flops(family):
    cfg = get_config(FAMILIES[family]).reduced()
    trace, _, _ = D.lower_cell(FAMILIES[family], TRAIN, None, cfg=cfg)
    flops, args_bytes = _real_train_flops(cfg, TRAIN)
    assert flops > 0
    assert trace.flops == flops
    assert trace.argument_bytes == args_bytes
    assert trace.peak_bytes > 0 and trace.collectives == []


def test_matvec_formulas_count_a_gram_solve():
    """FlopCounterMode's registry counts 0 for a matrix-vector product;
    the trace's formulas count 2·c² per matvec (and 2·c per dot): a
    power iteration on one gram C with 1-D vectors."""
    from torch.utils.flop_counter import FlopCounterMode

    c, sweeps = 24, 5
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(40, c, generator=gen)

    def solve():
        gram = s.T @ s                       # mm: 2·40·c²
        v = torch.ones(c) / c ** 0.5
        for _ in range(sweeps):
            w = torch.mv(gram, v)            # mv: 2·c²
            v = w / torch.linalg.vector_norm(w)
        lam = torch.dot(v, torch.mv(gram, v))   # mv + dot
        return torch.addmv(v, gram, v), lam  # addmv: 2·c²

    with FlopCounterMode(display=False) as plain:
        solve()
    with flop_counter() as fc:
        solve()
    gram_flops = 2 * 40 * c * c
    assert plain.get_total_flops() == gram_flops
    assert fc.get_total_flops() == gram_flops + (sweeps + 2) * 2 * c * c \
        + 2 * c


@pytest.mark.parametrize("matrix_free", [True, False], ids=["mf", "gram"])
def test_traced_msc_step_counts_the_real_flops(matrix_free):
    from repro_torch.core import MSCConfig
    from repro_torch.core.parallel import build_msc_parallel_flat

    trace, cfg = D.lower_msc(16, None, matrix_free=matrix_free)
    run = build_msc_parallel_flat(cfg, None, device="cpu")
    t = torch.randn((16, 16, 16), generator=torch.Generator().manual_seed(0))
    with flop_counter() as fc:
        run(t)
    assert trace.flops == fc.get_total_flops() > 0
    assert cfg == MSCConfig(power_iters=60, power_tol=0.0,
                            matrix_free=matrix_free, max_extraction_iters=16)


# ------------------------------------------------------- (c) and (d) --
_REF = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import MSCConfig
from repro.core.parallel import build_msc_parallel_flat
from repro.launch.mesh import make_local_mesh
from repro.roofline import report_from_compiled

out = {}
mesh = jax.make_mesh((4,), ("model",))
f = jax.jit(lambda a, b: a @ b,
            in_shardings=(NamedSharding(mesh, P(None, "model")),
                          NamedSharding(mesh, P("model", None))),
            out_shardings=NamedSharding(mesh, P()))
a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
b = jax.ShapeDtypeStruct((256, 128), jnp.float32)
rep = report_from_compiled(f.lower(a, b).compile(), arch="t", shape_name="s",
                           mesh_name="4", chips=4, model_fl=2*128*256*128)
out["matmul"] = rep.to_json()
mesh = make_local_mesh(2)
for mf in (True, False):
    cfg = MSCConfig(power_iters=60, power_tol=0.0, matrix_free=mf,
                    max_extraction_iters=M)
    run = build_msc_parallel_flat(mesh, cfg, relayout="gspmd")
    c = run.lower(jax.ShapeDtypeStruct((M, M, M), jnp.float32)).compile()
    out["mf" if mf else "gram"] = report_from_compiled(
        c, arch="m", shape_name="s", mesh_name="2x2", chips=4,
        model_fl=1.0).to_json()
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(subproc):
    out = subproc(f"M = {MSC_M}\n" + _REF, 4)
    return json.loads(out.split("REF", 1)[1])


def test_sharded_matmul_report_matches_the_reference(ref):
    """The reference's `TestRooflineReport` case: (128, 256) @ (256, 128)
    with the contraction cut over 4 ranks of "model", then the psum of
    the (128, 128) output, traced as rank 0 of a fake 4-rank group."""
    want = ref["matmul"]
    def step(a, b):
        y = a @ b
        dist.all_reduce(y, group=mesh.get_group("model"))
        return y

    with fake_world(4):
        mesh = _mesh((4,), ("model",), "cpu")
        with FakeTensorMode():
            trace, _ = trace_step(step, (torch.empty((128, 64)),
                                         torch.empty((64, 128))), 4)
    rep = report_from_compiled(trace, arch="t", shape_name="s",
                               mesh_name="4", chips=4,
                               model_fl=2 * 128 * 256 * 128)
    assert rep.hlo_flops_global == want["hlo_flops_global"] == 2 * 128**2 * 256
    assert rep.flops_ratio == want["flops_ratio"] == 1.0
    got_ar = rep.collectives_by_kind["all-reduce"]
    want_ar = want["collectives_by_kind"]["all-reduce"]
    assert got_ar["count"] == want_ar["count"] == 1
    assert got_ar["link_bytes"] == want_ar["link_bytes"]
    assert set(rep.collectives_by_kind) == set(want["collectives_by_kind"])
    # the product's operands and output, and the all-reduce's
    assert rep.bytes_per_device == want["bytes_per_device"]
    assert rep.collective_link_s > 0 and rep.compute_s > 0
    assert rep.memory_s > 0 and rep.unknown_trip_counts == 0
    assert rep.xla_cost_analysis == {}
    assert set(rep.memory_stats) <= set(want["memory_stats"])
    assert rep.note == "fits-hbm"
    # mfu_bound on the spec the report was made with
    h = report_from_compiled(trace, arch="t", shape_name="s",
                             mesh_name="4", chips=4, model_fl=1e9, hw=H100)
    assert h.mfu_bound == pytest.approx(
        1e9 / (4 * H100.peak_flops_bf16 * h.bound_s), rel=1e-12)
    assert rep.mfu_bound == pytest.approx(
        rep.model_flops / (4 * V5E.peak_flops_bf16 * rep.bound_s), rel=1e-12)
    assert h.to_json()["hw"] == H100.name and "hw" not in rep.to_json()


@pytest.mark.parametrize("variant", ["mf", "gram"])
def test_flat_msc_flops_match_the_reference(ref, variant):
    """The flat MSC step at m = 32, the gate off, as rank 0 of a fake (2,
    2) (data, model) mesh against the reference's HLO count on 4 XLA
    devices: within 2% (the same products; the reference's Rayleigh and
    λ terms are XLA dots the port also runs as products)."""
    with fake_world(4):
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        trace, _ = D.lower_msc(MSC_M, mesh, matrix_free=variant == "mf")
    got = trace.flops * trace.ranks
    want = ref[variant]["hlo_flops_global"]
    assert abs(got - want) <= 0.02 * want, (got, want)
    model = D.msc_model_flops(MSC_M, 60, variant == "mf")
    assert abs(model - got) <= 0.02 * got


def test_msc_auto_relayout_resolves_on_the_h100(monkeypatch):
    """relayout="auto" in an MSC cell resolves on the card's spec, not on
    the spec of the CPU the trace runs on (V5E, the reference's)."""
    import repro_torch.core.parallel as P

    seen = []
    resolve = P._resolve_auto

    def spy(*args, **kw):
        out = resolve(*args, **kw)
        seen.append((kw.get("hw"), out[1]))
        return out

    monkeypatch.setattr(P, "_resolve_auto", spy)
    with fake_world(4):
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        trace, cfg = D.lower_msc(MSC_M, mesh, power_iters=2,
                                 relayout="auto")
        sched = P._flat_schedule(cfg, mesh)
    assert seen == [(H100, choose_relayout(
        (MSC_M,) * 3, sched.slice_shards, sched.inner_shards,
        sweeps=max(cfg.power_check_every, 1), hw=H100))]
    assert trace.flops > 0


# ---------------------------------------------------------------- (e) --
def test_train_step_on_a_pod_mesh_counts_its_collectives():
    """A reduced dense arch with ZeRO (its params cut over "data") in 2
    microbatches, as rank 0 of a fake (2, 2, 2) (pod, data, model) mesh:
    the traced collectives by kind equal `LMShards.counts`, and the
    gathers over "data" of one microbatch output the parameters' model-cut
    bytes (each gathered once a microbatch)."""
    cfg = get_config("qwen1.5-0.5b").reduced(zero_shard=True,
                                               microbatches=2)
    shape = ShapeConfig("train_small", 32, 8, "train")
    with fake_world(8):
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        data_ranks = tuple(
            dist.get_process_group_ranks(mesh.get_group("data")))
        trace, _, shards = D.lower_cell("qwen1_5_0_5b", shape, mesh,
                                        cfg=cfg)
        with FakeTensorMode():
            step, state, _ = D.train_args(build_model(cfg), mesh, shape)
    counts = dict(shards.counts)
    assert counts and trace.counts() == counts
    assert set(trace.by_kind()) == {"all-gather", "reduce-scatter",
                                    "all-reduce"}
    gathered = sum(c.output_bytes for c in trace.collectives
                   if c.kind == "all-gather" and c.ranks == data_ranks)
    cut = 0
    for p in state.params.parameters():
        held = p._held
        data_cut = [h for h in held if h is not None and "data" in
                    ((h,) if isinstance(h, str) else h)]
        if data_cut:
            cut += p.numel() * p.element_size() * 2  # whole over "data"
    assert cut > 0
    assert gathered == 2 * cut
    assert trace.flops * trace.ranks > 0 and trace.alias_bytes > 0


def test_serve_steps_on_a_mesh_count_their_collectives():
    cfg = get_config("qwen1.5-0.5b").reduced(zero_shard=True)
    with fake_world(4):
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        for kind in ("prefill", "decode"):
            trace, _, shards = D.lower_cell(
                "qwen1_5_0_5b", ShapeConfig("s", 32, 4, kind), mesh,
                cfg=cfg)
            assert trace.counts() == dict(shards.counts), kind
            assert trace.flops > 0 and trace.argument_bytes > 0


# the per-token recurrences: a trip-counted trace against the unrolled one
RECURRENT = {"ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-2b"}
PREFILL = ShapeConfig("prefill_small", 64, 2, "prefill")
# the lengths of the loops each family's prefill steps through token by
# token: the RG-LRU's; none of Mamba-2's (its prefill is the chunked SSD)
PER_TOKEN = {"ssm": set(), "hybrid": {PREFILL.seq_len}}


def _prefill_trace(arch, mesh, unroll):
    """(StepTrace, the recurrences traced trip-counted): a reduced arch's
    prefill at s = 64 on one device (mesh None) or as rank 0 of `mesh`."""
    from unittest import mock

    from repro_torch.configs.inputs import input_specs
    from repro_torch.roofline import trace as T

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    scans = []
    real = T._Recorder.scan

    def counted(self, *a):
        scans.append(a[-1])
        return real(self, *a)

    with mock.patch.object(T._Recorder, "scan", counted), FakeTensorMode():
        if mesh is None:
            args = (D._whole(model.abstract()),
                    {k: D._fake(v) for k, v in
                     input_specs(cfg, PREFILL).items()})

            def step(params, batch):
                return model.prefill(params, batch,
                                     max_len=PREFILL.seq_len)
        else:
            step, args, _ = D.serve_args(model, mesh, PREFILL)
        trace, _ = trace_step(step, args, 1 if mesh is None else mesh.size(),
                              unroll=unroll)
    return trace, scans


@pytest.mark.parametrize("mesh_shape", [None, (1, 2)], ids=["one", "1x2"])
@pytest.mark.parametrize("family", list(RECURRENT))
def test_trip_counted_prefill_equals_the_unrolled_trace(family, mesh_shape):
    """The RG-LRU's per-token loops (`scan_steps`) traced once a layer
    and counted s times give the unrolled trace's FLOPs, collectives and
    traffic exactly, and its peak within 1% (the gap is 0 B at this size:
    the reckoning holds the ys the unrolled loop holds and the stack
    reads them as it does).  Mamba-2's prefill has no per-token loop:
    its trace is the same either way."""
    def run(unroll):
        if mesh_shape is None:
            return _prefill_trace(RECURRENT[family], None, unroll)
        with fake_world(2):
            mesh = _mesh(mesh_shape, ("data", "model"), "cpu")
            return _prefill_trace(RECURRENT[family], mesh, unroll)

    (trip, scans), (unrolled, none) = run(False), run(True)
    assert set(scans) == PER_TOKEN[family] and none == []
    assert trip.flops == unrolled.flops > 0
    assert trip.by_kind() == unrolled.by_kind()
    assert trip.counts() == unrolled.counts()
    assert trip.traffic_bytes == unrolled.traffic_bytes > 0
    gap = abs(trip.peak_bytes - unrolled.peak_bytes)
    assert gap <= 0.01 * unrolled.peak_bytes, (trip.peak_bytes,
                                               unrolled.peak_bytes)
    assert trip.argument_bytes == unrolled.argument_bytes
    assert trip.output_bytes == unrolled.output_bytes


# ---------------------------------------------------------------- (f) --
def _cli(args, tmp_path):
    """The CLI in a child process, which also fails if the package
    `repro_torch.launch` imports the dry run (as the reference's does
    not) or if the run imports jax or the reference."""
    code = ("import sys, repro_torch.launch\n"
            "assert 'repro_torch.launch.dryrun' not in sys.modules\n"
            "from repro_torch.launch import dryrun\n"
            f"rc = dryrun.main({args!r})\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp_path)


def test_cli_writes_one_report_a_cell(tmp_path):
    out = tmp_path / "reports"
    p = _cli(["--msc", "64", "--pods", "both", "--out-dir", str(out)],
             tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "=== dry-run complete: 2 cells ok, 0 failed ===" in p.stdout
    assert "--- msc-mf m=64 mesh=16x16" in p.stdout
    assert "memory_analysis:" in p.stdout
    names = sorted(os.listdir(out))
    assert names == ["msc-mf_64_16x16.json", "msc-mf_64_2x16x16.json"]
    for name, chips in zip(names, (256, 512)):
        rep = json.loads((out / name).read_text())
        assert rep["chips"] == chips and rep["hw"] == H100.name
        assert rep["note"].startswith("sweeps at the cap (60)")
        assert rep["note"].endswith("fits-hbm")
        assert rep["model_flops"] == D.msc_model_flops(64, 60, True)
        # 64 slices padded to one a rank: every rank runs one slice's
        # sweeps (and the padded epilogue), so the useful share is at
        # most 64 / ranks
        assert 0.9 * 64 / chips < rep["flops_ratio"] <= 64 / chips


def test_render_pods_reads_the_fit_from_each_note():
    """`roofline/table.py:render_pods`, the PERF.md table: a row an arch,
    both meshes in a cell, ✓ only when every mesh's note says fits-hbm,
    else ✗ and the largest need across meshes."""
    from repro_torch.roofline.table import render_pods

    def rep(arch, mesh, note, need, bound):
        return {"arch": arch, "shape": "train_4k", "mesh": mesh,
                "note": note, "dominant": "memory", "bound_s": bound,
                "flops_ratio": 0.5,
                "memory_stats": {"argument_size_in_bytes": need / 2,
                                 "temp_size_in_bytes": need / 2}}

    rows = [rep("a", "16x16", "x fits-hbm", 70e9, 0.25),
            rep("a", "2x16x16", "x fits-hbm", 40e9, 0.125),
            rep("b", "16x16", "x fits-hbm", 70e9, 2.0),
            rep("b", "2x16x16", "x EXCEEDS-HBM", 90e9, 1.5)]
    assert render_pods(rows).splitlines() == [
        "| arch | train_4k |", "|---|---|",
        "| a | ✓ memory 250.00ms/125.00ms (0.50) |",
        "| b | ✗ 90 GB memory 2.00s/1.50s (0.50) |"]


def test_cli_save_hlo_exits_with_its_message(tmp_path):
    p = _cli(["--msc", "64", "--save-hlo"], tmp_path)
    assert p.returncode != 0
    assert "the port compiles no HLO" in p.stderr


# ---------------------------------------------------------------- (g) --
# reference names with no counterpart, and why
EXPORT_EXCEPTIONS = {
    # specs → jax NamedShardings: a rank holds its shards, nothing names
    # a placement
    "sharding": {"shardings_for"},
    # the XLA HLO text parser: the trace (roofline/trace.py) takes its
    # role
    "roofline": {"HloAnalysis", "analyze", "shape_bytes"},
}
PACKAGES = ("checkpoint", "configs", "core", "data", "kernels", "launch",
            "models", "optim", "roofline", "serving", "sharding",
            "training")


def _exported(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not (
                type(v).__name__ == "module")}


@pytest.mark.parametrize("package", PACKAGES)
def test_port_packages_export_the_references_names(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = {k for k in _exported(ref)
            if getattr(getattr(ref, k), "__module__", "").startswith("repro")
            or not callable(getattr(ref, k))}
    want -= EXPORT_EXCEPTIONS.get(package, set())
    want -= {"annotations"}
    missing = sorted(k for k in want if not hasattr(port, k))
    assert not missing


def test_map_defs_and_msc_rules_are_the_references():
    from repro.models.params import is_def as jis_def
    from repro.sharding import MSC_RULES as JRULES
    from repro.sharding import MSC_TABLE as JTABLE
    from repro_torch.models import map_defs, model_defs
    from repro_torch.models.params import ParamDef, is_def
    from repro_torch.sharding import MSC_RULES, MSC_TABLE

    assert MSC_TABLE == JTABLE
    assert MSC_RULES.batch_axes == JRULES.batch_axes
    assert dataclasses.asdict(MSC_RULES)["table"] == JRULES.table
    cfg = get_config("qwen1.5-0.5b").reduced(scan_layers=True)
    shapes = map_defs(lambda d: d.shape, model_defs(cfg))
    from repro.configs import get_config as jget
    from repro.models import model_defs as jdefs
    from repro.models.params import map_defs as jmap

    jcfg = dataclasses.replace(jget("qwen1.5-0.5b").reduced(),
                               scan_layers=True)
    assert shapes == jmap(lambda d: d.shape, jdefs(jcfg))
    assert is_def(ParamDef((2,), (None,))) and not is_def((2,))
    assert jis_def is not None
