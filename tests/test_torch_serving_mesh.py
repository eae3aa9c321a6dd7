"""The port's MSC serving engines across gloo ranks on the CPU.

Each mesh shape is one spawn of gloo ranks (a FileStore under the test's
temporary directory, one thread per rank, bounded by a join timeout)
that runs all of that shape's cases and writes every rank's results and
`ServeStats` to a .npz.  The reference's engines run the same cases on
the same mesh shapes in one subprocess of 4 forced host devices, started
first so that it runs while the ranks do.  Meshes: (2,) and (3,) (the
bucket quantum rounds to 9: padding), (2, 2) with an inner dim, and a
(2, 2) ("data", "model") mesh whose slice role spans both dims.

Held, per request and mode: masks and `power_iters_run` identical to the
reference engine's on the same mesh shape, d and λ within 3e-5 of the
largest reference entry; the continuous engine's `ServeStats` counters
equal to the reference's; every rank's results and counters identical.
Also: the flat schedule on the composite mesh against the reference's
`PROD_MESH_MSC` tensor, `msc_run --batch` and `msc_serve --mesh-shape
--continuous` through their CLIs (the ranks' lines equal the reference
CLI's on its tensors; the spawned CLI ends and prints the reference's
lines), and `_bucket_quantum` on a mesh.

On a card (`pytest -m gpu`), one NCCL rank holds both engines on the
(1,) and (1, 1) meshes with the collectives inside their CUDA graphs;
on a machine with an even number of cards, every card one rank, both
engines on (n,), (n/2, 2) and (2, n/2) ("data", "model") against the
one-device engines.  This file imports jax only inside the CPU fixtures.
"""
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MSCConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serving import msc_engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 150
TOL = 3e-5

# name: (mesh shape, dim names)
MESHES = {
    "slice2": ((2,), ("slice",)),
    "slice3": ((3,), ("slice",)),
    "slice2x2": ((2, 2), ("slice", "inner")),
    "data2xmodel2": ((2, 2), ("data", "model")),
}
# the reference's static serving requests (tests/test_msc_serving.py) and
# continuous stream (tests/test_msc_continuous.py CONTINUOUS_PARITY)
STATIC_SIZES, N_STATIC = (14, 19), 5
STREAM = ((21, 70.0), (23, 30.0), ((18, 23, 15), (2, 3, 2), 60.0),
          (17, 90.0), (24, 40.0), (22, 35.0))
RUN_ARGV = ["--m", "24", "--batch", "2", "--mesh-shape", "2,2"]
SERVE_ARGV = ["--mesh-shape", "2,2", "--sizes", "14,19", "--requests", "4",
              "--max-batch", "2", "--continuous", "--slow-every", "3",
              "--arrival-rate", "1.5", "--no-loop-compare"]
STATS = [f.name for f in dataclasses.fields(msc_engine.ServeStats)]
# the static engine's all_to_all relayouts, beside the default "gspmd"
COLLECTIVE_RELAYOUTS = ("collective", "collective_stream")


def _static_cfg():
    return MSCConfig(epsilon=3e-4)


def _stream_cfg():
    return MSCConfig(epsilon=3e-4, power_tol=1e-2)


def _inputs(path):
    """The requests, made by the reference's generator (jax imported
    here only), to an .npz."""
    import jax

    from repro.core import PlantedSpec, make_planted_tensor
    from repro.launch import msc_serve as jserve

    def planted(seed, spec):
        return np.asarray(make_planted_tensor(jax.random.PRNGKey(seed),
                                              spec))

    out = {}
    for i in range(N_STATIC):
        m = STATIC_SIZES[i % len(STATIC_SIZES)]
        out[f"static{i}"] = planted(i, PlantedSpec.paper(m, float(max(m, 40))))
    for i, s in enumerate(STREAM):
        spec = (PlantedSpec.paper(*s) if len(s) == 2 else
                PlantedSpec(shape=s[0], cluster_sizes=s[1], gamma=s[2]))
        out[f"stream{i}"] = planted(i, spec)
    out["prod"] = planted(3, PlantedSpec.paper(m=40, gamma=70.0))
    for i in range(2):  # msc_run --batch 2: seeds 0, 1
        out[f"run{i}"] = planted(i, PlantedSpec.paper(24, 24.0))
    _, tensors = jserve.build_request_stream([14, 19], 4, 0, slow_every=3)
    for i, t in enumerate(tensors):
        out[f"serve{i}"] = np.asarray(t)
    np.savez(path, **out)


def _store(out, key, results):
    for i, r in enumerate(results):
        for j in range(3):
            out[f"{key}/{i}/{j}/mask"] = np.asarray(r[j].mask)
            out[f"{key}/{i}/{j}/d"] = np.asarray(r[j].d)
            out[f"{key}/{i}/{j}/lam"] = np.asarray(r[j].lambdas)
            out[f"{key}/{i}/{j}/iters"] = np.asarray(
                int(r[j].power_iters_run))


def _stats(out, key, stats):
    out[f"{key}/stats"] = np.asarray(json.dumps(dataclasses.asdict(stats)))


def _port_worker(device, key, in_path, out_dir):
    """One rank: both engines on the mesh `key`; on the composite mesh
    the flat schedule on the PROD tensor; on (2, 2) the two CLIs' runs
    on the reference's tensors, each rank's lines to a file."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import build_msc_parallel
    from repro_torch.launch import msc_run, msc_serve
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    shape, names = MESHES[key]
    inputs = dict(np.load(in_path))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    rank = dist.get_rank()
    out = {}
    eng = MSCServeEngine(_static_cfg(), max_batch=2, device="cpu", mesh=mesh)
    _store(out, "static", eng.run([inputs[f"static{i}"]
                                   for i in range(N_STATIC)]))
    _stats(out, "static", eng.stats)
    for relayout in COLLECTIVE_RELAYOUTS:
        reng = MSCServeEngine(_static_cfg(), max_batch=2, device="cpu",
                              mesh=mesh, relayout=relayout)
        _store(out, f"static_{relayout}", reng.run(
            [inputs[f"static{i}"] for i in range(N_STATIC)]))
        _stats(out, f"static_{relayout}", reng.stats)
    ceng = MSCContinuousEngine(_stream_cfg(), slots=2, device="cpu",
                               mesh=mesh)
    _store(out, "cont", ceng.run([inputs[f"stream{i}"]
                                  for i in range(len(STREAM))]))
    _stats(out, "cont", ceng.stats)
    if key == "data2xmodel2":
        res = build_msc_parallel(MSCConfig(epsilon=2e-4), "flat",
                                 mesh=mesh)(torch.from_numpy(inputs["prod"]))
        _store(out, "prod", [res])
    if key == "slice2x2":
        def planted(prefix):
            return lambda gen, spec: torch.from_numpy(
                inputs[f"{prefix}{gen.initial_seed()}"])

        msc_run.make_planted_tensor = planted("run")
        msc_serve.make_planted_tensor = planted("serve")
        with open(os.path.join(out_dir, f"cli{rank}.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            msc_run._run(msc_run.parse_args(RUN_ARGV + ["--device", "cpu"]),
                         device, dist.get_world_size())
            served = msc_serve._serve(msc_serve.parse_args(
                SERVE_ARGV + ["--device", "cpu"]), device)
            msc_serve._close(served)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


REFERENCE = r"""
import contextlib, dataclasses, io, json
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import MSCConfig, build_msc_parallel_flat
from repro.launch import msc_run, msc_serve
from repro.serving import MSCContinuousEngine, MSCServeEngine
inputs = dict(np.load({in_path!r}))
out = {{}}

def store(key, results):
    for i, r in enumerate(results):
        for j in range(3):
            out["%s/%d/%d/mask" % (key, i, j)] = np.asarray(r[j].mask)
            out["%s/%d/%d/d" % (key, i, j)] = np.asarray(r[j].d)
            out["%s/%d/%d/lam" % (key, i, j)] = np.asarray(r[j].lambdas)
            out["%s/%d/%d/iters" % (key, i, j)] = np.asarray(
                int(r[j].power_iters_run))

for key, (shape, names) in {meshes!r}.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    eng = MSCServeEngine(mesh, MSCConfig(epsilon=3e-4), max_batch=2)
    store(key + "/static", eng.run([inputs["static%d" % i]
                                    for i in range({n_static})]))
    out[key + "/static/stats"] = np.asarray(json.dumps(
        dataclasses.asdict(eng.stats)))
    ceng = MSCContinuousEngine(mesh, MSCConfig(epsilon=3e-4, power_tol=1e-2),
                               slots=2)
    store(key + "/cont", ceng.run([inputs["stream%d" % i]
                                   for i in range({n_stream})]))
    out[key + "/cont/stats"] = np.asarray(json.dumps(
        dataclasses.asdict(ceng.stats)))
    if key == "data2xmodel2":
        store(key + "/prod", [build_msc_parallel_flat(
            mesh, MSCConfig(epsilon=2e-4))(inputs["prod"])])
for name, mod, argv in (("run", msc_run, {run_argv!r}),
                        ("serve", msc_serve, {serve_argv!r})):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    out["cli/" + name] = np.asarray(buf.getvalue())
np.savez({out_path!r}, **out)
print("OK")
"""


class Runs:
    """The inputs, the reference's subprocess (in a thread, started at
    once) and one spawn of gloo ranks per mesh shape, each run once."""

    def __init__(self, tmp, subproc):
        self.tmp = tmp
        self.in_path = str(tmp / "inputs.npz")
        _inputs(self.in_path)
        self.port_runs = {}
        self.ref_path, self.ref_error, self.ref_data = (
            str(tmp / "reference.npz"), None, None)
        code = REFERENCE.format(
            in_path=self.in_path, out_path=self.ref_path, meshes=MESHES,
            n_static=N_STATIC, n_stream=len(STREAM), run_argv=RUN_ARGV,
            serve_argv=SERVE_ARGV)

        def reference():
            try:
                subproc(code, 4, timeout=400)
            except BaseException as e:  # noqa: BLE001 - raised in ref()
                self.ref_error = e

        self.thread = threading.Thread(target=reference, daemon=True)
        self.thread.start()

    def ref(self) -> dict:
        for key in MESHES:  # the ranks' runs, while the reference runs
            self.port(key)
        self.thread.join(420)
        assert not self.thread.is_alive(), "the reference did not end"
        if self.ref_error is not None:
            raise self.ref_error
        if self.ref_data is None:
            self.ref_data = dict(np.load(self.ref_path))
        return self.ref_data

    def port(self, key):
        """[rank 0's results, …] of the mesh's spawn; each with its CLI
        lines under "cli" on (2, 2)."""
        if key not in self.port_runs:
            out = self.tmp / key
            out.mkdir()
            n = int(np.prod(MESHES[key][0]))
            tmesh.spawn(_port_worker, n, out / "store", key, self.in_path,
                        str(out), device_type="cpu",
                        timeout=tmesh.datetime.timedelta(seconds=120),
                        join_timeout=SPAWN_TIMEOUT)
            ranks = []
            for r in range(n):
                d = dict(np.load(out / f"rank{r}.npz"))
                cli = out / f"cli{r}.txt"
                if cli.exists():
                    d["cli"] = cli.read_text()
                ranks.append(d)
            self.port_runs[key] = ranks
        return self.port_runs[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    return Runs(tmp_path_factory.mktemp("serving_mesh"), subproc)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _hold(port, ref, key, ref_key, n):
    for i in range(n):
        for j in range(3):
            p = lambda f: port[f"{key}/{i}/{j}/{f}"]  # noqa: E731
            r = lambda f: ref[f"{ref_key}/{i}/{j}/{f}"]  # noqa: E731
            np.testing.assert_array_equal(p("mask"), r("mask"),
                                          err_msg=f"{key} {i} {j}")
            assert int(p("iters")) == int(r("iters")), (key, i, j)
            for f in ("d", "lam"):
                assert _rel(p(f), r(f)) <= TOL, (key, i, j, f,
                                                 _rel(p(f), r(f)))


@pytest.mark.parametrize("key", list(MESHES))
def test_static_engine_matches_the_references(runs, key):
    _hold(runs.port(key)[0], runs.ref(), "static", f"{key}/static",
          N_STATIC)


@pytest.mark.parametrize("relayout", COLLECTIVE_RELAYOUTS)
@pytest.mark.parametrize("key", list(MESHES))
def test_static_engine_relayouts_match_the_references(runs, key, relayout):
    """The all_to_all relayouts (the first head makes every mode's block,
    each later head reads its own) against the reference's engine on the
    same mesh: results within the same tolerances, counters equal."""
    port, ref = runs.port(key)[0], runs.ref()
    _hold(port, ref, f"static_{relayout}", f"{key}/static", N_STATIC)
    got = json.loads(str(port[f"static_{relayout}/stats"]))
    want = json.loads(str(ref[f"{key}/static/stats"]))
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}


@pytest.mark.parametrize("key", list(MESHES))
def test_continuous_engine_matches_the_references(runs, key):
    port, ref = runs.port(key)[0], runs.ref()
    _hold(port, ref, "cont", f"{key}/cont", len(STREAM))
    got = json.loads(str(port["cont/stats"]))
    want = json.loads(str(ref[f"{key}/cont/stats"]))
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}


@pytest.mark.parametrize("key", list(MESHES))
def test_static_engine_counters_match_the_references(runs, key):
    """The reference counts one compile per bucket; the CPU counts the
    bucket's first dispatch, so every counter agrees."""
    got = json.loads(str(runs.port(key)[0]["static/stats"]))
    want = json.loads(str(runs.ref()[f"{key}/static/stats"]))
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}


@pytest.mark.parametrize("key", list(MESHES))
def test_every_rank_holds_the_same_results_and_counters(runs, key):
    ranks = runs.port(key)
    for r, other in enumerate(ranks[1:], 1):
        assert other.keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            if k == "cli":
                continue  # rank 0 alone prints
            np.testing.assert_array_equal(other[k], v, err_msg=f"{k} {r}")


def test_flat_schedule_on_the_composite_mesh(runs):
    """PROD_MESH_MSC's tensor (m = 40) on ("data", "model") = (2, 2): the
    slice role spans both dims, row-major."""
    _hold(runs.port("data2xmodel2")[0], runs.ref(), "prod",
          "data2xmodel2/prod", 1)


def _req_lines(text):
    return [x.strip() for x in text.splitlines() if x.startswith("  req ")]


def test_cli_lines_on_a_mesh_are_the_references(runs):
    """msc_run --batch 2 and msc_serve --continuous on (2, 2), each rank
    on the reference's tensors: rank 0 prints the reference CLI's
    per-request lines (rec and sweeps; shape, rec, sizes and sweeps) and
    its stats: and buckets: lines; the other ranks print nothing."""
    ranks, ref = runs.port("slice2x2"), runs.ref()
    port = ranks[0]["cli"]
    ref_run, ref_serve = str(ref["cli/run"]), str(ref["cli/serve"])
    run_lines = _req_lines(port)[:2]
    for got, want in zip(run_lines, _req_lines(ref_run)):
        rec_sweeps = lambda s: (s.split("rec=")[1].split()[0],  # noqa: E731
                                s.split("sweeps=")[1])
        assert rec_sweeps(got) == rec_sweeps(want)
    assert _req_lines(port)[2:] == _req_lines(ref_serve)
    for prefix in ("buckets:", "stats:"):
        pick = lambda t: [x for x in t.splitlines()  # noqa: E731
                          if x.startswith(prefix)]
        assert pick(port) == pick(ref_serve)
    assert "mesh: {'slice': 2, 'inner': 2}" in port
    assert all(not r["cli"] for r in ranks[1:])


@pytest.mark.parametrize("module,argv", [
    ("msc_run", ["--m", "24", "--batch", "2", "--mesh-shape", "2"]),
    ("msc_serve", ["--mesh-shape", "2", "--sizes", "14,19", "--requests",
                   "4", "--max-batch", "2", "--continuous",
                   "--no-loop-compare"]),
], ids=["msc_run_batch", "msc_serve_continuous"])
def test_cli_spawns_its_ranks(module, argv):
    """The CLIs through `--nproc 2`: they end, and rank 0 alone prints
    the reference's lines once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--nproc",
         "2", "--device", "cpu", *argv],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    if module == "msc_run":
        assert "devices=2" in out and "mesh: {'slice': 2}" in out
        assert out.count("req 0:") == 1 and out.count("rec=1.000") == 3
        assert "compiles: 1 cold, 0 warm" in out
    else:
        assert out.count("MSC serve:") == 1 and "mesh {'slice': 2}" in out
        assert out.count("stats: ") == 1
        assert "continuous decode loop" in out and "streamed 4 results" in out


# ---------------------------------------------------------- pure parts

QUANTUM_CASES = [((1,), ("slice",), 3), ((2,), ("slice",), 8),
                 ((3,), ("slice",), 8), ((2, 2), ("slice", "inner"), 8),
                 ((3, 2), ("slice", "inner"), 8), ((4, 2), ("slice", "inner"), 3),
                 ((2, 2), ("data", "model"), 8), ((3, 1), ("data", "model"), 4)]


def _stand_in_schedule(shape, names):
    """The shard counts a ModeSchedule on this mesh has: the roles of
    `msc_axes`, sized by the mesh's dims."""
    from repro_torch.sharding.specs import msc_axes

    dims = dict(zip(names, shape))
    slices, inner = msc_axes(types.SimpleNamespace(mesh_dim_names=names))
    return types.SimpleNamespace(
        slice_shards=int(np.prod([dims[a] for a in slices])),
        inner_shards=int(np.prod([dims[a] for a in inner])))


@pytest.mark.parametrize("shape,names,quantum", QUANTUM_CASES)
def test_bucket_quantum_on_a_mesh_is_the_references(shape, names, quantum):
    """`_bucket_quantum` rounds up to lcm(p, q) as the reference's does
    (tests/test_msc_serving.py::test_bucket_quantum_rounds_to_shards),
    held to the reference's function on a stand-in mesh."""
    from repro.serving.msc_engine import _bucket_quantum as jquantum

    stand_in = types.SimpleNamespace(shape=dict(zip(names, shape)),
                                     axis_names=names)
    got = msc_engine._bucket_quantum(quantum,
                                     _stand_in_schedule(shape, names))
    assert got == jquantum(stand_in, None, quantum)
    assert msc_engine._bucket_of((4, 4, 4), got) == tuple(
        -(-4 // got) * got for _ in range(3))


def test_bucket_quantum_rounds_to_shards():
    """The reference's case: quantum 3 on one device stays 3 and a
    (4, 4, 4) request takes the (6, 6, 6) bucket."""
    q = msc_engine._bucket_quantum(3, _stand_in_schedule((1,), ("slice",)))
    assert q == 3 and msc_engine._bucket_of((4, 4, 4), q) == (6, 6, 6)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planted(shape, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(shape).astype(np.float32)
    t[:3, :3, :3] += 30.0 / np.sqrt(27)
    return t


@pytest.mark.gpu
def test_engines_on_one_nccl_rank_keep_their_graphs(cuda_device, tmp_path):
    """World size 1 on NCCL: both engines on (1,) give the one-device
    engines' bits, on (1, 1) their masks and sweeps, the static engine
    under each relayout; each bucket captures 9 (static) or 2
    (continuous) graphs holding the collectives, and a warm pass
    captures none."""
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    reqs = [torch.from_numpy(_planted((20 + i, 18, 16), i)).to(cuda_device)
            for i in range(4)]
    cfg = MSCConfig(epsilon=3e-4, use_kernels=True)
    one = MSCServeEngine(cfg, max_batch=2, device=cuda_device)
    want = one.run(reqs)
    one.close()
    cone = MSCContinuousEngine(cfg, slots=2, device=cuda_device)
    cwant = cone.run(reqs)
    cone.close()
    tmesh.join("cuda", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        for shape in ((1,), (1, 1)):
            mesh = tmesh.make_msc_mesh("flat", shape)
            for make, ref, per_bucket in _mesh_engines(cfg, mesh, want,
                                                       cwant):
                eng = make()
                got = eng.run(reqs)
                cold = eng.stats.compiles
                buckets = len({eng.bucket_of(r.shape) for r in reqs})
                assert cold == per_bucket * buckets
                eng.run(reqs)
                assert eng.stats.compiles == cold
                for g, w in zip(got, ref):
                    for j in range(3):
                        assert torch.equal(g[j].mask, w[j].mask)
                        assert g[j].power_iters_run == w[j].power_iters_run
                        if shape == (1,):
                            assert torch.equal(g[j].d, w[j].d)
                eng.close()
    finally:
        tmesh.leave()


def _mesh_engines(cfg, mesh, want, cwant):
    """(make engine, the one-device results it is held to, graphs per
    bucket): the static engine under every relayout, then the continuous
    engine."""
    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    return [(functools.partial(MSCServeEngine, cfg, max_batch=2, mesh=mesh,
                               relayout=relayout), want, 9)
            for relayout in ("gspmd",) + COLLECTIVE_RELAYOUTS] + [
        (functools.partial(MSCContinuousEngine, cfg, slots=2, mesh=mesh),
         cwant, 2)]


def _nccl_worker(device, out_dir):
    """One NCCL rank of every card: both engines on (n,), (n/2, 2) and a
    (2, n/2) ("data", "model") mesh against the one-device engines on
    this rank's card; a mismatch raises, which fails the spawn."""
    import faulthandler

    # a rank stuck in a collective prints every thread's stack and exits,
    # so the spawn fails with the place it hung
    faulthandler.dump_traceback_later(240, exit=True)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serving import MSCContinuousEngine, MSCServeEngine

    n = dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = [torch.from_numpy(_planted((20 + 3 * i, 18, 16), i)).to(device)
            for i in range(5)]
    cfg = MSCConfig(epsilon=3e-4, use_kernels=True)
    want = MSCServeEngine(cfg, max_batch=2, device=device).run(reqs)
    cwant = MSCContinuousEngine(cfg, slots=2, device=device).run(reqs)
    meshes = [((n,), ("slice",)), ((n // 2, 2), ("slice", "inner")),
              ((2, n // 2), ("data", "model"))]
    lines = []
    for shape, names in meshes:
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
        for make, ref, per_bucket in _mesh_engines(cfg, mesh, want, cwant):
            eng = make()
            got = eng.run(reqs)
            cold = eng.stats.compiles
            buckets = len({eng.bucket_of(r.shape) for r in reqs})
            eng.run(reqs)
            assert cold == per_bucket * buckets and eng.stats.compiles == cold
            for g, w in zip(got, ref):
                for j in range(3):
                    assert torch.equal(g[j].mask, w[j].mask), (shape, j)
                    assert g[j].power_iters_run == w[j].power_iters_run
                    err = ((g[j].d - w[j].d).abs().max()
                           / w[j].d.abs().max()).item()
                    assert err <= TOL, (shape, j, err)
            lines.append(f"{type(eng).__name__} "
                         f"{getattr(eng, 'relayout', '')} {names} {shape}: "
                         f"{cold} "
                         f"graphs cold, 0 warm, {len(reqs)} requests held")
            eng.close()
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "nccl.txt"), "w") as f:
            f.write("\n".join(lines))


@pytest.mark.gpu
def test_engines_across_nccl_ranks(tmp_path):
    """Every card of the machine one NCCL rank (2 or more, an even count):
    both engines on (n,), (n/2, 2) and a composite (2, n/2) (data, model)
    mesh, their graphs holding collectives across the cards, give the
    one-device engines' masks and sweeps (d within 3e-5), capture their
    graphs cold and none warm."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2 \
            or torch.cuda.device_count() % 2:
        pytest.skip("needs an even number of CUDA cards, 2 or more")
    tmesh.spawn(_nccl_worker, torch.cuda.device_count(), tmp_path / "store",
                str(tmp_path), join_timeout=600)
    print((tmp_path / "nccl.txt").read_text())
