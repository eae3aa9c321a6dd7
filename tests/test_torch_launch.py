"""The port's CLI on the CPU, and the port's import boundary."""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import msc_run  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [
    ["--schedule", "flat", "--kernels"],
    ["--schedule", "sequential", "--kernels", "--precision", "bf16_fp32"],
    ["--schedule", "flat", "--epilogue", "ring", "--power-tol", "0"],
], ids=["flat_kernels", "sequential_bf16", "flat_ring_fixed"])
def test_cli_recovers_planted_cluster_on_cpu(argv, capsys):
    assert msc_run.main(["--m", "24", "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "rec=1.000" in out
    assert "sizes=[2, 2, 2]" in out and "sweeps=" in out and "t=" in out
    if "--power-tol" in argv:
        assert "sweeps=[60, 60, 60]" in out


def test_cli_returns_results_per_repeat():
    recs = msc_run.run(msc_run.parse_args(
        ["--m", "24", "--device", "cpu", "--kernels", "--repeats", "2"]))
    assert len(recs) == 2
    assert all(r["rec"] == 1.0 for r in recs)
    assert all(len(r["result"].modes) == 3 for r in recs)


@pytest.mark.parametrize("flag,exc,match", [
    # 8 ranks asked, 1 there: the reference's message
    (["--mesh-shape", "4,2"], ValueError, "8 devices but 1 are available"),
    # --batch on a mesh is checked as any mesh is: 2 ranks asked, 1 there
    (["--batch", "2", "--mesh-shape", "2"], ValueError,
     "2 devices but 1 are available"),
], ids=["mesh_shape_on_one_rank", "batch_on_a_mesh"])
def test_cli_unported_options_raise(flag, exc, match):
    with pytest.raises(exc, match=match):
        msc_run.main(["--m", "24", "--device", "cpu", *flag])


_REF_CLI = r"""
import jax, numpy as np
from repro.core import PlantedSpec, make_planted_tensor
from repro.launch import msc_run
np.save({path!r}, np.asarray(make_planted_tensor(
    jax.random.PRNGKey(0), PlantedSpec.paper(24, 24.0))))
msc_run.main({argv!r})
"""


def _run_line(out: str):
    """(rec, sizes, sweeps) of the CLI's `run 0:` line."""
    line = next(x for x in out.splitlines() if "run 0:" in x)
    m = re.search(r"rec=(\S+) .*sizes=(\[[^]]*\]).*sweeps=(\[[^]]*\])",
                  line)
    return m.groups()


def _cli_rank(device, argv, path, out_path):
    """One rank of the CLI's run on the mesh of every rank, its input the
    reference's planted tensor (in place of the port's of the same seed);
    what the rank prints goes to out_path.{rank}."""
    import contextlib

    import torch.distributed as dist

    msc_run.make_planted_tensor = lambda gen, spec: torch.from_numpy(
        np.load(path)).to(gen.device)
    with open(f"{out_path}.{dist.get_rank()}", "w") as f, \
            contextlib.redirect_stdout(f):
        msc_run._run(msc_run.parse_args(argv), device,
                     dist.get_world_size())


@pytest.mark.parametrize("argv,n,port_only", [
    (["--mesh-shape", "2,2", "--epilogue", "ring"], 4, []),
    (["--schedule", "grouped"], 3, ["--kernels"]),
], ids=["flat_2x2_ring", "grouped_3_kernels"])
def test_cli_on_a_mesh_prints_the_references_lines(argv, n, port_only,
                                                   subproc, tmp_path):
    """`--nproc n` gloo ranks print the rec= and sizes= of the reference
    CLI on n forced devices, each on its own planted tensor of seed 0;
    the same ranks' run on the reference's tensor prints its sweeps= too.
    The reference runs its einsum path (its kernels fail inside
    shard_map on this jax; ROADMAP.md queue 3)."""
    path = str(tmp_path / "t.npy")
    ref = subproc(_REF_CLI.format(path=path, argv=["--m", "24", *argv]), n)
    assert _run_line(ref)[0] == "1.000"
    argv = ["--m", "24", "--device", "cpu", *argv, *port_only]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.msc_run", "--nproc",
         str(n), *argv],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert port.returncode == 0, port.stderr
    assert f"devices={n}" in port.stdout and "mesh: {" in port.stdout
    assert _run_line(port.stdout)[:2] == _run_line(ref)[:2]
    out = tmp_path / "out"
    tmesh.spawn(_cli_rank, n, tmp_path / "store", argv, path, str(out),
                device_type="cpu", join_timeout=150)
    assert _run_line((tmp_path / "out.0").read_text()) == _run_line(ref)


@pytest.mark.parametrize("argv", [
    ["--gram", "--kernels"],
    ["--gram", "--kernels", "--schedule", "sequential"],
    ["--gram", "--precision", "bf16_fp32"],
], ids=["flat_kernels", "sequential_kernels", "flat_bf16"])
def test_cli_gram_recovers_planted_cluster_on_cpu(argv, capsys):
    assert msc_run.main(["--m", "24", "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "matrix_free=False" in out
    assert "rec=1.000" in out and "sizes=[2, 2, 2]" in out
    assert "sweeps=" in out


@pytest.mark.parametrize("argv", [
    ["--batch", "2"],
    ["--batch", "2", "--gram", "--kernels"],
], ids=["matrix_free", "gram_kernels"])
def test_cli_batch_serves_each_request_on_cpu(argv, capsys):
    res = msc_run.run(msc_run.parse_args(
        ["--m", "24", "--device", "cpu", *argv]))
    out = capsys.readouterr().out
    assert out.count("rec=1.000") == 3  # two requests and the mean
    assert "req 1:" in out and "speedup=" in out
    assert "compiles: 1 cold, 0 warm" in out
    assert res["recs"] == [1.0, 1.0]
    # each request answers as the single-tensor run of its seed does
    for i, r in enumerate(res["results"]):
        one = msc_run.run(msc_run.parse_args(
            ["--m", "24", "--device", "cpu", "--seed", str(i),
             *argv[2:]]))[0]["result"]
        for j in range(3):
            assert torch.equal(r[j].mask, one[j].mask.cpu())
            assert r[j].power_iters_run == one[j].power_iters_run


def test_cli_batch_needs_the_flat_schedule():
    with pytest.raises(SystemExit, match="parallel schedule"):
        msc_run.main(["--m", "24", "--device", "cpu", "--batch", "2",
                      "--schedule", "sequential"])


def test_cli_defaults_to_cuda_and_never_falls_back():
    args = msc_run.parse_args(["--m", "24"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            msc_run.run(args)


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "tools", "torch_profile.py")
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = list(_port_files())
    assert os.path.exists(files[-1]), "chip_smoke.py missing"
    assert len(files) > 10
    for part in ("serving", "gram.py", "fingerprint.py", "result_cache.py",
                 "faults.py", os.path.join("checkpoint", "store.py"),
                 os.path.join("roofline", "analyze.py"), "elastic.py",
                 os.path.join("roofline", "hw.py"),
                 os.path.join("roofline", "table.py"),
                 os.path.join("core", "autotune.py"),
                 os.path.join("launch", "distributed.py"),
                 os.path.join("launch", "dryrun.py"),
                 os.path.join("configs", "inputs.py"),
                 os.path.join("roofline", "trace.py")):
        assert any(f.endswith(part) or part in f for f in files), part
    bad = {f: sorted(set(_imported_roots(f)) & {"jax", "jaxlib", "repro"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
