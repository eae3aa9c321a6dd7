"""The port's CLI on the CPU, and the port's import boundary."""
import ast
import os

import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("flag", [["--mesh-shape", "4,2"],
                                  ["--schedule", "grouped"]])
def test_cli_unported_options_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        msc_run.main(["--m", "24", "--device", "cpu", *flag])


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
    for part in ("serving", "gram.py"):
        assert any(part in f for f in files), part
    bad = {f: sorted(set(_imported_roots(f)) & {"jax", "jaxlib", "repro"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
