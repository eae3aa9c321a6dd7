"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name; a throwaway cell added by new files alone runs."""
import json
import math
import re
import shutil
import time
from pathlib import Path

import pytest

from harness import cell as cells
from harness.runner import run_cell

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells_ = len(BENCH["workloads"])
    assert 1 <= cells_ <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, cells_ // 4)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in WORKLOADS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_loads_and_reports(name):
    cell = cells.load(name)
    assert cell.chips in (1, 4)
    e2e = {m["name"] for m in cell.metrics(trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.metrics(trace=True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e  # what it moves is reported in the cell


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    read = cells.reader(metric)
    assert callable(read)
    path = ROOT / "portbench" / "metrics" / f"{metric}.py"
    moves = re.search(r'^MOVES = "([^"]+)"', path.read_text(), re.M)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert moves and moves.group(1) == entry["moves"]


def _msc_cell(dst, bench):
    """A throwaway MSC configuration, mix and limits: the solve cell's at
    m = 20 over a pool of 2."""
    bench["configs"].append({"name": "msc-m20", "source": "test",
                             "file": "portbench/configs/msc-m20.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "msc-m20.pair", "config": "msc-m20",
                               "traffic": "pair", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "msc-m1000.solve" in m.get("workloads", []):
            m["workloads"].append("msc-m20.pair")
    conf = json.loads((dst / "configs" / "msc-m1000.json").read_text())
    conf.update(name="msc-m20", m=20, cluster_size=2)
    conf["solver"].update(epsilon=0.5 / 18 ** 2, max_extraction_iters=20)
    (dst / "configs" / "msc-m20.json").write_text(json.dumps(conf))
    (dst / "traffic" / "pair.json").write_text(json.dumps(
        {"driver": "solve", "pool": 2, "gamma": 20.0, "clients": 1}))
    (dst / "limits" / "msc-m20.pair.json").write_text(
        (dst / "limits" / "msc-m1000.solve.json").read_text())
    # the per-layer metrics whose readers find something on a CPU run
    return "msc-m20.pair", {"solve_roofline.solve", "sweeps_per_solve",
                            "device_idle_share.solve",
                            "host_reads_per_solve"}, {"setup_s", "solve_ms"}


def _lm_cell(dst, bench):
    """A throwaway LM configuration, mix and limits: a reduced
    granite-moe (`small_lm.py`) generating in fp32, whose limits read 0
    on its own tokens."""
    from small_lm import TRAFFIC, small_config

    cell = "granite-moe-tiny.short"
    bench["configs"].append({"name": "granite-moe-tiny", "source": "test",
                             "file": "portbench/configs/granite-moe-tiny.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": cell, "config": "granite-moe-tiny",
                               "traffic": "short", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "granite-moe-1b-a400m.offline" in m.get("workloads", []):
            m["workloads"].append(cell)
    conf = small_config(json.loads(
        (dst / "configs" / "granite-moe-1b-a400m.json").read_text()))
    conf["solver"]["compute_dtype"] = "float32"
    (dst / "configs" / "granite-moe-tiny.json").write_text(json.dumps(conf))
    tr = json.loads((dst / "traffic" / "offline.json").read_text())
    (dst / "traffic" / "short.json").write_text(json.dumps(
        dict(tr, **TRAFFIC)))
    (dst / "limits" / f"{cell}.json").write_text(json.dumps(
        {"missing": 0, "shape": 0, "token_gap_mean": 0.0}))
    # the device-only shares read nothing off a card
    return cell, {"prefill_share.lm"}, {"setup_s", "lm_tokens_per_s"}


@pytest.mark.parametrize("kind", ["msc", "lm"])
def test_a_new_cell_is_new_files_only(tmp_path, kind):
    """A throwaway configuration, mix, limits and BENCHMARK.json entry in a
    copy of the benchmark: the harness finds them by name, and every file
    that was there before is byte for byte the same."""
    dst = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(dst): p.read_bytes()
              for p in dst.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    name, layer, e2e = {"msc": _msc_cell, "lm": _lm_cell}[kind](dst, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load(name, root=tmp_path)
    for traced in (False, True):
        res = run_cell(cell, 3, 0.3, traced, device="cpu",
                       start_wall=time.time())
        assert res["correct"], res["checks"]
    assert set(res["metrics"]) == layer
    res = run_cell(cell, 3, 0.3, False, device="cpu", start_wall=time.time())
    assert set(res["metrics"]) == e2e
    assert all(math.isfinite(v["value"]) for v in res["metrics"].values())
    after = {p.relative_to(dst): p.read_bytes()
             for p in dst.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
