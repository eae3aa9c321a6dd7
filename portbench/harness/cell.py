"""A cell and everything that belongs to it, found by name.

`BENCHMARK.json` names each cell's configuration and traffic, its chips
and its metrics; the files beside it hold the rest:

  portbench/configs/<config>.json    sizes, solver settings, source
  portbench/traffic/<traffic>.json   the mix: which driver, pool, γ's,
                                     clients, route
  portbench/limits/<cell>.json       the limits of the compared numbers
  portbench/metrics/<metric>.py      one reader per per-layer metric

A language model's (the mix's driver "lm_generate", `harness/lm.py`):

  configs/<config>.json   the published config's keys as run (the
                          reference and `costs/lm.py` read them),
                          "reference" (the plain reference's module
                          under reference/: `weight_specs`, `hidden`,
                          `logits`, `without_multipliers`, `NoTF32`,
                          `fp8`), "port" (the port's
                          ModelConfig fields) and "solver" (its dtypes,
                          attention, MoE group and capacity)
  traffic/<traffic>.json  batch, prompt_lengths, new_tokens, max_len,
                          judge_per_call
  limits/<cell>.json      missing, shape, token_gap_mean

A new cell, configuration, mix or metric is new files and new entries;
no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports with --trace 0 or 1."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if self.name in m.get("workloads", [self.name])]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    here = root / BENCH.name
    config = _json(here / "configs" / f"{w['config']}.json")
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                root=root)


def reader(metric: str, root: Path = ROOT):
    """The `read(record)` function of portbench/metrics/<metric>.py."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
