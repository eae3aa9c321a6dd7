"""Nothing the benchmark runs imports JAX or the JAX package `repro`
(whole top-level names: `repro_torch` is the port), and the reference
imports nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_levels(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_levels(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_levels(path) <= {"__future__", "dataclasses", "numpy", "torch"}


def test_the_check_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe", object())
    assert run.forbidden_modules() == ["repro"]
