"""The port's examples `msc_serve`, `msc_activations` and `serve_lm`
against the reference's (`examples/*.py`), on the CPU with `--device cpu`.

The reference's three examples run in one subprocess (started first, so
it runs while the port's do) and their printed lines are compared with
the port's:
- `msc_serve`: fed the reference's tensors (its `jax.random` draws,
  carried across as numpy), every printed line equal to the reference's
  once the times are masked: the buckets, the counters of all four
  parts, every request's recovery rate (its masks against the planted
  ones) and sweeps;
- `msc_activations`: the layer-mode mask and the redundant layers found
  (the weights are the port's own random draws: d differs);
- `serve_lm`: the config, batch and generated shape (random weights: the
  tokens differ).
"""
import contextlib
import functools
import io
import os
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import msc_activations, msc_serve, serve_lm  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
REFERENCE = r"""
import contextlib, io, json, os, runpy, sys
out = {}
for name in ("msc_serve", "msc_activations", "serve_lm"):
    buf = io.StringIO()
    sys.argv = [name]
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(%r, name + ".py"), run_name="__main__")
    out[name] = buf.getvalue()
print("JSON" + json.dumps(out))
"""
# times and rates in the printed lines
TIMES = re.compile(r"\d+\.\d+s\b|\(\d+\.\d+ (req|tok)/s[^)]*\)")


class Reference:
    """The reference examples' output, from a subprocess started at once."""

    def __init__(self, subproc):
        self.out, self.err = None, None

        def run():
            try:
                text = subproc(REFERENCE % EXAMPLES, 1, timeout=300)
                import json

                line = [x for x in text.splitlines() if x.startswith("JSON")]
                self.out = json.loads(line[-1][4:])
            except BaseException as e:  # noqa: BLE001 - raised in get()
                self.err = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def get(self, name):
        self.thread.join(320)
        assert not self.thread.is_alive(), "the reference did not end"
        if self.err is not None:
            raise self.err
        return self.out[name]


@pytest.fixture(scope="module")
def reference(subproc):
    return Reference(subproc)


def _lines(text):
    return [TIMES.sub("<t>", x) for x in text.splitlines()
            if x.strip() and "Warning" not in x]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@functools.cache
def _jplanted(seed, shape, sizes, gamma):
    import jax

    from repro.core import PlantedSpec, make_planted_tensor

    return np.array(make_planted_tensor(
        jax.random.PRNGKey(seed), PlantedSpec(shape=shape,
                                              cluster_sizes=sizes,
                                              gamma=gamma)))


def test_msc_serve_example_prints_the_references_lines(reference,
                                                       monkeypatch):
    monkeypatch.setattr(
        msc_serve, "_planted", lambda seed, spec, dev: torch.tensor(
            _jplanted(seed, tuple(spec.shape), tuple(spec.cluster_sizes),
                      float(spec.gamma)), device=dev))
    got = _lines(_run(msc_serve.main, ["--device", "cpu"]))
    want = _lines(reference.get("msc_serve"))
    assert got == want


def test_msc_activations_example_finds_the_references_layers(reference):
    got = _run(msc_activations.main, ["--device", "cpu"]).splitlines()
    want = reference.get("msc_activations").splitlines()
    for prefix in ("layer-mode cluster mask:", "redundant layers detected:"):
        assert [x for x in got if x.startswith(prefix)] == \
            [x for x in want if x.startswith(prefix)]


def test_serve_lm_example_serves_the_references_shape(reference):
    got = _run(serve_lm.main, ["--device", "cpu"]).splitlines()[0]
    want = reference.get("serve_lm").splitlines()[0]
    assert got.split(" in ")[0] == want.split(" in ")[0]
    assert got.startswith("qwen1.5-0.5b-smoke: batch=4 prompt=32 gen=12 → "
                          "(4, 12)")
