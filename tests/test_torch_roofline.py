"""The port's roofline models, held to the reference's on the CPU.

Every model's dict and every chooser's pick equal the reference's at
`hw=V5E` (numbers to 1e-12 relative, ints, strings and tuples exactly):
the epilogue, eigensolve, relayout, continuous and static serving models
over the grids of `tests/test_roofline.py::TestEpilogueModel` and
`tests/test_autotune.py::TestChooserCrossovers`, the LM side's
`active_param_count` / `model_flops` on the dense configs the port
builds, `RooflineReport` and `table.render`.  The H100 spec runs every
model and chooser, and `target_hw` maps a CUDA device to it and the CPU
to the reference's V5E.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.roofline as J  # noqa: E402
from repro.roofline import table as jtable  # noqa: E402
import repro_torch.roofline as R  # noqa: E402
from repro_torch.roofline import table as rtable  # noqa: E402

EPILOGUES = ("allgather", "ring")


def _same(got, want, path="."):
    """Equal structures: floats to 1e-12 relative, the rest exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (path, got)
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0) or (
            got == want), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_v5e_and_pod_are_the_references():
    assert dataclasses.asdict(R.V5E) == dataclasses.asdict(J.V5E)
    assert R.CHIPS_PER_POD == J.CHIPS_PER_POD
    assert [f.name for f in dataclasses.fields(R.HwSpec)] == [
        f.name for f in dataclasses.fields(J.HwSpec)]
    assert R.RELAYOUTS == J.RELAYOUTS


def test_h100_spec_and_target_hw():
    h = R.H100
    assert (h.peak_flops_bf16, h.hbm_bw, h.ici_bw, h.ici_links,
            h.hbm_bytes, h.vmem_bytes) == (989e12, 3.35e12, 450e9, 18, 80e9,
                                           228 * 2**10)
    assert R.target_hw(torch.device("cuda")) is R.H100
    assert R.target_hw("cuda:0") is R.H100
    assert R.target_hw("cpu") is R.V5E
    assert R.target_hw(torch.device("cpu")) is R.V5E


@pytest.mark.parametrize("dtype_bytes", [4.0, 2.0])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_epilogue_model_is_the_references(epilogue, dtype_bytes):
    for m, c, p in ((1000, 1000, 8), (45, 45, 8), (64, 64, 4), (2, 2, 1),
                    (96, 96, 2), (256, 256, 8), (8, 8, 4), (32, 17, 3)):
        _same(R.epilogue_model(m, c, p, epilogue=epilogue,
                               dtype_bytes=dtype_bytes),
              J.epilogue_model(m, c, p, epilogue=epilogue,
                               dtype_bytes=dtype_bytes))


def test_epilogue_model_rejects_unknown():
    with pytest.raises(ValueError):
        R.epilogue_model(10, 10, 2, epilogue="bogus")


@pytest.mark.parametrize("overlap", [False, True])
def test_eigensolve_model_is_the_references(overlap):
    for m, r, c, p, q in ((1000, 1000, 1000, 8, 1), (24, 24, 24, 2, 2),
                          (45, 33, 21, 4, 2), (96, 96, 96, 8, 4),
                          (17, 9, 5, 1, 3)):
        for sweeps, db in ((12, 4.0), (6, 2.0)):
            _same(R.eigensolve_model(m, r, c, p, q, sweeps=sweeps,
                                     dtype_bytes=db, overlap=overlap),
                  J.eigensolve_model(m, r, c, p, q, sweeps=sweeps,
                                     dtype_bytes=db, overlap=overlap))


def test_relayout_model_and_choice_over_the_size_grid():
    """TestChooserCrossovers' size scan: every model and pick equal."""
    for m in range(4, 200, 4):
        kw = dict(sweeps=1, launch_s=1e-6)
        _same(R.relayout_model((m, m, m), 8, **kw),
              J.relayout_model((m, m, m), 8, **kw))
        assert R.choose_relayout((m, m, m), 8, **kw) == \
            J.choose_relayout((m, m, m), 8, **kw)


def test_relayout_choice_over_the_launch_cost_grid():
    picks = []
    for ls in np.geomspace(1e-9, 1e-2, 40):
        kw = dict(B=8, sweeps=8, launch_s=float(ls))
        _same(R.relayout_model((96, 96, 96), 8, **kw),
              J.relayout_model((96, 96, 96), 8, **kw))
        pick = R.choose_relayout((96, 96, 96), 8, **kw)
        assert pick == J.choose_relayout((96, 96, 96), 8, **kw)
        picks.append(pick)
    assert [p for i, p in enumerate(picks) if i == 0 or p != picks[i - 1]] \
        == ["collective_stream", "collective", "gspmd"]
    for q in (2, 4):
        _same(R.relayout_model((48, 40, 24), 4, q, B=2),
              J.relayout_model((48, 40, 24), 4, q, B=2))
    assert R.choose_relayout((96, 96, 96), 1) == "gspmd"


def test_epilogue_choice_over_the_grid():
    picks = set()
    for p in (1, 2, 4, 8):
        for m in (2, 8, 32, 96, 256):
            pick = R.choose_epilogue(m, m, p)
            assert pick == J.choose_epilogue(m, m, p), (m, p)
            picks.add(pick)
    assert picks == {"ring", "allgather"}


def test_chunk_steps_choice_is_the_references():
    hist = [32] * 7 + [240]
    kw = dict(check_every=8, shape=(48, 48, 48), p=8)
    for dispatch in (0.0, 1e-4, 1e-3, 1.0):
        assert R.choose_chunk_steps(hist, 8, dispatch_s=dispatch, **kw) == \
            J.choose_chunk_steps(hist, 8, dispatch_s=dispatch, **kw)
    assert R.choose_chunk_steps(hist, 8, dispatch_s=1.0, **kw) > 1
    assert R.choose_chunk_steps([24], 2, check_every=6,
                                shape=(24, 24, 24)) == 1
    with pytest.raises(ValueError):
        R.choose_chunk_steps(hist, 8, candidates=(), **kw)


@pytest.mark.parametrize("case", [
    dict(),
    dict(shape=(48, 48, 48), p=4, q=2, epilogue="ring", dispatch_s=1e-4),
    dict(exact_hit_rate=0.25, warm_hit_rate=0.25, lookup_s=0.5),
    dict(arrivals=[0, 0, 1, 2, 2, 5, 7, 9], priorities=[1, 0, 1, 0, 2, 0, 1,
                                                         0], slo_chunks=6),
    dict(refill_min_free=3, aging_chunks=4, warm_sweeps=12,
         warm_hit_rate=0.5),
], ids=["plain", "shape", "cache", "queues", "batching"])
def test_continuous_serving_model_is_the_references(case):
    hist = [12, 60, 18, 240, 24, 30, 6, 96]
    _same(R.continuous_serving_model(hist, 3, check_every=6, **case),
          J.continuous_serving_model(hist, 3, check_every=6, **case))


def test_serving_model_and_queue_wait_are_the_references():
    for kw in (dict(), dict(epilogue="ring", q=2, compile_s=3.0,
                            iter_hist=[12, 30, 6, 60])):
        _same(R.serving_model((24, 24, 16), 4, 2, **kw),
              J.serving_model((24, 24, 16), 4, 2, **kw))
    for args in ((0, 2, 4, 3.0), (5, 1, 4, 2.5), (3, 0, 2, 0.2)):
        assert R.expected_queue_wait(*args) == J.expected_queue_wait(*args)
    with pytest.raises(ValueError):
        R.expected_queue_wait(1, 1, 0, 1.0)


@pytest.mark.parametrize("name", ["qwen1_5_0_5b", "whisper_tiny",
                                  "gemma2_27b"])
def test_model_flops_are_the_references(name):
    from repro.configs import get_config as jget
    from repro.models.config import SHAPES_BY_NAME as JSHAPES
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES_BY_NAME

    assert R.active_param_count(get_config(name)) == \
        J.active_param_count(jget(name))
    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        assert R.model_flops(get_config(name), SHAPES_BY_NAME[shape],
                             kind) == J.model_flops(jget(name),
                                                    JSHAPES[shape], kind)


def _report_fields():
    return dict(arch="msc-mf", shape="msc_1000", mesh="16x16", chips=256,
                compute_s=1.5e-3, memory_s=4.2e-3, collective_s=2e-4,
                collective_link_s=7e-4, dominant="memory", model_flops=3e15,
                hlo_flops_global=3.3e15, flops_ratio=3e15 / 3.3e15,
                bytes_per_device=1.2e9, collective_bytes_global=5e9,
                collectives_by_kind={"all-gather": {"count": 3}},
                unknown_trip_counts=0, xla_cost_analysis={},
                memory_stats={"temp_size_in_bytes": 2**30}, note="n")


def test_roofline_report_and_save(tmp_path):
    got = R.RooflineReport(**_report_fields())
    want = J.RooflineReport(**_report_fields())
    _same(got.to_json(), want.to_json())
    assert got.summary() == want.summary()
    assert got.bound_s == 4.2e-3 and got.dominant == "memory"
    R.save_report(got, str(tmp_path / "a" / "r.json"))
    J.save_report(want, str(tmp_path / "b" / "r.json"))
    assert json.loads((tmp_path / "a" / "r.json").read_text()) == \
        json.loads((tmp_path / "b" / "r.json").read_text())


def test_table_renders_the_references_text(tmp_path):
    rows = []
    for i, (arch, shape, mesh) in enumerate((
            ("whisper-tiny", "decode_32k", "16x16"),
            ("msc-mf", "msc_1000", "16x16"), ("gemma2-27b", "train_4k",
                                               "16x16"),
            ("msc-gram-coll", "msc_1024", "2x16x16"))):
        r = R.RooflineReport(**dict(_report_fields(), arch=arch, shape=shape,
                                    mesh=mesh, compute_s=1e-3 * (i + 1)))
        R.save_report(r, str(tmp_path / f"{i}.json"))
        rows.append(r.to_json())
    got, want = rtable.load(str(tmp_path)), jtable.load(str(tmp_path))
    assert got == want
    for mesh in ("16x16", "2x16x16"):
        assert rtable.render(got, mesh) == jtable.render(want, mesh)
    assert rtable.fmt_s(2.5) == jtable.fmt_s(2.5)


def test_models_and_choosers_run_on_the_h100():
    """At hw=H100 every model runs, and each chooser picks the argmin of
    its model on that spec (the faster links favour the blocking forms
    at smaller sizes than on V5E)."""
    h = R.H100
    for m, p in ((96, 8), (1000, 8), (8, 2)):
        ag = R.epilogue_model(m, m, p, epilogue="allgather", hw=h)
        ring = R.epilogue_model(m, m, p, epilogue="ring", hw=h)
        want = "ring" if ring["latency_s"] < ag["latency_s"] else "allgather"
        assert R.choose_epilogue(m, m, p, hw=h) == want
        assert ag["comm_s"] == ag["link_bytes"] / h.ici_bw
    rel = R.relayout_model((200, 200, 200), 4, 2, B=8, sweeps=8, hw=h)
    lat = {k: rel[f"{k}_s"] for k in R.RELAYOUTS}
    assert R.choose_relayout((200, 200, 200), 4, 2, B=8, sweeps=8,
                             hw=h) == min(R.RELAYOUTS, key=lat.__getitem__)
    eig = R.eigensolve_model(1000, 1000, 1000, 1, sweeps=6, hw=h)
    assert eig["compute_s"] == 6 * 4.0 * 1000**3 / h.peak_flops_bf16
    cont = R.continuous_serving_model([24] * 28 + [240] * 4, 8,
                                      check_every=8, shape=(200, 200, 200),
                                      hw=h)
    assert 0.0 < cont["occupancy_static"] <= cont["occupancy_continuous"] \
        <= 1.0
    assert R.serving_model((200, 200, 200), 4, 1, hw=h)["speedup"] > 1.0
    assert R.choose_chunk_steps([24] * 8, 8, check_every=8,
                                shape=(200, 200, 200), hw=h) == 1
