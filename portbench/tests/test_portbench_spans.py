"""The readers of the program's spans on a traced CPU run of each cell at
a small size: the counts and host-clock shares read a number, the
device-time shares nothing (no card), and an untraced run records no
span."""
import math
import time

import pytest

from harness.runner import run_cell
from small import small

SPAN_METRICS = {
    "msc-m1000.solve": ({"host_reads_per_solve"},
                        {"unfold_share.solve", "eigensolve_roofline.window"}),
    "msc-m1000.gram": ({"host_reads_per_solve"},
                       {"unfold_share.solve", "eigensolve_roofline.window"}),
    "msc-serve-m400.skewed": ({"queue_wait_share.serve"},
                              {"refill_share.serve"}),
}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers_on_a_traced_cpu_run(name):
    numbers, device_only = SPAN_METRICS[name]
    cell = small(name)
    assert numbers | device_only <= {m["name"]
                                     for m in cell.metrics(trace=True)}
    res = run_cell(cell, 2**31 + 23, 0.3, True, device="cpu",
                   start_wall=time.time())
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert numbers <= set(got) and not device_only & set(got)
    for m in numbers:
        assert math.isfinite(got[m]["value"]) and got[m]["value"] > 0
    if "host_reads_per_solve" in numbers:
        # every mode reads once a gate chunk and once more: 2 at least
        assert got["host_reads_per_solve"]["value"] >= 6
    else:
        assert got["queue_wait_share.serve"]["value"] < 100


def test_an_untraced_run_records_no_span():
    from repro_torch import spans

    cell = small("msc-m1000.solve")
    run_cell(cell, 5, 0.3, True, device="cpu", start_wall=time.time())
    before = spans.recorded()
    assert before.spans
    run_cell(cell, 5, 0.3, False, device="cpu", start_wall=time.time())
    assert spans.recorded().spans == before.spans
