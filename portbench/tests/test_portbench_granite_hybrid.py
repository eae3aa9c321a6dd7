"""The granite-4.0-h-small cell on the CPU at a reduced size
(`small_hybrid.py`), through the harness as a run drives it: the port's
`ServeEngine` with the chunked SSD prefill in row slices, judged by the
plain reference (`reference/granite_hybrid.py`, the per-token
recurrence).

In fp32 the judge reads the program's own tokens as the reference's
best (gap 0, or a near tie's rounding); traced, the one reader that
needs no card reads a number.  The cell's limits hold against the
controls (fp8 operands; one expert fewer a token) and a planted fault of
the prefill (the SSM state taken after the padding).  The work counts
at the published widths against hand arithmetic."""
import contextlib
import time

import pytest

from costs import granite_hybrid as costs
from harness import cell as cells
from harness import judge, lm
from harness.runner import run_cell
from small_hybrid import small_hybrid

SEED = 2**31 + 41


def test_the_cell_runs_and_reads_its_own_tokens():
    cell = small_hybrid(compute_dtype="float32")
    for traced in (False, True):
        res = run_cell(cell, SEED, 0.3, traced, device="cpu",
                       start_wall=time.time())
        assert res["correct"] and res["failed"] == 0, res["checks"]
        assert res["checks"]["token_gap_mean"]["value"] < 1e-6
    # off a card only the program counter's share reads a number
    assert set(res["metrics"]) == {"prefill_share.lm"}


@pytest.mark.parametrize("seed", [1, 2])
def test_controls_are_not_correct(seed):
    cell = small_hybrid()
    got = {r["side"]: r["numbers"]
           for r in lm.readings(cell, seed, 0.3, "cpu")}
    for side in ("fp8", "top_k_less_1"):
        ok, checks = judge.verdict(got[side], cell.limits)
        assert not ok, (side, checks)


@contextlib.contextmanager
def padded_before_in_proj():
    """The prefill's SSM state taken after the chunk's padding."""
    import torch.nn.functional as F

    from repro_torch.models import ssm

    prefill = ssm.ssd_prefill

    def padded(p, x, cache, cfg):
        pad = -x.shape[1] % cfg.ssm_chunk
        y, cache = prefill(p, F.pad(x, (0, 0, 0, pad)), cache, cfg)
        return y[:, :x.shape[1]], cache

    ssm.ssd_prefill = padded
    try:
        yield
    finally:
        ssm.ssd_prefill = prefill


def test_a_state_fault_is_caught():
    cell = small_hybrid(compute_dtype="float32")
    with padded_before_in_proj():
        res = run_cell(cell, SEED, 0.3, False, device="cpu",
                       start_wall=time.time())
    assert not res["correct"], res["checks"]


def test_work_counts_at_the_published_widths():
    conf = cells.load("granite-4.0-h-small.offline").config
    d, v, inner, n, hs = 4096, 100352, 8192, 128, 128
    proj = d * (2 * inner + 2 * n + hs) + inner * d
    mamba = proj + 5 * (inner + 2 * n) + 3 * hs + inner + d
    attn = d * (64 + 16) * 128 + d
    moe = d * 72 + 72 * 3 * d * 768 + 3 * d * 1536 + d
    assert (costs.mamba_params(conf), costs.attn_params(conf),
            costs.moe_params(conf)) == (mamba, attn, moe) \
        == (102_291_072, 41_947_136, 698_650_624)
    assert costs.total_params(conf) == 9 * mamba + attn + 10 * moe \
        + v * d + d == 8_360_118_912
    full = dict(conf, num_hidden_layers=40, layer_types=(
        conf["layer_types"] * 4))
    assert costs.total_params(full) == 36 * mamba + 4 * attn + 40 * moe \
        + v * d + d == 32_207_337_984
    # a token: 9 Mamba layers (projections, conv, recurrence), one
    # attention layer's projections, 10 MoE layers (router, 10 experts,
    # the shared MLP)
    per = 9 * (2 * proj + 2 * 4 * (inner + 2 * n) + 6 * hs * 64 * n) \
        + 2 * d * 80 * 128 + 10 * 2 * (d * 72 + 10 * 3 * d * 768
                                       + 3 * d * 1536)
    assert costs.token_flops(conf) == per
    keys_op = 4 * 32 * 128
    assert costs.prefill_flops(conf, 1, 2) == 2 * per + 3 * keys_op \
        + 2 * d * v
    # a decode step at batch 128: every weight in bf16, the states read
    # and written in fp32, the one attention layer's cache
    state = 9 * 128 * (hs * 64 * n + 3 * (inner + 2 * n)) * 4
    kv = 2 * 128 * 100 * 8 * 128 * 2
    assert costs.decode_step_bytes(conf, 128, 100) == \
        2 * 8_360_118_912 + 2 * state + kv + kv // 100
