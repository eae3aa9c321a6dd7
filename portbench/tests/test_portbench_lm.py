"""The LM cell's parts on the CPU at a reduced size (`small_lm.py`).

The reference's form without multipliers (the port's) gives the
published form's logits.  The plain reference against the port: on the
harness's seeded weights in fp32, the program's copy rewritten without
the multipliers, the port's prefill logits and its decode steps through the KV
cache, teacher-forced on the same tokens, within 1e-4 of the largest
|logit| of the reference's full forward pass (fp32 sums in another
order: the port's chunked online softmax and grouped expert einsums
against one softmax and a loop over the experts); the port's
`ServeEngine` greedy tokens are the reference's argmax at every step.

The judge: 0 on the fp32 program's own tokens, and above the cell's
limit under the controls (fp8 operands; one expert fewer a token) and
under each fault of the timed path that the cell can have:

  unchanged  a decode step leaves the KV cache as it was (its keys and
             values written to a copy)
  half       the prefill runs half the batch and hands its logits and
             cache to the other half
  altered    the engine's last token of every sequence altered where it
             returns them

The work counts at the published widths against hand arithmetic.
"""
import contextlib
import time

import pytest
import torch

from costs import lm as costs
from harness import cell as cells
from harness import judge, lm, systems
from harness.runner import run_cell
from small_lm import small_lm

SEED = 2**31 + 29


def _program(cell, seed):
    """The port's model and parameters on the harness's weights of
    `seed`, and the reference with those weights."""
    from repro_torch.models import build_model

    ref = lm.reference_module(cell)
    w, eps = lm.port_weights(seed, cell, "cpu")
    model = build_model(systems.lm_config(cell, {"norm_eps": eps}))
    return (model, systems.lm_params(model, w), ref,
            lm.weights(seed, cell.config, ref, "cpu"))


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_without_multipliers_is_the_same_model(seed):
    cell = small_lm()
    conf = cell.config
    ref = lm.reference_module(cell)
    w = lm.weights(seed, conf, ref, "cpu")
    toks = torch.randint(0, conf["vocab_size"], (2, 12),
                         generator=torch.Generator().manual_seed(seed))
    with ref.NoTF32():
        want = ref.logits(w, ref.hidden(w, toks, conf), conf)
        plain = dict(conf, embedding_multiplier=1.0, residual_multiplier=1.0,
                     logits_scaling=1.0, rms_norm_eps=0.0,
                     attention_multiplier=ref.dims(conf)["dh"] ** -0.5)
        plain["rms_norm_eps"] = ref.without_multipliers(w, conf)
        got = ref.logits(w, ref.hidden(w, toks, plain), plain)
    assert not torch.equal(w["layers.attn.wo"],
                           lm.weights(seed, conf, ref, "cpu")[
                               "layers.attn.wo"])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("seed", [1, 2])
def test_port_matches_reference_in_fp32(seed):
    cell = small_lm(compute_dtype="float32")
    conf = cell.config
    model, params, ref, w = _program(cell, seed)
    b, s, n = 3, 10, 6
    toks = torch.randint(0, conf["vocab_size"], (b, s + n),
                         generator=torch.Generator().manual_seed(seed))
    with ref.NoTF32():
        want = ref.logits(w, ref.hidden(w, toks, conf), conf)
    scale = float(want.abs().max())
    logits, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                  max_len=s + n)
    torch.testing.assert_close(logits, want[:, s - 1], rtol=0,
                               atol=1e-4 * scale)
    for j in range(n):
        logits, cache = model.decode_step(params, toks[:, s + j:s + j + 1],
                                          cache, s + j)
        torch.testing.assert_close(logits, want[:, s + j], rtol=0,
                                   atol=1e-4 * scale)
    # the engine's greedy tokens are the reference's argmax at each step
    from repro_torch.serving import ServeEngine

    got = ServeEngine(model, params, b, s + n).generate(
        {"tokens": toks[:, :s]}, n)
    seq = torch.cat([toks[:, :s], got.long()], dim=1)
    with ref.NoTF32():
        best = lm.judged_logits(w, ref, conf, seq, s, n).argmax(dim=-1)
    assert torch.equal(best, got.long())


def test_judge_reads_zero_on_the_programs_own_tokens():
    cell = small_lm(compute_dtype="float32")
    res = run_cell(cell, SEED, 0.3, False, device="cpu",
                   start_wall=time.time())
    assert res["checks"]["token_gap_mean"]["value"] == 0.0
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_controls_are_not_correct(seed):
    cell = small_lm()
    got = {r["side"]: r["numbers"]
           for r in lm.readings(cell, seed, 0.3, "cpu")}
    for side in ("fp8", "top_k_less_1"):
        ok, checks = judge.verdict(got[side], cell.limits)
        assert not ok, (side, checks)


@contextlib.contextmanager
def broken(fault: str):
    from repro_torch.models import Model, map_cache
    from repro_torch.serving import ServeEngine

    saved = []

    def patch(owner, name, fn):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    if fault == "unchanged":
        step = Model.decode_step

        def still(self, params, tokens, cache, cache_len):
            logits, _ = step(self, params, tokens,
                             map_cache(cache, torch.clone), cache_len)
            return logits, cache

        patch(Model, "decode_step", still)
    elif fault == "half":
        prefill = Model.prefill

        def half(self, params, batch, max_len):
            b = batch["tokens"].shape[0]
            idx = torch.arange(b) % max(1, b // 2)
            logits, cache = prefill(
                self, params, {"tokens": batch["tokens"][:max(1, b // 2)]},
                max_len)
            return logits[idx], map_cache(cache, lambda t: t[idx])

        patch(Model, "prefill", half)
    elif fault == "altered":
        generate = ServeEngine.generate

        def altered(self, batch, n_tokens):
            out = generate(self, batch, n_tokens).clone()
            out[:, -1] = (out[:, -1] + 1) % self.model.cfg.vocab_size
            return out

        patch(ServeEngine, "generate", altered)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_fault_is_caught(fault):
    cell = small_lm(compute_dtype="float32")
    with broken(fault) if fault else contextlib.nullcontext():
        res = run_cell(cell, SEED, 0.3, False, device="cpu",
                       start_wall=time.time())
    assert res["correct"] is (fault is None), res["checks"]


def test_work_counts_at_the_published_widths():
    conf = cells.load("granite-moe-1b-a400m.offline").config
    d, f, v = 1024, 512, 49155
    attn = d * 16 * 64 * 2 + d * 8 * 64 * 2          # q, o; k, v
    layer = attn + d * 32 + 8 * 3 * d * f + 2 * d    # router, 8 experts
    assert layer == costs.active_layer_params(conf) == 15_763_456
    assert costs.active_params(conf) == 24 * layer + v * d + d \
        == 428_658_688
    total = 24 * (attn + d * 32 + 32 * 3 * d * f + 2 * d) + v * d + d
    assert costs.total_params(conf) == total == 1_334_628_352
    # a prompt of 2 positions: both through the layers, 1 + 2 keys, one
    # head; two new tokens: the prefill gives the first, one decode step
    # the second, over 3 keys
    keys_op = 4 * 16 * 64 * 24
    assert costs.prefill_flops(conf, 1, 2) == \
        2 * 2 * 24 * layer + 3 * keys_op + 2 * d * v
    assert costs.decode_flops(conf, 1, 2, 2) == \
        2 * 24 * layer + 2 * d * v + 3 * keys_op
    assert costs.decode_flops(conf, 1, 2, 1) == 0
    # a decode step at batch 64 reads every weight in bf16, and the cache
    kv = 2 * 24 * 64 * 100 * 8 * 64 * 2
    assert costs.decode_step_bytes(conf, 64, 100) == \
        2 * total + kv + kv // 100
    least = costs.decode_least_s(conf, 64, 100, 2)
    assert least == pytest.approx((2 * total + kv * 101 / 100) / 3.35e12)
    # 64 new tokens: 63 steps over 101 … 163 keys
    assert costs.decode_flops(conf, 1, 100, 64) == 63 * (
        2 * 24 * layer + 2 * d * v) + keys_op * sum(range(101, 164))
