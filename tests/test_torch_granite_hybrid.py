"""granite-4.0-h-small on the port (`configs/granite_4_0_h_small.py`):
Mamba-2 and MoE in every layer, NoPE attention, the published
multipliers, the chunked SSD prefill into the cache, the sliced prefill.

At a reduced size on the CPU (one period of 10 layers, hidden 64, 4
experts of 32 with top 2, 4 SSM heads of 16, state 16, chunk 8), on
seeded weights named and drawn as the plain reference
(`granite_hybrid_reference.py`) names them, in fp32:

- the port's prefill and its decode steps through the caches against
  the reference's full forward pass, on logits, within 2e-5 of the
  largest |logit|: both are fp32 and differ by the order of their sums
  (the chunked SSD against the per-token recurrence, the online softmax,
  the grouped expert einsums); they read ~2e-6 apart;
- two planted faults of the chunked prefill fail that comparison: the
  carried state zeroed between chunks, and the state taken after
  padding (the prompt padded to whole chunks before `in_proj`, whose
  padded positions still decay the state);
- `ssm.ssd_prefill` against `ssm.ssd_decode` (the per-token recurrence)
  from a non-zero state, y and both states, at prompt lengths shorter
  than a chunk, whole chunks, and whole chunks and a shorter one,
  within 1e-5 relative (fp32 sums in another order);
- a prefill in row slices gives the whole one's tokens, and its cache
  and logits within 1e-5 (fp32 products over fewer rows round
  differently); the engine refuses slices where routing could drop a
  token;
- the reduced granite-moe given its multipliers through the new fields
  equals the same model on `portbench/reference/lm.py:
  without_multipliers`' rewritten weights at the default multipliers,
  in its served logits and its training loss, within 1e-5 (the rewrite
  is exact up to rounding);
- the spans a traced prefill records;
- the two copies of the reference compute the same forward pass.

The published config builds on the `meta` device with 32.2 B parameters.
"""
import contextlib
import dataclasses
import importlib.util
import os

import pytest
import torch

import granite_hybrid_reference as ref
from repro_torch.configs.granite_4_0_h_small import CONFIG, PERIOD
from repro_torch.models import build_model, map_cache
from repro_torch.models import ssm as S
from repro_torch.models.params import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5

CONF = dict(
    num_hidden_layers=10, hidden_size=64, num_attention_heads=4,
    num_key_value_heads=2, intermediate_size=32, shared_intermediate_size=64,
    num_local_experts=4, num_experts_per_tok=2, vocab_size=256,
    mamba_n_heads=4, mamba_d_head=16, mamba_d_state=16, mamba_n_groups=1,
    mamba_d_conv=4, mamba_chunk_size=8,
    layer_types=["mamba" if k == "ssm" else "attention" for k in PERIOD],
    position_embedding_type="nope", rms_norm_eps=1e-5,
    embedding_multiplier=12.0, attention_multiplier=1 / 16,
    residual_multiplier=0.22, logits_scaling=16.0)
CFG = CONFIG.reduced(
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
    vocab_size=256, n_experts=4, n_shared_experts=2, experts_per_token=2,
    d_expert=32, ssm_heads=4, ssm_head_dim=16, ssm_state=16, ssm_chunk=8,
    attention_multiplier=1 / 16, compute_dtype="float32",
    capacity_factor=2.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(specs: dict, seed: int) -> dict:
    """The weights of `specs`, drawn as the benchmark's harness draws
    them: N(0, std²), or 1 + N(0, std²) for "one_plus"."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, init, std) in specs.items():
        t = torch.randn(shape, generator=g) * std
        out[name] = t + 1.0 if init == "one_plus" else t
    return out


def port_params(model, w: dict):
    """The model's parameters on reference-named weights: a leaf of layer
    i is row i of "layers.<leaf path>"; a norm's "scale" is the
    multiplier − 1 (the port's RMSNorm multiplies by 1 + scale)."""
    period = len(model.cfg.block_pattern) or 1

    def leaf(d, path):
        if path[0] == "layers":
            layer, rest = path[1] * period + int(path[2][1:]), path[3:]
        elif path[0] == "tail":
            layer, rest = path[1], path[2:]
        else:
            layer, rest = None, path
        name = ".".join(("layers",) * (layer is not None) + rest)
        t = w[name] if layer is None else w[name][layer]
        assert tuple(t.shape) == tuple(d.shape), name
        return (t - 1.0 if rest[-1] == "scale" else t).clone()

    return build(model.defs(), leaf)


def program(seed: int, **over):
    """(model, params) of the reduced hybrid on the weights of `seed`,
    the program's copy rewritten by `without_multipliers`."""
    w = weights(ref.weight_specs(CONF), seed)
    eps = ref.without_multipliers(w, CONF)
    model = build_model(dataclasses.replace(CFG, norm_eps=eps, **over))
    return model, port_params(model, w)


def tokens(seed: int, b: int, s: int) -> torch.Tensor:
    return torch.randint(0, CONF["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed + 100))


def gap(seed: int, s: int, n: int = 4, b: int = 2, **over) -> float:
    """The widest |logit − the reference's| / max |reference logit| over
    the prefill's logits and n teacher-forced decode steps."""
    model, params = program(seed, **over)
    toks = tokens(seed, b, s + n)
    w = weights(ref.weight_specs(CONF), seed)
    with ref.NoTF32():
        want = ref.logits(w, ref.hidden(w, toks, CONF), CONF)
    logits, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                  max_len=s + n)
    got = [logits]
    for j in range(n):
        logits, cache = model.decode_step(params, toks[:, s + j:s + j + 1],
                                          cache, s + j)
        got.append(logits)
    got = torch.stack(got, dim=1)
    return float((got - want[:, s - 1:]).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed,s", [(1, 13), (2, 21), (3, 16), (4, 5)])
def test_port_matches_the_reference(seed, s):
    assert gap(seed, s) < TOL


@contextlib.contextmanager
def planted(fault: str):
    """A fault of the chunked prefill, planted in `models/ssm.py`."""
    saved = {name: getattr(S, name) for name in ("_carry_chunks",
                                                 "ssd_prefill")}
    if fault == "carry_zeroed":
        def carry(states, chunk_decay, init):
            prev, _ = saved["_carry_chunks"](
                states, chunk_decay, init)
            zero = torch.zeros_like(prev)
            zero[:, 0] = prev[:, 0]  # the state before the first chunk
            return zero, states[:, -1]

        S._carry_chunks = carry
    else:  # "after_padding": the prompt padded to whole chunks first
        def prefill(p, x, cache, cfg):
            pad = -x.shape[1] % cfg.ssm_chunk
            y, cache = saved["ssd_prefill"](
                p, torch.nn.functional.pad(x, (0, 0, 0, pad)), cache, cfg)
            return y[:, :x.shape[1]], cache

        S.ssd_prefill = prefill
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(S, name, fn)


@pytest.mark.parametrize("fault", ["carry_zeroed", "after_padding"])
def test_planted_fault_fails_the_comparison(fault):
    with planted(fault):
        assert gap(1, 13) > 10 * TOL


def _ssm_layer(seed: int):
    model, params = program(seed)
    return params["tail"][0]["ssm"]


@pytest.mark.parametrize("s", [5, 13, 16, 21])
def test_chunked_prefill_matches_the_recurrence(s):
    p = _ssm_layer(4)
    b = 2
    g = torch.Generator().manual_seed(s)
    x = torch.randn(b, s, CFG.d_model, generator=g)
    shapes = S.ssm_cache_shape(CFG, b)
    start = tuple(torch.randn(sh, generator=g) * 0.3 for sh in shapes)
    runs = []
    for fn in (S.ssd_prefill, S.ssd_decode):
        cache = tuple(t.clone() for t in start)
        y, cache = fn(p, x, cache, CFG)
        runs.append((y,) + cache)
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    # the state moved, and carries the start's: a zero start differs
    assert not torch.allclose(runs[0][2], start[1])
    y0, _ = S.ssd_prefill(p, x, tuple(torch.zeros(sh) for sh in shapes),
                          CFG)
    assert float((y0 - runs[0][0]).abs().max()) > 1e-3 * float(
        y0.abs().max())


def test_sliced_prefill_equals_the_whole():
    from repro_torch.serving import ServeEngine

    b, s, n = 5, 11, 4
    toks = tokens(7, b, s)
    out = {}
    for slice_tokens in (0, 2 * s):  # slices of 2, 2 and 1 rows
        model, params = program(7, prefill_tokens=slice_tokens)
        eng = ServeEngine(model, params, b, s + n)
        eng.generate({"tokens": tokens(8, b, s)}, n)  # other rows first
        got = eng.generate({"tokens": toks}, n)
        out[slice_tokens] = (got, eng.logits)
        if slice_tokens:  # after the prefill, the cache is the whole one's
            _, whole = model.prefill(params, {"tokens": toks}, s + n)
            eng2 = ServeEngine(model, params, b, s + n)
            eng2._prefill_slices({"tokens": toks}, s)
            # fp32 products over fewer rows round differently
            for a, c in zip(_leaves(eng2._cache), _leaves(whole)):
                torch.testing.assert_close(
                    a, c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))
    assert torch.equal(out[0][0], out[2 * s][0])
    torch.testing.assert_close(out[0][1], out[2 * s][1], rtol=1e-5,
                               atol=1e-5 * float(out[0][1].abs().max()))


@pytest.mark.parametrize("group,refused", [(64, True), (4, False)])
def test_sliced_prefill_refused_where_routing_can_drop(group, refused):
    """Slices route in other GShard groups, so they are the whole
    prefill only where no token is dropped.  At capacity factor 1 (4
    experts, top 2) a group of 22 tokens has capacity 12, and the whole
    batch's of 55 has 28: refused.  A group of 4 tokens or fewer keeps
    every token (capacity at least 4, at most the group): sliced."""
    from repro_torch.serving import ServeEngine

    b, s = 5, 11
    model, params = program(7, prefill_tokens=2 * s, capacity_factor=1.0,
                            moe_group_size=group)
    eng = ServeEngine(model, params, b, s + 2)
    if refused:
        with pytest.raises(ValueError, match="drops no token"):
            eng.generate({"tokens": tokens(7, b, s)}, 2)
    else:
        assert eng.generate({"tokens": tokens(7, b, s)}, 2).shape == (b, 2)


def _leaves(tree):
    leaves = []
    map_cache(tree, leaves.append)
    return leaves


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_multipliers_through_the_fields_match_the_rewritten_weights():
    lm = _load(os.path.join(REPO, "portbench", "reference", "lm.py"),
               "granite_moe_reference")
    from repro_torch.configs.granite_moe_1b_a400m import CONFIG as MOE

    conf = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=32,
                num_local_experts=4, num_experts_per_tok=2, vocab_size=256,
                initializer_range=0.02, rms_norm_eps=1e-6, rope_theta=1e4,
                embedding_multiplier=12.0, attention_multiplier=0.015625,
                residual_multiplier=0.22, logits_scaling=6.0)
    small = MOE.reduced(d_model=64, head_dim=16, d_ff=32, vocab_size=256,
                        d_expert=32, compute_dtype="float32",
                        capacity_factor=2.0)
    w = weights(lm.weight_specs(conf), 5)
    published = dataclasses.replace(
        small, **{k: conf[k] for k in ("embedding_multiplier",
                                        "attention_multiplier",
                                        "residual_multiplier",
                                        "logits_scaling")})
    toks = tokens(5, 2, 9)
    runs, losses = [], []
    for cfg, ws in ((published, w), (small, {k: v.clone()
                                             for k, v in w.items()})):
        if cfg is small:
            cfg = dataclasses.replace(
                cfg, norm_eps=lm.without_multipliers(ws, conf))
        model = build_model(cfg)
        params = port_params(model, ws)
        logits, cache = model.prefill(params, {"tokens": toks[:, :6]}, 9)
        steps = [logits]
        for j in range(6, 9):
            logits, cache = model.decode_step(params, toks[:, j:j + 1],
                                              cache, j)
            steps.append(logits)
        runs.append(torch.stack(steps, 1))
        with torch.no_grad():  # the training loss divides by logits_scaling
            losses.append(model.loss_fn(params, {
                "tokens": toks, "labels": tokens(6, 2, 9)})[0])
    torch.testing.assert_close(runs[0], runs[1], rtol=0,
                               atol=1e-5 * float(runs[1].abs().max()))
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0)
    # and both are the published model of the reference
    with lm.NoTF32():
        want = lm.logits(w, lm.hidden(w, toks, conf), conf)
    torch.testing.assert_close(runs[0], want[:, 5:], rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_a_traced_prefill_records_its_spans():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.serving import ServeEngine

    b, s = 4, 10
    model, params = program(2, prefill_tokens=2 * s)
    eng = ServeEngine(model, params, b, s + 3)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.generate({"tokens": tokens(2, b, s)}, 3)
    rec = spans.recorded()
    names = [x.name for x in rec.spans]
    by = {x.id: x for x in rec.spans}
    assert names.count("lm.prefill") == names.count("lm.decode") == 1
    assert names.count("lm.prefill_slice") == rec.counters[
        "lm.prefill_slices"] == 2
    # 9 Mamba layers and 10 MoE layers a slice, inside its prefill
    assert names.count("lm.ssd") == 18 and names.count("lm.moe") == 20
    for x in rec.spans:
        if x.name in ("lm.ssd", "lm.moe"):
            assert by[by[x.parent].parent].name == "lm.prefill"
    assert rec.counters["lm.decode_steps"] == 3
    top = next(x for x in rec.spans if x.name == "lm.prefill")
    assert top.attrs == {"rows": b, "length": s}


def test_the_two_references_compute_the_same_forward():
    bench = _load(os.path.join(REPO, "portbench", "reference",
                               "granite_hybrid.py"), "granite_hybrid_bench")
    assert bench.weight_specs(CONF) == ref.weight_specs(CONF)
    w = weights(ref.weight_specs(CONF), 9)
    toks = tokens(9, 2, 12)
    with ref.NoTF32():
        want = ref.logits(w, ref.hidden(w, toks, CONF), CONF)
        got = bench.logits(w, bench.hidden(w, toks, CONF), CONF)
        for operand in (ref.fp8, bench.fp8):
            assert torch.equal(
                ref.logits(w, ref.hidden(w, toks, CONF, operand), CONF,
                           operand),
                bench.logits(w, bench.hidden(w, toks, CONF, operand), CONF,
                             operand))
    assert torch.equal(got, want)


def test_the_published_config_builds_on_meta():
    params = build_model(CONFIG).abstract()
    n = sum(p.numel() for p in params.parameters())
    assert abs(n - 32.2e9) < 0.1e9, n
    assert all(p.device.type == "meta" for p in params.parameters())
