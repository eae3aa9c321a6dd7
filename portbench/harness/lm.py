"""Language-model cells: inputs, the generation window and the judge.

The mix's "driver" is "lm_generate": offline batch generation, a closed
loop of one client on the port's `ServeEngine`.  Order of a run (as
`runner.run_cell`'s): the weights made on the device from the seed
(`weights`, named and shaped by the configuration's reference),
rewritten without the published multipliers (`port_weights`) and
handed to the program; the engine built and warmed up on every prompt
length of the mix (one whole call at the longest, which captures the
decode step, then a one-token call at each other length); the window; the memory peak; the program's state freed;
the weights made again from the seed for the reference, which judges a
sample of the sequences; the comparison.

The traffic (`portbench/traffic/<mix>.json`):

  batch            sequences a call; every prompt of a call has the
                   call's length (the engine's static shape)
  prompt_lengths   the lengths cycled, in pairs of the i-th shortest and
                   the i-th longest; the seed permutes the pairs, and
                   each pair runs short then long.  An evenly spaced
                   list of even count gives every pair the same prompt
                   tokens, so every seed's window of whole pairs holds
                   the same work
  new_tokens       greedy tokens generated a sequence
  max_len          the engine's positions (the longest prompt plus
                   new_tokens at most)
  judge_per_call   sequences of each call the reference judges, drawn
                   from the seed

The window makes its calls a pair at a time until `seconds` have passed
and ends at the end of that pair: whole pairs, `seconds` and at most one
pair more.  Prompt ids are uniform over the vocabulary, drawn from the
seed and the call's index, so the judge makes the same prompts again.

The comparison (limits in `portbench/limits/<cell>.json`):

  missing    calls that returned nothing
  shape      sequences of the wrong length
  token_gap_mean  the gap at each judged position, (max of the
                  reference's logits − the reference's logit at the
                  program's token) / max |the reference's logits|,
                  averaged over the window's judged positions: 0 where
                  the program chose the reference's best token at every
                  position

Logits are compared, not tokens: with random weights the best logit
moves with rounding, and a token lost to a near tie is not a wrong one.
The mean and not the widest gap is held: in bf16 a few percent of
positions lose a near tie, and the widest of some thousands of such
losses swings from seed to seed, while the mean keeps a sound run far
below the controls (PERF.md).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import time
import types

import numpy as np
import torch

from costs import lm as costs
from harness import judge as judges
from harness import systems, trace
from harness.generate import child_seed
from harness.report import mark, measured, ranks_entry, result
from harness.trace import span

NAMES = ("missing", "shape", "token_gap_mean")


def reference_module(cell):
    """The configuration's plain reference, `portbench/reference/<name>.py`
    named by its "reference" key."""
    path = cell.root / "portbench" / "reference" / \
        f"{cell.config['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_{cell.config['reference']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def weights(seed: int, conf: dict, ref, device) -> dict:
    """The weights of `ref.weight_specs(conf)`, one draw of a generator on
    the device a name, in fp32."""
    gen = torch.Generator(device=device).manual_seed(child_seed(seed, 10))
    out = {}
    for name, (shape, init, std) in ref.weight_specs(conf).items():
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(std)
        out[name] = t.add_(1.0) if init == "one_plus" else t
    return out


def order(seed: int, lengths) -> list:
    """One cycle of prompt lengths as pairs: the i-th shortest with the
    i-th longest, short first, the pairs in an order drawn from the seed
    (a middle length of an odd list stands alone)."""
    ls = sorted(lengths)
    pairs = [(ls[i], ls[-1 - i]) if i != len(ls) - 1 - i else (ls[i],)
             for i in range((len(ls) + 1) // 2)]
    rng = np.random.default_rng(child_seed(seed, 1))
    return [pairs[i] for i in rng.permutation(len(pairs))]


def port_weights(seed: int, cell, device) -> tuple:
    """The program's weights of `seed` and the RMSNorm epsilon they take:
    `weights`, rewritten in place by the reference's
    `without_multipliers` as the same model without the published
    multipliers, since the port's model has none."""
    ref, conf = reference_module(cell), cell.config
    w = weights(seed, conf, ref, device)
    return w, ref.without_multipliers(w, conf)


def prompts(seed: int, call: int, length: int, tr: dict, vocab: int,
            device) -> torch.Tensor:
    """(batch, length) int64 prompt ids of call `call`."""
    gen = torch.Generator(device=device).manual_seed(
        child_seed(seed, 3, call))
    return torch.randint(0, vocab, (tr["batch"], length), generator=gen,
                         device=device)


@dataclasses.dataclass
class Call:
    index: int
    length: int
    tokens: object  # (batch, new_tokens) ids the program returned
    prefill_ms: float
    decode_ms: float


@dataclasses.dataclass
class Window:
    seconds: float
    calls: list
    attempted: int
    missing: int


def generate_window(engine, seed: int, tr: dict, vocab: int, cycle: list,
                    seconds: float, traced: bool, device) -> Window:
    """Calls of `engine.generate` one after another, a pair of `cycle` at
    a time, until `seconds` have passed; the window ends at the end of
    that pair."""
    calls = []
    t0 = time.perf_counter()
    for pair in itertools.cycle(cycle):
        for length in pair:
            i = len(calls)
            batch = {"tokens": prompts(seed, i, length, tr, vocab, device)}
            with span("portbench.generate", traced):
                out = engine.generate(batch, tr["new_tokens"])
            calls.append(Call(i, length, out, engine.timings["prefill_ms"],
                              engine.timings["decode_ms"]))
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    for c in calls:
        c.tokens = None if c.tokens is None else c.tokens.cpu()
    return Window(seconds=wall, calls=calls, attempted=len(calls),
                  missing=sum(c.tokens is None for c in calls))


def _warm_up(engine, seed, tr, vocab, cycle, device) -> None:
    """One whole call at the longest length (the decode step's capture),
    then one token at every other length of the mix."""
    lengths = sorted({x for pair in cycle for x in pair}, reverse=True)
    for j, length in enumerate(lengths):
        gen = torch.Generator(device=device).manual_seed(
            child_seed(seed, 5, length))
        toks = torch.randint(0, vocab, (tr["batch"], length), generator=gen,
                             device=device)
        engine.generate({"tokens": toks}, tr["new_tokens"] if j == 0 else 1)


def sample_rows(seed: int, call: int, tr: dict) -> list:
    """The rows of call `call` that the reference judges."""
    rng = np.random.default_rng(child_seed(seed, 4, call))
    k = min(tr["judge_per_call"], tr["batch"])
    return sorted(rng.choice(tr["batch"], size=k, replace=False).tolist())


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(max − logit at `chosen`) / max |logit| at each position.
    ref_logits (…, V) fp32, chosen (…) ids."""
    best = ref_logits.amax(dim=-1)
    at = torch.gather(ref_logits, -1, chosen.long()[..., None])[..., 0]
    return (best - at) / ref_logits.abs().amax(dim=-1).clamp_min(1e-30)


def judged_logits(w, ref, conf, seq: torch.Tensor, length: int, n: int,
                  operand=None) -> torch.Tensor:
    """Teacher-forced logits (rows, n, V) at the n positions that chose the
    generated tokens (length − 1 … length + n − 2) of sequences `seq`
    (rows, length + n): prompt and generated ids."""
    hid = ref.hidden(w, seq[:, :length + n - 1], conf, operand)
    return ref.logits(w, hid[:, length - 1:], conf, operand)


def judge(window: Window, w: dict, ref, conf: dict, tr: dict, seed: int,
          device, control=None) -> tuple:
    """(numbers, calls judged, calls of the wrong shape, every judged
    position's gap) of the window's calls against the reference.  With
    `control` (an operand rounding), the control's instead: at each
    judged position the token the rounded reference puts first, read on
    the fp32 reference's logits."""
    n = tr["new_tokens"]
    nums = dict.fromkeys(NAMES, 0.0)
    nums["missing"] = float(window.missing)
    judged, misshapen, every = 0, 0, []
    with ref.NoTF32():
        for c in window.calls:
            if c.tokens is None:
                continue
            if tuple(c.tokens.shape) != (tr["batch"], n):
                nums["shape"] += float(tr["batch"])
                misshapen += 1
                continue
            pick = sample_rows(seed, c.index, tr)
            p = prompts(seed, c.index, c.length, tr, conf["vocab_size"],
                        device)[pick]
            got = c.tokens[pick].to(device)
            seq = torch.cat([p, got.long()], dim=1)
            want = judged_logits(w, ref, conf, seq, c.length, n)
            if control is not None:
                got = judged_logits(w, ref, conf, seq, c.length, n,
                                    control).argmax(dim=-1)
            every.append(gaps(want, got).flatten().cpu())
            judged += 1
            del want
    every = torch.cat(every) if every else torch.zeros(0)
    if every.numel():
        nums["token_gap_mean"] = float(every.double().mean())
    return nums, judged, misshapen, every


def serve(cell, seed: int, seconds: float, traced: bool, dev,
          start_wall: float, program=None) -> tuple:
    """Set-up and the window of an LM run on `dev` (one device), the
    program's state freed after: (window, setup_s, memory peak, trace
    summary).  `program` overrides fields of the port's ModelConfig of
    the cell (a fault planted for a control, `readings`)."""
    tr, conf = cell.traffic, cell.config
    cuda = dev.type == "cuda"
    cycle = order(seed, tr["prompt_lengths"])
    vocab = conf["vocab_size"]
    w, eps = port_weights(seed, cell, dev)
    engine = systems.lm_engine(cell, w, tr["batch"], tr["max_len"],
                               {"norm_eps": eps, **(program or {})})
    del w
    if cuda:
        torch.cuda.synchronize(dev)
    mark("weights made", start_wall, 0)
    _warm_up(engine, seed, tr, vocab, cycle, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - start_wall
    mark("warmed up", start_wall, 0)

    with trace.profiled(traced) as prof:
        window = generate_window(engine, seed, tr, vocab, cycle, seconds,
                                 traced, dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    engine.close()
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return window, setup_s, peak, prof.summary


def check(cell, window: Window, seed: int, dev, control=None) -> tuple:
    """`judge` of a window against the reference on weights made again
    from the seed; with `control`, the control's."""
    ref = reference_module(cell)
    w = weights(seed, cell.config, ref, dev)
    out = judge(window, w, ref, cell.config, cell.traffic, seed, dev,
                control)
    del w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, dev,
             start_wall: float) -> dict:
    """The LM cell's whole run on `dev` (one device): the result line."""
    window, setup_s, peak, summary = serve(cell, seed, seconds, traced,
                                           dev, start_wall)
    nums, judged, misshapen, _ = check(cell, window, seed, dev)
    correct, checks = judges.verdict(nums, cell.limits)
    # the gap is the window's: where it fails, every judged call does
    gap = checks["token_gap_mean"]
    failed = window.missing + misshapen + judged * (
        gap["limit"] is None or gap["value"] > gap["limit"])
    rec = record(cell, window, summary, dev.type == "cuda")
    metrics = measured(cell, rec, end_to_end(window, cell.traffic, setup_s),
                       traced)
    if not traced:
        correct = correct and len(metrics) == len(cell.metrics(trace=False))
    return result(correct, window.attempted, failed, metrics, checks, dev,
                  [ranks_entry(peak, summary)], 1, summary, traced)


def spread(g) -> dict:
    """How the judged positions' gaps spread: their 99th percentile and
    widest, and the share of positions whose token is not the
    reference's best."""
    g = g.double()
    return {"p99": float(torch.quantile(g, 0.99)), "max": float(g.max()),
            "differ": float((g > 0).double().mean()), "n": int(g.numel())}


def readings(cell, seed: int, seconds: float, device) -> list:
    """The numbers that set an LM cell's limits, on one seed, in one
    process (`control.py`): the program serves a window (`seconds`) and
    is judged as a run judges it (`program`, a sound reading); the same
    sequences are judged by the control, the reference with every
    product's operands rounded to fp8 e4m3 (`reference/lm.py:fp8`, one
    precision below the configuration's bf16), whose best token at each
    judged position is read on the fp32 reference's logits (`fp8`); and
    the program serves a second window with a fault planted, each token
    routed to one expert fewer than the configuration's, over the same
    weights (`top_k_less_1`).  A sound limit lies above the program's
    numbers and below both controls'."""
    dev = torch.device(device)
    fault = {"experts_per_token": cell.config["num_experts_per_tok"] - 1}
    out = []
    for side, program in (("program", None), ("top_k_less_1", fault)):
        t = time.time()
        window = serve(cell, seed, seconds, False, dev, t, program)[0]
        nums, _, _, g = check(cell, window, seed, dev)
        out.append({"side": side, "seed": seed, "numbers": nums,
                    "spread": spread(g), "calls": window.attempted,
                    "window_s": window.seconds,
                    "seconds": time.time() - t})
        if program is None:
            t = time.time()
            nums, _, _, g = check(cell, window, seed, dev,
                                  control=reference_module(cell).fp8)
            out.append({"side": "fp8", "seed": seed, "numbers": nums,
                        "spread": spread(g), "seconds": time.time() - t})
    return out


def record(cell, window: Window, summary, cuda: bool):
    """What the per-layer readers read of an LM run."""
    tr = cell.traffic
    return types.SimpleNamespace(
        cell=cell, window=window, trace=summary, costs=costs, cuda=cuda,
        conf=cell.config,
        calls=[{"batch": tr["batch"], "length": c.length,
                "new_tokens": tr["new_tokens"], "prefill_ms": c.prefill_ms,
                "decode_ms": c.decode_ms} for c in window.calls
               if c.tokens is not None])


def end_to_end(window: Window, tr: dict, setup_s: float) -> dict:
    """The end-to-end metrics an LM window gives: `lm_tokens_per_s`, the
    generated tokens of the completed calls over the window."""
    done = sum(c.tokens is not None for c in window.calls)
    out = {"setup_s": setup_s}
    if done:
        out["lm_tokens_per_s"] = (done * tr["batch"] * tr["new_tokens"]
                                  / window.seconds)
    return out
