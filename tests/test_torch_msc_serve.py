"""The static `msc_serve` CLI and the engine's captured steps, on the CPU.

On the CPU the engine runs its per-bucket steps (head, gate chunk, tail)
eagerly: the code a card captures as CUDA graphs.  Held here:
- the CLI prints the reference's lines, and every flag of a later
  ROADMAP item raises naming that item (the continuous mode's own lines
  are held in `tests/test_torch_continuous.py`);
- on the reference's request stream (built by `repro.launch.msc_serve`
  and carried across as numpy arrays), the port's engine answers as the
  reference's engine does: masks and sweeps identical, d and λ within
  3e-5 of the largest reference entry, the same counters;
- the engine's steps give the bits of the eager runner
  `build_msc_batched` on the same microbatch, and a warm bucket's second
  batch of other requests answers as a fresh engine does.
"""
import contextlib
import dataclasses
import functools
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core.parallel import make_msc_mesh  # noqa: E402
from repro.launch import msc_serve as jserve  # noqa: E402
from repro.serving import MSCServeEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.parallel import build_msc_batched  # noqa: E402
from repro_torch.launch import msc_serve  # noqa: E402
from repro_torch.serving import MSCServeEngine  # noqa: E402

SIZES, N_REQ, B, TOL = (9, 14, 19), 7, 2, 3e-5


@functools.cache
def _stream():
    """The reference's stream (every 3rd request a slow converger)."""
    specs, tensors = jserve.build_request_stream(SIZES, N_REQ, seed=0,
                                                 slow_every=3)
    out = []
    for t in tensors:
        x = np.array(t)
        x.setflags(write=False)
        out.append(x)
    return tuple(out)


def _jcfg(**kw):
    return JConfig(epsilon=3e-4, **kw)


@functools.cache
def _reference(precision):
    eng = JEngine(make_msc_mesh("flat"), _jcfg(precision=precision),
                  max_batch=B)
    return eng.run([jax.numpy.asarray(x) for x in _stream()]), eng.stats


def _close(got, want):
    want = np.asarray(want, np.float64)
    err = (np.abs(np.asarray(got, np.float64) - want).max()
           / max(np.abs(want).max(), 1e-30))
    assert err <= TOL, err


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32"])
def test_engine_on_the_reference_stream(precision):
    ref, ref_stats = _reference(precision)
    cfg = bridge.config_from_fields(dataclasses.asdict(
        _jcfg(precision=precision)))
    eng = MSCServeEngine(cfg, max_batch=B, device="cpu")
    out = eng.run(list(_stream()))
    for i, (p, r) in enumerate(zip(out, ref)):
        for j in range(3):
            np.testing.assert_array_equal(p[j].mask.numpy(),
                                          np.asarray(r[j].mask),
                                          err_msg=f"req {i} mode {j}")
            assert p[j].power_iters_run == int(r[j].power_iters_run)
            assert p[j].n_iters == int(r[j].n_iters)
            if precision == "fp32":
                _close(p[j].d.numpy(), r[j].d)
                _close(p[j].lambdas.numpy(), r[j].lambdas)
    s = eng.stats
    assert (s.requests, s.dispatches, s.compiles, s.filler_slots) == (
        ref_stats.requests, ref_stats.dispatches, ref_stats.compiles,
        ref_stats.filler_slots)
    assert eng.graphs == 0  # the CPU captures nothing


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(use_kernels=True), dict(use_kernels=True, matrix_free=False),
    dict(precision="bf16_fp32", epilogue="ring"), dict(power_tol=0.0)],
    ids=["einsum", "kernels", "gram_kernels", "bf16_ring", "fixed_trip"])
def test_engine_steps_give_the_eager_runners_bits(cfg_kw):
    cfg = bridge.config_from_fields(dataclasses.asdict(_jcfg())).with_(
        **cfg_kw)
    xs = [x for x in _stream() if x.shape[0] in (9, 14)][:B]
    eng = MSCServeEngine(cfg, max_batch=B, device="cpu")
    bucket = eng.bucket_of(xs[0].shape)
    assert all(eng.bucket_of(x.shape) == bucket for x in xs)
    got = eng.run(list(xs))
    batch = np.zeros((B,) + bucket, np.float32)
    dims = np.ones((B, 3), np.int32)
    for s, x in enumerate(xs):
        batch[s, :x.shape[0], :x.shape[1], :x.shape[2]] = x
        dims[s] = x.shape
    want = build_msc_batched(cfg, device="cpu")(torch.from_numpy(batch),
                                                dims)
    for s, x in enumerate(xs):
        for j in range(3):
            m = x.shape[j]
            w = want[j]
            assert torch.equal(got[s][j].mask, w.mask[s, :m])
            assert torch.equal(got[s][j].d, w.d[s, :m])
            assert torch.equal(got[s][j].lambdas, w.lambdas[s, :m])
            assert got[s][j].n_iters == int(w.n_iters[s])
            assert got[s][j].power_iters_run == int(w.power_iters_run[s])


def test_warm_bucket_serves_other_requests_as_a_fresh_engine():
    """The static buffers are rewritten per dispatch: a warm bucket's
    second microbatch (other requests, one slot of filler) answers as a
    fresh engine answers it."""
    cfg = bridge.config_from_fields(dataclasses.asdict(_jcfg())).with_(
        use_kernels=True)
    first = [x for x in _stream() if x.shape[0] == 14]
    warm = MSCServeEngine(cfg, max_batch=B, device="cpu")
    warm.run(first[:B])
    second = [x[:13, :12, :11].copy() for x in first[1:2]]
    got = warm.run(second)
    want = MSCServeEngine(cfg, max_batch=B, device="cpu").run(second)
    assert warm.stats.compiles == 1 and warm.stats.exec_cache_hits == 1
    for j in range(3):
        assert torch.equal(got[0][j].mask, want[0][j].mask)
        assert torch.equal(got[0][j].d, want[0][j].d)
        assert got[0][j].power_iters_run == want[0][j].power_iters_run
    warm.close()
    assert warm.memory_reckoning() == (0, 0) and warm.graphs == 0


def test_cli_prints_the_reference_lines(capsys):
    res = msc_serve.run(msc_serve.parse_args(
        ["--device", "cpu", "--sizes", "9,14", "--requests", "5",
         "--max-batch", "2", "--slow-every", "4"]))
    out = capsys.readouterr().out
    assert "MSC serve: 5 requests over sizes [9, 14]" in out
    assert "buckets: [(16, 16, 16)]" in out
    for i in range(5):
        assert f"  req {i}: shape=" in out
    assert "stats: 6 dispatches, 1 compiles, 5 exec cache hits, " \
           "2 filler slots" in out
    assert "cold " in out and "warm " in out and "req/s" in out
    assert "looped (B=1) warm " in out and "batched speedup" in out
    assert res["stats_cold"].compiles == 1 and res["stats_warm"].compiles == 0
    # the non-slow requests recover the planted cluster
    assert [r for i, r in enumerate(res["recs"]) if i % 4] == [1.0] * 3
    res["engine"].close()


def test_request_stream_follows_the_reference_rule():
    specs, tensors = msc_serve.build_request_stream([9, 14], 5, seed=3,
                                                    slow_every=2)
    assert [s.shape[0] for s in specs] == [9, 14, 9, 14, 9]
    assert [s.gamma for s in specs] == [2.0, 40.0, 2.0, 40.0, 2.0]
    again = msc_serve.build_request_stream([9, 14], 5, seed=3,
                                           slow_every=2)[1]
    assert all(torch.equal(a, b) for a, b in zip(tensors, again))
    jspecs, _ = jserve.build_request_stream([9, 14], 5, seed=3,
                                            slow_every=2)
    assert [(s.shape, s.cluster_sizes, s.gamma) for s in specs] == [
        (s.shape, s.cluster_sizes, s.gamma) for s in jspecs]


@pytest.mark.parametrize("flag,item", [
    (["--mesh-shape", "4,2"], "item 9"),
    (["--epilogue", "auto"], "item 11"),
    (["--chunks-per-step", "auto"], "item 11"),
    (["--autotune"], "item 10"),
])
def test_later_item_flags_raise_naming_their_item(flag, item):
    if item == "item 9":
        # item 9 is closed: --mesh-shape serves on a mesh of ranks, and a
        # shape that one rank cannot fill raises the reference's error
        with pytest.raises(ValueError, match="8 devices but 1 are"):
            msc_serve.main(["--device", "cpu", *flag])
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        msc_serve.main(["--device", "cpu", *flag])


# the tier flags' runs: the reference's small stream, every request of
# one bucket, through 2 slots
TIER_ARGV = ["--sizes", "9,14", "--requests", "6", "--max-batch", "2",
             "--slow-every", "3", "--no-loop-compare"]
# the continuous section's lines, by their start
TIER_LINES = ("  priority mix:", "streamed ", "  occupancy ", "  scheduler:",
              "  fault tolerance:", "  result cache persisted:",
              "result cache: reloaded", "restored from ")


def _templates(text, dirs=()):
    """The continuous section's lines with every number made '#' and
    every directory '<dir>'."""
    out = set()
    for line in text.splitlines():
        if line.startswith(TIER_LINES):
            for d in dirs:
                line = line.replace(str(d), "<dir>")
            line = re.sub(r"\d+(\.\d+)?", "#", line)
            out.add(re.sub(r"\{#: #(, #: #)*\}", "{#: #}", line))
    return out


@pytest.fixture(scope="module")
def reference_tier_lines(tmp_path_factory):
    """The reference CLI's continuous lines with every tier flag, then
    with --restore from its checkpoint and the cache it persisted."""
    tmp = tmp_path_factory.mktemp("ref_tiers")
    ck, cache = tmp / "ck", tmp / "cache"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main(TIER_ARGV + [
            "--continuous", "--priority-mix", "0:1.0,1:0.5",
            "--slo-chunks", "64", "--deadline-chunks", "96",
            "--bucket-policy", "all", "--checkpoint-dir", str(ck),
            "--ckpt-every", "2", "--cache-dir", str(cache),
            "--cache-max-bytes", "1048576", "--warm-start"])
        jserve.main(TIER_ARGV + ["--restore", str(ck), "--cache-dir",
                                 str(cache)])
    return _templates(buf.getvalue(), (ck, cache))


def _check_priority_mix(res, out, tmp):
    assert "  priority mix: {0: 0.5, 1: 1.5} arrivals/tick per class" in out
    assert len(res["continuous"]["results"]) == 6


def _check_one_class(res, out, tmp):
    assert "  priority mix: {0: 1.0} arrivals/tick per class" in out
    assert res["continuous"]["engine"].stats.preemptions == 0


def _check_no_preempt(res, out, tmp):
    eng = res["continuous"]["engine"]
    assert not eng.preempt and eng.stats.preemptions == 0
    assert len(res["continuous"]["results"]) == 6


def _check_bucket_policy(policy):
    def check(res, out, tmp):
        eng = res["continuous"]["engine"]
        assert eng.bucket_policy == policy and len(res["buckets"]) == 2
        for i, r in res["continuous"]["results"].items():  # as static
            for j in range(3):
                assert torch.equal(r[j].mask, res["results"][i][j].mask)
    return check


def _check_slo(res, out, tmp):
    cont = res["continuous"]
    s = cont["engine"].stats
    assert s.slo_sheds == cont["shed"] > 0 and s.shed_requests == s.slo_sheds
    assert len(cont["results"]) == 6 - cont["shed"]


def _check_deadline(res, out, tmp):
    assert res["continuous"]["engine"].stats.deadline_misses > 0


def _check_warm_start(res, out, tmp):
    cont = res["continuous"]
    s = cont["engine"].stats
    assert cont["cache"] is not None and cont["cache"].persist_dir is None
    # the warm-up served one request; the stream's repeat of it hits
    assert s.cache_hits >= 1 and s.cache_hits + s.cache_misses == 7
    assert "result cache persisted" not in out


def _check_checkpoints(every):
    def check(res, out, tmp):
        s = res["continuous"]["engine"].stats
        steps = [n for n in os.listdir(tmp / "ck") if n.startswith("step_")]
        assert s.checkpoints_written >= (2 if every == 1 else 1)
        assert 0 < len(steps) <= 3  # keep-last-3
        assert s.checkpoints_written * every <= s.chunk_steps
    return check


def _check_restore(res, out, tmp):
    assert f"restored from {tmp / 'ck'} onto mesh {{'slice': 1, 'inner': 1}}; " \
           f"drained " in out
    s = res["continuous"]["engine"].stats
    assert s.restores == 1 and s.checkpoints_written >= 1


def _check_cache_dir(res, out, tmp):
    assert f"  result cache persisted: " in out and str(tmp / "cc") in out
    assert "result cache: reloaded " in out  # the second run's reload
    assert res["continuous"]["engine"].stats.cache_hits >= 6


def _check_cache_max_bytes(res, out, tmp):
    cache = res["continuous"]["cache"]
    assert cache.max_bytes == 1024 and len(cache) == 1 and cache.evicted > 0


# name: (argv after TIER_ARGV, runs before the checked one, check)
TIER_CASES = {
    "priority_mix": (["--continuous", "--priority-mix", "0:0.5,1:1.5"], 0,
                     _check_priority_mix),
    "priority_mix_one_class": (["--continuous", "--priority-mix", "0:1.0"],
                               0, _check_one_class),
    "no_preempt": (["--continuous", "--no-preempt", "--priority-mix",
                    "0:1.0,1:1.0"], 0, _check_no_preempt),
    "bucket_policy_all": (["--continuous", "--bucket-policy", "all",
                           "--sizes", "9,21"], 0,
                          _check_bucket_policy("all")),
    "slo_chunks": (["--continuous", "--slo-chunks", "0"], 0, _check_slo),
    "deadline_chunks": (["--continuous", "--deadline-chunks", "1"], 0,
                        _check_deadline),
    "warm_start": (["--continuous", "--warm-start"], 0, _check_warm_start),
    "warm_start_persisted": (["--warm-start", "--continuous", "--cache-dir",
                              "{tmp}/cc"], 1, _check_cache_dir),
    "checkpoint_dir": (["--continuous", "--checkpoint-dir", "{tmp}/ck"], 0,
                       _check_checkpoints(8)),
    "ckpt_every": (["--continuous", "--checkpoint-dir", "{tmp}/ck",
                    "--ckpt-every", "1"], 0, _check_checkpoints(1)),
    "restore": (["--restore", "{tmp}/ck", "--ckpt-every", "1"], 0,
                _check_restore),
    "cache_dir": (["--continuous", "--cache-dir", "{tmp}/cc"], 1,
                  _check_cache_dir),
    "cache_max_bytes": (["--continuous", "--cache-dir", "{tmp}/cc",
                         "--cache-max-bytes", "1024"], 0,
                        _check_cache_max_bytes),
    "no_preempt_alone": (["--continuous", "--no-preempt"], 0,
                         _check_no_preempt),
    "bucket_policy_weighted": (["--continuous", "--bucket-policy",
                                "weighted", "--sizes", "9,21"], 0,
                               _check_bucket_policy("weighted")),
}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tier_flags_serve_and_print_the_reference_lines(
        case, tmp_path, capsys, reference_tier_lines):
    """Each tier flag serves on the CPU (a checkpoint for --restore made
    by a run with --checkpoint-dir first), prints only lines the
    reference's CLI prints (numbers and directories aside), and moves
    the counters it should."""
    argv, before, check = TIER_CASES[case]
    argv = [a.format(tmp=tmp_path) for a in argv]
    if case == "restore":
        msc_serve.main(["--device", "cpu", *TIER_ARGV, "--continuous",
                        "--checkpoint-dir", str(tmp_path / "ck")])
    for _ in range(before):
        msc_serve.main(["--device", "cpu", *TIER_ARGV, *argv])
    capsys.readouterr()
    res = msc_serve.run(msc_serve.parse_args(["--device", "cpu", *TIER_ARGV,
                                              *argv]))
    out = capsys.readouterr().out
    try:
        got = _templates(out, (tmp_path / "ck", tmp_path / "cc"))
        assert got and got <= reference_tier_lines, got - reference_tier_lines
        check(res, out, tmp_path)
    finally:
        res["engine"].close()
        res["continuous"]["engine"].close()


def test_cli_defaults_are_the_references_and_cuda():
    args = msc_serve.parse_args([])
    assert (args.sizes, args.requests, args.max_batch, args.bucket_quantum,
            args.epilogue, args.precision, args.power_tol, args.device) == (
        "16,21,33", 9, 4, 8, "allgather", "fp32", 1e-2, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            msc_serve.run(args)
