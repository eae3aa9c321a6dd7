"""CUDA graphs of the port on the card (`pytest -m gpu`; skips without one).

- A warm bucket of MSCServeEngine captures nothing, and its replays give
  the eager runner's (`build_msc_batched`) bits: masks, d, λ, counts.
- The extraction (the batched finalize), a replay of the engine's tail
  and of the LM decode step make no host sync
  (`torch.cuda.set_sync_debug_mode("error")`).
- After N replays a kernel's launch count has grown by N times the
  launches its capture recorded.
- MSCContinuousEngine captures 2 graphs per bucket cold and none warm,
  makes no host sync in a replay, launches `power_iter` 3 times per step
  replay and `abs_rowsum` 3 times per refill replay, and gives the bits
  of the same engine with its programs called eagerly on the card.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MSCConfig, ModeSchedule  # noqa: E402
from repro_torch.core.parallel import build_msc_batched  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import power_iter as kpi  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402
from repro_torch.serving import (MSCContinuousEngine,  # noqa: E402
                                 MSCServeEngine, ServeEngine)
from repro_torch.serving import graphs  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def no_host_sync():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _requests(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.normal(size=shape).astype(np.float32)
        l = [max(1, s // 10) for s in shape]
        x[:l[0], :l[1], :l[2]] += 60.0 / np.sqrt(np.prod(l))
        out.append(x)
    return out


def _eager(cfg, xs, b, bucket, device):
    batch = np.zeros((b,) + bucket, np.float32)
    dims = np.ones((b, 3), np.int32)
    for s, x in enumerate(xs):
        batch[s, :x.shape[0], :x.shape[1], :x.shape[2]] = x
        dims[s] = x.shape
    return build_msc_batched(cfg, device=device)(torch.from_numpy(batch),
                                                  dims)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [
    dict(use_kernels=True), dict(use_kernels=True, matrix_free=False),
    dict(precision="bf16_fp32", use_kernels=True), dict()],
    ids=["kernels", "gram_kernels", "bf16_kernels", "einsum"])
def test_warm_bucket_replays_the_eager_runners_bits(cuda_device, cfg_kw):
    cfg = MSCConfig(epsilon=3e-4, **cfg_kw)
    b = 2
    eng = MSCServeEngine(cfg, max_batch=b, device=cuda_device)
    cold = _requests([(40, 40, 40), (37, 33, 40)])
    eng.run(cold)
    assert eng.stats.compiles == eng.graphs == 9  # head, chunk, tail x 3
    warm = _requests([(38, 40, 35)], seed=1)  # one request and a filler
    before = eng.stats
    got = eng.run(warm)
    delta = eng.stats.delta(before)
    assert delta.compiles == 0 and delta.exec_cache_hits == 1
    want = _eager(cfg, warm, b, eng.bucket_of(warm[0].shape), cuda_device)
    for j in range(3):
        m = warm[0].shape[j]
        assert torch.equal(got[0][j].mask, want[j].mask[0, :m].cpu())
        assert torch.equal(got[0][j].d, want[j].d[0, :m].cpu())
        assert torch.equal(got[0][j].lambdas, want[j].lambdas[0, :m].cpu())
        assert got[0][j].n_iters == int(want[j].n_iters[0])
        assert got[0][j].power_iters_run == int(want[j].power_iters_run[0])
    eng.close()


@pytest.mark.gpu
def test_extraction_and_replays_make_no_host_sync(cuda_device):
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.normal(1.0, 0.3, (3, 200)).astype(np.float32))
    d[:, :20] += 5.0
    d = d.to(cuda_device)
    valid = torch.arange(200, device=cuda_device)[None] < torch.tensor(
        [[200], [150], [90]], device=cuda_device)
    iters = torch.full((3, 1), 12, dtype=torch.int32, device=cuda_device)
    sched = ModeSchedule(MSCConfig(epsilon=3e-4))
    with no_host_sync():
        res = sched.finalize_mode_batched(d, torch.ones_like(d), iters, valid)
        one = sched.finalize_mode(d[0], d[0], iters[0], valid[0], 200)
    assert torch.equal(res.mask[0], one.mask)

    # the engine's tail (λ, epilogue, extraction) replayed
    eng = MSCServeEngine(MSCConfig(epsilon=3e-4, use_kernels=True),
                         max_batch=2, device=cuda_device)
    eng.run(_requests([(40, 40, 40)]))
    (prog,) = eng._programs.values()
    n0 = kring.launches
    with no_host_sync():
        for j in range(3):
            prog.steps[j][2]()
    torch.cuda.synchronize()
    assert kring.launches - n0 == 3  # one abs_rowsum per tail
    eng.close()


@pytest.mark.gpu
def test_replays_count_their_captured_launches(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model

    cfg = get_config("whisper-tiny").reduced(attn_impl="pallas",
                                             compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch(cfg, 2, 8, kind="serve", device=cuda_device)
    engine = ServeEngine(model, params, 2, 24)  # room for 5 more steps
    n0 = kfa.launches
    toks = engine.generate(batch, 6)
    assert engine.captures == 1
    step = engine._decode
    assert step.launches == {kfa: cfg.n_layers}  # decode cross-attention
    # the encoder, the prefill's cross-attention and 6 decode steps
    assert kfa.launches - n0 == cfg.n_enc_layers + cfg.n_layers * 7
    n1 = kfa.launches
    with no_host_sync():
        for _ in range(5):
            step()
    torch.cuda.synchronize()
    assert kfa.launches - n1 == 5 * cfg.n_layers

    # the same tokens as an eager loop of decode_step
    logits, cache = model.prefill(params, batch, max_len=24)
    want = []
    for i in range(6):
        want.append(torch.argmax(logits, dim=-1)[:, None].to(torch.int32))
        logits, cache = model.decode_step(params, want[-1], cache, 8 + i)
    assert torch.equal(toks, torch.cat(want, dim=1))

    # the MSC gate chunk: one power_iter launch per replay
    eng = MSCServeEngine(MSCConfig(epsilon=3e-4, use_kernels=True),
                         max_batch=2, device=cuda_device)
    eng.run(_requests([(40, 40, 40)]))
    (prog,) = eng._programs.values()
    chunk = prog.steps[0][1]
    assert chunk.launches == {kpi: 1}
    n2 = kpi.launches
    for _ in range(4):
        chunk()
    assert kpi.launches - n2 == 4
    eng.close()


@contextlib.contextmanager
def no_sync_in_replays():
    """Every replay of a captured step runs under no_host_sync()."""
    call = graphs.Step.__call__

    def guarded(self):
        with no_host_sync():
            return call(self)

    graphs.Step.__call__ = guarded
    try:
        yield
    finally:
        graphs.Step.__call__ = call


@contextlib.contextmanager
def eager_steps():
    """Steps made meanwhile call their functions instead of capturing."""
    init = graphs.Step.__init__
    graphs.Step.__init__ = lambda self, fn, device, pool=None: init(
        self, fn, torch.device("cpu"))
    try:
        yield
    finally:
        graphs.Step.__init__ = init


def _skewed(n):
    """n planted requests over two buckets, every 4th near-noise."""
    shapes = [(40, 40, 40), (37, 33, 40), (21, 24, 18), (24, 20, 23)]
    out = []
    for i in range(n):
        (x,) = _requests([shapes[i % 4]], seed=i)
        if i % 4 == 0:  # a slow converger: the signal scaled far down
            x = 0.03 * x + np.random.default_rng(i).normal(
                size=x.shape).astype(np.float32)
        out.append(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [
    dict(use_kernels=True), dict(precision="bf16_fp32", use_kernels=True),
    dict()], ids=["kernels", "bf16_kernels", "einsum"])
def test_continuous_graphs_replay_the_eager_engines_bits(cuda_device,
                                                         cfg_kw):
    cfg = MSCConfig(epsilon=3e-4, **cfg_kw)
    xs = [torch.from_numpy(x).to(cuda_device) for x in _skewed(10)]
    eng = MSCContinuousEngine(cfg, slots=3, device=cuda_device)
    n_buckets = len({eng.bucket_of(x.shape) for x in xs})
    with no_sync_in_replays():
        cold = eng.run(xs)
    assert eng.stats.compiles == eng.graphs == 2 * n_buckets
    before = eng.stats
    kpi.launches = kring.launches = 0
    eng.placement, eng.refill_min_free = "stable", 2
    with no_sync_in_replays():
        warm = eng.run(xs[::-1])[::-1]
    delta = eng.stats.delta(before)
    assert delta.compiles == 0 and delta.refills and delta.chunk_steps
    if cfg.use_kernels:
        assert kpi.launches == 3 * delta.chunk_steps
        assert kring.launches == 3 * delta.refills
    with eager_steps():
        eager = MSCContinuousEngine(cfg, slots=3, device=cuda_device)
        want = eager.run(xs)
    assert eager.graphs == 0
    for got in (cold, warm):
        for g, w in zip(got, want):
            for j in range(3):
                assert torch.equal(g[j].mask, w[j].mask)
                assert torch.equal(g[j].d, w[j].d)
                assert torch.equal(g[j].lambdas, w[j].lambdas)
                assert g[j].power_iters_run == w[j].power_iters_run
    eng.close()
    eager.close()
