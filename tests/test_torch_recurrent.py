"""The port's Mamba-2 SSD and RG-LRU blocks and the archs built on them
(mamba2-2.7b, recurrentgemma-2b) against the reference on the CPU.

The blocks, in fp32 on the same weights and input, within 1e-5 of the
largest |output|: `ssd_train` (the chunked SSD, several chunks and a
shorter last one) and `rglru_block` without a cache (the port's log-depth
scan against `jax.lax.associative_scan`); `ssd_decode` and `rglru_block`
with a cache (the step loops) over a 5-token prefill from a zero cache,
then one decode step; after each, every cache leaf is fp32, as the
reference keeps it, and within 1e-5 of the reference's.

The whole model: weights from the reference's `Model.init` carried
across by `bridge.lm_params_from_numpy`, `scan_layers=True`
(recurrentgemma with 4 layers: one scanned (rglru, rglru, local)
super-block and a tail of one rglru layer); prefill and per-step logits
(both fed the reference's greedy tokens) within 1e-4 of max |logit| in
fp32 and 2e-2 in bf16, the cache's SSM and RG-LRU states fp32, and the
greedy tokens of the port's `ServeEngine` identical to the reference's
engine in fp32.  Then the CLI on the CPU.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import (lm_config_from_fields,  # noqa: E402
                                lm_params_from_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine, _leaves  # noqa: E402

PROMPT, GEN = 12, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's LM modules (JAX imported here, not at module
    level)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs.inputs import make_batch
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model, rglru, ssm
    from repro.serving.engine import ServeEngine as JServe

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, make_batch=make_batch,
        mesh=make_local_mesh, build_model=build_model, rglru=rglru, ssm=ssm,
        ServeEngine=JServe)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _block(jx, arch, defs_fn, seed):
    """A reduced fp32 config of `arch` in both packages and the same
    random block weights as a jnp dict and a port ParamTree."""
    jc = jx.configs.get_config(arch).reduced(compute_dtype="float32")
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    rng = np.random.default_rng(seed)
    arrays = {}

    def leaf(d, path):
        a = (0.3 * rng.normal(size=d.shape)).astype(np.float32)
        arrays[path[-1]] = a
        return torch.from_numpy(a.copy())

    p = TP.build(defs_fn(tc), leaf)
    return jc, tc, p, jx.jax.tree.map(jx.jnp.asarray, arrays), rng


def _cache_pair(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        _close(g.numpy(), w, 1e-5)


# ----------------------------------------------------------------- blocks ----
def test_ssd_train_matches_the_reference(jx):
    jc, tc, p, jp, rng = _block(jx, "mamba2-2.7b", TS.ssm_defs, 0)
    # 40 tokens in chunks of 16: three chunks, the last one padded
    x = rng.normal(size=(2, 40, jc.d_model)).astype(np.float32)
    want = jx.jax.jit(jx.ssm.ssd_train, static_argnums=2)(
        jp, jx.jnp.asarray(x), jc)
    _close(TS.ssd_train(p, _t(x), tc).numpy(), want, 1e-5)


def test_ssd_decode_and_its_cache_match_the_reference(jx):
    jc, tc, p, jp, rng = _block(jx, "mamba2-2.7b", TS.ssm_defs, 1)
    shapes = TS.ssm_cache_shape(tc, 2)
    assert shapes == jx.ssm.ssm_cache_shape(jc, 2)
    cache = tuple(torch.zeros(s) for s in shapes)
    jcache = tuple(jx.jnp.zeros(s, jx.jnp.float32) for s in shapes)
    decode = jx.jax.jit(jx.ssm.ssd_decode, static_argnums=3)
    for s in (5, 1):  # a prefill from the zero cache, then a decode step
        x = rng.normal(size=(2, s, jc.d_model)).astype(np.float32)
        bufs = cache
        y, cache = TS.ssd_decode(p, _t(x), cache, tc)
        jy, jcache = decode(jp, jx.jnp.asarray(x), jcache, jc)
        assert all(a is b for a, b in zip(cache, bufs))  # in place
        _close(y.numpy(), jy, 1e-5)
        _cache_pair(cache, [np.asarray(a) for a in jcache])


@pytest.mark.parametrize("s", [1, 7, 40], ids=["one", "odd", "several"])
def test_rglru_scan_matches_the_reference(jx, s):
    jc, tc, p, jp, rng = _block(jx, "recurrentgemma-2b", TR.rglru_defs, 2)
    x = rng.normal(size=(2, s, jc.d_model)).astype(np.float32)
    y, cache = TR.rglru_block(p, _t(x), tc)
    jy, _ = jx.jax.jit(jx.rglru.rglru_block, static_argnums=2)(
        jp, jx.jnp.asarray(x), jc)
    assert cache is None
    _close(y.numpy(), jy, 1e-5)


def test_rglru_step_loop_and_its_cache_match_the_reference(jx):
    jc, tc, p, jp, rng = _block(jx, "recurrentgemma-2b", TR.rglru_defs, 3)
    shapes = TR.rglru_cache_shape(tc, 2)
    assert shapes == jx.rglru.rglru_cache_shape(jc, 2)
    cache = tuple(torch.zeros(s) for s in shapes)
    jcache = tuple(jx.jnp.zeros(s, jx.jnp.float32) for s in shapes)
    block = jx.jax.jit(jx.rglru.rglru_block, static_argnums=2)
    xs = []
    for s in (5, 1):
        x = rng.normal(size=(2, s, jc.d_model)).astype(np.float32)
        xs.append(x)
        bufs = cache
        y, cache = TR.rglru_block(p, _t(x), tc, cache)
        jy, jcache = block(jp, jx.jnp.asarray(x), jc, jcache)
        assert all(a is b for a, b in zip(cache, bufs))
        _close(y.numpy(), jy, 1e-5)
        _cache_pair(cache, [np.asarray(a) for a in jcache])
    # the step loop and the log-depth scan: one function
    whole, _ = TR.rglru_block(p, _t(np.concatenate(xs, axis=1)), tc)
    _close(y.numpy(), whole[:, -1:].numpy(), 1e-5)


# ------------------------------------------------------------------ model ----
N_LAYERS = {"mamba2-2.7b": 2, "recurrentgemma-2b": 4}


def _models(jx, arch, dtype):
    """Both packages' reduced models on the reference's weights, a prompt
    batch and the reference's jitted prefill and decode steps."""
    jc = jx.configs.get_config(arch).reduced(
        compute_dtype=dtype, scan_layers=True, n_layers=N_LAYERS[arch])
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    jm, tm = jx.build_model(jc), Model(tc)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jx.jax.tree.map(np.asarray, jp))
    batch = jx.make_batch(jc, 2, PROMPT, seed=3, kind="serve")
    tb = {k: _t(v) for k, v in batch.items()}
    return types.SimpleNamespace(
        jm=jm, tm=tm, jp=jp, tp=tp, batch=batch, tb=tb, jc=jc, tc=tc,
        prefill=jx.jax.jit(jm.prefill, static_argnames="max_len"),
        decode=jx.jax.jit(jm.decode_step))


@pytest.fixture(scope="module")
def models(jx):
    """`_models` made once per arch and dtype for this module's tests."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            made[arch, dtype] = _models(jx, arch, dtype)
        return made[arch, dtype]

    return get


def _port_states(tcache, key):
    """The port's SSM ("ssm") or RG-LRU ("rnn") state leaves, super-block
    by super-block, then the tail."""
    blocks = [b for sb in tcache.get("layers", []) for b in sb.values()]
    blocks += list(tcache.get("tail", ()))
    return [t for b in blocks if key in b for t in b[key]]


def _ref_states(jcache, key, n):
    """The reference's in the same order: the leaves of its n scanned
    super-blocks carry a leading layer dim."""
    sb = jcache.get("layers", {})
    out = [np.asarray(leaf)[i] for i in range(n) for blk in sb.values()
           if key in blk for leaf in blk[key]]
    out += [np.asarray(leaf) for blk in jcache.get("tail", ())
            if key in blk for leaf in blk[key]]
    return out


def _hold_states(tcache, key, jcache=None):
    """Every SSM / RG-LRU state of the port's cache is fp32 (and with the
    reference's cache, within 1e-4 of its state)."""
    got = _port_states(tcache, key)
    assert got and all(t.dtype == torch.float32 for t in got)
    if jcache is not None:
        want = _ref_states(jcache, key, len(tcache.get("layers", [])))
        assert len(want) == len(got)
        for t, w in zip(got, want):
            _close(t.numpy(), w, 1e-4)


def _teacher_forced(m, toks=None, on_prefill=None):
    """The reference's logits (its jitted steps) and the port's, both fed
    `toks` (B, GEN) or else the reference's greedy tokens; calls
    on_prefill(reference cache, port cache) after the prefill.  Returns
    (reference logits, port logits, tokens, caches)."""
    import jax.numpy as jnp

    jl, jcache = m.prefill(m.jp, m.batch, max_len=PROMPT + GEN)
    tl, tcache = m.tm.prefill(m.tp, m.tb, max_len=PROMPT + GEN)
    if on_prefill is not None:
        on_prefill(jcache, tcache)
    js, ts, fed = [np.asarray(jl)], [tl.numpy()], []
    for i in range(GEN):
        tok = (jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
               if toks is None else jnp.asarray(toks[:, i:i + 1]))
        fed.append(np.asarray(tok))
        jl, jcache = m.decode(m.jp, tok, jcache, jnp.int32(PROMPT + i))
        tl, tcache = m.tm.decode_step(m.tp, _t(tok), tcache, PROMPT + i)
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
    return js, ts, np.concatenate(fed, axis=1), (jcache, tcache)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_fp32_prefill_decode_logits_and_states_match_the_reference(models,
                                                                   arch):
    m = models(arch, "float32")
    key = "ssm" if arch.startswith("mamba") else "rnn"
    if arch.startswith("recurrent"):
        assert len(m.tp["layers"]) == 1 and len(m.tp["tail"]) == 1
    js, ts, _, (jcache, tcache) = _teacher_forced(
        m, on_prefill=lambda jc_, tc_: _hold_states(tc_, key, jc_))
    for got, want in zip(ts, js):
        _close(got, want, 1e-4)
    _hold_states(tcache, key, jcache)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_bf16_logits_within_the_references_own_rounding(models, arch):
    """bf16 logits within 2e-2 of max |logit| of the reference's, or within
    the reference's own bf16-to-fp32 distance at that step where that is
    larger (both bf16 runs round at different points; recurrentgemma's
    reference lies up to 4.5e-2 from its own fp32 logits).  All three
    runs are fed the reference's bf16 greedy tokens."""
    mb = models(arch, "bfloat16")
    js, ts, toks, (_, tcache) = _teacher_forced(mb)
    key = "ssm" if arch.startswith("mamba") else "rnn"
    _hold_states(tcache, key)
    jf, _, _, _ = _teacher_forced(models(arch, "float32"), toks)
    for i, (got, want, ref32) in enumerate(zip(ts, js, jf)):
        assert np.isfinite(got).all()
        bound = max(2e-2, _rel(want, ref32))
        assert _rel(got, want) <= bound, (i, _rel(got, want), bound)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_generate_tokens_equal_the_reference_in_fp32(jx, models, arch):
    m = models(arch, "float32")
    max_len = PROMPT + GEN
    want = jx.ServeEngine(m.jm, jx.mesh(1), m.jp, 2, max_len).generate(
        m.batch, GEN)
    engine = ServeEngine(m.tm, m.tp, 2, max_len)
    got = engine.generate(m.tb, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the engine's buffers keep each leaf's dtype
    assert {t.dtype for t in _leaves(engine._cache)} == {torch.float32}


def test_cli_serves_mamba2_on_cpu(capsys):
    assert tserve.main(["--arch", "mamba2-2.7b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=mamba2-2.7b-smoke" in out
    assert "generated shape=(2, 3)" in out and "decode_ms_per_token=" in out
