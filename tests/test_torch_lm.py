"""LM serving parity: the port's configs, parameters, layers, models,
engine and CLI against the reference on the CPU.

Inputs come from numpy seeds or the reference's `make_batch`; weights are
the reference's `Model.init`, carried across by
`bridge.lm_params_from_numpy`.  Where the reference reaches its Pallas
flash kernel (`attn_impl="pallas"`) it runs in interpret mode, and the
port runs the kernel's plain version.

Tolerances: 1e-5 of the largest |output| for one fp32 layer and 1e-4 of
max |logit| for a whole fp32 model (sums in another order, carried
through a few layers); 2e-2 of max |logit| in bf16 (an activation on the
other side of a bf16 rounding boundary moves by 2^-8 and later layers
carry it on).  Greedy tokens must be identical in fp32.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (lm_config_from_fields,  # noqa: E402
                                lm_params_from_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import count_params, model_defs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT, GEN = 12, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's LM modules (JAX imported here, not at module
    level)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs.inputs import make_batch
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model, layers, params, transformer
    from repro.serving.engine import ServeEngine as JServe

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, make_batch=make_batch,
        mesh=make_local_mesh, build_model=build_model, layers=layers,
        params=params, transformer=transformer, ServeEngine=JServe)


def _np(tree, jx):
    return jx.jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ------------------------------------------------------ configs, params ----
# the port's own ModelConfig fields (GraniteMoe multipliers, NoPE, the
# engine's prefill slices), at the defaults that are the reference's
# model
PORT_ONLY = {"use_rope": True,
             "embedding_multiplier": 1.0, "attention_multiplier": 0.0,
             "residual_multiplier": 1.0, "logits_scaling": 1.0,
             "prefill_tokens": 0}


def _reference_fields(cfg) -> dict:
    """`dataclasses.asdict(cfg)` without the port's own fields, which must
    hold their defaults."""
    d = dataclasses.asdict(cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d


@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_config_equals_the_reference_field_by_field(jx, name):
    jc, tc = jx.configs.get_config(name), tconfigs.get_config(name)
    assert _reference_fields(tc) == dataclasses.asdict(jc)
    assert str(tc.cdtype).split(".")[-1] == jc.cdtype.name
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.is_encdec == jc.is_encdec
    assert _reference_fields(tc.reduced()) == \
        dataclasses.asdict(jc.reduced())
    assert lm_config_from_fields(dataclasses.asdict(jc)) == tc
    for alias, key in tconfigs.ALIASES.items():
        assert tconfigs.get_config(alias) is tconfigs.get_config(key)


@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_count_params_agrees_or_the_family_raises(jx, name):
    """Every family is built (MoE, SSM and hybrid since they were
    ported): the port's parameter count is the reference's."""
    jc, tc = jx.configs.get_config(name), tconfigs.get_config(name)
    want = jx.params.count_params(jx.transformer.model_defs(jc))
    assert count_params(model_defs(tc)) == want


@pytest.mark.parametrize("arch,kind", [("whisper-tiny", "serve"),
                                       ("internvl2-26b", "train")])
def test_make_batch_is_deterministic_with_the_reference_shapes(jx, arch,
                                                               kind):
    from repro_torch.configs.inputs import make_batch

    tc = tconfigs.get_config(arch).reduced()
    want = jx.make_batch(jx.configs.get_config(arch).reduced(), 2, 8,
                         kind=kind)
    got = make_batch(tc, 2, 8, seed=1, kind=kind, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name
        assert torch.equal(v, make_batch(tc, 2, 8, seed=1, kind=kind,
                                         device="cpu")[k])
    assert 0 <= int(got["tokens"].min()) and \
        int(got["tokens"].max()) < tc.vocab_size


def test_lm_config_from_fields_rejects_unknown_fields():
    fields = dataclasses.asdict(tconfigs.get_config("whisper-tiny"))
    with pytest.raises(ValueError, match="bogus"):
        lm_config_from_fields({**fields, "bogus": 1})


def test_params_carry_across_unstacked(jx):
    jc = jx.configs.get_config("whisper-tiny").reduced(scan_layers=True)
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    jp = _np(jx.build_model(jc).init(jx.jax.random.PRNGKey(1)), jx)
    tp = lm_params_from_numpy(tc, jp)
    assert isinstance(tp["layers"], torch.nn.ModuleList)
    assert len(tp["layers"]) == jc.n_layers
    assert len(tp["enc_layers"]) == jc.n_enc_layers
    for i in range(jc.n_layers):
        np.testing.assert_array_equal(
            tp["layers"][i]["k0"]["xattn"]["wq"].numpy(),
            jp["layers"]["k0"]["xattn"]["wq"][i])
    np.testing.assert_array_equal(tp["enc_layers"][1]["mlp"]["w3"].numpy(),
                                  jp["enc_layers"]["mlp"]["w3"][1])
    assert not any(p.requires_grad for p in tp.parameters())
    assert sum(p.numel() for p in tp.parameters()) == \
        count_params(model_defs(tc))
    # the port's own init draws every parameter, with the defs' shapes
    own = Model(tc).init(torch.Generator().manual_seed(0))
    assert [(n, p.shape) for n, p in own.named_parameters()] == \
        [(n, p.shape) for n, p in tp.named_parameters()]


# ----------------------------------------------------------------- layers ----
def _tree(defs, rng):
    """The same random values as a numpy dict and a port ParamTree."""
    def draw(d):
        return (0.2 * rng.normal(size=d.shape)).astype(np.float32)

    arrays = {}

    def leaf(d, path):
        a = draw(d)
        node = arrays
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
        return torch.from_numpy(a.copy())

    return arrays, TP.build(defs, leaf)


def _jtree(jx, arrays):
    return jx.jax.tree.map(jx.jnp.asarray, arrays)


@pytest.fixture(scope="module")
def small(jx):
    """A reduced gemma2 config in fp32 (GQA, softcap, local window) and a
    reduced qwen1.5 one (qkv bias, padded heads)."""
    g = jx.configs.get_config("gemma2-27b").reduced(
        compute_dtype="float32", local_window=8, attn_chunk=8)
    q = jx.configs.get_config("qwen1.5-0.5b").reduced(
        compute_dtype="float32", head_pad=6, n_kv_heads=2, attn_chunk=8)
    return {"gemma2": g, "qwen1.5": q}


def test_rmsnorm_rope_and_mlp_match_the_reference(jx, small):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6).numpy(),
           jx.layers.rmsnorm({"scale": jx.jnp.asarray(scale)},
                             jx.jnp.asarray(x), 1e-6), 1e-5)
    h = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    for pos in (np.arange(9) + 5, np.stack([np.arange(9), np.arange(9) + 3])):
        _close(TL.rope(_t(h), _t(pos), 1e4).numpy(),
               jx.layers.rope(jx.jnp.asarray(h), jx.jnp.asarray(pos), 1e4),
               1e-5)
    for act in ("gelu", "silu"):
        cfg = dataclasses.replace(small["qwen1.5"], act=act)
        tcfg = lm_config_from_fields(dataclasses.asdict(cfg))
        arrays, p = _tree(TL.mlp_defs(tcfg), rng)
        _close(TL.mlp(p, _t(x), tcfg).numpy(),
               jx.layers.mlp(_jtree(jx, arrays), jx.jnp.asarray(x), cfg),
               1e-5)


def _attn_pair(jx, jcfg, rng, **kw):
    """One attention call in both packages on the same weights and input;
    kv_cache, kv_source and static_kv are given as numpy."""
    tcfg = lm_config_from_fields(dataclasses.asdict(jcfg))
    arrays, p = _tree(TL.attention_defs(tcfg), rng)
    x = kw.pop("x")
    tkw, jkw = dict(kw), dict(kw)
    for key in ("kv_cache", "static_kv"):
        if key in kw:
            tkw[key] = tuple(_t(a) for a in kw[key])
            jkw[key] = tuple(jx.jnp.asarray(a) for a in kw[key])
    if "kv_source" in kw:
        tkw["kv_source"] = _t(kw["kv_source"])
        jkw["kv_source"] = jx.jnp.asarray(kw["kv_source"])
    if "cache_len" in kw:
        jkw["cache_len"] = jx.jnp.int32(kw["cache_len"])
        jkw["pos_offset"] = jkw["cache_len"]
        tkw["pos_offset"] = kw["cache_len"]
    ty, tc = TL.attention(p, _t(x), tcfg, **tkw)
    jy, jc = jx.layers.attention(_jtree(jx, arrays), jx.jnp.asarray(x), jcfg,
                                 **jkw)
    _close(ty.numpy(), jy, 1e-5)
    if jc is not None:
        for a, b in zip(tc, jc):
            _close(a.numpy(), b, 1e-5)
    return ty, tc


@pytest.mark.parametrize("impl", ["full", "chunked", "pallas"])
@pytest.mark.parametrize("model", ["gemma2", "qwen1.5"])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_without_cache_matches_the_reference(jx, small, impl,
                                                       model, kind):
    cfg = dataclasses.replace(small[model], attn_impl=impl)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 20, 128)).astype(np.float32)
    _attn_pair(jx, cfg, rng, x=x, kind=kind)


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("s", [5, 1], ids=["prefill", "decode"])
def test_attention_with_cache_matches_the_reference(jx, small, impl, s):
    cfg = dataclasses.replace(small["qwen1.5"], attn_impl=impl)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, 128)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
              for _ in range(2))
    _attn_pair(jx, cfg, rng, x=x, kind="attn", kv_cache=(ck, cv),
               cache_len=11)


@pytest.mark.parametrize("s,cache_len", [(1, 5), (1, 13), (12, 0), (3, 6)],
                         ids=["decode_filling", "decode_wrapped",
                              "prefill_longer_than_ring", "prefill_wraps"])
def test_attention_ring_buffer_matches_the_reference(jx, small, s,
                                                     cache_len):
    cfg = dataclasses.replace(small["gemma2"], attn_impl="chunked")
    w = cfg.local_window
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, s, 128)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, w, 2, 32)).astype(np.float32)
              for _ in range(2))
    _attn_pair(jx, cfg, rng, x=x, kind="local", kv_cache=(ck, cv),
               cache_len=cache_len)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_cross_attention_matches_the_reference(jx, small, impl):
    cfg = dataclasses.replace(small["qwen1.5"], attn_impl=impl, head_pad=0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    enc = rng.normal(size=(2, 17, 128)).astype(np.float32)
    _, kv = _attn_pair(jx, cfg, rng, x=x, kv_source=enc, causal=False)
    static = tuple(np.asarray(a) for a in kv)
    _attn_pair(jx, cfg, np.random.default_rng(4), x=x[:, :1],
               static_kv=static, causal=False)


# ------------------------------------------------------------------ model ----
def _models(jx, arch, dtype, impl, **over):
    jc = jx.configs.get_config(arch).reduced(compute_dtype=dtype,
                                             attn_impl=impl, **over)
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    jm, tm = jx.build_model(jc), Model(tc)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, _np(jp, jx))
    batch = jx.make_batch(jc, 2, PROMPT, seed=3, kind="serve")
    tb = {k: _t(v.astype(jx.jnp.float32)).to(tc.cdtype)
          if k != "tokens" else _t(v) for k, v in batch.items()}
    return types.SimpleNamespace(jm=jm, tm=tm, jp=jp, tp=tp, batch=batch,
                                 tb=tb, jc=jc, tc=tc)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_whisper_pallas_prefill_and_decode_logits(jx, dtype, tol):
    m = _models(jx, "whisper-tiny", dtype, "pallas")
    max_len = PROMPT + GEN
    jl, jcache = m.jm.prefill(m.jp, m.batch, max_len=max_len)
    tl, tcache = m.tm.prefill(m.tp, m.tb, max_len=max_len)
    _close(tl.numpy(), jl, tol)
    # teacher forcing: both fed the reference's greedy tokens
    tok = jx.jnp.argmax(jl, axis=-1)[:, None].astype(jx.jnp.int32)
    for i in range(GEN):
        jl, jcache = m.jm.decode_step(m.jp, tok, jcache,
                                      jx.jnp.int32(PROMPT + i))
        tl, tcache = m.tm.decode_step(m.tp, _t(tok), tcache, PROMPT + i)
        _close(tl.numpy(), jl, tol)
        tok = jx.jnp.argmax(jl, axis=-1)[:, None].astype(jx.jnp.int32)


@pytest.mark.parametrize("arch,impl", [("whisper-tiny", "pallas"),
                                       ("qwen1.5-0.5b", "chunked"),
                                       ("gemma2-27b", "chunked")])
def test_generate_tokens_equal_the_reference_in_fp32(jx, arch, impl):
    # gemma2: a 8-slot ring for its local layers, so decode wraps it
    over = {"local_window": 8} if arch == "gemma2-27b" else {}
    m = _models(jx, arch, "float32", impl, **over)
    max_len = PROMPT + GEN
    want = jx.ServeEngine(m.jm, jx.mesh(1), m.jp, 2, max_len).generate(
        m.batch, GEN)
    engine = ServeEngine(m.tm, m.tp, 2, max_len)
    got = engine.generate(m.tb, GEN)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(engine.timings) == {"prefill_ms", "decode_ms"}


def _port_model(arch, dtype="float32", impl="chunked", **over):
    """The port's reduced model with random weights and a prompt batch."""
    from repro_torch.configs.inputs import make_batch

    cfg = tconfigs.get_config(arch).reduced(compute_dtype=dtype,
                                            attn_impl=impl, **over)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return model, params, make_batch(cfg, 2, PROMPT, seed=1, kind="serve",
                                     device="cpu")


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return type(tree)(_clone_tree(v) for v in tree)


@pytest.mark.parametrize("arch,impl,dtype", [
    ("qwen1.5-0.5b", "chunked", "float32"),
    ("gemma2-27b", "chunked", "float32"),
    ("whisper-tiny", "pallas", "float32"),
    ("whisper-tiny", "pallas", "bfloat16")])
def test_decode_step_takes_a_device_cache_len_bit_for_bit(arch, impl, dtype):
    """cache_len as a 0-d tensor (the captured step's form) gives the
    int form's logits and cache, bit for bit (gemma2: an 8-slot ring for
    its local layers, so decode wraps it)."""
    over = {"local_window": 8} if arch == "gemma2-27b" else {}
    model, params, batch = _port_model(arch, dtype, impl, **over)
    logits, cache = model.prefill(params, batch, max_len=PROMPT + GEN)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    twin = _clone_tree(cache)
    for i in range(GEN):
        a, cache = model.decode_step(params, tok, cache, PROMPT + i)
        b, twin = model.decode_step(params, tok, twin,
                                    torch.tensor(PROMPT + i))
        assert torch.equal(a, b), i
        tok = torch.argmax(a, dim=-1)[:, None].to(torch.int32)
    from repro_torch.serving.engine import _leaves
    assert all(torch.equal(x, y)
               for x, y in zip(_leaves(cache), _leaves(twin)))


@pytest.mark.parametrize("arch,impl", [("whisper-tiny", "pallas"),
                                       ("gemma2-27b", "chunked")])
def test_engine_reuses_its_step_for_a_new_prompt(arch, impl):
    """The decode step's buffers are reloaded per generate: a second
    request to a warm engine (another prompt, a shorter one) answers as
    a fresh engine and as an eager loop of decode_step do."""
    over = {"local_window": 8} if arch == "gemma2-27b" else {}
    model, params, batch = _port_model(arch, impl=impl, **over)
    warm = ServeEngine(model, params, 2, PROMPT + GEN)
    warm.generate(batch, GEN)
    other = dict(batch, tokens=torch.flip(batch["tokens"], [1])[:, :PROMPT
                                                                 - 3])
    got = warm.generate(other, GEN)
    assert torch.equal(got, ServeEngine(model, params, 2, PROMPT + GEN)
                       .generate(other, GEN))
    logits, cache = model.prefill(params, other, max_len=PROMPT + GEN)
    toks = []
    for i in range(GEN):
        toks.append(torch.argmax(logits, dim=-1)[:, None].to(torch.int32))
        logits, cache = model.decode_step(params, toks[-1], cache,
                                          PROMPT - 3 + i)
    assert torch.equal(got, torch.cat(toks, dim=1))
    assert warm.captures == 0  # the CPU captures nothing


def test_engine_rejects_a_batch_it_was_not_built_for(jx):
    m = _models(jx, "qwen1.5-0.5b", "float32", "chunked")
    engine = ServeEngine(m.tm, m.tp, 2, PROMPT + GEN)
    with pytest.raises(ValueError, match="positions"):
        engine.generate(m.tb, GEN + 1)


# -------------------------------------------------------------------- CLI ----
@pytest.mark.parametrize("argv", [
    ["--arch", "whisper-tiny", "--attn-impl", "pallas"],
    ["--arch", "gemma2-27b", "--prompt-len", "40", "--gen", "3"],
], ids=["whisper_pallas", "gemma2_ring"])
def test_cli_serves_on_cpu(argv, capsys):
    assert tserve.main([*argv, "--reduced", "--device", "cpu", "--batch",
                        "2"]) == 0
    out = capsys.readouterr().out
    assert "generated shape=(2, " in out and "tok/s" in out
    assert "first sequence:" in out and "prefill_ms=" in out
    assert "decode_ms_per_token=" in out
    assert "flash_attention launches=0" in out  # the CPU runs no kernel


def test_cli_defaults_to_cuda_and_the_config_route():
    args = tserve.parse_args(["--arch", "whisper-tiny"])
    assert args.device == "cuda" and args.attn_impl is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.run(tserve.parse_args(["--arch", "whisper-tiny",
                                          "--reduced"]))


@pytest.mark.parametrize("flag", [["--production-mesh"],
                                  ["--model-axis", "2"]])
def test_cli_mesh_options_raise_with_roadmap_pointer(flag):
    """The mesh flags are ported (ROADMAP.md item 9): on one process
    --production-mesh raises the reference's "need 256 devices" and
    --model-axis clamps to the one rank, as the reference's
    make_local_mesh does, and serves on one device."""
    args = tserve.parse_args(["--arch", "whisper-tiny", "--reduced",
                              "--device", "cpu", "--batch", "2", "--gen",
                              "2", *flag])
    if args.production_mesh:
        with pytest.raises(RuntimeError, match="need 256 devices"):
            tserve.run(args)
    else:
        assert tuple(tserve.run(args)["tokens"].shape) == (2, 2)


# ----------------------------------------------------------------- guard ----
def test_no_port_module_loads_jax_or_the_reference():
    """Import every module of the port in a fresh interpreter: neither
    jax nor the reference package may end up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, check=True)
    n, bad = proc.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    # every module: the LM side, checkpoint/ and roofline/ included
    assert int(n) >= 61
