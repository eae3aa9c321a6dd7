"""The port's MoE layer and the MoE archs (qwen2-moe-a2.7b,
granite-moe-1b-a400m) against the reference on the CPU.

The layer: `layers.moe` on the same weights and input in fp32, with the
routing itself held, not only its outputs (a token dropped on one side
only could hide under an output bound): the reference's top-k indices,
queue positions and capacity are read from its own calls of
`jax.lax.top_k`, `jnp.cumsum` and `jax.nn.one_hot`, and its kept mask is
rebuilt from them as its code builds it.  Cases: qwen2-moe reduced with
padded experts (8 for 4 real) and one shared expert, granite reduced
(k = 2 of 4), granite with a capacity that drops tokens, and qwen2-moe
with duplicated router columns (tied scores: the lower expert index
wins on both sides).  Tolerances: y within 1e-5 of max |y|, aux within
1e-6 relative.

The whole model: weights from the reference's `Model.init` carried
across by `bridge.lm_params_from_numpy`, `scan_layers=True`; prefill and
per-step logits (both fed the reference's greedy tokens) within 1e-4 of
max |logit| in fp32 and 2e-2 in bf16, the `forward` aux equal to the
reference's within 1e-6 relative, and the greedy tokens of the port's
`ServeEngine` identical to the reference's engine in fp32.  Then the
CLI on the CPU, and every MoE, SSM and hybrid arch accepted on a mesh
(its cache specs the reference's, the engine on one gloo rank, the CLI
on two; tests/test_torch_lm_mesh.py holds them across four ranks).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (lm_config_from_fields,  # noqa: E402
                                lm_params_from_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models.transformer import Model, forward  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

PROMPT, GEN = 12, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's LM modules (JAX imported here, not at module
    level)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs.inputs import make_batch
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model, layers, transformer
    from repro.serving import engine as engine_mod
    from repro.serving.engine import ServeEngine as JServe

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, make_batch=make_batch,
        mesh=make_local_mesh, build_model=build_model, layers=layers,
        transformer=transformer, ServeEngine=JServe, engine_mod=engine_mod)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ------------------------------------------------------------------ layer ----
MOE_CASES = {
    # padded experts (router-masked) and one shared expert
    "qwen2_padded_shared": ("qwen2-moe-a2.7b", {"expert_pad": 8}, False),
    "granite_k2_of_4": ("granite-moe-1b-a400m", {}, False),
    # capacity 8 for 64 tokens x 2 choices over 4 experts: drops
    "granite_drops": ("granite-moe-1b-a400m", {"capacity_factor": 0.25},
                      False),
    # router columns 1 = 0 and 3 = 2: every token sees two exact ties
    "qwen2_tied_scores": ("qwen2-moe-a2.7b", {}, True),
}


def _moe_inputs(jx, arch, over, tie):
    jc = jx.configs.get_config(arch).reduced(compute_dtype="float32", **over)
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    rng = np.random.default_rng(5)
    arrays = {}

    def leaf(d, path):
        a = (0.2 * rng.normal(size=d.shape)).astype(np.float32)
        if tie and path == ("router",):
            a[:, 1], a[:, 3] = a[:, 0], a[:, 2]
        node = arrays
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
        return torch.from_numpy(a.copy())

    p = TP.build(TL.moe_defs(tc), leaf)
    x = rng.normal(size=(2, 32, jc.d_model)).astype(np.float32)
    return jc, tc, p, jx.jax.tree.map(jx.jnp.asarray, arrays), x


def _reference_moe(jx, monkeypatch, jp, x, jc):
    """The reference's (y, aux) and its routing, read from its own calls:
    top-k indices, the choice one-hots, queue positions, the capacity
    and the kept mask as its code forms it."""
    seen = {"one_hot": []}
    top_k, cumsum, one_hot = (jx.jax.lax.top_k, jx.jnp.cumsum,
                              jx.jax.nn.one_hot)

    def rec_top_k(a, k):
        v, i = top_k(a, k)
        seen["topi"] = np.asarray(i)
        return v, i

    def rec_cumsum(a, axis=None, **kw):
        out = cumsum(a, axis=axis, **kw)
        seen["flat"], seen["cum"] = np.asarray(a), np.asarray(out)
        return out

    def rec_one_hot(a, n, **kw):
        seen["one_hot"].append(n)
        return one_hot(a, n, **kw)

    monkeypatch.setattr(jx.jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jx.jnp, "cumsum", rec_cumsum)
    monkeypatch.setattr(jx.jax.nn, "one_hot", rec_one_hot)
    y, aux = jx.layers.moe(jp, jx.jnp.asarray(x), jc)
    monkeypatch.undo()
    topi = seen["topi"]
    cap = seen["one_hot"][1]  # one_hot(pos_e, cap): the second call
    onehot = seen["flat"].reshape(topi.shape + (-1,))
    pos = (seen["cum"] - seen["flat"]).reshape(onehot.shape)
    keep = onehot * (pos < cap)
    return np.asarray(y), float(aux), {"topi": topi, "pos": pos,
                                       "keep": keep, "cap": cap}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_routing_and_outputs_are_the_references(jx, monkeypatch, case):
    arch, over, tie = MOE_CASES[case]
    jc, tc, p, jp, x = _moe_inputs(jx, arch, over, tie)
    y, aux, want = _reference_moe(jx, monkeypatch, jp, x, jc)
    g, gs, cap = TL.moe_groups(x.shape[0] * x.shape[1], tc)
    assert cap == want["cap"]
    r = TL.moe_route(p, _t(x).reshape(g, gs, -1), tc, cap)
    np.testing.assert_array_equal(r["topi"].numpy(), want["topi"])
    np.testing.assert_array_equal(r["pos"].numpy(), want["pos"])
    np.testing.assert_array_equal(r["keep"].numpy(), want["keep"])
    ty, taux = TL.moe(p, _t(x), tc)
    _close(ty.numpy(), y, 1e-5)
    assert abs(float(taux) - aux) <= 1e-6 * abs(aux)
    chosen, kept = want["topi"].size, want["keep"].sum()
    if case == "granite_drops":
        assert kept < chosen  # capacity dropped tokens on both sides
    else:
        assert kept == chosen
    if tie:
        probs = r["probs"]
        assert torch.equal(probs[..., 0], probs[..., 1])
        # a tied pair both in the top k somewhere, ordered lower first
        both = (r["topi"] == 0).any(-1) & (r["topi"] == 1).any(-1)
        assert bool(both.any())
    if jc.expert_pad > jc.n_experts:
        assert not bool((r["topi"] >= jc.n_experts).any())


def test_moe_group_size_and_capacity_follow_the_reference_rules():
    cfg = tconfigs.get_config("qwen2-moe-a2.7b")
    # 16 x 32 tokens: 256 divides 512; capacity from the 60 real experts
    assert TL.moe_groups(512, cfg) == (2, 256, 24)
    # 16 decode tokens: one group of 16, capacity at least 4
    assert TL.moe_groups(16, cfg) == (1, 16, 4)
    # 3 x 7 tokens: the largest divisor of 21 up to 256 is 21
    assert TL.moe_groups(21, cfg)[:2] == (1, 21)
    assert TL.padded_experts(cfg) == 64


# ------------------------------------------------------------------ model ----
def _models(jx, arch, dtype):
    """Both packages' reduced models on the reference's weights, a prompt
    batch and the reference's jitted prefill and decode steps."""
    jc = jx.configs.get_config(arch).reduced(compute_dtype=dtype,
                                             scan_layers=True)
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


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
def test_prefill_decode_logits_and_aux_match_the_reference(jx, models, arch,
                                                            dtype, tol):
    m = models(arch, dtype)
    assert "moe" in m.tp["layers"][0]["k0"]
    max_len = PROMPT + GEN
    jl, jcache = m.prefill(m.jp, m.batch, max_len=max_len)
    tl, tcache = m.tm.prefill(m.tp, m.tb, max_len=max_len)
    _close(tl.numpy(), jl, tol)
    tok = jx.jnp.argmax(jl, axis=-1)[:, None].astype(jx.jnp.int32)
    for i in range(GEN):
        jl, jcache = m.decode(m.jp, tok, jcache, jx.jnp.int32(PROMPT + i))
        tl, tcache = m.tm.decode_step(m.tp, _t(tok), tcache, PROMPT + i)
        _close(tl.numpy(), jl, tol)
        tok = jx.jnp.argmax(jl, axis=-1)[:, None].astype(jx.jnp.int32)
    if dtype == "float32":
        jaux = jx.jax.jit(lambda p, t: jx.transformer.forward(p, t, m.jc)[2])(
            m.jp, m.batch["tokens"])
        _, _, taux = forward(m.tp, m.tb["tokens"], m.tc)
        assert taux.dtype == torch.float32 and float(jaux) > 0
        assert abs(float(taux) - float(jaux)) <= 1e-6 * float(jaux)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
def test_generate_tokens_equal_the_reference_in_fp32(jx, models, arch):
    m = models(arch, "float32")
    max_len = PROMPT + GEN
    want = jx.ServeEngine(m.jm, jx.mesh(1), m.jp, 2, max_len).generate(
        m.batch, GEN)
    got = ServeEngine(m.tm, m.tp, 2, max_len).generate(m.tb, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ CLI, mesh ----
def test_cli_serves_qwen2_moe_on_cpu(capsys):
    assert tserve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-moe-a2.7b-smoke" in out
    assert "generated shape=(2, 3)" in out and "decode_ms_per_token=" in out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "recurrentgemma-2b"])
def test_mesh_serving_is_accepted(jx, arch, tmp_path, capfd):
    """These families serve on a mesh: their cache specs are the
    reference's on stand-in (1, 2) and (2, 2) meshes; `ServeEngine` on a
    (1, 1) mesh of one gloo rank gives the one-device engine's tokens;
    `serve --nproc 2 --model-axis 2` serves on two ranks and prints the
    one-device run's first sequence."""
    from repro_torch.configs.inputs import make_batch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.serving.engine import cache_specs

    cfg = tconfigs.get_config(arch).reduced(compute_dtype="float32")
    jm = jx.build_model(jx.configs.get_config(arch).reduced(
        compute_dtype="float32"))
    model = Model(cfg)
    for dims in ({"data": 1, "model": 2}, {"data": 2, "model": 2}):
        stand = types.SimpleNamespace(shape=dims,
                                      axis_names=tuple(dims))
        want = jx.jax.tree.map(tuple, jx.engine_mod.cache_specs(
            jm, stand, 2, 16), is_leaf=lambda x: isinstance(
                x, jx.jax.sharding.PartitionSpec))
        got = cache_specs(model, dims, 2, 16)
        assert _plain(got) == _plain(want), dims
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 2, PROMPT, kind="serve", device="cpu")
    one = ServeEngine(model, params, 2, PROMPT + GEN).generate(batch, GEN)
    tmesh.join("cpu", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        eng = ServeEngine(model, params, 2, PROMPT + GEN,
                          mesh=tmesh.make_local_mesh(1, "cpu"))
        assert torch.equal(eng.generate(batch, GEN), one)
        eng.close()
    finally:
        tmesh.leave()
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "2"]
    assert tserve.main(argv + ["--nproc", "2", "--model-axis", "2"]) == 0
    mesh_out = capfd.readouterr().out
    assert tserve.main(argv) == 0
    one_out = capfd.readouterr().out
    assert mesh_out.count("mesh: {'data': 1, 'model': 2}") == 1
    first = [x for x in mesh_out.splitlines() if x.startswith("first")]
    assert first and first == [x for x in one_out.splitlines()
                               if x.startswith("first")]


def _plain(tree):
    """Specs as tuples in dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple) and any(isinstance(v, (dict, list, tuple))
                                       for v in tree):
        return tuple(_plain(v) for v in tree)
    return tuple(tree)
