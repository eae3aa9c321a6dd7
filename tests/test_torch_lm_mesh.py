"""LM serving on a (data, model) mesh: the port's specs against the
reference's, and the sharded engine across gloo ranks on the CPU.

The spec functions (`param_specs`, `batch_axes_for`, `serve_batch_axes`,
`cache_specs`) are pure functions of the defs and the mesh's dims: they
are held equal to the reference's for every config of
`src/repro/configs/` on the meshes (1, 1), (2, 1), (1, 2), (2, 2),
(1, 4), (16, 16) and (2, 16, 16), under both `zero_shard` settings; the
reference gets a stand-in mesh that carries only `.shape` and
`.axis_names`.  Every family is held through the port's own defs and
cache shapes, and through the reference's defs and cache shapes read
into the port's `ParamDef`.

Across gloo ranks (one spawn per mesh shape, bounded by a join timeout):
reduced qwen1.5-0.5b and whisper-tiny, their parameters made by the
reference and carried to each rank's shards by `bridge`, on (2, 2) (with
the MoE, SSM and hybrid families: qwen2-moe-a2.7b, granite-moe-1b-a400m,
mamba2-2.7b and recurrentgemma-2b, experts and channels cut over
"model"), on
(1, 4) (2 kv heads: the KV projections and caches fall back to their
head dim) and with B = 1 on (2, 1) (the cache's time dim cut over
"data"), with and without `zero_shard`.  Held: every step's logits under
teacher forcing within 1e-5 of max |logit| of the port's one-device
model, the fp32 tokens of `generate` identical, and every rank's tokens
the same.  A mismatch reports its logit margin.

On a card (`pytest -m gpu`): a (1, 1) mesh of one NCCL rank against the
one-device engine and the one-device train step (bit for bit).  On an
even number of cards every card is one rank of an (n/2, 2) mesh, held
to one device on the same weights from seed 0:
  * serving (`_nccl_lm_worker`): reduced whisper-tiny (kernel route) and
    qwen1.5-0.5b, then granite-moe-1b-a400m, mamba2-2.7b and
    recurrentgemma-2b at their published widths, fp32, (16, 32) + 16:
    the one-device tokens, the decode step one CUDA graph captured once
    cold and never warm; recurrentgemma's (1, 4096) no-cache forward
    with attn_impl="pallas", one `flash_attention` launch per local
    layer, within 2e-4 of max |h|;
  * training (`_nccl_train_worker`, under deterministic algorithms):
    qwen1.5-0.5b and granite-moe at their published widths, bf16, (8,
    512), 3 steps (losses within 1e-3, state bytes a card); then 2
    layers of each in fp32: the one-device gradients' noise floor with
    and without deterministic algorithms, every rank's step-1 gradients
    within 1e-5 of the largest |g| and their global norm within 1e-5,
    the MoE's routing identical in the forward and the remat recompute,
    losses within 1e-5; after step 1 every weight beyond 1e-5 of the
    largest |p| explained by its two gradients through AdamW's first
    step and within 2·lr (`attribute_step1`), after 3 steps every weight
    within 2·lr a step;
  * on four cards the training CLI, `--nproc 4 --model-axis 2`: a crash
    at step 9 resumed from the step-6 checkpoint gives the uninterrupted
    run's losses bit for bit.
`attribute_step1` is held on the CPU to planted gaps.
"""
import dataclasses
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model, model_defs  # noqa: E402
from repro_torch.models.params import ParamDef  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CONFIGS = ("internvl2_26b", "qwen1_5_0_5b", "deepseek_67b", "qwen2_5_32b",
           "gemma2_27b", "whisper_tiny", "qwen2_moe_a2_7b",
           "granite_moe_1b_a400m", "mamba2_2_7b", "recurrentgemma_2b")
BATCHES = (1, 2, 16, 32)
SPAWN_TIMEOUT = 200
TOL = 1e-5
PROMPT, GEN = 8, 4


@pytest.fixture(scope="module")
def jx():
    """The reference's LM modules (JAX imported here, not at module
    level)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import build_model, transformer
    from repro.serving import engine as jengine
    from repro.sharding import specs as jspecs

    return types.SimpleNamespace(jax=jax, configs=configs,
                                 build_model=build_model,
                                 transformer=transformer, engine=jengine,
                                 specs=jspecs)


def _stand_in(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _norm(tree):
    """Specs as plain tuples: the reference's PartitionSpecs and the
    port's tuples, in dicts and tuples."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, (tuple, list)):
        if all(not isinstance(x, (dict, tuple, list, PartitionSpec))
               for x in tree):
            return tuple(tree)  # a port spec
        return tuple(_norm(x) for x in tree)
    return tree


def _port_def(d):
    return ParamDef(tuple(d.shape), tuple(d.logical))


def _cfg(jx, name, zero):
    jc = jx.configs.get_config(name)
    return dataclasses.replace(jc, zero_shard=zero)


@pytest.mark.parametrize("zero", [True, False], ids=["zero", "no_zero"])
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_are_the_references(jx, name, zero):
    """On every mesh: the port's `param_specs` of its own defs (the
    families it builds) and `spec_for_def` of each of the reference's
    defs (every family), under the serve and the train rules."""
    jc = _cfg(jx, name, zero)
    jdefs = jx.transformer.model_defs(jc)
    leaves = jx.jax.tree.leaves(jdefs, is_leaf=lambda x: hasattr(
        x, "logical"))
    for shape, names in MESHES:
        stand = _stand_in(shape, names)
        dims = dict(zip(names, shape))
        for serve in (True, False):
            rules = tspecs.rules_for(zero, serve=serve)
            jrules = jx.specs.rules_for(zero, serve=serve)
            for d in leaves:
                assert tspecs.spec_for_def(_port_def(d), dims, rules) == \
                    tuple(jx.specs.spec_for_def(d, stand, jrules)), (d,
                                                                     shape)
            tc = dataclasses.replace(get_config(name), zero_shard=zero)
            got = tspecs.param_specs(model_defs(tc), dims, rules)
            want = _norm(jx.specs.param_specs(jdefs, stand, jrules))
            assert _norm(got) == want, shape


@pytest.mark.parametrize("zero", [True, False], ids=["zero", "no_zero"])
@pytest.mark.parametrize("name", CONFIGS)
def test_batch_and_cache_specs_are_the_references(jx, name, zero):
    """`batch_axes_for`, `batch_spec` and `serve_batch_axes` for B in
    {1, 2, 16, 32}, and the cache specs (`cache_specs` where the port
    builds the family, `_cache_leaf_spec` on every leaf of the
    reference's cache shapes otherwise) on every mesh."""
    jc = _cfg(jx, name, zero)
    jm = jx.build_model(jc)
    rules = tspecs.rules_for(zero, serve=True)
    jrules = jx.specs.rules_for(zero, serve=True)
    for shape, names in MESHES:
        stand = _stand_in(shape, names)
        dims = dict(zip(names, shape))
        assert tspecs.batch_spec(dims, rules) == tuple(
            jx.specs.batch_spec(stand, jrules))
        for b in BATCHES:
            assert tspecs.batch_axes_for(b, dims, rules) == \
                jx.specs.batch_axes_for(b, stand, jrules)
            used, rest = tengine.serve_batch_axes(b, dims, rules)
            assert (used, rest) == jx.engine.serve_batch_axes(b, stand,
                                                              jrules)
            want = _norm(jx.engine.cache_specs(jm, stand, b, 64))
            tm = build_model(dataclasses.replace(get_config(name),
                                                 zero_shard=zero))
            assert _norm(tengine.cache_specs(tm, dims, b, 64)) == want


def test_local_and_production_mesh_shapes_are_the_references():
    """`make_local_mesh` clamps the model dim as the reference's does;
    the production mesh needs 256 ranks."""
    for n in (1, 2, 3, 4, 6, 8):
        for model_axis in (0, 1, 2, 3, 4, 16):
            ma = max(1, min(model_axis, n))
            while n % ma:
                ma -= 1
            assert tmesh.local_mesh_shape(n, model_axis) == (n // ma, ma)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices"):
        tmesh.make_production_mesh(multi_pod=True)


# ------------------------------------------------------------ the ranks

# name: (mesh shape, batch, [(arch, attn_impl, zero_shard)])
RANK_MESHES = {
    "d2m2": ((2, 2), 2, [("qwen1.5-0.5b", "chunked", False),
                         ("qwen1.5-0.5b", "chunked", True),
                         ("whisper-tiny", "pallas", False),
                         ("whisper-tiny", "chunked", True),
                         ("qwen2-moe-a2.7b", "chunked", False),
                         ("granite-moe-1b-a400m", "chunked", True),
                         ("mamba2-2.7b", "chunked", True),
                         ("recurrentgemma-2b", "chunked", False)]),
    "d1m4": ((1, 4), 2, [("qwen1.5-0.5b", "chunked", False),
                         ("whisper-tiny", "pallas", False)]),
    "d2m1": ((2, 1), 1, [("qwen1.5-0.5b", "chunked", True),
                         ("whisper-tiny", "pallas", True)]),
}
RANK_CASES = [(k, i) for k, (_, _, cases) in RANK_MESHES.items()
              for i in range(len(cases))]


def _case_key(arch, impl, zero):
    return f"{arch}-{impl}-{'zero' if zero else 'nozero'}"


def _reference_params(path):
    """Each case's reduced config (fields) and the reference's random
    parameters (numpy), pickled to `path`."""
    import jax

    from repro import configs
    from repro.models import build_model

    out = {}
    for _, _, cases in RANK_MESHES.values():
        for arch, impl, zero in cases:
            jc = dataclasses.replace(
                configs.get_config(arch).reduced(compute_dtype="float32",
                                                 attn_impl=impl),
                zero_shard=zero)
            model = build_model(jc)
            # the families added later init jitted (one compile, the same
            # draws); the first ones keep their eager init
            init = model.init if arch in ("qwen1.5-0.5b", "whisper-tiny") \
                else jax.jit(model.init)
            params = init(jax.random.PRNGKey(0))
            out[_case_key(arch, impl, zero)] = (
                dataclasses.asdict(jc), jax.tree.map(np.asarray, params))
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _rank_worker(device, key, params_path, out_dir):
    """One rank: every case of `key`: the one-device model and the mesh
    engine (this rank's shards), teacher-forced logits of both for this
    rank's rows, the mesh's generated tokens and the one-device's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import Model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.sharding.activation import held_of

    shape, batch_size, cases = RANK_MESHES[key]
    with open(params_path, "rb") as f:
        store = pickle.load(f)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    max_len = PROMPT + GEN
    for arch, impl, zero in cases:
        name = _case_key(arch, impl, zero)
        fields, tree = store[name]
        cfg = bridge.lm_config_from_fields(fields)
        model = Model(cfg)
        one = bridge.lm_params_from_numpy(cfg, tree)
        shards = bridge.lm_params_from_numpy(cfg, tree, mesh=mesh)
        eng = ServeEngine(model, shards, batch_size, max_len, mesh=mesh)
        batch = make_batch(cfg, batch_size, PROMPT, seed=3, kind="serve",
                           device="cpu")
        local = eng.local_batch(batch)
        rows = eng.shards.part(torch.arange(batch_size), 0,
                               eng.shards.batch_entry)
        # teacher forcing: both fed the one-device model's greedy tokens
        want, cache1 = model.prefill(one, batch, max_len=max_len)
        got, cache = eng._prefill_fn(eng.params, local)
        logits = [(got, want[rows])]
        tok = torch.argmax(want, -1)[:, None].to(torch.int32)
        for i in range(GEN):
            want, _ = model.decode_step(one, tok, cache1, PROMPT + i)
            got, _ = eng._decode_fn(eng.params, tok[rows], cache, PROMPT + i)
            logits.append((got, want[rows]))
            tok = torch.argmax(want, -1)[:, None].to(torch.int32)
        out[f"{name}/got"] = torch.stack([g for g, _ in logits]).numpy()
        out[f"{name}/want"] = torch.stack([w for _, w in logits]).numpy()
        out[f"{name}/tokens"] = eng.generate(batch, GEN).numpy()
        out[f"{name}/tokens_one"] = ServeEngine(
            model, one, batch_size, max_len).generate(batch, GEN).numpy()
        if "attn" in shards["tail"][0]:
            lay = shards["tail"][0]["attn"]
            out[f"{name}/wk_held"] = np.asarray(repr(held_of(lay["wk"])))
            out[f"{name}/wq_shape"] = np.asarray(lay["wq"].shape)
            c = cache["tail"][0]["attn"][0]
            out[f"{name}/cache_held"] = np.asarray(repr(held_of(c)))
            out[f"{name}/cache_shape"] = np.asarray(c.shape)
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)


class RankRuns:
    def __init__(self, tmp):
        self.tmp = tmp
        self.params_path = str(tmp / "params.pkl")
        _reference_params(self.params_path)
        self.runs = {}

    def get(self, key):
        if key not in self.runs:
            out = self.tmp / key
            out.mkdir()
            n = int(np.prod(RANK_MESHES[key][0]))
            tmesh.spawn(_rank_worker, n, out / "store", key,
                        self.params_path, str(out), device_type="cpu",
                        timeout=tmesh.datetime.timedelta(seconds=150),
                        join_timeout=SPAWN_TIMEOUT)
            self.runs[key] = [dict(np.load(out / f"rank{r}.npz"))
                              for r in range(n)]
        return self.runs[key]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory, jx):
    return RankRuns(tmp_path_factory.mktemp("lm_mesh"))


@pytest.mark.parametrize("key,i", RANK_CASES,
                         ids=[f"{k}-{_case_key(*RANK_MESHES[k][2][i])}"
                              for k, i in RANK_CASES])
def test_mesh_engine_matches_the_one_device_model(rank_runs, key, i):
    name = _case_key(*RANK_MESHES[key][2][i])
    for r, run in enumerate(rank_runs.get(key)):
        got, want = run[f"{name}/got"], run[f"{name}/want"]
        scale = np.abs(want).max()
        err = np.abs(got - want).max() / scale
        # the margin between each row's two best one-device logits
        top2 = np.sort(want, axis=-1)[..., -2:]
        margin = float((top2[..., 1] - top2[..., 0]).min() / scale)
        assert err <= TOL, (name, r, err, f"logit margin {margin:.3g}")
        np.testing.assert_array_equal(run[f"{name}/tokens"],
                                      run[f"{name}/tokens_one"],
                                      err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("key", list(RANK_MESHES))
def test_every_rank_generates_the_same_tokens(rank_runs, key):
    runs = rank_runs.get(key)
    for case in RANK_MESHES[key][2]:
        name = _case_key(*case)
        for run in runs[1:]:
            np.testing.assert_array_equal(run[f"{name}/tokens"],
                                          runs[0][f"{name}/tokens"])


def test_ranks_hold_the_shards_the_specs_give(rank_runs):
    """(1, 4): 4 query heads cut 4 ways, 2 kv heads fall back to their
    head dim, so the cache's head dim is cut (its batch over the "data"
    dim of one rank); (2, 1) with B = 1: the
    batch takes no dim and the cache's time dim is cut over "data"."""
    run = rank_runs.get("d1m4")[0]
    name = _case_key("qwen1.5-0.5b", "chunked", False)
    assert str(run[f"{name}/wk_held"]) == "(None, None, 'model')"
    assert tuple(run[f"{name}/wq_shape"]) == (128, 1, 32)
    assert str(run[f"{name}/cache_held"]) == "('data', None, None, 'model')"
    assert tuple(run[f"{name}/cache_shape"]) == (2, PROMPT + GEN, 2, 8)
    run = rank_runs.get("d2m1")[0]
    name = _case_key("qwen1.5-0.5b", "chunked", True)
    assert str(run[f"{name}/cache_held"]) == "(None, 'data', 'model', None)"
    assert tuple(run[f"{name}/cache_shape"]) == (1, (PROMPT + GEN) // 2, 2,
                                                 32)
    assert str(run[f"{name}/wk_held"]) == "('data', 'model', None)"


def test_cli_serves_on_a_mesh(capfd):
    """`serve --nproc 4 --model-axis 2`: the ranks' tokens are the
    one-device run's, printed once."""
    from repro_torch.launch import serve as tserve

    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    assert tserve.main(argv + ["--nproc", "4", "--model-axis", "2"]) == 0
    mesh_out = capfd.readouterr().out
    assert tserve.main(argv) == 0
    one_out = capfd.readouterr().out
    assert mesh_out.count("mesh: {'data': 2, 'model': 2}") == 1
    first = [x for x in mesh_out.splitlines() if x.startswith("first")]
    assert first == [x for x in one_out.splitlines()
                     if x.startswith("first")]


# ------------------------------------------------------------- the card

@pytest.mark.gpu
def test_one_nccl_rank_serves_as_one_device(tmp_path):
    """World size 1 on NCCL, a (1, 1) mesh: reduced whisper-tiny through
    the kernel route gives the one-device engine's fp32 tokens and logits,
    its decode step one CUDA graph holding the collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("whisper-tiny").reduced(compute_dtype="float32",
                                             attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, 2, PROMPT, kind="serve", device=dev)
    one = ServeEngine(model, params, 2, PROMPT + 2 * GEN)
    one.generate(batch, GEN)
    want = one.generate(batch, GEN)
    tmesh.join("cuda", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        eng = ServeEngine(model, params, 2, PROMPT + 2 * GEN,
                          mesh=tmesh.make_local_mesh(1))
        eng.generate(batch, GEN)
        got = eng.generate(batch, GEN)
        assert eng.captures == 1
        assert torch.equal(got, want)
        assert torch.allclose(eng.logits, one.logits, rtol=0, atol=1e-5 *
                              float(one.logits.abs().max()))
        eng.close()
    finally:
        tmesh.leave()


# serving across the cards: reduced (arch, attn_impl) at (n, PROMPT) +
# GEN, then the MoE, SSM and hybrid families at their published widths in
# fp32 at the one-card serving phase's batch and lengths
SERVE_REDUCED = (("whisper-tiny", "pallas"), ("qwen1.5-0.5b", "chunked"))
SERVE_PUBLISHED = ("granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b")
SERVE_B, SERVE_PROMPT, SERVE_GEN = 16, 32, 16
RG_S = 4096      # recurrentgemma-2b's no-cache forward through the kernel
RG_TOL = 2e-4
# the spawns' bounds (s; `chip_smoke.py` phase 20c runs these tests under
# the sum of their bounds); a rank stuck a minute short of it prints its
# stacks and exits
SERVE_JOIN, TRAIN_JOIN, CLI_TIMEOUT = 300, 400, 400


def _card_gen(device):
    return torch.Generator(device=device).manual_seed(0)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _serve_pair(model, params, batch, gen, max_len, mesh):
    """The one-device engine and the mesh engine on the same weights and
    batch, each run cold (one eager step, the capture) and then warm:
    {tokens equal, one decode graph captured cold and none warm, warm
    decode ms a token on one device and on the mesh}."""
    from repro_torch.serving.engine import ServeEngine

    got = []
    for m in (None, mesh):
        eng = ServeEngine(model, params, batch["tokens"].shape[0], max_len,
                          mesh=m)
        eng.generate(batch, gen)
        first = eng._decode
        toks = eng.generate(batch, gen)
        got.append((toks, eng.timings["decode_ms"] / gen,
                    eng.captures == 1 and eng._decode is first))
        eng.close()
        del eng
    (t1, ms1, _), (t2, ms2, once) = got
    return {"tokens_equal": bool(torch.equal(t1, t2)), "one_graph": once,
            "ms_one": ms1, "ms_mesh": ms2}


def _rg_pallas_forward(cfg, params, mesh, device):
    """recurrentgemma's (1, RG_S) no-cache forward with attn_impl="pallas"
    on the mesh (this rank's shards) against one device: {hidden max rel
    diff, flash_attention launches on the mesh, local layers}."""
    from repro_torch.configs.inputs import make_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import build_model, forward
    from repro_torch.serving.engine import build_serve_steps, shard_params
    from repro_torch.sharding.activation import activation_sharding

    c = dataclasses.replace(cfg, attn_impl="pallas")
    tokens = make_batch(c, 1, RG_S, seed=2, kind="serve",
                        device=device)["tokens"]
    model = build_model(c)
    with torch.no_grad():
        want, _, _ = forward(params, tokens, c)
        _, _, _, _, p_specs, shards = build_serve_steps(model, mesh, 1, RG_S)
        local = shard_params(model, params, shards, p_specs, device)
        kfa.launches = 0
        with activation_sharding(shards):
            got, _, _ = forward(local, tokens, c)
        launches = kfa.launches
    return {"rel": float((got - want).abs().max() / want.abs().max()),
            "launches": launches,
            "local_layers": c.layer_kinds().count("local")}


def _nccl_lm_worker(device, out_dir):
    """One NCCL rank of every card on a (n/2, 2) mesh, each case against
    the one-device engine on this rank's card (the same weights, seed 0):
    reduced whisper-tiny (kernel route) and qwen1.5-0.5b in fp32 at (n,
    PROMPT) + GEN, then SERVE_PUBLISHED at their published widths in fp32
    at (SERVE_B, SERVE_PROMPT) + SERVE_GEN; on recurrentgemma-2b also the
    (1, RG_S) no-cache forward with attn_impl="pallas"
    (`_rg_pallas_forward`).  Writes this rank's results to
    `serve_rank{r}.json`; the test holds them."""
    import faulthandler
    import json

    # a rank stuck in a collective prints every thread's stack and exits,
    # so the spawn fails with the place it hung
    faulthandler.dump_traceback_later(SERVE_JOIN - 60, exit=True)
    import torch.distributed as dist

    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = tmesh.make_local_mesh(2)
    out = {"mesh": repr(tmesh.mesh_dims(mesh))}
    cases = [(arch, impl, True) for arch, impl in SERVE_REDUCED] + \
        [(arch, "chunked", False) for arch in SERVE_PUBLISHED]
    for arch, impl, reduced in cases:
        cfg = get_config(arch).reduced(compute_dtype="float32",
                                       attn_impl=impl) if reduced else \
            dataclasses.replace(get_config(arch), compute_dtype="float32")
        b, prompt, gen = (n, PROMPT, GEN) if reduced else \
            (SERVE_B, SERVE_PROMPT, SERVE_GEN)
        model = build_model(cfg)
        params = model.init(_card_gen(device))
        batch = make_batch(cfg, b, prompt, kind="serve", device=device)
        res = _serve_pair(model, params, batch, gen, prompt + gen, mesh)
        res.update(impl=impl, reduced=reduced, batch=[b, prompt, gen])
        if arch == "recurrentgemma-2b" and not reduced:
            res["pallas"] = _rg_pallas_forward(cfg, params, mesh, device)
        out[arch] = res
        del params, batch
        _free(device)
    with open(os.path.join(out_dir, f"serve_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(out, f)


def _serve_lines(runs):
    """The serving checks over every rank's results: (lines, failures)."""
    lines, fails = [], []
    for arch in runs[0]:
        if arch == "mesh":
            continue
        r0 = runs[0][arch]
        ok = all(r[arch]["tokens_equal"] and r[arch]["one_graph"]
                 for r in runs)
        what = ("reduced " if r0["reduced"] else "published ") + \
            f"{arch} {r0['impl']} fp32 {tuple(r0['batch'])}"
        lines.append(f"{what} on {runs[0]['mesh']}: tokens equal the "
                     f"one-device engine's and one decode graph on every "
                     f"rank: {ok}; warm decode {r0['ms_mesh']:.3f} ms a "
                     f"token against {r0['ms_one']:.3f} on one device "
                     f"(rank 0)")
        if not ok:
            fails.append(f"{what}: " + repr([r[arch] for r in runs]))
        if "pallas" in r0:
            pl = [r[arch]["pallas"] for r in runs]
            worst = max(p["rel"] for p in pl)
            ok = all(p["rel"] <= RG_TOL and p["launches"] == p["local_layers"]
                     for p in pl)
            lines.append(f"{arch} fp32 (1, {RG_S}) pallas forward: hidden "
                         f"within {worst:.3e} of max |h| (tol {RG_TOL}); "
                         f"flash_attention launches "
                         f"{[p['launches'] for p in pl]} by rank (want "
                         f"{pl[0]['local_layers']} each)")
            if not ok:
                fails.append(f"{arch} pallas forward: {pl}")
    return lines, fails


@pytest.mark.gpu
def test_lm_serving_across_nccl_ranks(tmp_path):
    """Every card one NCCL rank (an even count, 2 or more), a (n/2, 2)
    (data, model) mesh (`_nccl_lm_worker`): fp32 tokens equal to the
    one-device engine's, the decode step one CUDA graph holding
    collectives across the cards, for whisper-tiny and qwen1.5-0.5b
    reduced and granite-moe, mamba2 and recurrentgemma at their published
    widths; recurrentgemma's (1, 4096) pallas forward within 2e-4 of max
    |h|, one flash_attention launch per local layer on every rank."""
    import json

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2 \
            or torch.cuda.device_count() % 2:
        pytest.skip("needs an even number of CUDA cards, 2 or more")
    n = torch.cuda.device_count()
    tmesh.spawn(_nccl_lm_worker, n, tmp_path / "store", str(tmp_path),
                join_timeout=SERVE_JOIN)
    runs = [json.loads((tmp_path / f"serve_rank{r}.json").read_text())
            for r in range(n)]
    lines, fails = _serve_lines(runs)
    print("\n".join(lines))
    assert not fails, fails


# ------------------------------------------------- training on the card

TRAIN_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 3
GAP_LAYERS = 2   # the fp32 gap runs: published widths, this many layers


def _train_run(model, mesh, device, steps, batch_size, seq, first=False):
    """`steps` train steps from seed 0 on one device (mesh None) or on
    the mesh: (state, losses, step seconds after the first, and with
    `first` (parameters after step 1, step 1's gradients, its global
    norm) as clones, the rank's shards on the mesh)."""
    import time

    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.training.steps import build_train_step, make_train_state

    data = SyntheticLMDataset(model.cfg.vocab_size, seq, batch_size, seed=0)
    state = make_train_state(model, _card_gen(device), mesh=mesh)
    step, _, bspecs = build_train_step(model, mesh, AdamWConfig())
    losses, times, kept = [], [], None
    for i in range(steps):
        b = device_put_batch(data.batch(i), device,
                             None if mesh is None else bspecs, step.shards)
        _sync(device)
        t = time.perf_counter()
        state, met = step(state, b)
        losses.append(met["loss"].item())
        times.append(time.perf_counter() - t)
        if first and i == 0:
            kept = ([p.detach().clone() for p in leaves(state.params)],
                    [g.detach().clone() for g in step.accumulator],
                    met["grad_norm"].clone())
    return state, losses, times[1:], kept


def _state_list(state):
    from repro_torch.optim.adamw import leaves

    return leaves(state.params) + leaves(state.opt.m) + leaves(state.opt.v)


def _tree_gap(want, got, scale=None):
    """max |got − want| over paired leaves, over `scale` (by default the
    largest |want| of the tree)."""
    err = max(float((g.float() - w.float()).abs().max())
              for w, g in zip(want, got))
    if scale is None:
        scale = max(float(w.float().abs().max()) for w in want)
    return err / max(scale, 1e-30)


def adamw_step1(g, scale, b1=0.9, b2=0.95, eps=1e-8):
    """AdamW's first-step direction for gradient g under the clip factor
    `scale`, `optim/adamw.py:adamw_update`'s formula at step 1 (zero
    moments) in fp32: m̂ / (sqrt(v̂) + eps), lr·(that + wd·p) the move.
    It is ±1 for |g·scale| well above eps and linear in g below."""
    g = g.float() * scale
    m = (1 - b1) * g
    v = (1 - b2) * g * g
    return (m / (1.0 - b1)) / (torch.sqrt(v / (1.0 - b2)) + eps)


def attribute_step1(leaves_, p_scale, lr, scale, tol=1e-5):
    """The parameter entries more than `tol`·`p_scale` away from one
    device's after AdamW's first step, and whether the gradients explain
    each.

    `leaves_`: per leaf (p_one, p_mesh, g_one, g_mesh), the one-device
    parameter and step-1 gradient cut to the rank's block, and the rank's
    own; `scale`: one device's clip factor at step 1.  Both runs start
    from the same weights, so the mesh's weight minus one device's is
    −lr times the difference of the two first-step directions
    (`adamw_step1`): ±lr apart when a rounding-level gradient changes
    sign, and a fraction of lr when |g·scale| is near eps, where the
    direction is linear in g and carries the gradient's relative error.
    An off entry is explained when its weight gap is that difference
    within `tol`·`p_scale` and at most 2·lr (plus one rounding of the
    weight).  Returns {"off", "rounding" (off entries whose |g_one| is
    no larger than the largest |g_mesh − g_one| in its leaf),
    "unexplained", "gap" (the largest |p_mesh − p_one|), "resid" (the
    largest gap left after the directions' difference), "eps_x" (the
    largest |g_one·scale| / eps over the off entries), "first" (up to 5
    unexplained entries as (leaf, |g_one|, the leaf's gradient gap,
    |Δp|, the residual))}."""
    eps = 1e-8
    out = {"off": 0, "rounding": 0, "unexplained": 0, "gap": 0.0,
           "resid": 0.0, "eps_x": 0.0, "first": []}
    for k, (p1, p2, g1, g2) in enumerate(leaves_):
        p1, p2, g1, g2 = (t.detach().float() for t in (p1, p2, g1, g2))
        d = p2 - p1
        want = -lr * (adamw_step1(g2, scale) - adamw_step1(g1, scale))
        resid = (d - want).abs()
        floor = (g2 - g1).abs().max()
        rounding = torch.finfo(torch.float32).eps * p1.abs()
        ok = (resid <= tol * p_scale) & (d.abs() <= 2 * lr + rounding)
        is_off = d.abs() > tol * p_scale
        bad = is_off & ~ok
        out["off"] += int(is_off.sum())
        out["rounding"] += int((is_off & (g1.abs() <= floor)).sum())
        out["unexplained"] += int(bad.sum())
        if d.numel():
            out["gap"] = max(out["gap"], float(d.abs().max()))
            out["resid"] = max(out["resid"], float(resid.max()))
        if is_off.any():
            out["eps_x"] = max(out["eps_x"], float(
                (g1.abs() * scale)[is_off].max()) / eps)
        for j in bad.reshape(-1).nonzero()[:max(0, 5 - len(out["first"]))]:
            j = int(j)
            out["first"].append((k, float(g1.reshape(-1)[j].abs()),
                                 float(floor), float(d.reshape(-1)[j].abs()),
                                 float(resid.reshape(-1)[j])))
    return out


def _routes_same(r_one, r_mesh, shards):
    """Every routing decision (top-k indices and kept slots per group) of
    the mesh run the one-device run's, a rank's groups against its block
    of one device's."""
    d = shards.role(shards.batch_entry)[2] if shards.batch_entry else 0
    same = len(r_one) == len(r_mesh)
    for (t1, k1), (t2, k2) in zip(r_one, r_mesh):
        g = t2.shape[0]  # the rank's groups
        if g < t1.shape[0]:
            t1, k1 = t1[d * g:(d + 1) * g], k1[d * g:(d + 1) * g]
        same &= bool(torch.equal(t1, t2) and torch.equal(k1, k2))
    return same


def _bf16_run(model, mesh, device, batch_size, seq):
    """TRAIN_STEPS bf16 steps on one device and on the mesh: {the losses,
    their largest relative gap, this card's state bytes against one
    device's over the data dim plus the leaves "data" does not cut, the
    median step ms}."""
    import statistics

    from repro_torch.optim.adamw import leaves
    from repro_torch.sharding.activation import held_of

    dp = tmesh.mesh_dims(mesh)["data"]
    one, l_one, _, _ = _train_run(model, None, device, TRAIN_STEPS,
                                  batch_size, seq)
    one_bytes = sum(t.numel() * t.element_size() for t in _state_list(one))
    del one
    _free(device)
    mine, l_mesh, times, _ = _train_run(model, mesh, device, TRAIN_STEPS,
                                        batch_size, seq)
    mine_bytes = sum(t.numel() * t.element_size() for t in _state_list(mine))
    # the leaves "data" does not cut (the 1-D ones, biases): whole on
    # every data rank, with their moments
    whole = sum(3 * p.numel() * p.element_size()
                for p in leaves(mine.params)
                if "data" not in repr(held_of(p)))
    del mine
    _free(device)
    return {"losses": l_mesh, "losses_one": l_one,
            "rel": max(abs(a - b) / abs(a) for a, b in zip(l_one, l_mesh)),
            "bytes": mine_bytes, "bytes_one": one_bytes,
            "bytes_bound": one_bytes / dp + whole,
            "ms": statistics.median(times) * 1e3}


def _gap_run(model, mesh, device, batch_size, seq):
    """The fp32 runs that trace the mesh's parameter gap to the gradients
    (module doc of the card tests): {floor, floor_det, grad_gap, routes,
    routes_same, loss_rel, step1, after, params_gap}."""
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models.layers import record_routes
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.serving.engine import _slices
    from repro_torch.sharding.activation import held_of
    from repro_torch.training import steps as S_

    lr = AdamWConfig().lr
    out = {}
    batch = SyntheticLMDataset(model.cfg.vocab_size, seq, batch_size,
                               seed=0).batch(0)
    one = S_.make_train_state(model, _card_gen(device))
    b_one = device_put_batch(batch, device)
    # (a) the one-device gradients twice as the card runs by default, (b)
    # twice under deterministic algorithms
    for key, det in (("floor", False), ("floor_det", True)):
        torch.use_deterministic_algorithms(det)
        _, _, g_a = S_._grads(model, one.params, b_one)
        _, _, g_b = S_._grads(model, one.params, b_one)
        out[key] = _tree_gap(g_a, g_b)
        del g_a, g_b
    # (c) the mesh's step-1 gradients, each rank's shards against their
    # blocks of one device's; (d) the routing, forward and remat recompute
    shards = S_.train_shards(model, mesh)
    mine = S_.make_train_state(model, _card_gen(device), mesh=mesh)
    b_mesh = device_put_batch(batch, device, S_.batch_specs(model, mesh),
                              shards)

    def block(full, local):
        return full[_slices(full.shape, held_of(local), shards)]

    with record_routes() as r_one:
        _, _, g1 = S_._grads(model, one.params, b_one)
    with record_routes() as r_mesh:
        _, _, g2 = S_._grads(model, mine.params, b_mesh, shards)
    g_scale = max(float(g.abs().max()) for g in g1)
    out["grad_gap"] = _tree_gap(
        [block(g, p) for g, p in zip(g1, leaves(mine.params))], g2, g_scale)
    out["routes"] = len(r_mesh)
    out["routes_same"] = _routes_same(r_one, r_mesh, shards)
    del one, mine, g1, g2, r_one, r_mesh
    _free(device)

    # TRAIN_STEPS steps each, AdamW's first step held entry by entry
    one, l_one, _, (p1, g1, n1) = _train_run(model, None, device,
                                             TRAIN_STEPS, batch_size, seq,
                                             first=True)
    mine, l_mesh, _, (p2, g2, n2) = _train_run(model, mesh, device,
                                               TRAIN_STEPS, batch_size, seq,
                                               first=True)
    out["loss_rel"] = max(abs(a - b) / abs(a) for a, b in zip(l_one, l_mesh))
    # the clip's global norm (`optim/adamw.py:global_norm` over the cuts)
    out["gnorm"] = float(n1)
    out["gnorm_rel"] = abs(float(n2) - float(n1)) / float(n1)
    clip = torch.clamp(AdamWConfig().clip_norm / (n1 + 1e-9), max=1.0)
    p_scale = max(float(p.abs().max()) for p in p1)
    out["step1"] = attribute_step1(
        [(block(a, lay), b, block(ga, lay), gb) for a, b, ga, gb, lay in
         zip(p1, p2, g1, g2, leaves(mine.params))], p_scale, lr, clip)
    del p1, p2, g1, g2
    pairs = [(block(a.detach(), b), b.detach()) for a, b in zip(
        leaves(one.params), leaves(mine.params))]
    p_scale = max(float(a.detach().abs().max()) for a in leaves(one.params))
    diffs = torch.cat([(b.float() - a.float()).abs().reshape(-1)
                       for a, b in pairs])
    out["after"] = {"steps": TRAIN_STEPS,
                    "off": int((diffs > 1e-5 * p_scale).sum()),
                    "gap": float(diffs.max()), "bound": TRAIN_STEPS * 2 * lr}
    # the bar this check had: every entry within 1e-5 of the largest |p|
    out["params_gap"] = float(diffs.max()) / p_scale
    del one, mine, pairs, diffs
    _free(device)
    return out


def _published_train_cfg(arch, fp32):
    cfg = get_config(arch)
    if not fp32:
        return cfg
    return dataclasses.replace(cfg, n_layers=GAP_LAYERS,
                               compute_dtype="float32")


def _nccl_train_worker(device, out_dir, make_cfg=_published_train_cfg,
                       sizes=(TRAIN_B, TRAIN_S)):
    """One rank of an (n/2, 2) mesh ((2, 1) on two): NCCL, a card each,
    or gloo on the CPU.  For qwen1.5-0.5b and granite-moe-1b-a400m
    against one device on the rank's device, at `sizes` (batch,
    sequence): TRAIN_STEPS bf16 steps (`_bf16_run`), then the fp32 runs
    of `_gap_run`.  `make_cfg(arch, fp32)` gives the configs (by default
    the published ones, cut to GAP_LAYERS layers in fp32).  Writes this
    rank's results to `train_rank{r}.json`; the test holds them."""
    import faulthandler
    import json

    faulthandler.dump_traceback_later(TRAIN_JOIN - 60, exit=True)
    import torch.distributed as dist

    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = tmesh.make_local_mesh(1 if n == 2 else 2)
    out = {"mesh": repr(tmesh.mesh_dims(mesh)), "sizes": list(sizes)}
    try:
        for arch in TRAIN_ARCHS:
            torch.use_deterministic_algorithms(True)
            res = {"bf16": _bf16_run(build_model(make_cfg(arch, False)),
                                     mesh, device, *sizes)}
            res["fp32"] = _gap_run(build_model(make_cfg(arch, True)), mesh,
                                   device, *sizes)
            out[arch] = res
    finally:
        torch.use_deterministic_algorithms(False)
    with open(os.path.join(out_dir, f"train_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(out, f)


def _train_lines(runs):
    """The training checks over every rank's results: (lines, failures).

    bf16: losses within 1e-3 relative, each card's state bytes at most
    one device's over the data dim plus the leaves "data" does not cut.
    fp32: the step-1 gradients within 1e-5 of the largest |g| on every
    rank, their global norm within 1e-5 relative, the MoE's routing
    identical, losses within 1e-5 relative; after step 1 every parameter
    entry beyond 1e-5 of the largest |p| explained by its two gradients
    through AdamW's first step and within 2·lr (`attribute_step1`); after
    TRAIN_STEPS steps every entry within 2·lr a step."""
    lines, fails = [], []
    mesh, sizes = runs[0]["mesh"], tuple(runs[0]["sizes"])
    for arch in TRAIN_ARCHS:
        b = [r[arch]["bf16"] for r in runs]
        rel = max(x["rel"] for x in b)
        ok = rel <= 1e-3 and all(x["bytes"] <= x["bytes_bound"] for x in b)
        lines.append(f"{arch} bf16 {sizes} on {mesh}: "
                     f"losses {b[0]['losses']} within {rel:.3e} of one "
                     f"device's; state {[x['bytes'] for x in b]} B by card "
                     f"against {b[0]['bytes_one']} B on one (bound "
                     f"{max(x['bytes_bound'] for x in b):.0f}); step "
                     f"{b[0]['ms']:.2f} ms on rank 0")
        if not ok:
            fails.append(f"{arch} bf16: {b}")
        f = [r[arch]["fp32"] for r in runs]
        lines.append(
            f"{arch} fp32, {GAP_LAYERS} layers: one-device gradient noise "
            f"floor {[x['floor'] for x in f]} by card, "
            f"{[x['floor_det'] for x in f]} under deterministic algorithms; "
            f"step-1 gradients within {[x['grad_gap'] for x in f]} of the "
            f"largest |g| by rank (bar 1e-5), global norm {f[0]['gnorm']:.6g}"
            f" within {[x['gnorm_rel'] for x in f]}"
            + (f"; routing identical {[x['routes_same'] for x in f]} over "
               f"{f[0]['routes']} routings" if f[0]["routes"] else ""))
        lines.append(
            f"{arch} fp32: losses within {max(x['loss_rel'] for x in f):.3e};"
            f" after step 1 {[x['step1']['off'] for x in f]} entries beyond "
            f"1e-5 of the largest |p| by rank, of them at a rounding-level "
            f"gradient {[x['step1']['rounding'] for x in f]}, the largest "
            f"|g·clip| among them {[x['step1']['eps_x'] for x in f]} eps, "
            f"unexplained {[x['step1']['unexplained'] for x in f]}; largest "
            f"gap {[x['step1']['gap'] for x in f]}, left after AdamW's step "
            f"{[x['step1']['resid'] for x in f]}; after "
            f"{f[0]['after']['steps']} steps {[x['after']['off'] for x in f]}"
            f" entries beyond, largest gap {[x['after']['gap'] for x in f]} "
            f"(bound {f[0]['after']['bound']:.1e}), "
            f"{[x['params_gap'] for x in f]} of the largest |p|")
        for r, x in enumerate(f):
            if x["grad_gap"] > 1e-5:
                fails.append(f"{arch} rank {r}: step-1 gradients "
                             f"{x['grad_gap']:.3e} of the largest |g|")
            if x["gnorm_rel"] > 1e-5:
                fails.append(f"{arch} rank {r}: global norm "
                             f"{x['gnorm_rel']:.3e} relative")
            if x["routes"] and not x["routes_same"]:
                fails.append(f"{arch} rank {r}: routing differs")
            if x["loss_rel"] > 1e-5:
                fails.append(f"{arch} rank {r}: losses {x['loss_rel']:.3e}")
            if x["step1"]["unexplained"]:
                fails.append(f"{arch} rank {r}: after step 1 "
                             f"{x['step1']['unexplained']} entries "
                             f"unexplained, e.g. (leaf, |g_one|, leaf gap, "
                             f"|dp|, residual) {x['step1']['first']}")
            if x["after"]["gap"] > x["after"]["bound"]:
                fails.append(f"{arch} rank {r}: after {TRAIN_STEPS} steps "
                             f"a weight {x['after']['gap']:.3e} apart")
    return lines, fails


@pytest.mark.gpu
def test_one_nccl_rank_trains_as_one_device(tmp_path):
    """World size 1 on NCCL, a (1, 1) mesh under deterministic algorithms:
    reduced qwen1.5-0.5b and granite-moe (ZeRO rules, fp32, 3 steps) give
    the one-device steps' losses and state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `pytest -m gpu` on the H100)")
    from repro_torch.models import build_model

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    tmesh.join("cuda", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        mesh = tmesh.make_local_mesh(1)
        for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m"):
            model = build_model(get_config(arch).reduced(
                compute_dtype="float32", zero_shard=True, scan_layers=True))
            one, l_one, _, _ = _train_run(model, None, "cuda", 3, 4, 64)
            mine, l_mesh, _, _ = _train_run(model, mesh, "cuda", 3, 4, 64)
            assert l_one == l_mesh, arch
            assert all(torch.equal(a, b) for a, b in zip(
                _state_list(one), _state_list(mine))), arch
    finally:
        torch.use_deterministic_algorithms(False)
        tmesh.leave()


@pytest.mark.gpu
def test_training_across_nccl_ranks(tmp_path):
    """Every card one NCCL rank (an even count, 2 or more): qwen1.5-0.5b
    and granite-moe trained on an (n/2, 2) mesh ((2, 1) on two) against
    one device under deterministic algorithms (`_nccl_train_worker`,
    held by `_train_lines`)."""
    import json

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2 \
            or torch.cuda.device_count() % 2:
        pytest.skip("needs an even number of CUDA cards, 2 or more")
    # cuBLAS reads it when CUDA starts: set before the ranks are spawned
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    n = torch.cuda.device_count()
    tmesh.spawn(_nccl_train_worker, n, tmp_path / "store", str(tmp_path),
                join_timeout=TRAIN_JOIN)
    runs = [json.loads((tmp_path / f"train_rank{r}.json").read_text())
            for r in range(n)]
    lines, fails = _train_lines(runs)
    print("\n".join(lines))
    assert not fails, fails


def _small_train_cfg(arch, fp32):
    """The train configs at a small width with the published ones' cuts
    on (2, 2): every head dim, ffn and expert count even, and granite's
    vocab odd (whole over "model", the embed dim cut over "data")."""
    over = dict(n_layers=GAP_LAYERS, d_model=128, n_heads=4, head_dim=32,
                d_ff=256, loss_chunk=32, attn_chunk=32,
                compute_dtype="float32" if fp32 else "bfloat16")
    if arch.startswith("granite"):
        over.update(vocab_size=515, n_kv_heads=2, n_experts=4,
                    experts_per_token=2, d_expert=64, moe_group_size=64)
    else:
        over.update(vocab_size=512, n_kv_heads=4)
    return dataclasses.replace(get_config(arch), **over)


def test_training_checks_on_gloo_ranks(tmp_path):
    """`_nccl_train_worker` on a (2, 2) mesh of four gloo ranks at a small
    width with the published cuts (`_small_train_cfg`), (8, 32): every
    check the card test makes holds (`_train_lines`)."""
    import json

    tmesh.spawn(_nccl_train_worker, 4, tmp_path / "store", str(tmp_path),
                _small_train_cfg, (8, 32), device_type="cpu",
                join_timeout=SPAWN_TIMEOUT)
    runs = [json.loads((tmp_path / f"train_rank{r}.json").read_text())
            for r in range(4)]
    lines, fails = _train_lines(runs)
    assert not fails, (fails, lines)


CLI_STEPS, CLI_CKPT, CLI_FAIL = 12, 6, 9


@pytest.mark.gpu
def test_training_cli_resumes_across_nccl_ranks(tmp_path):
    """`launch.train --nproc 4 --model-axis 2` on four cards, qwen1.5-0.5b
    at (8, 512): a crash at step 9 resumed from the step-6 checkpoint
    gives the uninterrupted run's losses bit for bit (the CLI runs
    deterministically on the card); both runs exit 0."""
    import json
    import statistics
    import subprocess
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(repo, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen1.5-0.5b", "--nproc", "4", "--model-axis", "2", "--device",
            "cuda", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--steps", str(CLI_STEPS), "--ckpt-every", str(CLI_CKPT)]
    runs = {}
    for name, extra in (("crash", ["--fail-at", str(CLI_FAIL)]),
                        ("clean", [])):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run(
            argv + extra + ["--ckpt-dir", str(tmp_path / f"ck_{name}"),
                            "--metrics-out", str(out)],
            capture_output=True, text=True, timeout=CLI_TIMEOUT, env=env)
        if proc.returncode:  # the ranks' tracebacks, whole
            print(f"{name} run: exit {proc.returncode}\n{proc.stdout[-3000:]}"
                  f"\n{proc.stderr[-12000:]}")
        assert proc.returncode == 0, name
        assert proc.stdout.count(
            "devices=4 mesh={'data': 2, 'model': 2}") == 1, proc.stdout
        runs[name] = json.loads(out.read_text())["metrics"]
    crash = [m["loss"] for m in runs["crash"]]
    clean = [m["loss"] for m in runs["clean"]]
    # the crashed run: steps 0..8, then 6..11 again from the checkpoint
    assert len(clean) == CLI_STEPS
    assert len(crash) == CLI_FAIL + CLI_STEPS - CLI_CKPT
    assert crash[:CLI_FAIL] == clean[:CLI_FAIL]
    assert crash[CLI_FAIL:] == clean[CLI_CKPT:]
    ms = statistics.median(m["step_time_s"] for m in runs["clean"][1:]) * 1e3
    print(f"launch.train --nproc 4 --model-axis 2 qwen1.5-0.5b ({TRAIN_B}, "
          f"{TRAIN_S}): the crash at step {CLI_FAIL} resumed from step "
          f"{CLI_CKPT} gives the uninterrupted run's {CLI_STEPS} losses bit "
          f"for bit ({clean[0]:.6f} -> {clean[-1]:.6f}); step {ms:.2f} ms "
          f"(median of steps 2..{CLI_STEPS}, rank 0)")


# ------------------------------------------------ the attribution on the CPU

def _planted(case, lr=3e-4):
    """One leaf, its step-1 gradients on both sides and the weights the
    port's AdamW step gives them (no clip), with a planted gap: "flip",
    the sign of a rounding-level gradient flipped; "near_eps", a gradient
    at eps, above its leaf's gradient gap, 20% larger on the mesh; "big",
    a weight moved at a large gradient; "far", a flipped weight moved on
    beyond 2·lr."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import AdamWState, adamw_update

    gen = torch.Generator().manual_seed(0)
    g_one = torch.randn(64, generator=gen)
    g_one[:4] = torch.tensor([3e-8, -2e-8, 1e-8, 0.0])  # at eps and below
    g_mesh = g_one + 1e-9 * torch.randn(64, generator=gen)
    g_mesh[:4] = g_one[:4]
    p0 = torch.randn(64, generator=gen) * 0.02

    def adamw(g):
        p = [p0.clone()]
        state = AdamWState(step=torch.zeros((), dtype=torch.int32),
                           m=[torch.zeros(64)], v=[torch.zeros(64)])
        adamw_update([g], state, p, AdamWConfig(lr=lr, clip_norm=1e9))
        return p[0]

    if case in ("flip", "far"):
        g_mesh[0] = -g_one[0]
    if case == "near_eps":
        g_mesh[2] = 1.2 * g_one[2]
    p_one, p_mesh = adamw(g_one), adamw(g_mesh)
    if case == "big":
        p_mesh[10] += 5e-4
    if case == "far":
        p_mesh[0] += 3 * lr
    return [(p_one, p_mesh, g_one, g_mesh)], float(p0.abs().max()), lr, 1.0


@pytest.mark.parametrize("case", ["flip", "near_eps", "big", "far"])
def test_step1_attribution_of_planted_gaps(case):
    """`attribute_step1` explains a sign flip at a rounding-level gradient
    (within 2·lr) and a gradient at eps that differs by 20% (AdamW's
    first step is linear there), and fails a gap at a large gradient and
    a gap beyond 2·lr."""
    res = attribute_step1(*_planted(case))
    assert res["off"] == 1, res
    assert res["rounding"] == (1 if case in ("flip", "far") else 0), res
    if case in ("flip", "near_eps"):
        assert res["unexplained"] == 0 and res["gap"] <= 2 * 3e-4, res
    else:
        assert res["unexplained"] == 1 and len(res["first"]) == 1, res
