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
one-device engine and the one-device train step (bit for bit), and on
an even number of cards every card one rank of an (n/2, 2) mesh,
serving and training qwen1.5-0.5b and granite-moe at their published
widths against one device.
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


def _nccl_lm_worker(device, out_dir):
    """One NCCL rank of every card: reduced whisper-tiny (kernel route,
    fp32) and qwen1.5-0.5b on a (n/2, 2) mesh against the one-device
    engine on this rank's card; a mismatch raises."""
    import faulthandler

    # a rank stuck in a collective prints every thread's stack and exits,
    # so the spawn fails with the place it hung
    faulthandler.dump_traceback_later(240, exit=True)
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.inputs import make_batch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = tmesh.make_local_mesh(2)
    lines = []
    for arch, impl in (("whisper-tiny", "pallas"), ("qwen1.5-0.5b",
                                                    "chunked")):
        cfg = get_config(arch).reduced(compute_dtype="float32",
                                       attn_impl=impl)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        batch = make_batch(cfg, n, PROMPT, kind="serve", device=device)
        want = ServeEngine(model, params, n, PROMPT + GEN).generate(batch,
                                                                    GEN)
        eng = ServeEngine(model, params, n, PROMPT + GEN, mesh=mesh)
        eng.generate(batch, GEN)
        got = eng.generate(batch, GEN)
        assert eng.captures == 1 and torch.equal(got, want), arch
        eng.close()
        lines.append(f"{arch} {impl} on {tmesh.mesh_dims(mesh)}: tokens "
                     f"equal the one-device engine's, one decode graph")
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "nccl_lm.txt"), "w") as f:
            f.write("\n".join(lines))


@pytest.mark.gpu
def test_lm_serving_across_nccl_ranks(tmp_path):
    """Every card one NCCL rank (an even count, 2 or more), a (n/2, 2)
    (data, model) mesh: fp32 tokens equal to the one-device engine's, the
    decode step one CUDA graph holding collectives across the cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2 \
            or torch.cuda.device_count() % 2:
        pytest.skip("needs an even number of CUDA cards, 2 or more")
    tmesh.spawn(_nccl_lm_worker, torch.cuda.device_count(),
                tmp_path / "store", str(tmp_path), join_timeout=600)
    print((tmp_path / "nccl_lm.txt").read_text())


# ------------------------------------------------- training on the card

def _train_run(model, mesh, device, steps, batch_size, seq):
    """`steps` train steps from seed 0 on one device (mesh None) or on
    the mesh: (state, losses, step seconds after the first)."""
    import time

    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.steps import build_train_step, make_train_state

    data = SyntheticLMDataset(model.cfg.vocab_size, seq, batch_size, seed=0)
    state = make_train_state(
        model, torch.Generator(device=device).manual_seed(0), mesh=mesh)
    step, _, bspecs = build_train_step(model, mesh, AdamWConfig())
    losses, times = [], []
    for i in range(steps):
        b = device_put_batch(data.batch(i), device,
                             None if mesh is None else bspecs, step.shards)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, b)
        losses.append(met["loss"].item())
        times.append(time.perf_counter() - t)
    return state, losses, times[1:]


def _state_list(state):
    from repro_torch.optim.adamw import leaves

    return leaves(state.params) + leaves(state.opt.m) + leaves(state.opt.v)


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
            one, l_one, _ = _train_run(model, None, "cuda", 3, 4, 64)
            mine, l_mesh, _ = _train_run(model, mesh, "cuda", 3, 4, 64)
            assert l_one == l_mesh, arch
            assert all(torch.equal(a, b) for a, b in zip(
                _state_list(one), _state_list(mine))), arch
    finally:
        torch.use_deterministic_algorithms(False)
        tmesh.leave()


def _nccl_train_worker(device, out_dir):
    """One NCCL rank of every card, an (n/2, 2) mesh ((2, 1) on two):
    qwen1.5-0.5b and granite-moe at their published widths, (8, 512), 3
    bf16 steps against one device on this card (losses within 1e-3
    relative), each card's state bytes at most one device's over the
    data dim plus the leaves "data" does not cut; then 2
    layers of each in fp32 (losses within 1e-5 relative, parameters
    within 1e-5 of the largest |p|).  A mismatch raises."""
    import dataclasses
    import faulthandler
    import statistics

    faulthandler.dump_traceback_later(900, exit=True)
    import torch.distributed as dist

    from repro_torch.models import build_model
    from repro_torch.optim.adamw import leaves
    from repro_torch.serving.engine import _slices
    from repro_torch.sharding.activation import held_of
    from repro_torch.training.steps import train_shards

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    mesh = tmesh.make_local_mesh(1 if n == 2 else 2)
    dp = tmesh.mesh_dims(mesh)["data"]
    lines = []
    for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m"):
        model = build_model(get_config(arch))
        one, l_one, _ = _train_run(model, None, device, 3, 8, 512)
        one_bytes = sum(t.numel() * t.element_size()
                        for t in _state_list(one))
        del one
        torch.cuda.empty_cache()
        mine, l_mesh, times = _train_run(model, mesh, device, 3, 8, 512)
        rel = max(abs(a - b) / abs(a) for a, b in zip(l_one, l_mesh))
        mine_bytes = sum(t.numel() * t.element_size()
                         for t in _state_list(mine))
        # the leaves "data" does not cut (the 1-D ones, biases): whole
        # on every data rank, with their moments
        whole = sum(3 * p.numel() * p.element_size()
                    for p in leaves(mine.params)
                    if "data" not in repr(held_of(p)))
        assert rel <= 1e-3, (arch, rel)
        assert mine_bytes <= one_bytes / dp + whole, (arch, mine_bytes)
        ms = statistics.median(times) * 1e3
        lines.append(f"{arch} bf16 (8, 512) on {tmesh.mesh_dims(mesh)}: "
                     f"losses {l_mesh} within {rel:.3e} of one device's; "
                     f"state {mine_bytes} B a card against {one_bytes} B "
                     f"on one; step {ms:.2f} ms, "
                     f"{8 * 512 / n / ms * 1e3:.0f} tokens/s a card")
        del mine
        torch.cuda.empty_cache()
        small = build_model(dataclasses.replace(
            get_config(arch), n_layers=2, compute_dtype="float32"))
        one, l_one, _ = _train_run(small, None, device, 3, 8, 512)
        mine, l_mesh, _ = _train_run(small, mesh, device, 3, 8, 512)
        rel = max(abs(a - b) / abs(a) for a, b in zip(l_one, l_mesh))
        ts = train_shards(small, mesh)
        err = max(float((a[_slices(a.shape, held_of(b), ts)] - b).detach()
                        .abs().max()) for a, b in zip(leaves(one.params),
                                                      leaves(mine.params)))
        scale = max(float(a.detach().abs().max())
                    for a in leaves(one.params))
        assert rel <= 1e-5 and err <= 1e-5 * scale, (arch, rel, err)
        lines.append(f"{arch} fp32, 2 layers: losses within {rel:.3e}, "
                     f"parameters within {err / scale:.3e} of the largest "
                     f"|p|")
        del one, mine
        torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "nccl_train.txt"), "w") as f:
            f.write("\n".join(lines))


@pytest.mark.gpu
def test_training_across_nccl_ranks(tmp_path):
    """Every card one NCCL rank (an even count, 2 or more): qwen1.5-0.5b
    and granite-moe trained on an (n/2, 2) mesh ((2, 1) on two) against
    one device (`_nccl_train_worker`)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2 \
            or torch.cuda.device_count() % 2:
        pytest.skip("needs an even number of CUDA cards, 2 or more")
    tmesh.spawn(_nccl_train_worker, torch.cuda.device_count(),
                tmp_path / "store", str(tmp_path), join_timeout=1200)
    print((tmp_path / "nccl_train.txt").read_text())
