"""The port's optimiser, data pipeline and train step against the
reference on the CPU.

Both packages start from the same numbers: parameter and gradient trees
drawn with numpy from a seed, or the reference's own `make_train_state`
carried across by `bridge.train_state_from_numpy`.

Tolerances:
  * `adamw_update`, 3 updates with clipping active and a cosine
    schedule: parameters, moments, grad norm and lr within 1e-6 of each
    leaf's largest value (the global norm sums its leaves in another
    order);
  * `cosine_warmup`: the warmup steps and the clamped tail bit for bit;
    on the cosine part within rel 5e-7 (torch's fp32 `cos` and XLA's
    differ by one ulp at some arguments; the schedule's affine map then
    carries that to at most two ulps of the lr);
  * `topk_compress_update` on trees with planted ties: masks identical,
    residuals exact;
  * `SyntheticLMDataset`: batches identical;
  * `build_train_step`, 3 fp32 steps on one device for 1 and 2
    microbatches, with and without compression: losses and grad norms
    within rel 1e-5, final parameters within 1e-5 of the tree's largest
    |p|.  With compression a few entries whose |g + r| sits at the k-th
    largest value may fall on the other side of the threshold under
    fp32 rounding: at most 10 entries of the tree may then differ, each
    by at most 2·lr a step.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import (_numpy_leaf,  # noqa: E402
                                lm_config_from_fields,
                                train_state_from_numpy)
from repro_torch.core import PlantedSpec  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher,  # noqa: E402
                                       SyntheticLMDataset,
                                       TensorChunkLoader, device_put_batch)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, compress_init, cosine_warmup,
                               topk_compress_update)
from repro_torch.optim.compression import _topk_mask  # noqa: E402
from repro_torch.training.steps import build_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these shapes are tiny, and threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (JAX imported here, not at module level)."""
    jax = pytest.importorskip("jax")
    from repro import configs, optim
    from repro.data.pipeline import SyntheticLMDataset as JData
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.models.params import is_def
    from repro.optim import compression
    from repro.training import steps

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, optim=optim,
        compression=compression, Data=JData, mesh=make_local_mesh,
        build_model=build_model, is_def=is_def, steps=steps)


def _path(name):
    return tuple(int(k) if k.isdigit() else k for k in name.split("."))


def _pairs(tree, ref):
    """(name, port tensor, reference numpy leaf) over the port's tree."""
    for name, p in tree.named_parameters():
        yield name, p.detach().numpy(), _numpy_leaf(ref, _path(name),
                                                    p.shape)


# a tree with a nested dict, a stacked block and a tuple, as models have
DEFS = {
    "embed": TP.ParamDef((12, 8), ("vocab", "embed")),
    "norm": {"scale": TP.ParamDef((8,), ("embed",))},
    "layers": TP.Stacked({"k0": {"w": TP.ParamDef((8, 6), ("embed", "ffn")),
                                 "b": TP.ParamDef((6,), ("ffn",))}}, 2),
    "tail": ({"w": TP.ParamDef((6, 8), ("ffn", "embed"))},),
}


def _stack(layers):
    """The reference's stacked block from per-layer dicts."""
    if isinstance(layers[0], dict):
        return {k: _stack([d[k] for d in layers]) for k in layers[0]}
    return np.stack(layers)


def _ref_of(tree):
    """The reference's pytree (numpy) of a port parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    if isinstance(tree, TP.LayerStack):
        return _stack([_ref_of(t) for t in tree])
    if isinstance(tree, torch.nn.ModuleList):
        return tuple(_ref_of(t) for t in tree)
    return {k: _ref_of(tree[k])
            for k in list(tree._parameters) + list(tree._modules)}


def _trees(seed, scale=1.0, ties=False):
    """(port ParamTree, reference pytree of numpy) with the same values:
    normal draws, or with `ties` each magnitude at least twice: a leaf's
    second half the negated first half, whose first quarter repeats its
    second quarter."""
    rng = np.random.default_rng(seed)

    def leaf(d, _):
        a = (scale * rng.normal(size=d.shape)).astype(np.float32)
        if ties:
            flat = a.reshape(-1)
            half, q = flat.size // 2, flat.size // 4
            flat[:q] = flat[q:2 * q]
            flat[half:2 * half] = -flat[:half]
        return torch.from_numpy(a)

    tree = TP.build(DEFS, leaf)
    return tree, _ref_of(tree)


def test_tree_helper_matches_the_reference_layout():
    tree, ref = _trees(0)
    for name, got, want in _pairs(tree, ref):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert isinstance(tree["layers"], TP.LayerStack)


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_three_updates_match_the_reference(jx, schedule):
    params, jparams = _trees(1)
    kw = dict(lr=1e-2, clip_norm=0.5, weight_decay=0.1)
    sched = (cosine_warmup(1e-2, 2, 5), jx.optim.cosine_warmup(1e-2, 2, 5)) \
        if schedule else (None, None)
    tcfg = AdamWConfig(schedule=sched[0], **kw)
    jcfg = jx.optim.AdamWConfig(schedule=sched[1], **kw)
    tstate, jstate = adamw_init(params), jx.optim.adamw_init(jparams)
    jp = jx.jax.tree.map(jx.jnp.asarray, jparams)
    update = jx.jax.jit(jx.optim.adamw_update, static_argnums=3)
    for i in range(3):
        grads, jgrads = _trees(10 + i, scale=3.0)
        jp, jstate, jm = update(jx.jax.tree.map(jx.jnp.asarray, jgrads),
                                jstate, jp, jcfg)
        params, tstate, tm = adamw_update(grads, tstate, params, tcfg)
        assert float(jm["grad_norm"]) > kw["clip_norm"]  # clipping active
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-6 * abs(float(jm[k])), k
    assert int(tstate.step) == int(jstate.step) == 3
    npj = jx.jax.tree.map(np.asarray, (jp, jstate.m, jstate.v))
    for tree, ref in zip((params, tstate.m, tstate.v), npj):
        for name, got, want in _pairs(tree, ref):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("args", [(1e-3, 3, 17), (3e-4, 10, 100, 0.2),
                                  (1.0, 0, 7)])
def test_cosine_warmup_every_step(jx, args):
    mine, ref = cosine_warmup(*args), jx.optim.cosine_warmup(*args)
    steps = range(args[2] + 3)
    got = np.array([float(mine(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    want = np.array([float(ref(jx.jnp.int32(s))) for s in steps],
                    np.float32)
    warm, total = args[1], args[2]
    exact = [s for s in steps if s < warm or s >= total]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


@pytest.mark.parametrize("frac", [0.05, 0.25])
def test_topk_compression_with_ties(jx, frac):
    """Masks identical and residuals exact over three steps, on trees
    whose magnitudes all come in tied pairs (the k-th value's ties are
    all kept, more than k entries, on both sides)."""
    params, jparams = _trees(2)
    tstate, jstate = compress_init(params), jx.optim.compress_init(jparams)
    mask = jx.jax.jit(jx.compression._topk_mask, static_argnums=1)
    update = jx.jax.jit(jx.optim.topk_compress_update, static_argnums=2)
    for i in range(3):
        grads, jgrads = _trees(20 + i, ties=True)
        for name, g, jg in _pairs(grads, jgrads):
            got = _topk_mask(torch.from_numpy(g), frac).numpy()
            want = np.asarray(mask(jx.jnp.asarray(jg), frac))
            np.testing.assert_array_equal(got, want, err_msg=name)
            k = max(1, int(g.size * frac))
            assert want.sum() >= k
        jsent, jstate = update(jx.jax.tree.map(jx.jnp.asarray, jgrads),
                               jstate, frac)
        sent, tstate = topk_compress_update(grads, tstate, frac)
        names = [n for n, _ in grads.named_parameters()]
        jsent = jx.jax.tree.map(np.asarray, jsent)
        for name, s in zip(names, sent):
            np.testing.assert_array_equal(
                s.numpy(), _numpy_leaf(jsent, _path(name), s.shape),
                err_msg=name)
        resid = jx.jax.tree.map(np.asarray, jstate.residual)
        for name, got, want in _pairs(tstate.residual, resid):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed,steps", [(0, (0, 1, 7)), (3, (0, 1000)),
                                        (12345, (5, 2**20))])
def test_synthetic_lm_batches_are_the_references(jx, seed, steps):
    mine = SyntheticLMDataset(vocab_size=512, seq_len=40, global_batch=3,
                              seed=seed)
    ref = jx.Data(vocab_size=512, seq_len=40, global_batch=3, seed=seed)
    np.testing.assert_array_equal(mine.templates, ref.templates)
    for step in steps:
        a, b = mine.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    it = iter(mine)
    np.testing.assert_array_equal(next(it)["tokens"], ref.batch(0)["tokens"])
    dev = device_put_batch(mine.batch(1), "cpu")
    assert dev["labels"].dtype == torch.int32
    np.testing.assert_array_equal(dev["labels"].numpy(),
                                  ref.batch(1)["labels"])


def test_prefetcher_and_tensor_chunk_loader():
    data = SyntheticLMDataset(vocab_size=64, seq_len=8, global_batch=2)
    pre = Prefetcher((data.batch(i) for i in range(3)), device="cpu")
    got = list(pre)
    assert len(got) == 3
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      data.batch(i)["tokens"])
    spec = PlantedSpec.paper(12, 50.0)
    loader = TensorChunkLoader(spec, n_chunks=5, seed=3, device="cpu")
    full = loader.full_tensor()
    assert tuple(full.shape) == spec.shape
    assert torch.equal(full, TensorChunkLoader(spec, 5, seed=3,
                                               device="cpu").full_tensor())
    # the planted block carries the signal γ·w⊗u⊗v (w, u, v of norm 1)
    l = spec.cluster_sizes[0]
    assert full[:l, :l, :l].mean().item() > 50.0 / l ** 1.5 / 2


# --------------------------------------------------------- train step ----
STEPS, LR = 3, 3e-4


def _np_init(jx, jm, seed=0):
    """The reference's parameter pytree drawn with numpy as its `init`
    draws it (normal × scale, ones, zeros), without its eager per-leaf
    jax.random calls (one compile per leaf shape)."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init in ("zeros", "ones"):
            return np.full(d.shape, float(d.init == "ones"), np.float32)
        fan_in = d.shape[0] if len(d.shape) == 1 else \
            int(np.prod(d.shape[:-1]))
        scale = d.scale if d.scale is not None else 1 / np.sqrt(fan_in)
        return (scale * rng.normal(size=d.shape)).astype(np.float32)

    return jx.jax.tree.map(one, jm.defs(), is_leaf=jx.is_def)


@pytest.mark.parametrize("compress", [None, 0.1])
@pytest.mark.parametrize("n_mb", [1, 2])
def test_build_train_step_three_steps_match_the_reference(jx, n_mb,
                                                          compress):
    jc = jx.configs.get_config("qwen1.5-0.5b").reduced(
        compute_dtype="float32", n_layers=1, scan_layers=True)
    tc = lm_config_from_fields(dataclasses.asdict(jc))
    jm = jx.build_model(jc)
    params = _np_init(jx, jm)
    jstate = jx.steps.TrainState(
        params=params, opt=jx.optim.adamw_init(params),
        compress=(jx.optim.compress_init(params) if compress is not None
                  else None))
    fn, s_shard, _ = jx.steps.build_train_step(
        jm, jx.mesh(), jx.optim.AdamWConfig(lr=LR, clip_norm=0.5),
        compress_frac=compress, microbatches=n_mb)
    jstate = jx.jax.device_put(jstate, s_shard)  # one compile, not two
    npst = jx.jax.tree.map(np.asarray, jstate)
    tstate = train_state_from_numpy(
        tc, npst.params, npst.opt.step, npst.opt.m, npst.opt.v,
        None if compress is None else npst.compress.residual)
    step, sspecs, bspecs = build_train_step(
        Model(tc), None, AdamWConfig(lr=LR, clip_norm=0.5),
        compress_frac=compress, microbatches=n_mb)
    assert bspecs.keys() == {"tokens", "labels"}
    assert (sspecs.compress is None) == (compress is None)
    data = SyntheticLMDataset(jc.vocab_size, 32, 4, seed=1)
    for i in range(STEPS):
        jstate, jmet = fn(jstate, data.batch(i))
        tstate, tmet = step(tstate, device_put_batch(data.batch(i), "cpu"))
        for k in ("loss", "grad_norm", "lr", "aux"):
            want = float(jmet[k])
            assert abs(float(tmet[k]) - want) <= 1e-5 * abs(want), k
    assert int(tstate.opt.step) == STEPS
    ref = jx.jax.tree.map(np.asarray, jstate.params)
    pairs = list(_pairs(tstate.params, ref))
    top = max(np.abs(want).max() for _, _, want in pairs)
    diff = np.concatenate([np.abs(got - want).reshape(-1)
                           for _, got, want in pairs])
    off = diff > 1e-5 * top
    if compress is None:
        assert not off.any(), diff.max() / top
    else:
        assert off.sum() <= 10 and diff.max() <= 2 * LR * STEPS, \
            (off.sum(), diff.max())
