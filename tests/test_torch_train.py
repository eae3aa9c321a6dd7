"""The port's training side against the reference on the CPU: the loss
and its gradients per family, the state's layout and checkpoints, the
fault-tolerant loop, the CLI and the example.

Weights and states are the reference's (`Model.init`,
`make_train_state`), carried across by `bridge.lm_params_from_numpy` and
`bridge.train_state_from_numpy`; batches are the reference's
`make_batch` or `SyntheticLMDataset` (the same numpy draws on both
sides).

Tolerances:
  * `Model.loss_fn` in fp32, reduced dense, MoE, SSM, hybrid and
    encoder-decoder models with their super-blocks scanned (so the
    reference rematerialises them and the port recomputes them under
    `torch.utils.checkpoint`) and the loss in two chunks: the loss within
    rel 1e-5 and every gradient leaf within 1e-4 of that leaf's largest
    |g| (`jax.value_and_grad(model.loss_fn, has_aux=True)`);
  * in bf16: the loss within 2e-2, or within the reference's own
    bf16-to-fp32 distance where that is larger;
  * padded experts and padded heads get exactly zero gradient;
  * the loop: a crash and resume gives the uninterrupted run's bits;
    checkpoints cross between the packages byte for byte, and a resumed
    reference checkpoint continues with the reference's losses within
    rel 1e-5.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (_numpy_leaf,  # noqa: E402
                                lm_config_from_fields, lm_params_from_numpy,
                                train_state_from_numpy)
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_checkpoint, tree_leaves)
from repro_torch.checkpoint.store import host_leaves  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLMDataset,  # noqa: E402
                                       device_put_batch)
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import elastic, train as ttrain  # noqa: E402
from repro_torch.models import Model, trainable  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.training.loop import (TrainLoop,  # noqa: E402
                                       TrainLoopConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 64
FAMILIES = ["qwen1.5-0.5b", "granite-moe-1b-a400m", "mamba2-2.7b",
            "recurrentgemma-2b", "whisper-tiny"]


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
    from repro import checkpoint, configs
    from repro.configs.inputs import make_batch
    from repro.data.pipeline import SyntheticLMDataset as JData
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.models.params import is_def
    from repro.optim import AdamWConfig as JAdam
    from repro.training import loop, steps

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, make_batch=make_batch,
        Data=JData, mesh=make_local_mesh, build_model=build_model,
        is_def=is_def, Adam=JAdam, loop=loop, steps=steps,
        checkpoint=checkpoint)


def _np_init(jx, jm, seed=0):
    """The reference's parameter pytree drawn with numpy as its `init`
    draws it (normal × scale, ones, zeros), without its eager per-leaf
    jax.random calls."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        fan_in = d.shape[0] if len(d.shape) == 1 else \
            int(np.prod(d.shape[:-1]))
        scale = d.scale if d.scale is not None else 1 / np.sqrt(fan_in)
        return (scale * rng.normal(size=d.shape)).astype(np.float32)

    return jx.jax.tree.map(one, jm.defs(), is_leaf=jx.is_def)


def _path(name):
    return tuple(int(k) if k.isdigit() else k for k in name.split("."))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(jx, arch, dtype, **over):
    jc = jx.configs.get_config(arch).reduced(
        compute_dtype=dtype, scan_layers=True, loss_chunk=SEQ // 2, **over)
    return jc, lm_config_from_fields(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def fp32_ref(jx):
    """Per arch: the reference's fp32 (loss, aux, grads), weights and batch,
    made once for this module."""
    made = {}

    def get(arch):
        if arch not in made:
            jc, tc = _cfgs(jx, arch, "float32")
            jm = jx.build_model(jc)
            params = _np_init(jx, jm)
            batch = jx.make_batch(jc, 2, SEQ, seed=3, kind="train")
            (loss, aux), grads = jx.jax.jit(jx.jax.value_and_grad(
                jm.loss_fn, has_aux=True))(
                    jx.jax.tree.map(jx.jnp.asarray, params), batch)
            made[arch] = types.SimpleNamespace(
                loss=float(loss), aux=float(aux),
                grads=jx.jax.tree.map(np.asarray, grads),
                params=params, batch=batch)
        return made[arch]

    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_fp32_loss_and_every_gradient_match_the_reference(jx, fp32_ref,
                                                          arch):
    ref = fp32_ref(arch)
    _, tc = _cfgs(jx, arch, "float32")
    assert tc.remat and tc.scan_layers
    params = trainable(lm_params_from_numpy(tc, ref.params))
    loss, aux = Model(tc).loss_fn(params,
                                  {k: _t(v) for k, v in ref.batch.items()})
    assert loss.dtype == aux.dtype == torch.float32
    assert abs(loss.item() - ref.loss) <= 1e-5 * abs(ref.loss)
    assert abs(aux.item() - ref.aux) <= 1e-5 * max(abs(ref.aux), 1e-30)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    for name, g in zip(names, grads):
        want = _numpy_leaf(ref.grads, _path(name), g.shape)
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(),
                                                   1e-30)
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_loss_matches_the_reference(jx, fp32_ref, arch):
    ref32 = fp32_ref(arch)
    jc, tc = _cfgs(jx, arch, "bfloat16")
    jm = jx.build_model(jc)
    want, _ = jx.jax.jit(jm.loss_fn)(
        jx.jax.tree.map(jx.jnp.asarray, ref32.params), ref32.batch)
    want = float(want)
    params = trainable(lm_params_from_numpy(tc, ref32.params))
    got, _ = Model(tc).loss_fn(params,
                               {k: _t(v) for k, v in ref32.batch.items()})
    tol = max(2e-2, abs(want - ref32.loss) / abs(ref32.loss))
    assert abs(got.item() - want) <= tol * abs(want), (got.item(), want)
    got.backward()  # the bf16 backward runs and reaches every leaf
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in params.parameters())


def test_loss_mask_matches_the_reference(jx, fp32_ref):
    ref = fp32_ref("qwen1.5-0.5b")
    jc, tc = _cfgs(jx, "qwen1.5-0.5b", "float32")
    mask = (np.arange(SEQ)[None, :] % 3 != 0).astype(np.float32).repeat(2, 0)
    mask[1, :] = 0.0  # a whole row masked out
    batch = dict(ref.batch, loss_mask=mask)
    want, _ = jx.build_model(jc).loss_fn(
        jx.jax.tree.map(jx.jnp.asarray, ref.params),
        jx.jax.tree.map(jx.jnp.asarray, batch))
    got, _ = Model(tc).loss_fn(lm_params_from_numpy(tc, ref.params),
                               {k: _t(v) for k, v in batch.items()})
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def _zero_grads_on_pads(cfg, batch_seq=24):
    model = Model(cfg)
    params = trainable(model.init(torch.Generator().manual_seed(0)))
    tok = torch.arange(2 * batch_seq, dtype=torch.int32).reshape(2, -1) % 128
    loss, _ = model.loss_fn(params, {"tokens": tok, "labels": (tok + 1) % 128})
    loss.backward()
    return params


def test_padded_experts_get_zero_gradient():
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced(
        expert_pad=8, compute_dtype="float32")
    params = _zero_grads_on_pads(cfg)
    for blk in params["tail"]:
        moe = blk["moe"]
        for name in ("w1", "w2", "w3"):
            g = moe[name].grad
            assert g[4:].abs().max().item() == 0.0, name
            assert g[:4].abs().max().item() > 0.0, name
        assert moe["router"].grad[:, 4:].abs().max().item() == 0.0
        assert moe["router"].grad[:, :4].abs().max().item() > 0.0


def test_padded_heads_get_zero_gradient():
    cfg = tconfigs.get_config("qwen2.5-32b").reduced(
        head_pad=6, compute_dtype="float32")   # 4 real heads over 2 groups
    params = _zero_grads_on_pads(cfg)
    for blk in params["tail"]:
        gq, go = blk["attn"]["wq"].grad, blk["attn"]["wo"].grad
        for pad in (2, 5):   # each kv group's third slot is padding
            assert gq[:, pad].abs().max().item() == 0.0
            assert go[pad].abs().max().item() == 0.0
        assert gq[:, 0].abs().max().item() > 0.0


def test_pallas_loss_has_no_backward_in_either_package(jx, fp32_ref):
    ref = fp32_ref("qwen1.5-0.5b")
    jc, tc = _cfgs(jx, "qwen1.5-0.5b", "float32", attn_impl="pallas")
    jm = jx.build_model(jc)
    with pytest.raises(AssertionError):
        jx.jax.value_and_grad(jm.loss_fn, has_aux=True)(
            jx.jax.tree.map(jx.jnp.asarray, ref.params), ref.batch)
    params = trainable(lm_params_from_numpy(tc, ref.params))
    batch = {k: _t(v) for k, v in ref.batch.items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        Model(tc).loss_fn(params, batch)
    with torch.no_grad():  # the forward alone runs (the kernel's plain form)
        loss, _ = Model(tc).loss_fn(params, batch)
    assert abs(loss.item() - ref.loss) <= 1e-5 * ref.loss


# ------------------------------------------------------------ the state ----
@contextlib.contextmanager
def _one_rank(tmp):
    """A (1, 1) (data, model) mesh of one gloo rank in this process."""
    from repro_torch.launch import mesh as tmesh

    tmesh.join("cpu", rank=0, world_size=1, store_file=tmp / "store")
    try:
        yield tmesh.make_local_mesh(1, "cpu")
    finally:
        tmesh.leave()


def test_state_layout_specs_and_microbatches_follow_the_reference(
        jx, tmp_path):
    jc, tc = _cfgs(jx, "granite-moe-1b-a400m", "float32")
    jm, tm = jx.build_model(jc), Model(tc)
    want = jx.steps.abstract_train_state(jm, compress=True)
    got = tsteps.abstract_train_state(tm, compress=True)
    wl = jx.jax.tree.leaves(want)
    gl = tree_leaves(got)
    assert [tuple(w.shape) for w in wl] == [
        (len(g),) + tuple(g[0].shape) if isinstance(g, list) else
        tuple(g.shape) for g in gl]
    assert all((g[0] if isinstance(g, list) else g).device.type == "meta"
               for g in gl)
    specs = tsteps.state_specs(tm, {"data": 2, "model": 2}, compress=True)
    assert specs.opt.m == specs.opt.v == specs.params
    assert specs.compress.residual == specs.params and specs.opt.step == ()
    for dims in ({"data": 1, "model": 1}, {"data": 4, "model": 2},
                 {"pod": 2, "data": 16, "model": 16}):
        mesh = types.SimpleNamespace(shape=dims)
        for batch, seq in ((8, 128), (256, 4096), (64, 32768)):
            for arch in ("qwen1.5-0.5b", "qwen2.5-32b"):
                jcfg = jx.configs.get_config(arch)
                assert tsteps.auto_microbatches(
                    tconfigs.get_config(arch), batch, seq, dims) == \
                    jx.steps.auto_microbatches(jcfg, batch, seq, mesh)
    # a step over ranks runs on their DeviceMesh: a {dim: size} dict of
    # two ranks raises; a (1, 1) mesh of one gloo rank runs the mesh path
    # (its collectives among one rank) with the one-device step's bits
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsteps.build_train_step(tm, {"data": 2, "model": 1}, AdamWConfig())
    batch = device_put_batch(SyntheticLMDataset(tc.vocab_size, 32, 2,
                                                seed=0).batch(0), "cpu")
    one = tsteps.make_train_state(tm, torch.Generator().manual_seed(0))
    step, _, _ = tsteps.build_train_step(tm, None, AdamWConfig())
    one, m_one = step(one, batch)
    with _one_rank(tmp_path) as mesh:
        mine = tsteps.make_train_state(tm, torch.Generator().manual_seed(0),
                                       mesh=mesh)
        step, sspecs, _ = tsteps.build_train_step(tm, mesh, AdamWConfig())
        mine, m_mesh = step(mine, batch)
        assert sspecs == tsteps.state_specs(tm, mesh)
        # one gradient collective per leaf over the batch dims
        assert sum(step.shards.grad_counts.values()) == len(
            list(mine.params.parameters()))
    assert torch.equal(m_one["loss"], m_mesh["loss"])
    assert _same_bits(one, mine)
    with pytest.raises(ValueError, match="in place"):
        tsteps.build_train_step(tm, None, AdamWConfig(), donate=False)


# ------------------------------------------------------------- the loop ----
def _small(arch="qwen1.5-0.5b"):
    return tconfigs.get_config(arch).reduced(compute_dtype="float32",
                                             scan_layers=True)


def _loop(tmp, name, cfg=None, **kw):
    cfg = cfg or _small()
    data = SyntheticLMDataset(cfg.vocab_size, 32, 2, seed=0)
    loop_cfg = TrainLoopConfig(ckpt_dir=str(tmp / name), **dict(
        dict(total_steps=8, ckpt_every=4), **kw))
    return TrainLoop(Model(cfg), None, AdamWConfig(), loop_cfg, data,
                     device="cpu")


def _same_bits(a, b):
    return all(np.array_equal(x, y) for x, y in
               zip(host_leaves(a), host_leaves(b)))


def test_crash_and_resume_give_the_uninterrupted_bits(tmp_path):
    clean = _loop(tmp_path, "clean")
    s_clean = clean.run_with_restarts()
    crashed = _loop(tmp_path, "crash", fail_at_step=6)
    s_crash = crashed.run_with_restarts()
    losses = [m["loss"] for m in crashed.metrics]
    # steps 0..5, the crash at 6, then 4..7 again from the step-4 save
    assert len(losses) == 10 and len(crashed.restart_s) == 1
    want = [m["loss"] for m in clean.metrics]
    assert losses == want[:6] + want[4:]
    assert _same_bits(s_crash, s_clean)
    assert sorted(os.listdir(tmp_path / "crash")) == [
        "step_00000004", "step_00000008"]
    assert want[-1] < want[0]


def test_corrupt_newest_step_falls_back_to_the_previous(tmp_path):
    loop = _loop(tmp_path, "ck", async_ckpt=False)
    loop.run()
    leaf = tmp_path / "ck" / "step_00000008" / "leaf_00003.npy"
    leaf.write_bytes(leaf.read_bytes()[:-8] + b"\0" * 8)
    again = _loop(tmp_path, "ck")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        step, state = again.resume_or_init()
    assert step == 4 and any("failed restore" in str(w.message)
                             for w in seen)
    want, _ = restore_checkpoint(str(tmp_path / "ck"), 4,
                                 tsteps.abstract_train_state(Model(_small())))
    assert _same_bits(state, want)
    # nothing restorable at all: a fresh state from the seed
    (tmp_path / "ck" / "step_00000004" / "manifest.json").write_text("{")
    step, _ = again.resume_or_init()
    assert step == 0


def test_checkpoints_cross_between_the_packages(jx, tmp_path):
    """A reference TrainLoop's step-4 checkpoint resumed by the port (same
    leaves, then the reference's next losses), and the port's final
    checkpoint restored by the reference: same leaves, same bytes."""
    jc, tc = _cfgs(jx, "qwen1.5-0.5b", "float32")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jdata = jx.Data(jc.vocab_size, 32, 2, seed=0)
    jm = jx.build_model(jc)

    class JitInit(type(jm)):
        """The reference's model with its init jitted (the same draws, one
        compile in place of one per leaf)."""

        def init(self, key):
            return jx.jax.jit(super().init)(key)

    jloop = jx.loop.TrainLoop(
        JitInit(jc), jx.mesh(), jx.Adam(), jx.loop.TrainLoopConfig(
            total_steps=6, ckpt_every=4, ckpt_dir=str(ref_dir),
            async_ckpt=False), jdata)
    jstate = jloop.run()
    os.makedirs(port_dir)
    os.rename(ref_dir / "step_00000004", port_dir / "step_00000004")
    from repro.checkpoint.store import load_leaves as jload

    port = TrainLoop(Model(tc), None, AdamWConfig(), TrainLoopConfig(
        total_steps=6, ckpt_every=4, ckpt_dir=str(port_dir)),
        SyntheticLMDataset(tc.vocab_size, 32, 2, seed=0), device="cpu")
    start, resumed = port.resume_or_init()
    assert start == 4
    for got, want in zip(host_leaves(resumed),
                         jload(str(port_dir), 4)[0]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    state = port.run(resumed, start)
    for got, want in zip(port.metrics, jloop.metrics[4:]):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]
    like = jx.jax.tree.map(np.asarray, jstate)
    back, _ = jx.checkpoint.restore_checkpoint(str(port_dir), 6, like)
    back = [np.asarray(x) for x in jx.jax.tree.leaves(back)]
    mine = host_leaves(state)
    assert len(back) == len(mine)
    for a, b in zip(back, mine):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_manager_snapshots_before_in_place_updates(tmp_path):
    """An async save holds the state as it was when save returned, though
    the caller then changes the tensors in place."""
    state = tsteps.make_train_state(Model(_small()),
                                    torch.Generator().manual_seed(0))
    before = host_leaves(state)
    ckpt = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    ckpt.save(1, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    ckpt.wait()
    back, _ = restore_checkpoint(str(tmp_path), 1, state)
    for a, b in zip(host_leaves(back), before):
        assert np.array_equal(a, b)


def test_train_loop_on_ranks_and_elastic_trainer(tmp_path, capsys):
    cfg = _small()
    # on ranks the loop takes their DeviceMesh (a dict of two raises); on
    # a (1, 1) mesh of one gloo rank it trains with the one-device bits
    with pytest.raises(TypeError, match="DeviceMesh"):
        TrainLoop(Model(cfg), {"data": 1, "model": 2}, AdamWConfig(),
                  TrainLoopConfig(ckpt_dir=str(tmp_path)),
                  SyntheticLMDataset(cfg.vocab_size, 32, 2), device="cpu")
    one = _loop(tmp_path, "one", total_steps=3, ckpt_every=2)
    s_one = one.run()
    with _one_rank(tmp_path) as mesh:
        ranks = TrainLoop(Model(cfg), mesh, AdamWConfig(), TrainLoopConfig(
            total_steps=3, ckpt_every=2, ckpt_dir=str(tmp_path / "mesh")),
            SyntheticLMDataset(cfg.vocab_size, 32, 2, seed=0), device="cpu")
        s_mesh = ranks.run()
    assert [m["loss"] for m in ranks.metrics] == \
        [m["loss"] for m in one.metrics]
    assert _same_bits(s_one, s_mesh)
    assert elastic.make_elastic_mesh(2) is None  # no process group
    trainer = elastic.ElasticTrainer(
        Model(cfg), AdamWConfig(), TrainLoopConfig(
            total_steps=3, ckpt_every=2, ckpt_dir=str(tmp_path / "el")),
        SyntheticLMDataset(cfg.vocab_size, 32, 2), device="cpu")
    loop, _ = trainer.run()
    assert len(loop.metrics) == 3
    loop, _ = trainer.run()   # the restart resumes the final step
    assert loop.metrics == []
    # without ranks --model-axis clamps to the one device, as the
    # reference's make_local_mesh does
    assert ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                        "cpu", "--model-axis", "2", "--steps", "3",
                        "--batch", "2", "--seq", "32", "--ckpt-dir",
                        str(tmp_path / "cli")]) == 0
    assert "devices=1 mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="need 256 devices"):
        ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                     "cpu", "--production-mesh"])


def test_cli_crash_restart_end_to_end(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"   # tiny shapes: threads only contend
    out = tmp_path / "metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "8",
         "--batch", "2", "--seq", "32", "--ckpt-every", "4",
         "--fail-at", "6", "--ckpt-dir", str(tmp_path / "ck"),
         "--metrics-out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "done: 10 steps" in proc.stdout
    assert "mesh={'data': 1, 'model': 1}" in proc.stdout


def test_train_lm_example_on_cpu(tmp_path, capsys):
    assert train_lm.main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                          str(tmp_path)]) == 0
    assert "M params" in capsys.readouterr().out
    cfg = train_lm.size_config("100m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (8, 768, 32768)
