"""Training over ranks on the CPU: the port's train step, loop, elastic
trainer and CLI on (data, model) meshes of gloo ranks, held to the port's
one-device step (which tests/test_torch_train.py holds to
`jax.value_and_grad` and to the reference's step).

Reduced configs in fp32 at (B, S) = (4, 32), super-blocks scanned (so
each is recomputed in the backward, its collectives again) and the loss
in two chunks; the MoE is granite-moe with 3 real experts padded to 4
(`expert_pad`), so the experts divide the model dim, once more with
its MoE groups the whole batch (a group spans the batch ranks).  Two
spawns, each
bounded by a join timeout: four ranks as a (2, 2) mesh under the ZeRO
rules, then two ranks as a (1, 2) mesh without ZeRO (every leaf whole
over "data") and as a (2, 1) mesh for the elastic resume.  Each rank
runs the one-device step on the same seed and batch and compares its
shards with the one-device tensors' blocks.

Held, per family (dense, MoE, SSM, hybrid, and the encoder-decoder
whisper-tiny with its frames) and mesh:
  * `Model.loss_fn` and its gradients: the loss within 1e-5 relative,
    every gradient shard within 1e-5 of the largest |g| of the whole
    gradient, and the MoE routing decisions (top-k indices and kept slots
    of every group, in the forward and the remat recompute) identical;
  * two train steps with 2 microbatches and top-k compression
    (`compress_frac` 0.25): losses within 1e-5 relative, parameters
    within 1e-5 of the largest |p|, m and v within 1e-5 of their largest
    |m| and |v|, and the residual within 1e-5 of the largest accumulated
    gradient of the last step (the residual is a part of the gradients
    and carries their rounding: its own largest entry is below the
    top-k threshold); for whisper-tiny all that but in at most 10
    entries of each tree (a top-k boundary entry or a rounding-level
    gradient: sent on one side only, or stepped the other way), each
    weight within 2·lr a step, as `tests/test_torch_optim.py` holds the
    port to the reference;
  * every rank's parameters, m, v, residual and gradient accumulator
    have exactly the local shape of the spec `state_specs` gives and are
    marked with it;
  * the collective counter: one gradient reduce-scatter a microbatch
    per leaf cut over "data", one gradient all_reduce a microbatch per
    leaf whole over it (none for a cut leaf).
The loop: on (2, 2) a crash at step 3 resumed from the step-2
checkpoint gives the uninterrupted run's bits; a run that crashes there
leaves its step-2 checkpoint, which restores bit for bit on a 2-rank
(2, 1) mesh, on one device (and rewritten there, byte for byte the same
files) and in the reference's `restore_checkpoint`; `ElasticTrainer` on
the 2 ranks resumes it and its losses are within 1e-5 relative of a
one-device run's.  `bridge.train_state_from_numpy(mesh=)` gives each
(2, 2) rank its blocks of the reference's train state, bit for bit.
Then `launch.train --nproc 2 --model-axis 2`.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.checkpoint.store import (host_leaves,  # noqa: E402
                                          load_leaves)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# "/span": granite-moe with MoE groups of the whole batch, so on (2, 2) a
# group spans both batch ranks (their tokens gathered, every rank routing
# every group and keeping its rows)
FAMILIES = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "granite-moe/span",
            "mamba2-2.7b", "recurrentgemma-2b", "whisper-tiny")
MESHES = {"d2m2": ((2, 2), True), "d1m2": ((1, 2), False)}
B, S, N_MB, FRAC = 4, 32, 2, 0.25
TOL = 1e-5
LOOP_STEPS, CKPT_EVERY, FAIL_AT = 4, 2, 3
SPAWN_TIMEOUT = 240


def _cfg(arch, zero=True):
    over = dict(compute_dtype="float32", zero_shard=zero, scan_layers=True,
                loss_chunk=16)
    if arch.startswith("granite-moe"):
        over.update(n_experts=3, expert_pad=4)
    if arch.endswith("/span"):
        arch = "granite-moe-1b-a400m"
        over.update(moe_group_size=B * S)
    return get_config(arch).reduced(**over)


def _rel_tree(pairs, scale=None):
    """max |got − want| over the (want, got) pairs, over `scale` (by
    default the largest |want| of the whole tree)."""
    err = max(float((g - w).abs().max()) for w, g in pairs)
    if scale is None:
        scale = max(float(w.abs().max()) for w, _ in pairs)
    return err / max(scale, 1e-30)


def _family(mesh, arch, zero):
    """The checks of one family on this rank (module doc): a dict of
    numbers and flags."""
    from repro_torch.data.pipeline import SyntheticLMDataset, device_put_batch
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.serving.engine import _slices, _spec_at
    from repro_torch.sharding.activation import held_of, is_model
    from repro_torch.training import steps as S_

    cfg = _cfg(arch, zero)
    model = Model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, S, B, seed=0)
    if cfg.is_encdec:  # the frames and tokens of `make_batch`
        from repro_torch.configs.inputs import make_batch

        data = type("Frames", (), {"batch": staticmethod(
            lambda i: {k: v.numpy() for k, v in make_batch(
                cfg, B, S, seed=i, kind="train", device="cpu").items()})})
    shards = S_.train_shards(model, mesh)
    bspecs = S_.batch_specs(model, mesh)
    one = S_.make_train_state(model, torch.Generator().manual_seed(0),
                              compress=True)
    mine = S_.make_train_state(model, torch.Generator().manual_seed(0),
                               compress=True, mesh=mesh)
    out = {}

    def block(full, local):
        return full[_slices(full.shape, held_of(local), shards)]

    # ---- loss, gradients, routing
    batch = data.batch(0)
    with L.record_routes() as r_one:
        l1, _, g1 = S_._grads(model, one.params,
                              device_put_batch(batch, "cpu"))
    with L.record_routes() as r_mesh:
        l2, _, g2 = S_._grads(model, mine.params, device_put_batch(
            batch, "cpu", bspecs, shards), shards)
    out["loss_rel"] = abs(float(l2) - float(l1)) / abs(float(l1))
    out["grad_err"] = _rel_tree([(block(g, p), gm) for p, g, gm in zip(
        leaves(mine.params), g1, g2)])
    d = shards.role(shards.batch_entry)[2] if shards.batch_entry else 0
    same = len(r_one) == len(r_mesh)
    for (t1, k1), (t2, k2) in zip(r_one, r_mesh):
        g = t2.shape[0]  # the rank's groups, or every group when they span
        if g < t1.shape[0]:
            t1, k1 = t1[d * g:(d + 1) * g], k1[d * g:(d + 1) * g]
        same &= torch.equal(t1, t2) and torch.equal(k1, k2)
    out["routes"] = len(r_mesh)
    out["routes_same"] = same

    # ---- two steps, 2 microbatches, compression
    step1, _, _ = S_.build_train_step(model, None, AdamWConfig(),
                                      compress_frac=FRAC, microbatches=N_MB)
    step2, specs, _ = S_.build_train_step(model, mesh, AdamWConfig(),
                                          compress_frac=FRAC,
                                          microbatches=N_MB)
    losses = []
    for i in range(2):
        b = data.batch(i)
        one, m1 = step1(one, device_put_batch(b, "cpu"))
        mine, m2 = step2(mine, device_put_batch(b, "cpu", bspecs, shards))
        losses.append(abs(float(m2["loss"]) - float(m1["loss"]))
                      / abs(float(m1["loss"])))
    out["step_loss_rel"] = max(losses)
    for name, a, b in (
            ("params", one.params, mine.params),
            ("m", one.opt.m, mine.opt.m), ("v", one.opt.v, mine.opt.v),
            ("residual", one.compress.residual, mine.compress.residual)):
        pairs = [(block(x, y), y.detach())
                 for x, y in zip(leaves(a), leaves(b))]
        # the residual (what compression held back) carries the
        # gradients' rounding: it is measured on their scale
        scale = max(float(g.abs().max()) for g in step1.accumulator) \
            if name == "residual" else None
        out[f"{name}_err"] = _rel_tree(pairs, scale)
        # the entries beyond TOL of that scale, and the largest difference
        big = scale or max(float(w.abs().max()) for w, _ in pairs)
        diffs = torch.cat([(g - w).abs().reshape(-1) for w, g in pairs])
        out[f"{name}_off"] = int((diffs > TOL * big).sum())
        out[f"{name}_off_max"] = float(diffs.max())

    # ---- layouts: every tensor the shard its spec gives
    want = {}
    for name, p in one.params.named_parameters():
        spec = tuple(_spec_at(specs.params, [
            int(k) if k.isdigit() else k for k in name.split(".")]))
        want[name] = (spec, shards.local_shape(p.shape, spec))
    ok = True
    for tree in (mine.params, mine.opt.m, mine.opt.v,
                 mine.compress.residual):
        for name, t in tree.named_parameters():
            spec, shape = want[name]
            ok &= tuple(held_of(t)) == spec and tuple(t.shape) == shape
    for (name, _), acc in zip(one.params.named_parameters(),
                              step2.accumulator):
        ok &= tuple(acc.shape) == want[name][1] and \
            acc.dtype == torch.float32
    out["layout_ok"] = ok

    # ---- the collective counter of the last step
    cut = sum(any(h is not None and not is_model(h) for h in held_of(p))
              for p in leaves(mine.params))
    whole = len(leaves(mine.params)) - cut
    out["cut_leaves"], out["whole_leaves"] = cut, whole
    out["grad_rs"] = shards.grad_counts["reduce_scatter"]
    out["grad_ar"] = shards.grad_counts["all_reduce"]
    out["step_rs"] = step2.shards.grad_counts["reduce_scatter"]
    out["step_ar"] = step2.shards.grad_counts["all_reduce"]
    return out


def _loop(model, mesh, ckpt_dir, **kw):
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig

    cfg = TrainLoopConfig(total_steps=LOOP_STEPS, ckpt_every=CKPT_EVERY,
                          ckpt_dir=ckpt_dir, **kw)
    data = SyntheticLMDataset(model.cfg.vocab_size, S, B, seed=0)
    return TrainLoop(model, mesh, AdamWConfig(), cfg, data, device="cpu")


def _state_bits(a, b):
    from repro_torch.optim.adamw import leaves

    return all(torch.equal(x, y) for x, y in zip(
        leaves(a.params) + leaves(a.opt.m) + leaves(a.opt.v),
        leaves(b.params) + leaves(b.opt.m) + leaves(b.opt.v))) and \
        torch.equal(a.opt.step, b.opt.step)


def _worker_d2m2(device, out_dir):
    """The (2, 2) spawn: the families, then the loops."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training.loop import _InjectedFailure

    shape, zero = MESHES["d2m2"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res = {}
    for arch in FAMILIES:
        for k, v in _family(mesh, arch, zero).items():
            res[f"{arch}/{k}"] = v
    model = Model(_cfg("qwen1.5-0.5b"))
    clean = _loop(model, mesh, os.path.join(out_dir, "clean"))
    s_clean = clean.run()
    crash = _loop(model, mesh, os.path.join(out_dir, "crash"),
                  fail_at_step=FAIL_AT)
    s_crash = crash.run_with_restarts()
    want = [m["loss"] for m in clean.metrics]
    res["resume_losses_equal"] = [m["loss"] for m in crash.metrics] == \
        want[:FAIL_AT] + want[CKPT_EVERY:]
    res["resume_bits"] = _state_bits(s_crash, s_clean)
    dead = _loop(model, mesh, os.path.join(out_dir, "elastic"),
                 fail_at_step=FAIL_AT)
    try:
        dead.run()
        res["crashed"] = False
    except _InjectedFailure:
        res["crashed"] = True
    dead.ckpt.wait()
    res["bridge_shards"] = _bridge_shards(mesh, out_dir)
    np.savez(os.path.join(out_dir, f"d2m2_rank{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})


def _bridge_shards(mesh, out_dir):
    """`bridge.train_state_from_numpy(mesh=)` on the reference's train
    state: every tensor the block of the one-device bridge's tensor that
    its spec gives the rank, bit for bit."""
    import pickle

    from repro_torch import bridge
    from repro_torch.serving.engine import _slices
    from repro_torch.sharding.activation import held_of
    from repro_torch.training.steps import train_shards

    with open(os.path.join(out_dir, "ref_state.pkl"), "rb") as f:
        fields, (params, step, m, v, residual) = pickle.load(f)
    cfg = bridge.lm_config_from_fields(fields)
    one = bridge.train_state_from_numpy(cfg, params, step, m, v, residual)
    mine = bridge.train_state_from_numpy(cfg, params, step, m, v, residual,
                                         mesh=mesh)
    shards = train_shards(Model(cfg), mesh)
    ok = torch.equal(one.opt.step, mine.opt.step)
    for a, b in ((one.params, mine.params), (one.opt.m, mine.opt.m),
                 (one.opt.v, mine.opt.v),
                 (one.compress.residual, mine.compress.residual)):
        for x, y in zip(a.parameters(), b.parameters()):
            ok &= torch.equal(x[_slices(x.shape, held_of(y), shards)], y)
    return ok and all(p.requires_grad for p in mine.params.parameters())


def _worker_two(device, out_dir):
    """The 2-rank spawn: the families on (1, 2), then on the (2, 1) mesh
    of `make_elastic_mesh` the step-2 checkpoint's restore and the
    elastic trainer's resume."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.elastic import ElasticTrainer, make_elastic_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.loop import TrainLoopConfig

    shape, zero = MESHES["d1m2"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res = {}
    for arch in FAMILIES:
        for k, v in _family(mesh, arch, zero).items():
            res[f"{arch}/{k}"] = v
    ck = os.path.join(out_dir, "elastic")
    model = Model(_cfg("qwen1.5-0.5b"))
    mesh21 = make_elastic_mesh(1, "cpu")
    res["elastic_mesh"] = str(tmesh.mesh_dims(mesh21))
    loop = _loop(model, mesh21, ck)
    start, state = loop.resume_or_init()
    whole = host_leaves(state, loop.shards)
    if dist.get_rank() == 0:
        raw, _ = load_leaves(ck, start)
        res["restored_bits"] = len(raw) == len(whole) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(raw, whole))
    res["restored_step"] = start
    from repro_torch.data.pipeline import SyntheticLMDataset

    trainer = ElasticTrainer(
        model, AdamWConfig(), TrainLoopConfig(
            total_steps=LOOP_STEPS, ckpt_every=CKPT_EVERY, ckpt_dir=ck),
        SyntheticLMDataset(model.cfg.vocab_size, S, B, seed=0),
        prefer_model=1, device="cpu")
    el_loop, _ = trainer.run()
    res["elastic_losses"] = [m["loss"] for m in el_loop.metrics]
    one = _loop(model, None, os.path.join(out_dir, f"one{dist.get_rank()}"))
    one.run()
    res["one_losses"] = [m["loss"] for m in one.metrics]
    np.savez(os.path.join(out_dir, f"two_rank{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})


def _reference_state(path):
    """The reference's train state of the reduced dense config (random
    parameters, one AdamW step's worth of random moments and residual),
    as numpy, pickled to `path` with the config's fields."""
    import dataclasses
    import pickle

    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import build_model as jbuild
    from repro.training.steps import make_train_state

    jc = jconfigs.get_config("qwen1.5-0.5b").reduced(
        compute_dtype="float32", zero_shard=True, scan_layers=True,
        loss_chunk=16)
    state = jax.jit(lambda k: make_train_state(jbuild(jc), k, compress=True))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state)
    rs = np.random.RandomState(1)

    def noise(t):
        return jax.tree.map(lambda a: rs.standard_normal(a.shape).astype(
            a.dtype), t)

    out = (tree.params, np.asarray(3, np.int32), noise(tree.opt.m),
           noise(tree.opt.v), noise(tree.compress.residual))
    with open(path, "wb") as f:
        pickle.dump((dataclasses.asdict(jc), out), f)


class Runs:
    """The two spawns, run once, in order (the second resumes the
    first's checkpoint)."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.ranks = None

    def get(self):
        if self.ranks is None:
            _reference_state(self.tmp / "ref_state.pkl")
            for fn, n, name in ((_worker_d2m2, 4, "d2m2"),
                                (_worker_two, 2, "two")):
                tmesh.spawn(fn, n, self.tmp / f"store_{name}",
                            str(self.tmp), device_type="cpu",
                            timeout=tmesh.datetime.timedelta(seconds=150),
                            join_timeout=SPAWN_TIMEOUT)
            self.ranks = {
                "d2m2": [dict(np.load(self.tmp / f"d2m2_rank{r}.npz"))
                         for r in range(4)],
                "d1m2": [dict(np.load(self.tmp / f"two_rank{r}.npz"))
                         for r in range(2)]}
        return self.ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(tmp_path_factory.mktemp("train_mesh"))


CASES = [(m, a) for m in MESHES for a in FAMILIES]
IDS = [f"{m}-{a}" for m, a in CASES]


@pytest.mark.parametrize("key,arch", CASES, ids=IDS)
def test_loss_and_gradients_match_one_device(runs, key, arch):
    for r, run in enumerate(runs.get()[key]):
        assert float(run[f"{arch}/loss_rel"]) <= TOL, (r, run[
            f"{arch}/loss_rel"])
        assert float(run[f"{arch}/grad_err"]) <= TOL, (r, run[
            f"{arch}/grad_err"])


@pytest.mark.parametrize("key,arch", [
    (m, a) for m in MESHES for a in FAMILIES if a.startswith("granite")])
def test_moe_routing_decisions_are_identical(runs, key, arch):
    for run in runs.get()[key]:
        # two MoE layers, routed in the forward and in the remat recompute
        assert int(run[f"{arch}/routes"]) == 4
        assert bool(run[f"{arch}/routes_same"])


@pytest.mark.parametrize("key,arch", CASES, ids=IDS)
def test_two_steps_with_microbatches_and_compression(runs, key, arch):
    for r, run in enumerate(runs.get()[key]):
        assert float(run[f"{arch}/step_loss_rel"]) <= TOL, r
        for what in ("params", "m", "v", "residual"):
            if arch == "whisper-tiny":
                # a few entries may differ: where the accumulated
                # gradient sits at the top-k threshold, or is
                # rounding-level (AdamW moves a weight by ~lr whatever
                # |g|), the two reduction orders may send it or not, or
                # step it the other way, as between the port and the
                # reference (tests/test_torch_optim.py, test_torch_train.py)
                assert int(run[f"{arch}/{what}_off"]) <= 10, (r, what)
            else:
                assert float(run[f"{arch}/{what}_err"]) <= TOL, (
                    r, what, run[f"{arch}/{what}_err"])
        if arch == "whisper-tiny":  # each weight within 2·lr a step
            assert float(run[f"{arch}/params_off_max"]) <= 2 * 2 * 3e-4


@pytest.mark.parametrize("key,arch", CASES, ids=IDS)
def test_every_rank_holds_its_state_specs_shard(runs, key, arch):
    for run in runs.get()[key]:
        assert bool(run[f"{arch}/layout_ok"])


@pytest.mark.parametrize("key,arch", CASES, ids=IDS)
def test_gradients_reach_the_shards_by_reduce_scatter(runs, key, arch):
    """ZeRO (2, 2): a reduce-scatter a microbatch for each leaf cut over
    "data" (the 1-D and the leaves no data dim divides are summed by an
    all_reduce); no ZeRO (1, 2): no leaf is cut, each is summed."""
    zero = MESHES[key][1]
    for run in runs.get()[key]:
        cut, whole = int(run[f"{arch}/cut_leaves"]), int(
            run[f"{arch}/whole_leaves"])
        assert (cut > 0) == zero
        assert int(run[f"{arch}/grad_rs"]) == cut
        assert int(run[f"{arch}/grad_ar"]) == whole
        assert int(run[f"{arch}/step_rs"]) == N_MB * cut
        assert int(run[f"{arch}/step_ar"]) == N_MB * whole


def test_bridge_gives_each_rank_its_shards_of_the_reference_state(runs):
    for run in runs.get()["d2m2"]:
        assert bool(run["bridge_shards"])


def test_crash_and_resume_on_a_mesh_give_the_uninterrupted_bits(runs):
    for run in runs.get()["d2m2"]:
        assert bool(run["resume_losses_equal"]) and bool(run["resume_bits"])


def test_mesh_checkpoint_restores_on_two_ranks_one_device_and_reference(
        runs, tmp_path):
    """The (2, 2) run's step-2 checkpoint: the 2-rank restore's leaves,
    gathered, are the files' bits; on one device the same, and written
    again from there, the same bytes; the reference's restore reads
    them."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.checkpoint.store import restore_checkpoint as jrestore
    from repro.models import build_model as jbuild
    from repro.training.steps import abstract_train_state as jabstract

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training.steps import abstract_train_state

    ranks = runs.get()
    assert all(bool(r["crashed"]) for r in ranks["d2m2"])
    assert int(ranks["d1m2"][0]["restored_step"]) == CKPT_EVERY
    assert bool(ranks["d1m2"][0]["restored_bits"])
    ck = str(runs.tmp / "elastic")
    raw, _ = load_leaves(ck, CKPT_EVERY)
    model = Model(_cfg("qwen1.5-0.5b"))
    state, _ = restore_checkpoint(ck, CKPT_EVERY, abstract_train_state(model))
    mine = host_leaves(state)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(raw, mine))
    CheckpointManager(str(tmp_path)).save(CKPT_EVERY, state)
    step_dir = f"step_{CKPT_EVERY:08d}"
    names = sorted(os.listdir(os.path.join(ck, step_dir)))
    assert names == sorted(os.listdir(tmp_path / step_dir))
    for name in names:
        assert (tmp_path / step_dir / name).read_bytes() == \
            open(os.path.join(ck, step_dir, name), "rb").read(), name
    jc = jconfigs.get_config("qwen1.5-0.5b").reduced(
        compute_dtype="float32", zero_shard=True, scan_layers=True,
        loss_chunk=16)
    back, _ = jrestore(ck, CKPT_EVERY, jabstract(jbuild(jc)))
    back = [np.asarray(x) for x in jax.tree.leaves(back)]
    assert len(back) == len(raw)
    assert all(np.array_equal(a, b) for a, b in zip(back, raw))


def test_elastic_trainer_resumes_on_fewer_ranks(runs):
    """(2, 2) crashed at step 3; two ranks as (2, 1) resume at step 2 and
    train steps 2 and 3 with the one-device run's losses."""
    for run in runs.get()["d1m2"]:
        assert str(run["elastic_mesh"]) == "{'data': 2, 'model': 1}"
        got, want = run["elastic_losses"], run["one_losses"]
        assert len(got) == LOOP_STEPS - CKPT_EVERY
        np.testing.assert_allclose(got, want[CKPT_EVERY:], rtol=TOL, atol=0)


def test_cli_trains_over_ranks(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "4",
         "--batch", "4", "--seq", "32", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu",
         "--nproc", "2", "--model-axis", "2"],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert out.count("devices=2 mesh={'data': 1, 'model': 2}") == 1
    assert out.strip().splitlines()[-1].startswith("done: 4 steps")
