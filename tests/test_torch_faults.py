"""The port's checkpoints, injected faults and restores, on the CPU,
against the reference's (`tests/test_msc_faults.py`'s cases).

Held here:
- the checkpoint store: a leaf list round trip without a `like`, atomic
  overwrite with no `.tmp` left, a corrupt leaf skipped with a warning,
  the manifest-only `checkpoint_extra`, keep-last-k GC; each package's
  store reads the other's steps;
- `FaultInjector` counts and fires as the reference's; `fail_all_from`,
  `best_msc_shape` and `best_mesh_shape` on the reference's cases;
- the engine: a mid-solve checkpoint restores bit for bit (masks, d,
  sweeps); periodic checkpoints with GC; a corrupt newest step degrades
  to the previous one with a warning; policy overrides; transient chunk
  and refill failures retry (the refill's host bookkeeping rolled back)
  and give the uninterrupted bits; a persistent failure serves every
  request through `msc_sequential`; load is shed while a bucket recovers
  and the backoff delays the retry.  Every `ServeStats` counter of those
  runs equals the reference engine's under the same fault plan;
- across packages: a checkpoint the reference's engine wrote mid-solve
  restores in the port's engine and finishes with the reference's
  uninterrupted masks and sweeps (d within 3e-5 of the largest reference
  entry), and the reverse;
- one subprocess SIGKILLed after a chunk (`kill_after_chunk`), bounded by
  a timeout, restored here: the union of its results and the restored
  engine's is the uninterrupted run, bit for bit;
- across world sizes: a checkpoint written in one process restored on 2
  gloo ranks, and one written on 2 gloo ranks restored in one process
  (one spawn, with a join timeout), held to the reference's engine on the
  same mesh shapes (4 forced host devices in a subprocess): masks and
  sweeps identical, d within 3e-5.
The reference engine runs on a one-device mesh, einsum path, unless said.
"""
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import make_msc_mesh  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.launch.elastic import best_mesh_shape as jbest_mesh  # noqa: E402
from repro.launch.elastic import best_msc_shape as jbest_msc  # noqa: E402
from repro.serving import MSCContinuousEngine as JEngine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.store import (checkpoint_extra,  # noqa: E402
                                          gc_checkpoints, latest_restorable,
                                          load_leaves, restorable_steps,
                                          save_checkpoint)
from repro_torch.core import msc_sequential  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.elastic import (best_mesh_shape,  # noqa: E402
                                        best_msc_shape, restore_msc_engine)
from repro_torch.serving import MSCContinuousEngine  # noqa: E402
from repro_torch.serving.faults import (FaultInjector, FaultPlan,  # noqa: E402
                                        InjectedFault, LoadShedError,
                                        corrupt_checkpoint_leaf,
                                        fail_all_from)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 3e-5
SPAWN_TIMEOUT = 150
# the reference test's stream: four requests over the 16³ and 24³ buckets
GAMMAS = (90.0, 70.0, 30.0, 40.0)


def _jcfg():
    return JConfig(epsilon=3e-4, power_tol=1e-2)


def _cfg():
    return bridge.config_from_fields(dataclasses.asdict(_jcfg()))


def _mesh():
    return make_msc_mesh("flat", devices=jax.devices()[:1])


@functools.cache
def _stream():
    out = []
    for i in range(4):
        x = np.asarray(jplanted(jax.random.PRNGKey(i),
                                JSpec.paper(14 + i, GAMMAS[i])), np.float32)
        x.setflags(write=False)
        out.append(x)
    return tuple(out)


def _engine(**kw):
    return MSCContinuousEngine(_cfg(), slots=2, bucket_quantum=8,
                               device="cpu", **kw)


def _jengine(**kw):
    return JEngine(_mesh(), _jcfg(), slots=2, bucket_quantum=8, **kw)


def _host(res):
    return [(np.asarray(res[j].mask), np.asarray(res[j].d),
             int(res[j].power_iters_run)) for j in range(3)]


def _held(got, want, exact=False):
    for j in range(3):
        mask, d, sweeps = want[j]
        np.testing.assert_array_equal(np.asarray(got[j].mask), mask)
        assert int(got[j].power_iters_run) == sweeps, j
        gd = np.asarray(got[j].d, np.float64)
        if exact:
            np.testing.assert_array_equal(gd, d)
        else:
            assert np.abs(gd - d).max() <= TOL * max(np.abs(d).max(), 1e-30)


@functools.cache
def _port_ref():
    """The port's uninterrupted run of the stream."""
    return [_host(r) for r in _engine().run(list(_stream()))]


@functools.cache
def _jref():
    return [_host(r) for r in _jengine().run(list(_stream()))]


# ---------------------------------------------------- the store -------

def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(4, 3)).astype(np.float32),
            np.arange(6, dtype=np.int64)]


def test_store_round_trip_and_atomic_overwrite(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _leaves(), extra={"k": 1})
    leaves, extra = load_leaves(d, 5)
    assert extra == {"k": 1}
    for a, b in zip(_leaves(), leaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    save_checkpoint(d, 5, [torch.ones(2)] + _leaves(1)[1:])  # overwrite
    assert os.listdir(d) == ["step_00000005"]
    np.testing.assert_array_equal(load_leaves(d, 5)[0][0], np.ones(2))


def test_corrupt_leaf_skipped_with_warning(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _leaves(0))
    save_checkpoint(d, 2, _leaves(1), extra={"mesh": [["slice", 8]]})
    corrupt_checkpoint_leaf(d, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert restorable_steps(d) == [1]
    assert any("corrupt" in str(x.message) for x in w)
    assert latest_restorable(d) == 1
    assert restorable_steps(d, verify_sha=False) == [2, 1]
    with pytest.raises(IOError, match="integrity"):
        load_leaves(d, 2)
    assert checkpoint_extra(d, 2) == {"mesh": [["slice", 8]]}


def test_gc_keeps_newest_and_sweeps_tmp(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, _leaves(s))
    os.makedirs(tmp_path / "step_00000009.tmp")
    gc_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_each_store_reads_the_others_steps(tmp_path):
    save_checkpoint(str(tmp_path / "port"), 3, _leaves(), extra={"a": [1]})
    jstore.save_checkpoint(str(tmp_path / "ref"), 4, _leaves(2),
                           extra={"b": 2})
    for d, step, want, extra in ((tmp_path / "port", 3, _leaves(), {"a": [1]}),
                                 (tmp_path / "ref", 4, _leaves(2),
                                  {"b": 2})):
        for load in (load_leaves, jstore.load_leaves):
            leaves, got = load(str(d), step)
            assert got == extra
            for a, b in zip(want, leaves):
                np.testing.assert_array_equal(a, b)
    with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
        with open(tmp_path / "ref" / "step_00000004" / "manifest.json") as g:
            assert json.load(f)["treedef"] == json.load(g)["treedef"]


# ----------------------------------------------------- fault harness --

def test_fault_injector_counts_and_fires_as_the_references():
    plan = dict(fail_chunks=(1,), fail_refills=(0, 2))
    port, ref = FaultInjector(FaultPlan(**plan)), \
        jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    for kind in ("chunk", "refill", "chunk", "refill", "refill", "chunk",
                 "checkpoint"):
        got = want = None
        try:
            port.before(kind)
        except InjectedFault as e:
            got = str(e)
        try:
            ref.before(kind)
        except jfaults.InjectedFault as e:
            want = str(e)
        assert got == want
        port.after(kind)
    assert port.counts == ref.counts == {"chunk": 3, "refill": 3,
                                         "checkpoint": 1}
    assert fail_all_from(3, horizon=5) == (3, 4, 5, 6, 7) == \
        jfaults.fail_all_from(3, horizon=5)


@pytest.mark.parametrize("n,prefer", [(8, 1), (8, 2), (6, 4), (4, 8),
                                      (5, 0), (1, 3), (12, 5)])
def test_best_shapes_are_the_references(n, prefer):
    assert best_msc_shape(n, prefer) == jbest_msc(n, prefer)
    assert best_mesh_shape(n, max(prefer, 1)) == jbest_mesh(n,
                                                            max(prefer, 1))


def test_best_msc_shape_cases():
    assert best_msc_shape(8, 1) == (8, 1)
    assert best_msc_shape(8, 2) == (4, 2)
    assert best_msc_shape(6, 4) == (2, 3)
    assert best_msc_shape(4, 8) == (1, 4)
    assert best_msc_shape(5, 0) == (5, 1)


# ------------------------------------------- checkpoint and restore --

def _mid_solve(eng, ticks=3):
    rids = [eng.submit(t) for t in _stream()]
    got = {}
    for _ in range(ticks):
        got.update(eng.step())
    return rids, got


def _drain(eng, got):
    while eng.has_work():
        got.update(eng.step())
    return got


def test_mid_solve_checkpoint_restores_bit_identically(tmp_path):
    eng = _engine(checkpoint_dir=str(tmp_path), ckpt_every_chunks=0)
    rids, got = _mid_solve(eng)
    path = eng.checkpoint()
    assert os.path.basename(path) == f"step_{eng._total_chunks:08d}"
    meta = checkpoint_extra(str(tmp_path), eng._total_chunks)
    assert meta["dtype"] == "float32" and meta["mesh"] == [["slice", 1]]
    assert meta["cfg"] == dataclasses.asdict(_jcfg())
    eng2 = MSCContinuousEngine.restore(str(tmp_path), device="cpu")
    assert eng2.stats.restores == 1 and eng2.cfg == eng.cfg
    assert eng2.slots == eng.slots and eng2._tick == eng._tick
    _drain(eng2, got)
    assert sorted(got) == sorted(rids)
    for rid, want in zip(rids, _port_ref()):
        _held(got[rid], want, exact=True)


def test_periodic_checkpoints_and_gc(tmp_path):
    eng = _engine(checkpoint_dir=str(tmp_path), ckpt_every_chunks=1,
                  keep_checkpoints=2)
    out = eng.run(list(_stream()))
    assert eng.stats.checkpoints_written >= 3
    assert len([n for n in os.listdir(tmp_path)
                if not n.endswith(".tmp")]) <= 2
    for got, want in zip(out, _port_ref()):
        _held(got, want, exact=True)


def test_corrupt_newest_degrades_to_previous(tmp_path):
    eng = _engine(checkpoint_dir=str(tmp_path), ckpt_every_chunks=0,
                  keep_checkpoints=5)
    rids = [eng.submit(t) for t in _stream()]
    eng.step()
    p1 = eng.checkpoint()
    got = eng.step()
    p2 = eng.checkpoint()
    corrupt_checkpoint_leaf(str(tmp_path), int(os.path.basename(p2)[5:]))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng2 = MSCContinuousEngine.restore(str(tmp_path), device="cpu")
    assert any("failed" in str(x.message) for x in w)
    assert eng2._total_chunks == int(os.path.basename(p1)[5:])
    got = _drain(eng2, {})  # from the older step: every request again
    for rid, want in zip(rids, _port_ref()):
        _held(got[rid], want, exact=True)


def test_restore_without_checkpoint_raises_and_overrides_apply(tmp_path):
    with pytest.raises(FileNotFoundError, match="restorable"):
        MSCContinuousEngine.restore(str(tmp_path / "none"), device="cpu")
    eng = _engine(checkpoint_dir=str(tmp_path))
    for t in _stream()[:2]:
        eng.submit(t)
    eng.checkpoint()
    eng2 = MSCContinuousEngine.restore(str(tmp_path), device="cpu",
                                       ckpt_every_chunks=0, max_retries=7)
    assert eng2.ckpt_every_chunks == 0 and eng2.max_retries == 7
    eng3 = restore_msc_engine(str(tmp_path), device="cpu")
    assert eng3.mesh is None and eng3.stats.restores == 1


# ----------------------------------------------------- recovery policy --

PLANS = {
    "chunk": dict(fail_chunks=(1,)),
    "refill": dict(fail_refills=(1,)),
    "both": dict(fail_chunks=(2, 5), fail_refills=(3,)),
}


@functools.cache
def _jfaulted(name):
    eng = _jengine(retry_backoff_s=0.0, fault_injector=jfaults.FaultInjector(
        jfaults.FaultPlan(**PLANS[name])))
    out = eng.run(list(_stream()))
    return [_host(r) for r in out], dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_transient_failures_retry_and_match(name):
    """A failed refill rolls back its host bookkeeping (queues, slot map,
    staged admissions), so the retry plans the same refill again."""
    eng = _engine(retry_backoff_s=0.0,
                  fault_injector=FaultInjector(FaultPlan(**PLANS[name])))
    out = eng.run(list(_stream()))
    ref, ref_stats = _jfaulted(name)
    assert eng.stats.retries >= 1 and eng.stats.fallback_requests == 0
    for got, want, jwant in zip(out, _port_ref(), ref):
        _held(got, want, exact=True)
        _held(got, jwant)
    assert dataclasses.asdict(eng.stats) == ref_stats


def test_persistent_failure_falls_back_to_msc_sequential():
    plan = dict(fail_chunks=fail_all_from(0))
    eng = _engine(retry_backoff_s=0.0, max_retries=2,
                  fault_injector=FaultInjector(FaultPlan(**plan)))
    jeng = _jengine(retry_backoff_s=0.0, max_retries=2,
                    fault_injector=jfaults.FaultInjector(
                        jfaults.FaultPlan(**plan)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = eng.run(list(_stream()))
        jout = jeng.run(list(_stream()))
    assert any("sequential oracle" in str(x.message) for x in w)
    assert eng.stats.fallback_requests == len(_stream())
    assert eng.stats.evictions == 0
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    for t, got, jgot in zip(_stream(), out, jout):
        seq = msc_sequential(torch.from_numpy(np.array(t)), _cfg(),
                             device="cpu")
        _held(got, _host(seq), exact=True)
        _held(got, _host(jgot))
    # the bucket came back healthy: a new request goes through the table
    eng._faults = None
    (again,) = eng.run([_stream()[0]])
    _held(again, _port_ref()[0], exact=True)


def test_load_is_shed_during_recovery():
    eng = _engine(retry_backoff_s=0.0,
                  fault_injector=FaultInjector(FaultPlan(fail_chunks=(0,))))
    eng.submit(_stream()[0])
    eng.step()  # the injected failure: recovering
    with pytest.raises(LoadShedError, match="recovering"):
        eng.submit(_stream()[1])
    assert eng.stats.shed_requests == 1
    eng.step()  # the retry succeeds
    rid = eng.submit(_stream()[1])
    got = _drain(eng, {})
    assert rid in got


def test_backoff_delays_the_retry():
    import time

    eng = _engine(retry_backoff_s=30.0,
                  fault_injector=FaultInjector(FaultPlan(fail_chunks=(0,))))
    eng.submit(_stream()[0])
    eng.step()
    tb = next(iter(eng._tables.values()))
    assert tb.retry_at > time.monotonic()
    before = eng.stats
    assert eng.step() == {}
    assert eng.stats.dispatches == before.dispatches


# ------------------------------------------------- across packages ----

def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    jeng = _jengine(checkpoint_dir=str(tmp_path), ckpt_every_chunks=0)
    rids = [jeng.submit(t) for t in _stream()]
    got = {}
    for _ in range(3):
        got.update(jeng.step())
    jeng.checkpoint()
    eng = MSCContinuousEngine.restore(str(tmp_path), device="cpu")
    assert eng.stats.restores == 1 and eng.slots == 2
    _drain(eng, got)
    assert sorted(got) == sorted(rids)
    for rid, want in zip(rids, _jref()):
        _held(got[rid], want)


@dataclasses.dataclass
class _Mode:
    """One mode's result read back from a file."""
    mask: np.ndarray
    d: np.ndarray
    power_iters_run: int


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    eng = _engine(checkpoint_dir=str(tmp_path), ckpt_every_chunks=0)
    rids, got = _mid_solve(eng)
    eng.checkpoint()
    jeng = JEngine.restore(str(tmp_path), mesh=_mesh())
    assert jeng.stats.restores == 1
    _drain(jeng, got)
    assert sorted(got) == sorted(rids)
    for rid, want in zip(rids, _jref()):
        _held(got[rid], want)


# ------------------------------------------------ kill and resume -----

CHILD = r'''
import json, os, sys
import numpy as np, torch
from repro_torch.core import MSCConfig
from repro_torch.serving import MSCContinuousEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan
torch.set_num_threads(1)
plan, ckpt, inputs, outdir = (json.loads(sys.argv[1]), sys.argv[2],
                              sys.argv[3], sys.argv[4])
xs = np.load(inputs)
eng = MSCContinuousEngine(MSCConfig(epsilon=3e-4, power_tol=1e-2), slots=2,
                          bucket_quantum=8, device="cpu",
                          checkpoint_dir=ckpt, ckpt_every_chunks=2,
                          fault_injector=FaultInjector(FaultPlan(**plan)))
for i in range(len(xs.files)):
    eng.submit(xs["x%d" % i])
eng.checkpoint()
while eng.has_work():
    for rid, res in eng.step().items():
        np.savez(os.path.join(outdir, "rid_%d.npz" % rid),
                 **{"m%d_%s" % (j, k): np.asarray(getattr(res[j], k))
                    for j in range(3)
                    for k in ("mask", "d", "power_iters_run")})
raise SystemExit(7)  # the kill never fired
'''


def test_sigkilled_child_resumes_bit_identically(tmp_path):
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **{f"x{i}": x for i, x in enumerate(_stream())})
    ckpt, outdir = tmp_path / "ckpt", tmp_path / "out"
    outdir.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps({"kill_after_chunk": 2}),
         str(ckpt), str(inputs), str(outdir)], env=env, timeout=120,
        capture_output=True, text=True)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    got = {}
    for f in os.listdir(outdir):
        z = np.load(outdir / f)
        got[int(f[4:-4])] = [_Mode(z[f"m{j}_mask"], z[f"m{j}_d"],
                                   int(z[f"m{j}_power_iters_run"]))
                             for j in range(3)]
    eng = MSCContinuousEngine.restore(str(ckpt), device="cpu",
                                      ckpt_every_chunks=0)
    assert eng.stats.restores == 1
    _drain(eng, got)
    assert sorted(got) == [0, 1, 2, 3]
    for rid, want in enumerate(_port_ref()):
        _held(got[rid], want, exact=True)


# ---------------------------------------------- across world sizes ----

REF_MESHES = r'''
import json, sys
import numpy as np, jax
from repro.core import MSCConfig, make_msc_mesh
from repro.serving import MSCContinuousEngine
xs = np.load(sys.argv[1])
cfg = MSCConfig(epsilon=3e-4, power_tol=1e-2)
out = {}
for p in (1, 2):
    mesh = make_msc_mesh("flat", devices=jax.devices()[:p], shape=(p, 1))
    res = MSCContinuousEngine(mesh, cfg, slots=2, bucket_quantum=8).run(
        [xs["x%d" % i] for i in range(len(xs.files))])
    for i, r in enumerate(res):
        for j in range(3):
            out["p%d/%d/%d/mask" % (p, i, j)] = np.asarray(r[j].mask)
            out["p%d/%d/%d/d" % (p, i, j)] = np.asarray(r[j].d)
            out["p%d/%d/%d/iters" % (p, i, j)] = np.asarray(
                int(r[j].power_iters_run))
np.savez(sys.argv[2], **out)
'''


def _save_results(path, results):
    out = {}
    for rid, r in results.items():
        for j in range(3):
            out[f"{rid}/{j}/mask"] = np.asarray(r[j].mask)
            out[f"{rid}/{j}/d"] = np.asarray(r[j].d)
            out[f"{rid}/{j}/iters"] = np.asarray(int(r[j].power_iters_run))
    np.savez(path, **out)


def _load_results(path):
    z = np.load(path)
    rids = sorted({int(k.split("/")[0]) for k in z.files})
    return {rid: [_Mode(z[f"{rid}/{j}/mask"], z[f"{rid}/{j}/d"],
                        int(z[f"{rid}/{j}/iters"])) for j in range(3)]
            for rid in rids}


def _ranks_worker(device, inputs, ckpt_one, ckpt_two, out_dir):
    """On 2 gloo ranks: restore the one-process checkpoint on a (2,) mesh
    and drain it; then write a mid-solve checkpoint of a fresh (2,)
    engine.  Rank 0 saves its results."""
    import torch.distributed as dist

    from repro_torch.launch.elastic import restore_msc_engine

    xs = np.load(inputs)
    eng = restore_msc_engine(ckpt_one, device=device, device_type="cpu")
    assert eng.mesh is not None and tuple(eng.mesh.shape) == (2, 1)
    got = _drain(eng, {})
    eng.close()
    mesh = tmesh.make_msc_mesh("flat", (2, 1), "cpu")
    eng = MSCContinuousEngine(_cfg(), slots=2, bucket_quantum=8, mesh=mesh,
                              checkpoint_dir=ckpt_two, ckpt_every_chunks=0)
    for i in range(len(xs.files)):
        eng.submit(xs[f"x{i}"])
    before = {}
    for _ in range(3):
        before.update(eng.step())
    eng.checkpoint()
    eng.close()
    if dist.get_rank() == 0:
        _save_results(os.path.join(out_dir, "restored_on_two.npz"), got)
        _save_results(os.path.join(out_dir, "before_two.npz"), before)


@pytest.fixture(scope="module")
def world_sizes(tmp_path_factory):
    """One process writes a mid-solve checkpoint; 2 gloo ranks restore it
    and write their own; the reference's engine runs the stream on (1,)
    and (2,) meshes meanwhile (a subprocess of 4 forced devices)."""
    tmp = tmp_path_factory.mktemp("world")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{f"x{i}": x for i, x in enumerate(_stream())})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_out = tmp / "ref.npz"
    ref = subprocess.Popen([sys.executable, "-c", REF_MESHES, str(inputs),
                            str(ref_out)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        eng = _engine(checkpoint_dir=str(tmp / "one"), ckpt_every_chunks=0)
        _, before_one = _mid_solve(eng)
        eng.checkpoint()
        tmesh.spawn(_ranks_worker, 2, tmp / "store", str(inputs),
                    str(tmp / "one"), str(tmp / "two"), str(tmp),
                    device_type="cpu", join_timeout=SPAWN_TIMEOUT)
        restored = MSCContinuousEngine.restore(str(tmp / "two"),
                                               device="cpu")
        back = _drain(restored, _load_results(tmp / "before_two.npz")
                      if os.path.exists(tmp / "before_two.npz") else {})
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err
    z = np.load(ref_out)

    def reference(p):
        return [[(z[f"p{p}/{i}/{j}/mask"], z[f"p{p}/{i}/{j}/d"],
                  int(z[f"p{p}/{i}/{j}/iters"])) for j in range(3)]
                for i in range(4)]

    on_two = dict(before_one)
    on_two.update(_load_results(tmp / "restored_on_two.npz"))
    return {"on_two": on_two, "on_one": back, "ref1": reference(1), "ref2": reference(2)}


@pytest.mark.parametrize("case,ref", [("on_two", "ref2"), ("on_one",
                                                           "ref1")])
def test_restore_across_world_sizes(world_sizes, case, ref):
    got = world_sizes[case]  # the writer's results, then the restored's
    assert sorted(got) == [0, 1, 2, 3]
    for rid in range(4):
        _held(got[rid], world_sizes[ref][rid])
        _held(got[rid], world_sizes["ref1"][rid])
