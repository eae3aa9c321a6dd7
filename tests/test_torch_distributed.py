"""The port's multi-host control plane on the CPU (gloo), against the
reference's (`tests/test_msc_distributed.py`'s cases).

Held here:
- the control channel's framing: header and arrays round trip, a header
  alone, EOF raises ChannelClosed; the bytes on the wire are the
  reference's;
- the format-2 store with single-process CPU tensors, each written with
  its full index range: round trip, an uncommitted step invisible, a
  missing process record refusing to commit, a corrupt shard rejected
  under SHA verification, a deleted shard rejected; a partial block
  placed by its index; every file of a step byte for byte the
  reference store's from the same data;
- `DistKillPlan` as the reference's;
- the degenerate mode: `MSCDistributedServer` with one process gives the
  bare engine's results and `ServeStats`, byte for byte;
- the two-process CLI (`--num-processes 2 --spawn-workers --device cpu`,
  sizes 8): the served results against the reference's
  `msc_sequential` run on the same tensors (masks and sweeps identical,
  d within rtol 1e-5 / atol 3e-5); a committed step holds shard files of
  both processes; a worker SIGKILLed at `step:3` resumes with the same
  results; a torn checkpoint (`shard:1`) is never restored;
- across packages: the port's format-2 steps (one process mid-solve, and
  the (2, 1) and (2, 2) meshes' from the CLI) finish in the reference's
  `MSCContinuousEngine.restore` on a (1, 1) mesh, and the reference's
  single-process format-2 step finishes in the port's.
The five CLI runs start together (one fixture), each bounded by a
timeout and a short heartbeat timeout.
"""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import make_msc_mesh  # noqa: E402
from repro.core.msc import msc_sequential as jmsc_sequential  # noqa: E402
from repro.launch import distributed as jdist  # noqa: E402
from repro.serving import MSCContinuousEngine as JEngine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.store import (begin_sharded_checkpoint,  # noqa: E402
                                          commit_sharded_checkpoint,
                                          latest_restorable, load_leaves,
                                          restorable_steps,
                                          write_process_shards)
from repro_torch.launch.distributed import (ChannelClosed,  # noqa: E402
                                            DistributedSpec,
                                            MSCDistributedServer, recv_msg,
                                            send_msg)
from repro_torch.launch.msc_serve import build_request_stream  # noqa: E402
from repro_torch.serving import MSCContinuousEngine  # noqa: E402
from repro_torch.serving.faults import (DistKillPlan,  # noqa: E402
                                        corrupt_checkpoint_shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RTOL, ATOL = 1e-5, 3e-5
CLI_TIMEOUT = 120
SIZES = [8]
SEED = 0
N_REQ = 5


def _jcfg():
    return JConfig(epsilon=3e-4, power_tol=1e-2)


def _cfg():
    return bridge.config_from_fields(dataclasses.asdict(_jcfg()))


def _jmesh():
    return make_msc_mesh("flat", devices=jax.devices()[:1], shape=(1, 1))


@functools.cache
def _stream(n_req, slow_every):
    """The CLI's request tensors (the port's generator, on the CPU)."""
    _, tensors = build_request_stream(SIZES, n_req, SEED,
                                      slow_every=slow_every)
    return tuple(t.numpy() for t in tensors)


@functools.cache
def _oracle(n_req, slow_every):
    """The reference's msc_sequential on the port's request tensors."""
    return tuple(jax.tree.map(np.asarray, jmsc_sequential(x, _jcfg()))
                 for x in _stream(n_req, slow_every))


def _held(got, want, exact=False):
    """Masks and sweeps identical, d within the reference's bound (or
    bit for bit)."""
    for j in range(3):
        np.testing.assert_array_equal(np.asarray(got[j].mask),
                                      np.asarray(want[j].mask))
        assert int(got[j].power_iters_run) == int(want[j].power_iters_run)
        if exact:
            np.testing.assert_array_equal(np.asarray(got[j].d),
                                          np.asarray(want[j].d))
        else:
            np.testing.assert_allclose(np.asarray(got[j].d, np.float64),
                                       np.asarray(want[j].d, np.float64),
                                       rtol=RTOL, atol=ATOL)


# ------------------------------------------------ framing -------------

def _pair():
    srv = socket.create_server(("localhost", 0))
    cli = socket.create_connection(srv.getsockname())
    acc, _ = srv.accept()
    srv.close()
    return cli, acc


def test_framing_round_trips_header_and_arrays():
    cli, acc = _pair()
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.zeros((0, 2), np.int64),  # an empty queue
              np.asarray(True)]
    n = send_msg(cli, {"cmd": "tick", "tick": 7}, arrays)
    header, got = recv_msg(acc)
    assert header == {"cmd": "tick", "tick": 7}
    assert len(got) == len(arrays)
    for a, b in zip(arrays, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape
    # the reference's framing: its reader takes the port's bytes, and
    # the port's the reference's, with the same byte count
    jdist.send_msg(acc, {"cmd": "tick", "tick": 7}, arrays)
    header, got = recv_msg(cli)
    assert header == {"cmd": "tick", "tick": 7} and len(got) == 3
    send_msg(cli, {"tag": "x"}, arrays)
    header, got = jdist.recv_msg(acc)
    assert header == {"tag": "x"} and got[0].shape == (3, 4)
    assert n > sum(a.nbytes for a in arrays)
    cli.close()
    acc.close()


def test_framing_header_alone():
    cli, acc = _pair()
    send_msg(acc, {"tag": "ready"})
    header, got = recv_msg(cli)
    assert header == {"tag": "ready"} and got == []
    cli.close()
    acc.close()


def test_framing_eof_raises_channel_closed():
    cli, acc = _pair()
    cli.close()  # a SIGKILLed peer's socket closes at once
    with pytest.raises(ChannelClosed):
        recv_msg(acc)
    acc.close()


# ------------------------------------------------ sharded store -------

def _payload(seed=0):
    """CPU tensors, each its whole leaf, and one host leaf."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.integers(0, 9, size=(3,)).astype(np.int32)
    dev = [(0, torch.from_numpy(a), ((0, 4), (0, 6))),
           (1, torch.from_numpy(b), ((0, 3),))]
    host = [(2, np.arange(5, dtype=np.int64))]
    return dev, host


def _committed(d, step=2):
    dev, host = _payload()
    tmp = begin_sharded_checkpoint(d, step)
    write_process_shards(tmp, 0, dev)
    commit_sharded_checkpoint(d, step, num_processes=1, full_leaves=host)
    return d


def test_sharded_store_round_trip(tmp_path):
    d = str(tmp_path)
    dev, host = _payload()
    tmp = begin_sharded_checkpoint(d, 3)
    assert write_process_shards(tmp, 0, dev) == len(dev)
    commit_sharded_checkpoint(d, 3, num_processes=1, full_leaves=host,
                              extra={"k": 1})
    assert restorable_steps(d, verify_sha=True) == [3]
    leaves, extra = load_leaves(d, 3)
    assert extra == {"k": 1}
    for a, b in zip([t.numpy() for _, t, _ in dev] + [h for _, h in host],
                    leaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_sharded_store_uncommitted_step_is_invisible(tmp_path):
    d = str(tmp_path)
    dev, _ = _payload()
    write_process_shards(begin_sharded_checkpoint(d, 5), 0, dev)
    # no commit: the master (or a worker) died here
    assert restorable_steps(d, verify_sha=False) == []
    assert latest_restorable(d, verify_sha=False) is None
    assert os.path.isdir(os.path.join(d, "step_00000005.tmp"))


def test_sharded_store_missing_record_refuses_commit(tmp_path):
    d = str(tmp_path)
    dev, host = _payload()
    write_process_shards(begin_sharded_checkpoint(d, 7), 0, dev)
    with pytest.raises(IOError, match="missing shard record"):
        commit_sharded_checkpoint(d, 7, num_processes=2, full_leaves=host)
    assert restorable_steps(d, verify_sha=False) == []
    assert os.path.isdir(os.path.join(d, "step_00000007.tmp"))


def test_sharded_store_corrupt_shard_rejected_by_sha(tmp_path):
    d = _committed(str(tmp_path))
    path = corrupt_checkpoint_shard(d, 2)
    assert "_p000_s000" in os.path.basename(path)
    assert restorable_steps(d, verify_sha=True) == []
    assert restorable_steps(d, verify_sha=False) == [2]  # the files exist
    with pytest.raises((IOError, ValueError)):
        load_leaves(d, 2, verify=True)


def test_sharded_store_deleted_shard_rejected(tmp_path):
    d = _committed(str(tmp_path))
    step_dir = os.path.join(d, "step_00000002")
    shard = next(f for f in sorted(os.listdir(step_dir)) if "_p000_" in f)
    os.unlink(os.path.join(step_dir, shard))
    assert restorable_steps(d, verify_sha=False) == []


def test_sharded_store_places_partial_blocks(tmp_path):
    """Two processes' rows of one (4, 6) leaf, each with its index and the
    global shape; a block that does not fit its index raises."""
    d = str(tmp_path)
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    tmp = begin_sharded_checkpoint(d, 1)
    for p in range(2):
        rows = (2 * p, 2 * p + 2)
        write_process_shards(tmp, p, [(0, torch.from_numpy(full[2 * p:
                                                                2 * p + 2]),
                                       (rows, (0, 6)), (4, 6))])
    commit_sharded_checkpoint(d, 1, num_processes=2, full_leaves=[])
    leaves, _ = load_leaves(d, 1)
    np.testing.assert_array_equal(leaves[0], full)
    with pytest.raises(ValueError, match="does not place"):
        write_process_shards(tmp, 0, [(0, torch.zeros(2, 6),
                                       ((0, 3), (0, 6)), (4, 6))])
    with pytest.raises(ValueError, match="does not place"):
        write_process_shards(tmp, 0, [(0, torch.zeros(2, 6),
                                       ((2, 4), (0, 6)))])


def test_sharded_store_files_are_the_references(tmp_path):
    """The same payload through both stores: every file of the committed
    step (shards, vote record, full leaves, manifest) byte for byte."""
    dev, host = _payload()
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    write_process_shards(begin_sharded_checkpoint(port, 4), 0, dev)
    commit_sharded_checkpoint(port, 4, num_processes=1, full_leaves=host,
                              extra={"k": [1, 2]})
    jstore.write_process_shards(
        jstore.begin_sharded_checkpoint(ref, 4), 0,
        [(i, jax.device_put(t.numpy())) for i, t, _ in dev])
    jstore.commit_sharded_checkpoint(ref, 4, num_processes=1,
                                     full_leaves=host, extra={"k": [1, 2]})
    a, b = (os.path.join(x, "step_00000004") for x in (port, ref))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


def test_dist_kill_plan_is_the_references(monkeypatch):
    monkeypatch.setenv("MSC_DIST_KILL", "shard:2")
    plan, jplan = DistKillPlan.from_env(), jfaults.DistKillPlan.from_env()
    assert (plan.point, plan.index) == (jplan.point, jplan.index) == \
        ("shard", 2)
    assert plan.POINTS == jplan.POINTS
    monkeypatch.delenv("MSC_DIST_KILL")
    assert DistKillPlan.from_env() is None
    with pytest.raises(ValueError, match="unknown kill point"):
        DistKillPlan("refill", 0)
    killed = []
    monkeypatch.setattr("repro_torch.serving.faults._sigkill",
                        lambda: killed.append(True))
    p = DistKillPlan("step", 1)
    for point in ("tick", "step", "tick", "shard"):
        p.hit(point)
    assert not killed
    p.hit("step")
    assert killed == [True]


# ------------------------------------------------ degenerate mode -----

def test_degenerate_mode_is_the_engine_byte_for_byte():
    cfg = _cfg()
    _, tensors = build_request_stream([8, 12], 4, seed=0)
    eng = MSCContinuousEngine(cfg, slots=3, device="cpu")
    rids = [eng.submit(t) for t in tensors]
    direct = {}
    while eng.has_work() and not all(r in direct for r in rids):
        direct.update(eng.step())

    server = MSCDistributedServer(DistributedSpec(num_processes=1), cfg,
                                  mesh_shape=(1, 1), slots=3, device="cpu")
    srids = [server.submit(t) for t in tensors]
    via = {}
    while any(s not in via for s in srids):
        via.update(server.step())
    server.shutdown()
    assert server.mesh is None and server.control["ticks"] == 0
    for rid, srid in zip(rids, srids):
        _held(via[srid], direct[rid], exact=True)
    assert dataclasses.astuple(eng.stats) == \
        dataclasses.astuple(server.stats)


# ------------------------------------------------ two-process CLI -----

# name: (processes, extra flags, requests, slow_every)
CLI_RUNS = {
    "clean": (2, (), N_REQ, 0),
    "ckpt": (2, ("--ckpt-every", "2"), N_REQ, 0),
    # (2, 2): ranks that differ on the inner dim write the same ranges
    "ckpt_2x2": (4, ("--ckpt-every", "2", "--mesh-shape", "2,2"), N_REQ, 0),
    "kill": (2, ("--ckpt-every", "2", "--worker-kill-at", "step:3"), 6, 3),
    "torn": (2, ("--ckpt-every", "2", "--worker-kill-at", "shard:1"), 6, 3),
}


def _cli_cmd(root, name):
    n_proc, extra, n_req, slow_every = CLI_RUNS[name]
    cmd = [sys.executable, "-m", "repro_torch.launch.distributed",
           "--num-processes", str(n_proc), "--spawn-workers",
           "--device", "cpu",
           "--requests", str(n_req), "--sizes", ",".join(map(str, SIZES)),
           "--seed", str(SEED), "--slow-every", str(slow_every),
           "--slots", "3", "--heartbeat-timeout", "20",
           "--outdir", os.path.join(root, name, "out")]
    if extra:
        cmd += ["--ckpt-dir", os.path.join(root, name, "ckpt"), *extra]
    return cmd


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLI runs, started together: {name: (results, stats,
    checkpoint dir)}."""
    root = str(tmp_path_factory.mktemp("dist_cli"))
    env = dict(os.environ)
    env.pop("MSC_DIST_KILL", None)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = {name: subprocess.Popen(_cli_cmd(root, name), env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name in CLI_RUNS}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            out[name] = AssertionError(
                f"distributed CLI {name} failed (rc={proc.returncode})\n"
                f"--- stdout ---\n{stdout}\n--- stderr ---\n{stderr}")
            continue
        base = os.path.join(root, name)
        results = dict(np.load(os.path.join(base, "out", "results.npz")))
        with open(os.path.join(base, "out", "stats.json")) as f:
            stats = json.load(f)
        out[name] = (results, stats, os.path.join(base, "ckpt"))
    return out


def _run(cli, name):
    got = cli[name]
    if isinstance(got, Exception):
        raise got
    return got


def _matches_oracle(results, n_req, slow_every):
    for i, res in enumerate(_oracle(n_req, slow_every)):
        np.testing.assert_array_equal(
            results[f"iters_{i}"],
            [int(res[j].power_iters_run) for j in range(3)])
        for j in range(3):
            np.testing.assert_array_equal(results[f"mask_{i}_{j}"],
                                          np.asarray(res[j].mask))
            np.testing.assert_allclose(results[f"d_{i}_{j}"],
                                       np.asarray(res[j].d),
                                       rtol=RTOL, atol=ATOL)


def test_two_processes_serve_the_sequential_oracle(cli):
    results, stats, _ = _run(cli, "clean")
    assert stats["n_results"] == N_REQ
    assert stats["host_losses"] == 0 and stats["heartbeats_missed"] == 0
    assert stats["lost_hosts"] == []
    assert dict(stats["mesh"]) == {"slice": 2, "inner": 1}
    assert stats["control"]["ticks"] > 0
    assert stats["control"]["wire_bytes"] > sum(
        x.nbytes for x in _stream(N_REQ, 0))
    _matches_oracle(results, N_REQ, 0)


def test_checkpoints_hold_shards_of_both_processes(cli):
    results, stats, ckpt = _run(cli, "ckpt")
    assert stats["checkpoints_written"] >= 1
    assert stats["shard_files_written"] > 0
    assert stats["host_losses"] == 0
    steps = restorable_steps(ckpt, verify_sha=True)
    assert steps, "no committed multi-host checkpoint on disk"
    names = os.listdir(os.path.join(ckpt, f"step_{steps[-1]:08d}"))
    assert any("_p000_" in n for n in names)
    assert any("_p001_" in n for n in names)
    with open(os.path.join(ckpt, f"step_{steps[-1]:08d}",
                           "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 2 and man["processes"] == 2
    assert man["extra"]["carry_layout"] == "device"
    _matches_oracle(results, N_REQ, 0)


def test_worker_sigkill_resumes_bit_identical(cli):
    # every 3rd request is near-noise and runs many gate chunks, so the
    # run outlasts the kill point
    results, stats, _ = _run(cli, "kill")
    assert stats["host_losses"] == 1
    assert stats["heartbeats_missed"] >= 1
    assert stats["reinits"] == 1
    assert stats["restores"] == 1  # resumed from a committed step
    assert stats["lost_hosts"] == [1]
    assert stats["recovery_s"] is not None
    assert stats["n_results"] == 6
    _matches_oracle(results, 6, 3)
    clean, _, _ = _run(cli, "torn")  # the same stream, another fault
    for k in results:
        if not k.startswith("d_"):
            np.testing.assert_array_equal(results[k], clean[k])


def test_torn_checkpoint_never_selected(cli):
    # the worker died on the second checkpoint command, before its shard
    # write: that step was .tmp at the loss, and the restore took an
    # earlier committed one
    results, stats, _ = _run(cli, "torn")
    torn = stats["torn_steps_at_loss"]
    assert torn, "expected a torn .tmp step at recovery time"
    assert stats["restored_step"] is not None
    assert stats["restored_step"] < min(torn)
    assert stats["host_losses"] == 1 and stats["restores"] == 1
    assert stats["n_results"] == 6
    _matches_oracle(results, 6, 3)


# ------------------------------------------------ across packages -----

MID_N, MID_SLOW = 4, 2


def _mid_solve(eng, tensors, ticks=3):
    rids = [eng.submit(t) for t in tensors]
    got = {}
    for _ in range(ticks):
        got.update(eng.step())
    return rids, got


def _drain(eng, got):
    while eng.has_work():
        got.update(eng.step())
    return got


def _port_format2(tmp_path):
    """A mid-solve format-2 step the port's one process writes, beside
    the port's uninterrupted results of the same stream."""
    eng = MSCContinuousEngine(_cfg(), slots=3, device="cpu")
    tensors = _stream(MID_N, MID_SLOW)
    whole = eng.run([torch.from_numpy(x) for x in tensors])
    rids, got = _mid_solve(eng, [torch.from_numpy(x) for x in tensors])
    assert len(got) < len(rids)  # mid-solve
    d = str(tmp_path)
    step = eng._total_chunks
    device, host, meta = eng._export_split()
    n = write_process_shards(begin_sharded_checkpoint(d, step), 0, device)
    assert n == len(device) == 15
    commit_sharded_checkpoint(d, step, num_processes=1, full_leaves=host,
                              extra=meta)
    return d, dict(zip(rids, whole)), got


@pytest.mark.parametrize("source", ["one_process", "ckpt", "ckpt_2x2"])
def test_a_port_format2_step_finishes_in_the_reference(source, tmp_path,
                                                        cli):
    """One process mid-solve, the (2, 1) CLI run's step and the (2, 2)
    run's, each finished by the reference's engine on a (1, 1) mesh."""
    if source == "one_process":
        d, want, got = _port_format2(tmp_path)
        step = None
    else:
        results, stats, d = _run(cli, source)
        assert dict(stats["mesh"]) == {
            "ckpt": {"slice": 2, "inner": 1},
            "ckpt_2x2": {"slice": 2, "inner": 2}}[source]
        _matches_oracle(results, N_REQ, 0)
        step = restorable_steps(d, verify_sha=True)[-1]  # the oldest
        got = {}
        want = dict(enumerate(_oracle(N_REQ, 0)))
    jeng = JEngine.restore(d, mesh=_jmesh(), step=step)
    assert jeng.stats.restores == 1
    before = set(got)
    _drain(jeng, got)
    assert set(got) - before, "the restored step held no work"
    for rid in set(got) - before:
        _held(got[rid], want[rid])


def test_a_reference_format2_step_finishes_in_the_port(tmp_path):
    jeng = JEngine(_jmesh(), _jcfg(), slots=3)
    tensors = _stream(MID_N, MID_SLOW)
    whole = jeng.run(list(tensors))
    rids, got = _mid_solve(jeng, tensors)
    assert len(got) < len(rids)
    d = str(tmp_path)
    step = jeng._total_chunks
    device, host, meta = jeng._export_split()
    tmp = jstore.begin_sharded_checkpoint(d, step)
    jstore.write_process_shards(tmp, 0, device)
    jstore.commit_sharded_checkpoint(d, step, num_processes=1,
                                     full_leaves=host, extra=meta)
    eng = MSCContinuousEngine.restore(d, device="cpu")
    assert eng.stats.restores == 1 and eng.slots == 3
    _drain(eng, got)
    assert sorted(got) == sorted(rids)
    for rid, want in zip(rids, whole):
        _held(got[rid], want)
