"""Parallel MSC builders — counterpart of `repro/core/parallel.py`.

Every schedule is a layout declaration over `core/schedule.py:
ModeSchedule`, which owns the padding, the masks, the per-rank Alg. 2
body and the epilogue.  With `mesh=None` each `build_*` function runs on
one device: the three modes one after another, every relayout the same
local transpose.  With a DeviceMesh (`launch/mesh.py`) every rank of the mesh
calls the built function on the same tensor and gets the same result:

* **flat**: the three modes one after another, each over every slice
  rank.  The relayout says how the tensor moves between the mode
  layouts:
  - "gspmd": each rank cuts its blocks of the three unfoldings from the
    tensor it was given (the counterpart of the reference's global
    transpose);
  - "collective": each rank keeps its mode-1 block only and the other
    two layouts come by all_to_all (the reference's
    `_build_flat_collective`): on an inner dim one all_to_all over it
    first, then one over the slice dim per mode;
  - "collective_stream": the same, each all_to_all as p−1 send/receive
    steps, bit-identical to "collective".
* **grouped** (paper Fig. 3): mesh ("mode"=3, "slice"[, "inner"]); each
  mode group solves its own unfolding, its collectives within the
  group (the MPI group communicator); cube tensors only.

Collectives (paper → here): MPI_Allgatherv(V) → all_gather_into_tensor
over the slice group, or the ring of send/receive steps;
MPI_Allreduce(λ, MAX) → all_reduce MAX; the inner-dim partial sums →
all_reduce SUM; MPI_Gatherv(d) → an all_gather of d and λ, the
extraction then on every rank.

relayout="auto" and cfg.epilogue="auto" resolve per tensor shape from
the roofline choosers (`_resolve_auto`), on the spec of the device the
function runs on (`roofline.target_hw`), each resolution built once.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .msc import MODE_PERMS
from .power_iter import SolveState
from .schedule import (ModeSchedule, _exchange,  # noqa: F401
                       build_epilogue_rowsum, gather_shards, pad_to,
                       take_block)
from .types import MSCConfig, MSCResult, resolve_device

RELAYOUTS = ("gspmd", "collective", "collective_stream")

# column dim of modes 1/2 is m3, of mode 3 is m2 (see MODE_PERMS)
C_OF = (2, 2, 1)


def batch_perm(mode: int) -> tuple:
    """MODE_PERMS[mode] behind a leading request dim."""
    return (0,) + tuple(a + 1 for a in MODE_PERMS[mode])


def check_relayout(relayout: str) -> None:
    """Raise on a relayout the port does not know ("auto" resolves per
    shape)."""
    if relayout not in RELAYOUTS + ("auto",):
        raise ValueError(f"unknown relayout {relayout!r}; "
                         f"expected one of {RELAYOUTS + ('auto',)}")


def agreed(mesh, value):
    """`value` (a choice every rank makes alone), checked to be the same on
    every rank of `mesh`'s world; one device has nothing to check.  Every
    rank calls it in the same order."""
    if mesh is None:
        return value
    import torch.distributed as dist

    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    if any(v != value for v in seen):
        raise RuntimeError(f"ranks resolved differently: {seen}")
    return value


def _resolve_auto(cfg: MSCConfig, shape, relayout: str, mesh=None,
                  B: int = 1, device=None, hw=None):
    """(cfg, relayout) for one tensor shape, "auto" resolved by the
    roofline choosers on `hw`, by default `device`'s spec
    (`roofline.target_hw`: V5E, the reference's, on the CPU); a knob that
    is not "auto" passes through.
    On a mesh every rank must resolve alike: the models are deterministic,
    and `agreed` checks it."""
    from repro_torch.roofline import (choose_epilogue, choose_relayout,
                                      target_hw)

    hw = hw or target_hw(_mesh_device(mesh, device))
    sched = _flat_schedule(cfg, mesh)
    p, q = sched.slice_shards, sched.inner_shards
    if relayout == "auto":
        relayout = choose_relayout(shape, p, q, B=B,
                                   sweeps=max(cfg.power_check_every, 1),
                                   hw=hw)
    if cfg.epilogue == "auto":
        m1, _, m3 = shape
        # mode 1 dominates the epilogue bytes on cubes; the schedules take
        # one policy for all three modes
        cfg = cfg.with_(epilogue=choose_epilogue(m1, m3, p, hw=hw))
    agreed(mesh, (cfg.epilogue, relayout))
    return cfg, relayout


def _per_shape(build, cfg: MSCConfig, relayout: str, mesh, device, batched):
    """A runner that resolves "auto" per input shape and builds (once per
    shape) `build(cfg, relayout)` for it."""
    built = {}

    def run(tensor, *rest):
        shape = tuple(np.shape(tensor))
        if shape not in built:
            rcfg, rlay = _resolve_auto(
                cfg, shape[1:] if batched else shape, relayout, mesh,
                B=shape[0] if batched else 1, device=device)
            built[shape] = build(rcfg, rlay)
        return built[shape](tensor, *rest)

    return run


def _mesh_device(mesh, device):
    """The device a built function runs on: the rank's on a mesh."""
    if mesh is None:
        return resolve_device(device if device is not None else "cuda")
    from repro_torch.launch.mesh import mesh_device

    return mesh_device(mesh)


def _flat_schedule(cfg: MSCConfig, mesh) -> ModeSchedule:
    """The flat schedule's roles: "inner" shards rows when the mesh has
    it, the other dim shards slices (`sharding/specs.py:msc_axes`)."""
    if mesh is None:
        return ModeSchedule(cfg)
    from repro_torch.sharding.specs import msc_axes

    slice_axes, inner_axes = msc_axes(mesh)
    return ModeSchedule(cfg, mesh, slice_axes, inner_axes)


# ------------------------------------------------------ relayout collectives

def _stream_all_to_all(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """all_to_all_single(out, x) as p−1 send/receive steps: at step k
    this rank sends its part (i+k) mod p to rank (i+k) mod p and receives
    rank (i−k) mod p's part i.  Pure data movement, so `out` holds the
    blocking collective's bits."""
    import torch.distributed as dist

    p, i = dist.get_world_size(group), dist.get_rank(group)
    out[i].copy_(x[i])
    for k in range(1, p):
        to, frm = (i + k) % p, (i - k) % p
        for w in _exchange(x[to], dist.get_global_rank(group, to), out[frm],
                           dist.get_global_rank(group, frm), group):
            w.wait()


def _a2a(x: torch.Tensor, group, split: int, concat: int,
         stream: bool) -> torch.Tensor:
    """The reference's tiled `lax.all_to_all(x, split_axis=split,
    concat_axis=concat)` over a group of p ranks: x's split dim cut in p
    parts, part j sent to rank j, and the parts received from ranks 0…p−1
    joined along the concat dim.  all_to_all_single splits dim 0 only, so
    the split dim is made leading and contiguous first."""
    import torch.distributed as dist

    p = dist.get_world_size(group)
    xs = x.movedim(split, 0)
    xs = xs.reshape((p, xs.shape[0] // p) + tuple(xs.shape[1:])).contiguous()
    out = torch.empty_like(xs)
    if stream:
        _stream_all_to_all(out, xs, group)
    else:
        dist.all_to_all_single(out, xs, group=group)
    del xs
    # out (p, part, *rest): rest is x's dims without the split one; put the
    # source rank beside the concat dim and merge them, rank-major
    c = concat - (concat > split)
    y = out.movedim(0, 1 + c)
    shape = tuple(y.shape)
    y = y.reshape(shape[:1 + c] + (shape[1 + c] * shape[2 + c],)
                  + shape[3 + c:])
    return y.movedim(0, split)


def collective_pads(sched: ModeSchedule, shape) -> tuple:
    """Padded (m1, m2, m3) of the collective relayout: m1 is cut p ways and
    then q ways, m2 q ways and then p ways, m3 p ways."""
    p, q = sched.slice_shards, sched.inner_shards
    m1, m2, m3 = shape
    return (pad_to(m1, p * q), pad_to(m2, p * q // math.gcd(p, q)),
            pad_to(m3, p))


def _collective_blocks(sched: ModeSchedule, t: torch.Tensor, stream: bool):
    """This rank's slice-major block of each mode in turn, by the
    reference's all_to_all relayout (`_build_flat_collective`).

    t (…, m1, m2, m3): the tensor, under any leading request dims.  The
    rank keeps its block of the padded mode-1 layout, (m1'/p, m2'/q, m3');
    on an inner dim one all_to_all over it (split m1, concat m2) frees the
    row-sharded dim; then one all_to_all over the slice dim per mode gives
    mode 2 (m2'/p, m1'/q, m3') and mode 3 (m3'/p, m1'/q, m2').  Each
    all_to_all moves the rank's share of the tensor once.
    """
    lead = t.dim() - 3
    p, q = sched.slice_shards, sched.inner_shards
    m1p, m2p, m3p = collective_pads(sched, t.shape[lead:])
    b1, r1 = m1p // p, m2p // q
    blk = take_block(t, ((sched.slice_index * b1, b1),
                         (sched.inner_index * r1, r1), (0, m3p)))
    yield blk
    if sched.inner_group is not None:  # step A: free the inner-sharded dim
        blk = _a2a(blk, sched.inner_group, lead, lead + 1, stream)
    keep = tuple(range(lead))
    b2 = _a2a(blk, sched.slice_group, lead + 1, lead, stream)
    yield b2.permute(keep + (lead + 1, lead, lead + 2)).contiguous()
    del b2
    b3 = _a2a(blk, sched.slice_group, lead + 2, lead, stream)
    del blk
    yield b3.permute(keep + (lead + 2, lead, lead + 1)).contiguous()


# ------------------------------------------------------ the build functions

def build_msc_parallel_flat(cfg: MSCConfig, mesh=None,
                            relayout: str = "gspmd", device=None):
    """tensor → MSCResult, flat schedule: on one device (mesh=None, on
    `device`, default "cuda"), or over a DeviceMesh (every rank calls it
    on the same tensor and gets the same result).  relayout="auto" or
    cfg.epilogue="auto" resolve per tensor shape (`_resolve_auto`)."""
    check_relayout(relayout)
    if relayout == "auto" or cfg.epilogue == "auto":
        return _per_shape(
            lambda c, r: build_msc_parallel_flat(c, mesh, r, device), cfg,
            relayout, mesh, device, batched=False)
    dev = _mesh_device(mesh, device)
    sched = _flat_schedule(cfg, mesh)
    if mesh is not None and relayout != "gspmd":
        return _build_flat_collective(sched, dev,
                                      stream=relayout == "collective_stream")

    def run(tensor) -> MSCResult:
        t = torch.as_tensor(tensor).to(dev)
        modes = []
        for j in range(3):
            d, lam, iters, valid, m = sched.run_mode(t.permute(MODE_PERMS[j]))
            modes.append(sched.finalize_mode(d, lam, iters, valid, m))
        return MSCResult(modes=tuple(modes))

    return run


def _collective_modes(sched: ModeSchedule, t: torch.Tensor, dev, stream: bool,
                      sizes, finalize) -> MSCResult:
    """The three modes of `t` (…, m1, m2, m3) with the all_to_all relayout
    (see `_collective_blocks`).  sizes(j) gives mode j's true slice count
    m and column count c_valid: ints, or per request (B,) and (B, 1)
    tensors under a request dim; finalize(d, lam, iters, valid, m) makes
    the mode's result.  Zero rows drop out of every covariance; zero
    columns are kept at zero by masking the start vectors to the true
    column count (`c_valid`), which keeps the iterates' bits."""
    pads = collective_pads(sched, t.shape[t.dim() - 3:])
    modes = []
    for j, block in enumerate(_collective_blocks(sched, t, stream)):
        m, c_valid = sizes(j)
        d, lam, iters = sched.mode_local(
            block, sched.slice_mask(pads[j], m, dev), c_valid=c_valid)
        del block
        whole = torch.arange(pads[j], device=dev)
        valid = (whole < m if isinstance(m, int)
                 else whole[None, :] < m[:, None])
        modes.append(finalize(d, lam, iters, valid, m))
    return MSCResult(modes=tuple(modes))


def _build_flat_collective(sched: ModeSchedule, dev, stream: bool):
    """The flat schedule with the all_to_all relayout."""
    def run(tensor) -> MSCResult:
        t = torch.as_tensor(tensor).to(dev)
        shape = tuple(t.shape)
        return _collective_modes(
            sched, t, dev, stream, lambda j: (shape[j], shape[C_OF[j]]),
            sched.finalize_mode)

    return run


def build_msc_parallel_grouped(cfg: MSCConfig, mesh, device=None):
    """tensor → MSCResult, the paper's 3-group schedule (Fig. 3).

    The mesh is ("mode"=3, "slice"[, "inner"]): the ranks of mode group j
    solve unfolding j, each its (slice, inner) block, with every
    collective of the solve inside the group (the MPI group
    communicator; the ring circulates within it).  Then d, λ and the
    sweeps are gathered over the slice dim and across the three groups,
    so every rank extracts all three modes.  Cube tensors only.
    """
    if mesh is None:
        raise ValueError("the grouped schedule runs on a mesh of 3·s·q "
                         "ranks (launch/mesh.py:make_msc_mesh('grouped'))")
    names = tuple(mesh.mesh_dim_names or ())
    if "mode" not in names or mesh.size(names.index("mode")) != 3:
        raise ValueError(f"grouped schedule needs mode=3, got mesh "
                         f"{dict(zip(names, mesh.shape))}")
    sched = ModeSchedule(cfg, mesh, slice_axes=("slice",),
                         inner_axes=("inner",) if "inner" in names else (),
                         group_axes=("mode",))
    dev = _mesh_device(mesh, device)
    g = mesh.get_local_rank("mode")
    modes_group = mesh.get_group("mode")

    def run(tensor) -> MSCResult:
        t = torch.as_tensor(tensor).to(dev)
        m1, m2, m3 = t.shape
        if not (m1 == m2 == m3):
            raise ValueError("grouped schedule requires a cube tensor")
        d, lam, iters, valid, m = sched.run_mode(t.permute(MODE_PERMS[g]))
        d, lam, iters = sched.gather(d, lam, iters)
        # every group's whole mode to every rank, in mode order
        d3, lam3, it3 = gather_shards(
            d, lam, torch.amax(iters, dim=-1, keepdim=True), modes_group)
        n = d.shape[-1]
        return MSCResult(modes=tuple(
            sched.extract_mode(d3[j * n:(j + 1) * n], lam3[j * n:(j + 1) * n],
                               it3[j:j + 1], valid, m) for j in range(3)))

    return run


def build_msc_batched(cfg: MSCConfig, mesh=None, relayout: str = "gspmd",
                      device=None):
    """(batch (B, M1, M2, M3), dims (B, 3)) → MSCResult with a leading B.

    The request-batched flat schedule: B independent MSC solves,
    bucket-padded to one shape with true sizes in `dims`, run through one
    set of batched contractions per mode, on one device or over a mesh
    (the relayouts of `build_msc_parallel_flat`, every dim shifted under
    the request dim).  Each request gates on its own (per-request
    `power_iters_run`); every field of the ModeResults carries the leading
    B dim at the padded size, and callers slice `[i, :dims[i, j]]` per
    request (MSCServeEngine does).  relayout="auto" or cfg.epilogue="auto"
    resolve per batch shape (`_resolve_auto`, with B the batch's).
    """
    check_relayout(relayout)
    if relayout == "auto" or cfg.epilogue == "auto":
        return _per_shape(
            lambda c, r: build_msc_batched(c, mesh, r, device), cfg,
            relayout, mesh, device, batched=True)
    dev = _mesh_device(mesh, device)
    sched = _flat_schedule(cfg, mesh)
    stream = relayout == "collective_stream"

    def run(batch, dims) -> MSCResult:
        b = torch.as_tensor(batch).to(dev)
        dims = torch.as_tensor(dims, dtype=torch.int32).to(dev)
        modes = []
        if mesh is None or relayout == "gspmd":
            for j in range(3):
                d, lam, iters, valid = sched.run_mode_batched(
                    b.permute(batch_perm(j)), dims[:, j], dims[:, C_OF[j]])
                modes.append(sched.finalize_mode_batched(d, lam, iters,
                                                         valid))
            return MSCResult(modes=tuple(modes))
        return _collective_modes(
            sched, b, dev, stream,
            lambda j: (dims[:, j], dims[:, C_OF[j]][:, None]),
            lambda d, lam, iters, valid, m: sched.finalize_mode_batched(
                d, lam, iters, valid))

    return run


class MSCChunkPlan:
    """The continuous engine's two programs per bucket, on one device or
    on every rank of a mesh.

    The static batched pipeline runs a bucket to completion: its gated
    loop ends on the batch's slowest request, so one slow request holds
    all B slots.  The chunk plan cuts that loop at the gate chunk:

      * `build_step()`: every slot's three modes advance
        `chunks_per_step` gate chunks over the persistent slot state, and
        the per-slot `finished` verdicts come back;
      * `build_refill()`: between chunks, the evicted slots are finalized
        (the similarity tail and the extraction, from their frozen
        iterates), then the table is repacked (an arbitrary slot
        permutation) and freed slots take newly admitted requests.

    State per mode: the slice-major block (B, m, r, c), read only between
    refills, and a `SolveState` carry (see `ModeSchedule`'s chunk-resumable
    entry points).  Holding all three unfoldings triples the tensor bytes
    resident against the static path's one layout at a time: the price of
    advancing the modes together.  Every computation keeps the leading
    slot dim, so results do not depend on slot placement, eviction order
    or arrival interleaving.

    On a mesh (the flat schedule's roles, `msc_axes`) each rank holds its
    (slice, inner) block of every unfolding and its rows of the carries
    (`mode_shapes`), and every rank runs both programs in lockstep.  Each
    rank is a process of its own, so what the host policy reads is the
    same on every rank by construction, the counterpart of the
    reference's `replicate_outputs`: `finished` comes from verdicts the
    gate all-reduces over the slice group (and λ and the residuals are
    summed over the inner group before it), and the refill gathers every
    slot's d, λ and sweeps over the slice group before its extraction.

    The programs update the blocks and carries they are given in place,
    the port's counterpart of the reference's donated buffers; on a card
    the engine captures each as a CUDA graph (`serving/msc_engine.py`),
    with the collectives inside.  Matrix-free only, as in the reference.
    `replicate_outputs` records the reference's flag for a mesh that
    spans processes; the programs are the same either way.
    """

    def __init__(self, cfg: MSCConfig, chunks_per_step=1, device="cuda",
                 mesh=None, power_route=None, replicate_outputs=False):
        if not cfg.matrix_free:
            raise ValueError("the continuous engine requires "
                             "matrix_free=True (see power_iter."
                             "build_chunk_fn)")
        if chunks_per_step == "auto" or cfg.epilogue == "auto":
            raise ValueError("a chunk plan takes concrete knobs: "
                             "MSCContinuousEngine resolves 'auto' per bucket")
        self.chunks_per_step = int(chunks_per_step)
        if self.chunks_per_step < 1:
            raise ValueError(f"chunks_per_step must be >= 1, got "
                             f"{chunks_per_step}")
        self.sched = _flat_schedule(cfg, mesh)
        self.device = _mesh_device(mesh, device)
        # the power kernel's route per mode (`kernels/power_iter.py:routes`),
        # or None for its own pick: what the engine's autotuner searches
        self.power_route = None if power_route is None else tuple(power_route)
        self.replicate_outputs = bool(replicate_outputs)

    # ---- shapes and state ---------------------------------------------
    def padded_shapes(self, bucket, B: int):
        """(B, m', r', c) whole padded block shape per mode: m to the slice
        shards, r to the inner shards (one device pads nothing)."""
        shapes = []
        for j in range(3):
            m, r, c = (bucket[i] for i in MODE_PERMS[j])
            m_pad, r_pad = self.sched.pad_amounts(m, r)
            shapes.append((B, m_pad, r_pad, c))
        return tuple(shapes)

    def mode_shapes(self, bucket, B: int):
        """(B, m'/S, r'/Q, c) block shape per mode: this rank's share of
        the padded unfolding (the whole unfolding on one device)."""
        p, q = self.sched.slice_shards, self.sched.inner_shards
        return tuple((B, m // p, r // q, c)
                     for B, m, r, c in self.padded_shapes(bucket, B))

    def warm_shapes(self, bucket, B: int):
        """(B, m', c) warm-start staging per mode: one row of iterates per
        slot, the whole padded slice dim (each rank takes its rows in the
        refill), laid out as the carry's v."""
        return tuple((B, m, c) for B, m, _, c in self.padded_shapes(bucket, B))

    def resume_shapes(self, bucket, B: int):
        """(B, m') λ / residual resume staging per mode (the resumed
        iterate rides the warm staging)."""
        return tuple((B, m) for B, m, _, _ in self.padded_shapes(bucket, B))

    def local_block(self, j: int, tensor: torch.Tensor, shape):
        """This rank's (m'/S, r'/Q, c) block of a request's mode-j
        unfolding, zero-padded to `shape` (one mode_shapes entry, without
        its slot dim)."""
        b, rq, c = shape
        t = tensor.permute(MODE_PERMS[j])
        return take_block(t, ((self.sched.slice_index * b, b),
                              (self.sched.inner_index * rq, rq), (0, c)))

    def init_state(self, bucket, B: int, dtype):
        """A fresh slot table on the device: zero blocks, every slot inert
        (done, so frozen until the first refill).  Returns (blocks,
        carries), one of each per mode."""
        z = dict(device=self.device)
        blocks, carries = [], []
        for shape in self.mode_shapes(bucket, B):
            _, m, _, c = shape
            blocks.append(torch.zeros(shape, dtype=dtype, **z))
            carries.append(SolveState(
                v=torch.zeros((B, m, c), dtype=torch.float32, **z),
                lam=torch.zeros((B, m), dtype=torch.float32, **z),
                resid=torch.zeros((B, m), dtype=torch.float32, **z),
                iters=torch.zeros(B, dtype=torch.int32, **z),
                done=torch.ones(B, dtype=torch.bool, **z)))
        return tuple(blocks), tuple(carries)

    def export_slot(self, bucket, carries, slot: int):
        """Host form of one slot's three mode carries: per mode a
        SolveState of v (m, c), lam (m,), resid (m,), iters (int), done
        (bool), each mode's slice dim at its true bucket size (gathered
        over the slice ranks: every rank calls it)."""
        out = []
        for j, carry in enumerate(carries):
            host = self.sched.export_carry(carry, bucket[MODE_PERMS[j][0]])
            out.append(SolveState(v=host.v[slot], lam=host.lam[slot],
                                  resid=host.resid[slot],
                                  iters=int(host.iters[slot]),
                                  done=bool(host.done[slot])))
        return out

    def export_carries(self, bucket, carries):
        """Host form of a bucket's three mode carries
        (`ModeSchedule.export_carry`)."""
        return [self.sched.export_carry(carry, bucket[MODE_PERMS[j][0]])
                for j, carry in enumerate(carries)]

    def import_carries(self, bucket, host_carries):
        """This rank's device carries from `export_carries`' host form
        (from any mesh)."""
        shapes = self.padded_shapes(bucket, 1)
        return tuple(self.sched.import_carry(host, shapes[j][1], self.device)
                     for j, host in enumerate(host_carries))

    def rebuild_blocks(self, bucket, B: int, dtype, arrs):
        """Device blocks from per-slot host tensors (None for a slot
        without a request, whose rows stay zero): this rank's block of
        each tensor's three unfoldings, as the engine stages an admitted
        request."""
        blocks = []
        for j, shape in enumerate(self.mode_shapes(bucket, B)):
            host = torch.zeros(shape, dtype=dtype)
            for s, arr in enumerate(arrs):
                if arr is not None:
                    host[s] = self.local_block(
                        j, torch.as_tensor(np.array(arr)), shape[1:])
            blocks.append(host.to(self.device))
        return tuple(blocks)

    # ---- the two programs ---------------------------------------------
    def build_step(self):
        """(blocks, carries) → (carries, finished (B,) bool).

        One scheduler tick: every slot's three modes advance
        `chunks_per_step` gate chunks (finished modes pass through
        frozen), with the kernel on `power_route`; the carries are updated
        in place.  A slot is finished
        once all three of its modes are converged or capped; the flags
        are the same on every rank.  The blocks may be given in the
        precision policy's dtype (the engine's operand copies), so that
        nothing is cast per step.
        """
        sched = self.sched
        cap = sched.cfg.power_iters
        steps = self.chunks_per_step
        routes = self.power_route or (None,) * 3

        def step(blocks, carries):
            finished = None
            for block, carry, route in zip(blocks, carries, routes):
                new = sched.chunk_local(block, carry, steps=steps,
                                        route=route)
                for f in dataclasses.fields(SolveState):
                    getattr(carry, f.name).copy_(getattr(new, f.name))
                fin = carry.done | (carry.iters >= cap)
                finished = fin if finished is None else finished & fin
            return carries, finished

        return step

    def build_refill(self):
        """(blocks, carries, dims, new_blocks, new_dims, take_new,
        new_done, perm[, warm_v, use_warm, resume_lam, resume_resid,
        resume_iters, resume_done, use_resume]) → (blocks, carries,
        results).

        First the finalize: `results` is the slot-padded batched MSCResult
        of every slot from the pre-repack state, under the pre-repack
        sizes `dims` (B, 3): the similarity tail and the extraction (on
        the device, no host read) from each slot's current iterates,
        frozen for a finished slot, gathered to every rank.  The engine
        reads the evicted slots' rows.  Then the repack, in place: slot s
        takes the fresh request of `new_blocks` (the staged blocks,
        `mode_shapes`) and `new_dims` where take_new[s], else old slot
        perm[s]'s state verbatim; new_done[s] seeds slot s inert.

        The fresh carries (`ModeSchedule.init_mode_carry`) take the
        warm-start inputs, warm_v (per mode, `warm_shapes`) and use_warm
        (B,), and the preempt-to-host resume inputs, resume_lam and
        resume_resid (per mode, `resume_shapes`), resume_iters and
        resume_done (B, 3) and use_resume (B,).  A cold refill passes
        them all-False (the engine's static buffers, so one captured
        program serves cold, warm and resumed admissions).
        """
        sched = self.sched
        dev = self.device

        def refill(blocks, carries, dims, new_blocks, new_dims, take_new,
                   new_done, perm, warm_v, use_warm, resume_lam,
                   resume_resid, resume_iters, resume_done, use_resume):
            dims = torch.as_tensor(dims, device=dev)
            new_dims = torch.as_tensor(new_dims, device=dev)
            take_new = torch.as_tensor(take_new, device=dev).bool()
            new_done = torch.as_tensor(new_done, device=dev).bool()
            perm = torch.as_tensor(perm, device=dev).long()
            use_warm = torch.as_tensor(use_warm, device=dev).bool()
            use_resume = torch.as_tensor(use_resume, device=dev).bool()
            resume_iters = torch.as_tensor(resume_iters, device=dev)
            resume_done = torch.as_tensor(resume_done, device=dev)
            modes = []
            for j in range(3):
                block, carry = blocks[j], carries[j]
                B, b, _, c = block.shape
                m_pad = b * sched.slice_shards
                d, lam = sched.finalize_local(
                    block, sched.slice_mask(m_pad, dims[:, j], dev), carry.v)
                valid = (torch.arange(m_pad, device=dev)[None, :]
                         < dims[:, j][:, None])
                modes.append(sched.finalize_mode_batched(
                    d, lam, carry.iters[:, None], valid))
                fresh = sched.init_mode_carry(
                    B, m_pad, c, new_dims[:, C_OF[j]], new_done,
                    warm_v=torch.as_tensor(warm_v[j], device=dev),
                    use_warm=use_warm,
                    resume_lam=torch.as_tensor(resume_lam[j], device=dev),
                    resume_resid=torch.as_tensor(resume_resid[j],
                                                 device=dev),
                    resume_iters=resume_iters[:, j],
                    resume_done=resume_done[:, j], use_resume=use_resume)
                sched.repack_local(perm, take_new, block, carry,
                                   new_blocks[j], fresh)
            return blocks, carries, MSCResult(modes=tuple(modes))

        return refill


def build_msc_parallel(cfg: MSCConfig, schedule: str = "flat", mesh=None,
                       device=None, **kw):
    """The parallel entry point: schedule "flat" (one device or a mesh,
    `relayout=` in kw) or "grouped" (a mesh of 3·s·q ranks)."""
    if schedule == "flat":
        return build_msc_parallel_flat(cfg, mesh=mesh, device=device, **kw)
    if schedule == "grouped":
        return build_msc_parallel_grouped(cfg, mesh, device=device, **kw)
    raise ValueError(f"unknown schedule {schedule!r}")
