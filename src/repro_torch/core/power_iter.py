"""Batched top-eigenpair extraction for slice covariances (paper §III-C).

Counterpart of `repro/core/power_iter.py`.  Two paths:

* explicit gram (paper-faithful, Alg. 1): form C_i = T_iᵀT_i once
  (`batched_gram`), then iterate v ← C_i v;
* matrix-free: iterate v ← Tᵀ(T v) without forming C_i.

Adaptive gate: when `tol > 0` the sweep count is a cap.  Every
`check_every` sweeps the solver measures the λ-weighted Rayleigh residual
max_i (‖C_i v_i − λ_i v_i‖ / max(λ_i, 1)) · λ_i / λ_max and stops once it
drops below `tol`.  A leading request dim (B, b, r, c) gets one verdict
per request; a converged request's iterate freezes.

The reference runs the gated loop inside one jit; here it is a host
loop over gate chunks whose only device-to-host read is `_any_active`,
once per chunk.  `plan_*` cut a solve at that read (`Eigensolve`): the
eager solvers run the plan, and the static MSC engine replays it from
CUDA graphs.

On a mesh (one process per device, `core/schedule.py`) the solvers take
two `torch.distributed` groups: the slice group, over which the gate's
maxima are all-reduced (MAX) before the chunk's host read, so every rank
leaves the loop on the same sweep; and the inner group, over which the
partial contractions of a row-sharded slice are all-reduced (SUM).

Precision policy `bf16_fp32`: operands of T v and Tᵀ(T v) are rounded
to bf16 and multiplied and summed in fp32; normalization, the gate and
the final Rayleigh quotient stay fp32.  On the gram path the formation
rounds only T to bf16 (C is summed and kept in fp32), the iteration
rounds C and v to bf16, and λ = vᵀCv uses the fp32 C.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import spans

PRECISIONS = ("fp32", "bf16_fp32")

def compute_dtype(precision: str) -> torch.dtype:
    """Operand dtype of the precision policy ("fp32" | "bf16_fp32")."""
    if precision == "fp32":
        return torch.float32
    if precision == "bf16_fp32":
        return torch.bfloat16
    raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")


def _init_vectors(batch, dim: int, dtype=torch.float32, c_valid=None,
                  device="cpu") -> torch.Tensor:
    """Deterministic start vectors: ones + 0.01·sin(1.37·k + 0.3), unit norm.

    batch: an int or a tuple of leading dims.  c_valid masks the start to
    the first c_valid columns (a scalar or an array broadcastable against
    the batch dims), so zero-padded columns stay exactly zero.
    Returns a contiguous (*batch, dim) tensor.
    """
    shape = (batch,) if isinstance(batch, int) else tuple(batch)
    k = torch.arange(dim, dtype=dtype, device=device)
    v0 = torch.ones(dim, dtype=dtype, device=device) + 0.01 * torch.sin(
        1.37 * k + 0.3)
    if c_valid is not None:
        idx = torch.arange(dim, device=device)
        # an int bound compares on the device as it is (a tensor made
        # from it would be a copy from the host)
        keep = idx < c_valid if isinstance(c_valid, int) else (
            idx < torch.as_tensor(c_valid, device=device)[..., None])
        v0 = torch.where(keep, v0,
                         torch.zeros((), dtype=dtype, device=device))
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    return v0.expand(*shape, dim).contiguous()


def _normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def merge_warm_start(v0: torch.Tensor, warm_v: torch.Tensor,
                     use_warm: torch.Tensor) -> torch.Tensor:
    """Warm-start selection of the serving admission path: request b
    starts from `warm_v[b]` (a cached near-converged iterate set) where
    `use_warm[b]`, else from `v0[b]`.  The warm rows are re-normalized;
    an all-zero padded row stays exactly zero.  Device ops only: the
    refill program runs this."""
    w = _normalize(warm_v.to(v0.dtype))
    u = use_warm.reshape((-1,) + (1,) * (v0.dim() - 1))
    return torch.where(u, w, v0)


def predict_remaining_sweeps(iter_hist, current: int, *, cap: int,
                             check_every: int = 1) -> float:
    """Expected remaining sweeps of a request that has run `current`,
    under the empirical histogram of realized max-mode sweeps: the
    conditional tail E[S − current | S > current].  A request past every
    entry is predicted to run to `cap`; an empty histogram predicts one
    more gate chunk.  A pure host function (scheduler policy)."""
    cur = max(0, int(current))
    tail = [int(s) for s in iter_hist if int(s) > cur]
    if tail:
        return sum(tail) / len(tail) - cur
    if any(int(s) <= cur for s in iter_hist):
        return float(max(cap - cur, check_every))
    return float(max(1, check_every))


def _psum_inner(x: torch.Tensor, inner_group=None) -> torch.Tensor:
    """all_reduce(SUM) of a partial contraction over the inner (row-shard)
    group, in place; the identity without one."""
    if inner_group is not None:
        import torch.distributed as dist

        with spans.span("msc.collective", kind="inner_all_reduce"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=inner_group)
    return x


def convergence_gate(lam: torch.Tensor, resid: torch.Tensor, tol: float,
                     slice_group=None) -> torch.Tensor:
    """True once every slice's λ-weighted residual is below tol.

    lam, resid: (..., b).  Maxima reduce over the slice dim only, so each
    leading request gets its own verdict.  With a slice group both maxima
    are all-reduced (MAX) over it, so every rank reaches the same verdict
    (the lockstep exit: a rank that left the loop alone would leave its
    peers waiting in the next collective).
    """
    weighted = torch.amax(resid / torch.clamp(lam, min=1.0) * lam, dim=-1)
    lam_max = torch.amax(lam, dim=-1)
    if slice_group is not None:
        import torch.distributed as dist

        both = torch.stack([weighted, lam_max])
        with spans.span("msc.collective", kind="gate_all_reduce"):
            dist.all_reduce(both, op=dist.ReduceOp.MAX, group=slice_group)
        weighted, lam_max = both[0], both[1]
    return weighted <= tol * torch.clamp(lam_max, min=1e-30)


@dataclasses.dataclass
class SolveState:
    """Resumable eigensolver carry; `step_chunk` maps it to the next one.

    v (..., b, c) unit iterates; lam, resid (..., b) at the last probe;
    iters (...) int32 realized sweeps; done (...) bool gate verdict.
    """

    v: torch.Tensor
    lam: torch.Tensor
    resid: torch.Tensor
    iters: torch.Tensor
    done: torch.Tensor

    def exhausted(self, n_iters: int) -> torch.Tensor:
        """Per request: converged or capped, so it never advances again."""
        return self.done | (self.iters >= n_iters)


def init_solve_state(v0: torch.Tensor) -> SolveState:
    """Fresh SolveState from start vectors v0 (..., b, c)."""
    gshape, b = v0.shape[:-2], v0.shape[-2]
    z = dict(device=v0.device)
    return SolveState(v=v0,
                      lam=torch.zeros(gshape + (b,), dtype=torch.float32, **z),
                      resid=torch.zeros(gshape + (b,), dtype=torch.float32, **z),
                      iters=torch.zeros(gshape, dtype=torch.int32, **z),
                      done=torch.zeros(gshape, dtype=torch.bool, **z))


def step_chunk(chunk_fn, state: SolveState, *, k: int, n_iters: int,
               tol: float, slice_group=None) -> SolveState:
    """One gate chunk: advance every unfinished request by k sweeps.

    chunk_fn(v) -> (v_new, lam, resid).  The chunk always computes on the
    whole batch; `active` only masks the state update, so a finished
    request passes through untouched.  slice_group: see
    `convergence_gate`.
    """
    active = ~state.done & (state.iters < n_iters)
    v_new, lam, resid = chunk_fn(state.v)
    fired = convergence_gate(lam, resid, tol, slice_group)
    return SolveState(
        v=torch.where(active[..., None, None], v_new, state.v),
        lam=torch.where(active[..., None], lam, state.lam),
        resid=torch.where(active[..., None], resid, state.resid),
        iters=torch.where(active, state.iters + k, state.iters),
        done=state.done | (active & fired))


def _any_active(state: SolveState, n_iters: int) -> bool:
    """The gated loop's one host sync per chunk: is any request still live?
    (An `msc.gate_read` span, counted in `msc.gate_reads`.)"""
    with spans.span("msc.gate_read"):
        spans.count("msc.gate_reads")
        return bool(torch.any(~state.exhausted(n_iters)))


def _gated_loop(step, state: SolveState, n_iters: int) -> SolveState:
    """`step` driven until every request is converged or capped, with one
    host read per chunk.  step(state) returns the next state; a captured
    step (a CUDA graph replayed, `serving/msc_engine.py`) updates `state`
    in place and returns it."""
    while _any_active(state, n_iters):
        with spans.span("msc.gate_chunk"):
            state = step(state)
    return state


@dataclasses.dataclass
class Eigensolve:
    """A top-eigenpair solve cut where the host reads.

    `v0` starts it; `step(state)` advances it by one gate chunk when
    `gated`, else runs the whole fixed trip count at once; `finish(state)`
    gives λ.  The operands the step reads (the precision-policy copy, the
    gram) are made once, when the solve is planned, and the closures keep
    them.  `run()` is the eager solve; the static MSC engine captures the
    plan, the step and the finish as CUDA graphs instead.
    """

    v0: torch.Tensor
    step: Callable[[SolveState], SolveState]
    finish: Callable[[SolveState], torch.Tensor]
    n_iters: int
    gated: bool

    def run(self):
        """Returns (lambdas (..., b), vectors (..., b, c), iters with the
        request shape)."""
        state = init_solve_state(self.v0)
        state = (_gated_loop(self.step, state, self.n_iters) if self.gated
                 else self.step(state))
        return self.finish(state), state.v, state.iters


def gated_solve(v0, chunk_fn, k: int, n_iters: int, tol: float,
                finish, slice_group=None) -> Eigensolve:
    """The gated Eigensolve over chunk_fn(v) -> (v_new, lam, resid)."""
    def step(state):
        return step_chunk(chunk_fn, state, k=k, n_iters=n_iters, tol=tol,
                          slice_group=slice_group)

    return Eigensolve(v0, step, finish, n_iters, gated=True)


def make_chunk_probe(matvec, k: int):
    """chunk_fn(v) -> (v_new, lam, resid): k matvec sweeps, the last one
    doubling as the gate probe.  matvec(v) returns the unnormalized C v
    in fp32."""
    def chunk_fn(v):
        for _ in range(k - 1):
            v = _normalize(matvec(v))
        w = matvec(v)
        lam = torch.sum(w * v, dim=-1)  # Rayleigh quotient (v is unit)
        resid = torch.linalg.vector_norm(w - lam[..., None] * v, dim=-1)
        return _normalize(w), lam, resid

    return chunk_fn


def _adaptive(matvec, v0: torch.Tensor, n_iters: int, tol: float,
              check_every: int, finish, slice_group=None) -> Eigensolve:
    """Fixed loop when tol <= 0, gated chunks otherwise.

    With tol > 0 the cap rounds up to a multiple of check_every."""
    if tol <= 0.0:
        def step(state):
            v = state.v
            for _ in range(n_iters):
                v = _normalize(matvec(v))
            return dataclasses.replace(
                state, v=v, iters=torch.full_like(state.iters, n_iters))

        return Eigensolve(v0, step, finish, n_iters, gated=False)
    k = max(1, min(check_every, n_iters))
    return gated_solve(v0, make_chunk_probe(matvec, k), k, n_iters, tol,
                       finish, slice_group)


def matvec_matrix_free(slices: torch.Tensor, precision: str = "fp32",
                       inner_group=None, overlap: bool = False):
    """matvec(v) = Tᵀ round(T round(v)) with precision-policy operands and
    fp32 products and sums (the operand copy is made once, not per call),
    the partials all-reduced over `inner_group`.

    overlap=True splits the slices in two halves: half A's all_reduce is
    in flight (async) while half B computes.  The reduction is elementwise
    and the halves join in order, so the result has the fused form's bits
    (for two inner ranks; more may sum in another order).  It needs an
    inner group and two local slices, and is the fused form otherwise.
    """
    dt = compute_dtype(precision)
    s = slices.to(dt).float()
    b = slices.shape[-3]
    split = bool(overlap) and inner_group is not None and b >= 2

    def local(sh, vh):
        tv = (sh @ vh.to(dt).float().unsqueeze(-1)).squeeze(-1)
        return (tv.to(dt).float().unsqueeze(-2) @ sh).squeeze(-2)

    def matvec(v):
        if not split:
            return _psum_inner(local(s, v), inner_group)
        import torch.distributed as dist

        h = b // 2
        wa = local(s[..., :h, :, :], v[..., :h, :])
        work = dist.all_reduce(wa, op=dist.ReduceOp.SUM, group=inner_group,
                               async_op=True)
        wb = _psum_inner(local(s[..., h:, :, :], v[..., h:, :]), inner_group)
        with spans.span("msc.collective", kind="inner_all_reduce"):
            work.wait()
        return torch.cat([wa, wb], dim=-2)

    return matvec


def rayleigh_fp32(slices: torch.Tensor, v: torch.Tensor,
                  inner_group=None) -> torch.Tensor:
    """λ = ‖T v‖² per slice, always fp32 (summed over `inner_group`)."""
    tv = (slices.float() @ v.unsqueeze(-1)).squeeze(-1)
    return _psum_inner(torch.sum(tv * tv, dim=-1), inner_group)


def build_chunk_fn(slices: torch.Tensor, cfg, inner_group=None, route=None):
    """(chunk_fn, k): the gate-chunk body `step_chunk` advances, chosen by
    cfg.use_kernels (the CUDA kernel: one fused launch per chunk, or one
    `power_matvec` per sweep with an inner group, on `route` if given) or
    the einsum probe."""
    if not cfg.matrix_free:
        raise ValueError("chunk-resumable solves require matrix_free=True "
                         "(the explicit gram has no persistent-operand "
                         "form yet)")
    k = max(1, min(cfg.power_check_every, cfg.power_iters))
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.build_chunk_fn(slices, k, precision=cfg.precision,
                                   inner_group=inner_group, route=route), k
    return make_chunk_probe(matvec_matrix_free(
        slices, cfg.precision, inner_group, overlap=cfg.inner_overlap), k), k


def plan_matrix_free(slices: torch.Tensor, n_iters: int = 60,
                     tol: float = 0.0, check_every: int = 6,
                     precision: str = "fp32", c_valid=None,
                     slice_group=None, inner_group=None,
                     overlap: bool = False) -> Eigensolve:
    """The einsum matrix-free solve of `power_iteration_matrix_free`."""
    v0 = _init_vectors(slices.shape[:-2], slices.shape[-1], torch.float32,
                       c_valid, device=slices.device)
    return _adaptive(
        matvec_matrix_free(slices, precision, inner_group, overlap), v0,
        n_iters, tol, check_every,
        lambda st: rayleigh_fp32(slices, st.v, inner_group), slice_group)


def power_iteration_matrix_free(slices: torch.Tensor, n_iters: int = 60,
                                tol: float = 0.0, check_every: int = 6,
                                precision: str = "fp32", c_valid=None,
                                slice_group=None, inner_group=None):
    """Top eigenpair of T_iᵀT_i for a batch of slices (b, r, c) or
    (B, b, r, c).  Returns (lambdas (..., b), vectors (..., b, c), iters
    with the request shape); λ = ‖T v‖² in fp32 whatever the precision."""
    return plan_matrix_free(slices, n_iters, tol, check_every, precision,
                            c_valid, slice_group, inner_group).run()


def plan_gram(slices: torch.Tensor, n_iters: int = 60, tol: float = 0.0,
              check_every: int = 6, precision: str = "fp32",
              use_kernel: bool = False, c_valid=None, slice_group=None,
              inner_group=None) -> Eigensolve:
    """The explicit-gram solve of `power_iteration_gram`: C is formed here,
    once (a partial C over this rank's rows, all-reduced over
    `inner_group`)."""
    s = slices.to(compute_dtype(precision))
    if use_kernel:
        from repro_torch.kernels import ops as kops

        gram = kops.batched_gram(s.contiguous(), out_dtype=torch.float32)
    else:
        gram = s.float().transpose(-1, -2) @ s.float()
    del s  # a bf16 operand copy is not needed while iterating
    return plan_on_gram(_psum_inner(gram, inner_group), n_iters, tol,
                        check_every, precision, c_valid, slice_group)


def power_iteration_gram(slices: torch.Tensor, n_iters: int = 60,
                         tol: float = 0.0, check_every: int = 6,
                         precision: str = "fp32", use_kernel: bool = False,
                         c_valid=None, slice_group=None, inner_group=None):
    """Paper-faithful path: form C_i = T_iᵀT_i explicitly, then iterate.

    slices (b, r, c) or request-batched (B, b, r, c).  C is summed and
    stored in fp32 (the `batched_gram` kernel when use_kernel, else a
    plain fp32 product of the precision-policy operands).  Returns
    (lambdas (..., b), vectors (..., b, c), iters with the request shape).
    """
    return plan_gram(slices, n_iters, tol, check_every, precision,
                     use_kernel, c_valid, slice_group, inner_group).run()


def plan_on_gram(gram: torch.Tensor, n_iters: int = 60, tol: float = 0.0,
                 check_every: int = 6, precision: str = "fp32",
                 c_valid=None, slice_group=None) -> Eigensolve:
    """The solve of `power_iteration_on_gram` on given covariances."""
    dt = compute_dtype(precision)
    g = gram.to(dt).float()  # bf16-rounded copy; in fp32 gram itself

    def matvec(v):
        return (g @ v.to(dt).float().unsqueeze(-1)).squeeze(-1)

    def finish(state):
        cv = (gram.float() @ state.v.unsqueeze(-1)).squeeze(-1)
        return torch.sum(state.v * cv, dim=-1)

    v0 = _init_vectors(gram.shape[:-2], gram.shape[-1], torch.float32,
                       c_valid, device=gram.device)
    return _adaptive(matvec, v0, n_iters, tol, check_every, finish,
                     slice_group)


def power_iteration_on_gram(gram: torch.Tensor, n_iters: int = 60,
                            tol: float = 0.0, check_every: int = 6,
                            precision: str = "fp32", c_valid=None,
                            slice_group=None):
    """Power iteration given covariance matrices (..., b, c, c).

    The matvec is a plain product on C with precision-policy operands
    (C and v rounded to bf16 under bf16_fp32) and fp32 sums; λ = vᵀCv
    on the fp32 C whatever the precision."""
    return plan_on_gram(gram, n_iters, tol, check_every, precision,
                        c_valid, slice_group).run()


def plan_eigensolve(slices: torch.Tensor, cfg, c_valid=None,
                    slice_group=None, inner_group=None) -> Eigensolve:
    """Dispatch on MSCConfig: matrix_free / use_kernels select the path.
    On a mesh, slice_group gates in lockstep and inner_group sums the
    partial contractions of row-sharded slices."""
    kw = dict(n_iters=cfg.power_iters, tol=cfg.power_tol,
              check_every=cfg.power_check_every, precision=cfg.precision,
              c_valid=c_valid, slice_group=slice_group,
              inner_group=inner_group)
    if not cfg.matrix_free:
        return plan_gram(slices, use_kernel=cfg.use_kernels, **kw)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.plan_matrix_free(slices, **kw)
    return plan_matrix_free(slices, overlap=cfg.inner_overlap, **kw)


def top_eigenpairs(slices: torch.Tensor, cfg, c_valid=None,
                   slice_group=None, inner_group=None):
    """Returns (lambdas (..., b), vectors (..., b, c), iters per request)."""
    return plan_eigensolve(slices, cfg, c_valid, slice_group,
                           inner_group).run()


def rayleigh_residual(slices: torch.Tensor, lam: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """‖C v − λ v‖ / max(λ, 1) per slice, C = TᵀT applied matrix-free: the
    convergence diagnostic the tests read (`repro.core.power_iter`'s)."""
    tv = torch.einsum("brc,bc->br", slices, v)
    cv = torch.einsum("brc,br->bc", slices, tv)
    resid = torch.linalg.vector_norm(cv - lam[:, None] * v, dim=-1)
    return resid / torch.clamp(lam, min=1.0)
