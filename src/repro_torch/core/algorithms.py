"""Federated round algorithms, the SVRG family (counterpart of the subset of
repro/core/algorithms.py this slice ports).

  fedsvrg       — SVRG-corrected local steps (= FedLin)
  fedosaa_svrg  — THE PAPER: FedSVRG local steps + one AA step (Alg. 1)

Every round function has the signature round(state) -> (state, RoundMetrics).
The reference vmaps its per-client bodies over K; here the client axis is
an explicit leading K axis, so each per-client stage is one batched call
(one kernel launch per round on the card): the stacked gradients, the
fused trajectory of every client, their Gram matrices, their eigen-solves
and their updates.

The channel is the identity (lossless wire) and every client takes part in
every round with full-batch local steps; minibatches, cohorts, codecs,
faults and the other algorithm families come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.anderson import (AAConfig, AAStats, multisecant_update,
                                       resolve_aa_impl, trajectory_to_sy)
from repro_torch.core.problem import ClientBatch, FLProblem
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.utils import tree_math as tm

#: the round algorithms this package implements
ALGORITHMS = ("fedsvrg", "fedosaa_svrg")

#: client uplinks of one SVRG-family round, in units of d (paper Table 1):
#: the local gradient, then the model delta
UPLINKS_PER_ROUND = 2


@dataclasses.dataclass(frozen=True)
class AlgoHParams:
    """Tuning knobs of the SVRG family (paper §4 / Appendix D.1)."""

    eta: float = 1.0            # local learning rate η
    local_epochs: int = 10      # L
    aa: AAConfig = AAConfig()
    aa_impl: str = "auto"       # AA step: "tree" (plain tensor ops),
                                # "kernel" (single-pass Gram/update kernels),
                                # "auto" (= kernel)
    local_impl: str = "auto"    # local trajectory: "tree" (autodiff
                                # residuals, 4 X sweeps per step), "kernel"
                                # (fused dual-gradient kernel, 1 X sweep per
                                # step; linear-design models only), "auto"
                                # (= kernel where eligible)


class ServerState(NamedTuple):
    """params: [d]; t: the round counter. The reference's SCAFFOLD control
    variates (c, c_k) come with that family. Its PRNG key has no
    counterpart: the full-batch identity-channel round draws no random
    numbers (an init with init_scale > 0 takes a torch.Generator)."""

    params: torch.Tensor
    t: int


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # global f(w^t) before the update
    grad_norm: torch.Tensor     # ‖∇f(w^t)‖
    theta_mean: torch.Tensor    # mean AA optimization gain (nan if n/a)
    gram_cond_max: torch.Tensor  # worst AA Gram conditioning (nan if n/a)
    gram_cond_mean: torch.Tensor  # mean AA Gram conditioning (nan if n/a)
    aa_used_min: torch.Tensor   # fewest AA columns surviving filtering
    aa_clipped_max: torch.Tensor  # most columns the clip_rtol screen dropped
    cohort_ess: torch.Tensor    # effective sample size 1/Σw² of the weights
    comm_bytes: torch.Tensor    # bytes on the wire this round (a host
                                # tensor: counted from shapes)


def _check_device(problem: FLProblem, device) -> torch.device:
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"the problem's data is on {problem.device}, not on "
                         f"{dev}; build it with device={str(dev)!r}")
    return dev


def init_state(problem: FLProblem, generator: "torch.Generator | None" = None,
               device: "str | torch.device" = DEFAULT_DEVICE) -> ServerState:
    _check_device(problem, device)
    return ServerState(problem.init(generator), 0)


def comm_bytes_per_round(params: torch.Tensor) -> float:
    """Identity channel: each of the round's uplinks carries d values of the
    params' dtype (864 B at d=54 in f64, as the reference counts)."""
    return float(UPLINKS_PER_ROUND * params.numel() * params.element_size())


# --------------------------------------------------------------------------
# local trajectories
# --------------------------------------------------------------------------

#: legal values of the local-trajectory implementation knob
LOCAL_IMPLS = ("auto", "tree", "kernel")


def resolve_local_impl(impl: str, problem: FLProblem | None = None) -> str:
    """"auto" resolves to the fused kernel; a problem without the
    linear-design protocol keeps the autodiff path ("tree") even when the
    kernel is asked for, as the reference's resolve_local_impl does."""
    if impl not in LOCAL_IMPLS:
        raise ValueError(f"unknown local_impl {impl!r}; choose from {LOCAL_IMPLS}")
    if impl == "tree" or (problem is not None and problem.linear_design is None):
        return "tree"
    return "kernel"


def _stack_grads(problem: FLProblem, w: torch.Tensor, x, y, mask) -> torch.Tensor:
    """[K, d] client gradients at w ([d], shared) or at w [K, d] (per client)."""
    return vmap(problem.grad, in_dims=(None if w.dim() == 1 else 0, 0))(
        w, ClientBatch(x, y, mask))


def _stack_losses(problem: FLProblem, w: torch.Tensor, x, y, mask) -> torch.Tensor:
    return vmap(problem.loss, in_dims=(None, 0))(w, ClientBatch(x, y, mask))


def _local_trajectory(hp: AlgoHParams, w0: torch.Tensor,
                      residual_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Run L corrected-GD steps from w0 [K, d] and return the full
    trajectory: (w_traj, r_traj), each [K, L+1, d] — FedOSAA evaluates L+1
    residuals (Alg. 1 needs r_L for the last Y column)."""
    w = w0
    ws, rs = [], []
    for _ in range(hp.local_epochs + 1):
        r = residual_fn(w)
        ws.append(w)
        rs.append(r)
        w = tm.tree_axpy(-hp.eta, r, w)
    return torch.stack(ws, 1), torch.stack(rs, 1)


def _fused_trajectory(problem: FLProblem, hp: AlgoHParams, w0: torch.Tensor,
                      batch: ClientBatch, anchor_scale: float,
                      corr: torch.Tensor | None):
    """The fused linear-design twin of _local_trajectory (kernels/
    local_update): both residual gradients of every step ride ONE sweep of
    the client's design. r(w) = ∇f_k(w) − a·∇f_k(w^t) + corr collapses to
    Xᵀ(c(Xw) − a·c(Xw^t))/n + reg·w + u with u = corr − a·reg·w^t."""
    design = problem.linear_design(batch)
    u = torch.zeros_like(w0) if corr is None else corr
    if anchor_scale:
        u = u - design.reg * w0
    return fused_trajectory(
        design.x[:, None], design.y[:, None], batch.mask[:, None], w0, u,
        link=design.link, reg=design.reg, eta=hp.eta,
        anchor_scale=anchor_scale, steps=hp.local_epochs + 1)


def _svrg_trajectory(problem: FLProblem, hp: AlgoHParams, w_t, g_global,
                     batch: ClientBatch):
    """Every client's SVRG-corrected trajectory from the anchor w_t [d]:
    the fused kernel when resolved, else the two-autodiff residual path."""
    if hp.local_impl == "kernel":
        return _fused_trajectory(problem, hp, w_t, batch, 1.0, g_global)
    K = batch.x.shape[0]
    # −∇f_k(w^t) + ∇f(w^t): the constant SVRG correction of full-batch steps
    corr = g_global - _stack_grads(problem, w_t, *batch)

    def residual(w):
        return _stack_grads(problem, w, *batch) + corr

    return _local_trajectory(hp, w_t.expand(K, -1), residual)


def _client_svrg(problem: FLProblem, hp: AlgoHParams, use_aa: bool, w_t,
                 g_global, x, y, mask):
    """Every client's local work: trajectory, then (FedOSAA) one AA step.
    Returns (w_k [K, d], AAStats with [K] entries)."""
    w_traj, r_traj = _svrg_trajectory(problem, hp, w_t, g_global,
                                      ClientBatch(x, y, mask))
    if not use_aa:
        return w_traj[:, -1], _nan_stats(x.shape[0], w_t)
    s, y_stack = trajectory_to_sy(w_traj, r_traj, hp.aa.residual_ema)
    return multisecant_update(w_t, g_global, s, y_stack, hp.eta, hp.aa,
                              impl=hp.aa_impl)


def _nan_stats(k: int, like: torch.Tensor) -> AAStats:
    nan = torch.full((k,), torch.nan, dtype=like.dtype, device=like.device)
    zero = torch.zeros((k,), dtype=torch.int64, device=like.device)
    return AAStats(nan, nan, nan, zero, zero)


def _aggregate(weights: torch.Tensor, stacked: torch.Tensor,
               anchor: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_k weights_k · stacked_k; with ``anchor``, the delta form
    anchor + Σ_k w_k (x_k − anchor)."""
    weights = weights.to(stacked.dtype)
    if anchor is None:
        return torch.tensordot(weights, stacked, dims=1)
    return anchor + torch.tensordot(weights, stacked - anchor, dims=1)


def _nan_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """Max (or min) of the non-nan entries of a per-client vector; nan if
    there are none. No host sync."""
    ok = ~torch.isnan(x)
    fill = -torch.inf if largest else torch.inf
    filled = torch.where(ok, x, fill)
    v = filled.max() if largest else filled.min()
    return torch.where(ok.any(), v, torch.nan)


class CrossClientReduce:
    """Cross-client reductions of the one-device runtime with the identity
    channel. The reference's uplink/broadcast are identities on that
    channel, so this slice's round cores do not call them."""

    def wsum(self, weights, stacked, anchor=None):
        return _aggregate(weights, stacked, anchor)

    def nanmean(self, x):
        return torch.nanmean(x)

    def nanmax(self, x):
        return _nan_extreme(x, largest=True)

    def nanmin(self, x):
        return _nan_extreme(x, largest=False)

    def ess(self, weights):
        return 1.0 / torch.clamp((weights * weights).sum(), min=1e-30)


VMAP_REDUCE = CrossClientReduce()


def _metric_parts(problem, R, w, g, stats: AAStats, x, y, mask, weight,
                  comm_bytes: float) -> RoundMetrics:
    """f(w), ‖g‖ and the AA health stats, reduced across every client, and
    the round's wire bytes. The column counts are nan where a client ran no
    AA step (theta is nan)."""
    no_aa = torch.isnan(stats.theta)
    used = torch.where(no_aa, torch.nan, stats.used_columns.to(torch.float32))
    clipped = torch.where(no_aa, torch.nan,
                          stats.clipped_columns.to(torch.float32))
    return RoundMetrics(
        loss=R.wsum(weight, _stack_losses(problem, w, x, y, mask)),
        grad_norm=tm.tree_norm(g),
        theta_mean=R.nanmean(stats.theta),
        gram_cond_max=R.nanmax(stats.gram_cond),
        gram_cond_mean=R.nanmean(stats.gram_cond),
        aa_used_min=R.nanmin(used),
        aa_clipped_max=R.nanmax(clipped),
        cohort_ess=R.ess(weight),
        comm_bytes=torch.tensor(comm_bytes),
    )


def _svrg_round_core(problem, hp, use_aa, R, w_t, x, y, mask, weight,
                     comm_bytes: float):
    """SVRG family: corrected local steps (+ optional AA), delta aggregation.
    ``weight`` [K] weighs the clients both in ∇f and in the aggregate (every
    client takes part in every round).

    Two wire crossings, both lossless here: the local full-batch gradients
    travel up, then w^t and ∇f travel down and the model deltas travel up."""
    g_k = _stack_grads(problem, w_t, x, y, mask)
    g_global = R.wsum(weight, g_k)
    w_k, stats = _client_svrg(problem, hp, use_aa, w_t, g_global, x, y, mask)
    new_params = R.wsum(weight, w_k, anchor=w_t)
    return new_params, _metric_parts(problem, R, w_t, g_global, stats, x, y,
                                     mask, weight, comm_bytes)


def make_round_fn(algo: str, problem: FLProblem, hp: AlgoHParams,
                  device: "str | torch.device" = DEFAULT_DEVICE):
    """Return round(state) -> (state, RoundMetrics) for ``algo`` on
    ``problem`` (whose data must already be on ``device``)."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; choose from {ALGORITHMS}")
    _check_device(problem, device)
    # resolve the knobs once, so the round bodies see "tree"/"kernel"
    hp = dataclasses.replace(hp, aa_impl=resolve_aa_impl(hp.aa_impl),
                             local_impl=resolve_local_impl(hp.local_impl, problem))
    comm_bytes = comm_bytes_per_round(problem.init(None))
    C = problem.clients
    use_aa = algo == "fedosaa_svrg"

    def round_fn(state: ServerState):
        new_params, metrics = _svrg_round_core(
            problem, hp, use_aa, VMAP_REDUCE, state.params, C.x, C.y, C.mask,
            C.weight, comm_bytes)
        return ServerState(new_params, state.t + 1), metrics

    return round_fn


def _cg_solve(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain CG on an SPD system, fixed iteration count."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = tm.tree_dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(tm.tree_dot(p, ap), min=1e-30)
        x = tm.tree_axpy(alpha, p, x)
        r = tm.tree_axpy(-alpha, ap, r)
        rs_new = tm.tree_dot(r, r)
        p = tm.tree_axpy(rs_new / torch.clamp(rs, min=1e-30), p, r)
        rs = rs_new
    return x
