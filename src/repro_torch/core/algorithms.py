"""Federated round algorithms, the SVRG family (counterpart of the subset of
repro/core/algorithms.py this slice ports).

  fedsvrg       — SVRG-corrected local steps (= FedLin)
  fedosaa_svrg  — THE PAPER: FedSVRG local steps + one AA step (Alg. 1)

Every round function has the signature round(state) -> (state, RoundMetrics).
The reference vmaps its per-client bodies over K; here the client axis is
an explicit leading K axis, so each per-client stage is one batched call
(one kernel launch per round on the card): the stacked gradients, the
fused trajectory of every client, their Gram matrices, their eigen-solves,
their updates, and each uplink's codec.

Every wire crossing goes through a CommChannel (repro_torch/comm): the
broadcasts through its downlink codec, the uploads through its uplink codec
with error feedback and difference coding, as the uplink schema of the
algorithm declares them. Every client takes part in every round with
full-batch local steps; minibatches, cohorts, faults and the other
algorithm families come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.comm import CommChannel, IdentityCodec, make_channel
from repro_torch.comm.schema import (DELTA_UPLINK, GRAD_UPLINK, UplinkSpec,
                                     init_schema_state, uplink_byte_breakdown,
                                     validate_schema)
from repro_torch.core.anderson import (AAConfig, AAStats, multisecant_update,
                                       resolve_aa_impl, trajectory_to_sy)
from repro_torch.core.problem import ClientBatch, FLProblem
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.utils import tree_math as tm

#: the round algorithms this package implements
ALGORITHMS = ("fedsvrg", "fedosaa_svrg")

#: the uploads of one round of each algorithm, in round order
#: (comm/schema.py): the local gradient, then the model delta
_SVRG_UPLINKS = validate_schema((GRAD_UPLINK, DELTA_UPLINK))
UPLINK_SCHEMAS: "dict[str, tuple[UplinkSpec, ...]]" = {
    "fedsvrg": _SVRG_UPLINKS,
    "fedosaa_svrg": _SVRG_UPLINKS,
}


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
    """params: [d]; t: the round counter; comm: the clients' carried wire
    state, ``{tag: {"ef": [K, d], "ref": [K, d]}}`` keyed by the
    algorithm's uplink schema (comm/schema.py), or None on a lossless
    channel. The reference's SCAFFOLD control variates (c, c_k) come with
    that family. Its PRNG key has no counterpart: a stochastic codec's
    uniforms are drawn from (seed, t, the uplink's fold) (make_round_fn)."""

    params: torch.Tensor
    t: int
    comm: "dict | None" = None


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
    arrivals: torch.Tensor      # deadline-gated landings this round; nan (a
                                # host tensor) while robust/async_agg is not
                                # ported, as the reference's with async off
    staleness_mean: torch.Tensor  # mean landed buffer age (nan, likewise)
    staleness_max: torch.Tensor   # oldest landed buffer age (nan, likewise)


#: the RoundMetrics fields that are host tensors: counted from shapes and the
#: configuration, the same in every round of one round function. The engine
#: reads them on the host and keeps them out of its device readout.
HOST_METRICS = ("comm_bytes", "arrivals", "staleness_mean", "staleness_max")


def _check_device(problem: FLProblem, device) -> torch.device:
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"the problem's data is on {problem.device}, not on "
                         f"{dev}; build it with device={str(dev)!r}")
    return dev


def init_state(problem: FLProblem, generator: "torch.Generator | None" = None,
               device: "str | torch.device" = DEFAULT_DEVICE,
               channel: "CommChannel | str | None" = None,
               algo: str | None = None) -> ServerState:
    """Round 0: the problem's initial params and the comm buffers ``algo``
    carries under ``channel`` (``algo`` may be None on the identity wire)."""
    _check_device(problem, device)
    params = problem.init(generator)
    channel = make_channel(channel)
    if algo is None:
        if not channel.is_identity:
            raise ValueError(f"init_state: channel {channel.name!r} carries "
                             "per-algorithm comm state; pass algo")
        return ServerState(params, 0, None)
    comm = init_comm_state(channel, params, problem.clients.num_clients, algo)
    return ServerState(params, 0, comm)


def init_comm_state(channel: CommChannel, params: torch.Tensor, K: int,
                    algo: str) -> "dict | None":
    """The per-client buffers of ``algo``'s uplink schema under ``channel``
    (ServerState.comm); None when no uplink carries any."""
    return init_schema_state(channel, UPLINK_SCHEMAS[algo], params, K)


def comm_bytes_per_round(algo: str, params: torch.Tensor,
                         channel: "CommChannel | str | None" = None) -> float:
    """Bytes on the wire for one client's uploads in one round of ``algo``
    through ``channel``: each record of its uplink schema at its kind's
    codec-exact rate. On the identity channel each upload carries d values
    of the params' dtype (864 B per round at d=54 in f64); under int8 it
    is 116 B per round at d=54 (54 B + one 4 B scale, twice)."""
    channel = make_channel(channel)
    return float(sum(uplink_byte_breakdown(
        channel, UPLINK_SCHEMAS[algo], params).values()))


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
    the fused kernel when resolved, else the two-autodiff residual path.
    Runs inside the ``fl.local_trajectory`` profiler scope, as the
    reference's named scope."""
    with record_function("fl.local_trajectory"):
        if hp.local_impl == "kernel":
            return _fused_trajectory(problem, hp, w_t, batch, 1.0, g_global)
        K = batch.x.shape[0]
        # −∇f_k(w^t) + ∇f(w^t): the constant SVRG correction of full-batch
        # steps
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
    """Cross-client reductions and the wire of the one-device runtime."""

    def __init__(self, channel: CommChannel | None = None):
        self.channel = make_channel(channel)

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

    def uplink(self, stacked: torch.Tensor, spec: UplinkSpec,
               anchor: torch.Tensor | None = None, state: "dict | None" = None,
               draw: "Callable[[UplinkSpec, tuple], torch.Tensor] | None" = None):
        """Channel roundtrip of every client's upload stacked [K, d],
        declared by ``spec`` (repro/core/algorithms.py:837-911).

        The wire carries ``stacked_k − anchor`` for an anchored spec, less
        the carried reference ``state[spec.tag]["ref"]`` when there is one
        (difference coding), plus the error-feedback residual
        ``state[spec.tag]["ef"]``; ``codec.uplink`` does that arithmetic
        around the codec. ``draw(spec, shape)`` gives a stochastic
        codec's uniforms [K, nc, C]. ``state`` is the whole comm dict (or
        None); tags other than ``spec.tag`` pass through. Returns (the
        server's view of the uploads [K, d], the comm dict with this tag's
        buffers advanced)."""
        if spec.anchored != (anchor is not None):
            raise ValueError(
                f"uplink {spec.tag!r}: anchored={spec.anchored} but anchor "
                f"{'missing' if anchor is None else 'given'}")
        codec = self.channel.up_codec(spec.kind)
        if isinstance(codec, IdentityCodec):
            return stacked, state
        sub = state.get(spec.tag) if state is not None else None
        ef = sub.get("ef") if sub else None
        ref = sub.get("ref") if sub else None
        with record_function("fl.uplink"):
            shape = codec.draw_shape(stacked.shape[-1])
            if shape is not None and draw is None:
                raise ValueError(f"uplink {spec.tag!r}: codec {codec} draws "
                                 "uniforms; pass draw")
            u = None if shape is None else draw(spec, (stacked.shape[0], *shape))
            dec, new_e, new_h = codec.uplink(stacked, u, anchor, ref, ef)
        if not sub:
            return dec, state
        new_sub = {}
        if "ef" in sub:
            new_sub["ef"] = new_e
        if "ref" in sub:
            new_sub["ref"] = new_h
        return dec, {**state, spec.tag: new_sub}

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Server->client broadcast through the (deterministic) downlink."""
        return self.channel.broadcast(x)


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
        arrivals=torch.tensor(torch.nan),
        staleness_mean=torch.tensor(torch.nan),
        staleness_max=torch.tensor(torch.nan),
    )


def _svrg_round_core(problem, hp, use_aa, R, w_t, x, y, mask, weight,
                     comm_bytes: float, comm=None, draw=None):
    """SVRG family: corrected local steps (+ optional AA), delta aggregation
    (repro/core/algorithms.py:998-1029). ``weight`` [K] weighs the clients
    both in ∇f and in the aggregate (every client takes part in every round).

    Two wire crossings: w^t travels down and the local full-batch gradients
    travel up; then ∇f travels down and the model deltas travel up, anchored
    at the broadcast w^t. The metrics are taken at the broadcast w^t.
    Returns (new params, metrics, the advanced comm state)."""
    w_t = R.broadcast(w_t)
    g_k, comm = R.uplink(_stack_grads(problem, w_t, x, y, mask), GRAD_UPLINK,
                         state=comm, draw=draw)
    g_global = R.broadcast(R.wsum(weight, g_k))
    w_k, stats = _client_svrg(problem, hp, use_aa, w_t, g_global, x, y, mask)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    new_params = R.wsum(weight, w_k, anchor=w_t)
    return new_params, _metric_parts(problem, R, w_t, g_global, stats, x, y,
                                     mask, weight, comm_bytes), comm


def _draw_seed(seed: int, t: int, fold: int) -> int:
    """The seed of one uplink's uniforms in round t (host arithmetic only)."""
    return int(np.random.SeedSequence([seed, t, fold]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_round_fn(algo: str, problem: FLProblem, hp: AlgoHParams,
                  channel: "CommChannel | str | None" = None, seed: int = 0,
                  device: "str | torch.device" = DEFAULT_DEVICE):
    """Return round(state, uniforms=None) -> (state, RoundMetrics) for
    ``algo`` on ``problem`` (whose data must already be on ``device``),
    every wire crossing through ``channel`` (None: the lossless identity).

    A stochastic codec's uniforms: one [K, nc, C] f32 tensor per uplink and
    round, from a torch.Generator on the device seeded from (seed, t, the
    uplink's fold); row k is client k. The reference's key streams cannot
    be reproduced in torch, so a caller that needs its draws (the parity
    tests) passes ``uniforms={tag: [K, nc, C]}`` instead.

    A chunk of rounds gets its uniforms ahead of time through two
    attributes of the returned function: ``round.uniform_shapes``, {tag:
    (K, nc, C)} for each uplink that draws (empty on a deterministic wire),
    and ``round.fill_uniforms(bufs, t0)``, which writes into
    ``bufs[tag][i]`` the uniforms round t0 + i would draw, by the same
    generator calls. The engine (core/engine.py) fills its static
    [B, K, nc, C] buffers so before each replay of its CUDA graph and passes
    slot i's views as ``uniforms``: a graph would otherwise replay the
    draws seeded at capture.

    On the card, with ``aa_impl`` "kernel" (or "auto", its default), a
    round makes no host read: every kernel and torch op is enqueued and
    nothing is read back (chip_smoke.py holds a round to it under
    ``torch.cuda.set_sync_debug_mode("error")``), so the engine can capture
    it. The "tree" AA path's batched ``torch.linalg.eigh`` checks its info
    on the host once a round."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; choose from {ALGORITHMS}")
    dev = _check_device(problem, device)
    # resolve the knobs once, so the round bodies see "tree"/"kernel"
    hp = dataclasses.replace(hp, aa_impl=resolve_aa_impl(hp.aa_impl),
                             local_impl=resolve_local_impl(hp.local_impl, problem))
    channel = make_channel(channel)
    params0 = problem.init(None)
    comm_bytes = comm_bytes_per_round(algo, params0, channel)
    R = CrossClientReduce(channel)
    C = problem.clients
    use_aa = algo == "fedosaa_svrg"
    # reseeded for each uplink's draw
    gen = torch.Generator(device=dev)
    folds, shapes = {}, {}
    for spec in UPLINK_SCHEMAS[algo]:
        shape = channel.up_codec(spec.kind).draw_shape(params0.shape[-1])
        if shape is not None:
            folds[spec.tag] = spec.fold
            shapes[spec.tag] = (C.num_clients, *shape)

    def uniforms_of(t: int, fold: int, shape: tuple,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """Round t's uniforms for the uplink of ``fold``."""
        gen.manual_seed(_draw_seed(seed, t, fold))
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=dev, out=out)

    def fill_uniforms(bufs: "dict[str, torch.Tensor]", t0: int) -> None:
        for tag, buf in bufs.items():
            for i in range(buf.shape[0]):
                uniforms_of(t0 + i, folds[tag], shapes[tag], out=buf[i])

    def round_fn(state: ServerState, uniforms: "dict | None" = None):
        def draw(spec: UplinkSpec, shape: tuple) -> torch.Tensor:
            if uniforms is not None:
                u = uniforms[spec.tag]
                if tuple(u.shape) != shape:
                    raise ValueError(f"uplink {spec.tag!r}: uniforms of shape "
                                     f"{tuple(u.shape)}, expected {shape}")
                return u
            return uniforms_of(state.t, spec.fold, shape)

        new_params, metrics, comm = _svrg_round_core(
            problem, hp, use_aa, R, state.params, C.x, C.y, C.mask,
            C.weight, comm_bytes, state.comm, draw)
        return ServerState(new_params, state.t + 1, comm), metrics

    round_fn.uniform_shapes = shapes
    round_fn.fill_uniforms = fill_uniforms
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
