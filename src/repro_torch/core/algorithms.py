"""Federated round algorithms (counterpart of repro/core/algorithms.py):
all ten of the reference's.

The trajectory family, ``TRAJECTORY_ALGOS`` (local work: an L-step
corrected-GD trajectory, the fused trajectory kernel's):

  fedavg            — McMahan et al. baseline (no correction)
  fedsvrg           — SVRG-corrected local steps (= FedLin)
  scaffold          — control-variate corrected local steps (the paper's
                      variant: c = ∇f(w^{t-1}), c_k = ∇f_k(w^{t-1}))
  fedosaa_svrg      — THE PAPER: FedSVRG local steps + one AA step (Alg. 1)
  fedosaa_scaffold  — SCAFFOLD local steps + one AA step (Alg. 2)
  fedosaa_avg       — negative control (Appendix D.4): AA on uncorrected steps
  lbfgs             — one-step L-BFGS on the same S/Y data (App. D.1)

The Newton family, ``NEWTON_ALGOS`` (local work: Hessian-vector products,
forward-over-reverse autodiff as the reference's):

  giant             — local Newton-CG on the global gradient (Wang et al.)
  newton_gmres      — GIANT with GMRES in place of CG (core/krylov.py)
  dane              — exact local minimization of the DANE surrogate by
                      damped Newton-CG with backtracking

Every round function has the signature round(state, draws=None) ->
(state, RoundMetrics). The reference vmaps its per-client bodies over K;
here the client axis is an explicit leading K axis, so each per-client
stage is one batched call (one kernel launch per round on the card): the
stacked gradients, the fused trajectory of every client, their Gram
matrices, their AA steps, every client's CG or GMRES iteration, and each
uplink's codec.

Every wire crossing goes through a CommChannel (repro_torch/comm): the
broadcasts through its downlink codec, the uploads through its uplink codec
with error feedback and difference coding, as the uplink schema of the
algorithm declares them. Local steps of the trajectory family are full
batch, or minibatches of ``batch_size`` rows drawn per step; the SVRG family
can carry AA columns across rounds (``carry_history``). GIANT and
Newton-GMRES can end a round with the reference's global line search
(``line_search``).

Cohorts (``participation`` < 1 or ``cohort_size``): a round computes on C
of the K clients, drawn without replacement with p ∝ data size. Their data,
draws and per-client state rows (c_k, hist_s/hist_y, the comm buffers;
core/client_store.py) are gathered to [C, ...], the unchanged round core
runs on them, and the updated rows are scattered back into the K-sized
store: clients outside the cohort keep their rows bit for bit. C = K is
the identity cohort, bit for bit the dense round.

Faults and the deadline gate (``faults=``, ``async_cfg=``;
repro_torch/robust): the round draws its fault realization with its other
draws, zeroes dropped clients' weights, wraps the reduce so the uplinks
carry the byzantine, stale and DP perturbations, poisons the byzantine
clients' last AA column (the SVRG family's FedOSAA), and after the
unchanged round core refreshes the stale anchors, freezes the dropped
clients' rows and runs the gate's buffer fold and transition, dense or in
a cohort, with no host read.
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
from repro_torch.comm.schema import (CTRL_UPLINK, DELTA_UPLINK, DIR_UPLINK,
                                     GRAD_UPLINK, UplinkSpec, init_schema_state,
                                     uplink_byte_breakdown, validate_schema)
from repro_torch.core.anderson import (AAConfig, AAStats, lbfgs_two_loop,
                                       multisecant_update, resolve_aa_impl,
                                       trajectory_to_sy)
from repro_torch.core.client_store import ClientStateStore
from repro_torch.core.krylov import gmres
from repro_torch.core.problem import (ClientBatch, FLProblem, sample_minibatch,
                                      sample_minibatch_indices)
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.robust import async_agg, faults as flt
from repro_torch.utils import tree_math as tm

#: the round algorithms this package implements: the reference's ten
ALGORITHMS = ("fedavg", "fedsvrg", "scaffold", "fedosaa_svrg",
              "fedosaa_scaffold", "fedosaa_avg", "lbfgs", "giant",
              "newton_gmres", "dane")
#: algorithms whose local work is the L-step corrected-GD trajectory: the
#: ones the fused trajectory kernel applies to
TRAJECTORY_ALGOS = ALGORITHMS[:7]
#: the Newton family: local Hessian-vector products, no trajectory
NEWTON_ALGOS = ("giant", "newton_gmres", "dane")
#: the algorithms that aggregate Newton directions and may end a round with
#: the global line search (AlgoHParams.line_search)
LINE_SEARCH_ALGOS = ("giant", "newton_gmres")
#: the algorithms that carry SCAFFOLD's control variates (ServerState.c/c_k)
SCAFFOLD_ALGOS = ("scaffold", "fedosaa_scaffold")


class CommCost(NamedTuple):
    """Per-round communication accounting (paper Table 1).

    round_trips — synchronous server↔client exchanges per round: 2 where
      the global gradient ∇f(w^t) is needed before local work (the SVRG
      family, L-BFGS, the Newton family), 1 where everything rides one
      exchange (FedAvg, SCAFFOLD).
    float_units — client-uplink floats per round in units of d: 1 for a
      model delta alone, 2 when a gradient or a control variate travels
      beside it. Each algorithm's uplink schema has that many records.
    """

    round_trips: int
    float_units: float


COMM_TABLE = {
    "fedavg":           CommCost(1, 1.0),
    "fedsvrg":          CommCost(2, 2.0),
    "scaffold":         CommCost(1, 2.0),
    "fedosaa_svrg":     CommCost(2, 2.0),
    "fedosaa_scaffold": CommCost(1, 2.0),
    "fedosaa_avg":      CommCost(1, 1.0),
    "lbfgs":            CommCost(2, 2.0),
    "giant":            CommCost(2, 2.0),
    "newton_gmres":     CommCost(2, 2.0),
    "dane":             CommCost(2, 2.0),
}


def comm_floats_per_round(algo: str, d: int, line_search: bool = False) -> float:
    """Floats on the wire for one client's uploads in one round of ``algo``
    on a d-parameter model (Table 1's units times d), plus d for the line
    search's broadcast of the aggregated direction (GIANT, Newton-GMRES)."""
    extra = float(d) if line_search and algo in LINE_SEARCH_ALGOS else 0.0
    return COMM_TABLE[algo].float_units * d + extra


#: the uploads of one round of each algorithm, in round order
#: (comm/schema.py): the SVRG family, L-BFGS and DANE send the local
#: gradient, then the model delta; SCAFFOLD the delta, then its control
#: variate; the AVG family the delta alone; GIANT and Newton-GMRES the
#: gradient, then the Newton direction (unanchored, error feedback only)
_SVRG_UPLINKS = validate_schema((GRAD_UPLINK, DELTA_UPLINK))
_SCAFFOLD_UPLINKS = validate_schema((DELTA_UPLINK, CTRL_UPLINK))
_AVG_UPLINKS = validate_schema((DELTA_UPLINK,))
_NEWTON_UPLINKS = validate_schema((GRAD_UPLINK, DIR_UPLINK))
UPLINK_SCHEMAS: "dict[str, tuple[UplinkSpec, ...]]" = {
    "fedavg":           _AVG_UPLINKS,
    "fedosaa_avg":      _AVG_UPLINKS,
    "fedsvrg":          _SVRG_UPLINKS,
    "fedosaa_svrg":     _SVRG_UPLINKS,
    "scaffold":         _SCAFFOLD_UPLINKS,
    "fedosaa_scaffold": _SCAFFOLD_UPLINKS,
    "lbfgs":            _SVRG_UPLINKS,
    "giant":            _NEWTON_UPLINKS,
    "newton_gmres":     _NEWTON_UPLINKS,
    "dane":             _SVRG_UPLINKS,
}

#: the name of a round's minibatch draw (make_round_fn), and the fold of its
#: seed: distinct from every uplink's (comm/schema.py, 101–104)
MINIBATCH = "minibatch"
MINIBATCH_FOLD = 105
#: the name of a cohort round's draw of its C client indices, and its fold
COHORT = "cohort"
COHORT_FOLD = 106


@dataclasses.dataclass(frozen=True)
class AlgoHParams:
    """Tuning knobs shared by all algorithms (paper §4 / Appendix D.1)."""

    eta: float = 1.0            # local learning rate η
    local_epochs: int = 10      # L (the CG/GMRES iterations q of GIANT and
                                # Newton-GMRES)
    batch_size: int | None = None   # rows drawn per local step; None: full
                                # batch (the trajectory family only)
    aa: AAConfig = AAConfig()
    line_search: bool = False   # GIANT-style global backtracking (GIANT,
                                # Newton-GMRES): one extra broadcast
    participation: float = 1.0  # share of the clients in a round: < 1
                                # draws a cohort of C = max(1, round(p·K))
                                # (resolve_cohort_size)
    cohort_size: int | None = None  # an explicit cohort size C (wins over
                                # ``participation``); C = K is the identity
                                # cohort; None with p >= 1: the dense round
    carry_history: int = 0      # (s, y) columns carried ACROSS rounds (paper
                                # App. A option 1; the SVRG family only):
                                # the last H fresh columns of each round
                                # are prepended to the next round's
    dane_newton_iters: int = 20  # DANE: damped Newton steps a round
    dane_cg_iters: int = 100    # DANE: CG iterations a Newton step
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
    channel; c [d] and c_k [K, d]: SCAFFOLD's server and client control
    variates (None for the other algorithms); hist_s, hist_y [K, H, d]: the
    AA columns carried across rounds (None unless ``carry_history`` > 0).
    The reference's PRNG key has no counterpart: a round's draws come from
    (seed, t, a fold of their own) (make_round_fn)."""

    params: torch.Tensor
    t: int
    comm: "dict | None" = None
    c: "torch.Tensor | None" = None
    c_k: "torch.Tensor | None" = None
    hist_s: "torch.Tensor | None" = None
    hist_y: "torch.Tensor | None" = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # global f(w^t) before the update
    grad_norm: torch.Tensor     # ‖∇f(w^t)‖ (SCAFFOLD: ‖c‖ of the new c)
    theta_mean: torch.Tensor    # mean AA optimization gain (nan if n/a)
    gram_cond_max: torch.Tensor  # worst AA Gram conditioning (nan if n/a)
    gram_cond_mean: torch.Tensor  # mean AA Gram conditioning (nan if n/a)
    aa_used_min: torch.Tensor   # fewest AA columns surviving filtering
    aa_clipped_max: torch.Tensor  # most columns the clip_rtol screen dropped
    cohort_ess: torch.Tensor    # effective sample size 1/Σw² of the weights
    comm_bytes: torch.Tensor    # bytes on the wire this round (a host
                                # tensor: counted from shapes)
    arrivals: torch.Tensor      # deadline-gated landings this round (a
                                # device tensor); nan, a host tensor, with
                                # the gate off
    staleness_mean: torch.Tensor  # mean landed buffer age (likewise)
    staleness_max: torch.Tensor   # oldest landed buffer age (likewise)


#: the RoundMetrics fields that are host tensors in a synchronous round:
#: counted from shapes and the configuration, the same in every round of
#: one round function. A round function names its own in ``host_metrics``
#: (the gated round's arrivals and staleness are device tensors); the
#: engine reads those on the host and keeps them out of its device readout.
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
               algo: str | None = None,
               hp: AlgoHParams | None = None) -> ServerState:
    """Round 0: the problem's initial params, the comm buffers ``algo``
    carries under ``channel`` (``algo`` may be None on the identity wire),
    zero control variates for the SCAFFOLD family, and zero carried AA
    columns [K, H, d] when ``hp.carry_history`` = H > 0."""
    _check_device(problem, device)
    params = problem.init(generator)
    channel = make_channel(channel)
    K = problem.clients.num_clients
    hist_s = hist_y = c = c_k = None
    if hp is not None and hp.carry_history > 0:
        hist_s, hist_y = (params.new_zeros((K, hp.carry_history, *params.shape))
                          for _ in range(2))
    if algo is None:
        if not channel.is_identity:
            raise ValueError(f"init_state: channel {channel.name!r} carries "
                             "per-algorithm comm state; pass algo")
        return ServerState(params, 0, None, hist_s=hist_s, hist_y=hist_y)
    if algo in SCAFFOLD_ALGOS:
        c, c_k = torch.zeros_like(params), params.new_zeros((K, *params.shape))
    comm = init_comm_state(channel, params, K, algo)
    return ServerState(params, 0, comm, c, c_k, hist_s, hist_y)


def init_comm_state(channel: CommChannel, params: torch.Tensor, K: int,
                    algo: str) -> "dict | None":
    """The per-client buffers of ``algo``'s uplink schema under ``channel``
    (ServerState.comm); None when no uplink carries any."""
    return init_schema_state(channel, UPLINK_SCHEMAS[algo], params, K)


def comm_bytes_per_round(algo: str, params: torch.Tensor,
                         channel: "CommChannel | str | None" = None,
                         line_search: bool = False) -> float:
    """Bytes on the wire for one client's uploads in one round of ``algo``
    through ``channel``: each record of its uplink schema at its kind's
    codec-exact rate, plus, with ``line_search`` on GIANT or Newton-GMRES,
    the broadcast of the aggregated direction at the downlink's rate. On
    the identity channel each upload carries d values of the params' dtype
    (864 B per round of FedOSAA-SVRG at d=54 in f64); under int8 it is
    116 B per round at d=54 (54 B + one 4 B scale, twice). On fp32 it is 4
    × ``comm_floats_per_round``."""
    channel = make_channel(channel)
    total = sum(uplink_byte_breakdown(
        channel, UPLINK_SCHEMAS[algo], params).values())
    if line_search and algo in LINE_SEARCH_ALGOS:
        total += channel.downlink_bytes(params)
    return float(total)


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
    """[K] client losses at w [d] (shared) or at w [K, d] (per client)."""
    return vmap(problem.loss, in_dims=(None if w.dim() == 1 else 0, 0))(
        w, ClientBatch(x, y, mask))


def _losses_along(problem: FLProblem, ws: torch.Tensor,
                  batch: ClientBatch) -> torch.Tensor:
    """[K, m] client losses at m points each, in one batched call: ws [m,
    d] (the same points for every client) or [K, m, d] (per client)."""
    along = vmap(problem.loss, in_dims=(0, None))
    return vmap(along, in_dims=(None if ws.dim() == 2 else 0, 0))(ws, batch)


def _local_trajectory(hp: AlgoHParams, w0: torch.Tensor,
                      residual_fn: Callable[[torch.Tensor, int], torch.Tensor]):
    """Run L corrected-GD steps from w0 [K, d] and return the full
    trajectory: (w_traj, r_traj), each [K, L+1, d] — FedOSAA evaluates L+1
    residuals (Alg. 1 needs r_L for the last Y column). ``residual_fn(w,
    step)`` gives step ``step``'s residual."""
    w = w0
    ws, rs = [], []
    for step in range(hp.local_epochs + 1):
        r = residual_fn(w, step)
        ws.append(w)
        rs.append(r)
        w = tm.tree_axpy(-hp.eta, r, w)
    return torch.stack(ws, 1), torch.stack(rs, 1)


def _make_residual_fn(problem: FLProblem, w_t: torch.Tensor, batch: ClientBatch,
                      idx: torch.Tensor | None, anchor: bool,
                      corr: torch.Tensor | None):
    """r(w; ζ) = ∇f_k(w; ζ) − a·∇f_k(w^t; ζ) + corr for every client (the
    reference's _make_residual_fn, batched): a = 1 with corr = ∇f(w^t) is
    the SVRG correction, taken on the SAME rows ζ as the live gradient; a =
    0 with corr = c − c_k is SCAFFOLD's; a = 0 with no corr is FedAvg's.
    ζ is the full batch, or step ℓ's rows ``idx[:, ℓ]`` [K, b]. A full
    batch's SVRG correction is the same every step and is taken once."""
    fixed = None
    if anchor and idx is None:
        fixed = corr - _stack_grads(problem, w_t, *batch)

    def residual(w: torch.Tensor, step: int) -> torch.Tensor:
        mb = batch if idx is None else sample_minibatch(batch, idx[:, step])
        g = _stack_grads(problem, w, *mb)
        if anchor:
            return g + (fixed if idx is None
                        else corr - _stack_grads(problem, w_t, *mb))
        return g if corr is None else g + corr

    return residual


def _fused_trajectory(problem: FLProblem, hp: AlgoHParams, w0: torch.Tensor,
                      batch: ClientBatch, anchor_scale: float,
                      corr: torch.Tensor | None, idx: torch.Tensor | None):
    """The fused linear-design twin of _local_trajectory (kernels/
    local_update): both residual gradients of every step ride ONE sweep of
    the client's design. r(w) = ∇f_k(w) − a·∇f_k(w^t) + corr collapses to
    Xᵀ(c(Xw) − a·c(Xw^t))/n + reg·w + u with u = corr − a·reg·w^t.
    Minibatch mode gathers each step's rows ``idx`` [K, steps, b] into
    x [K, steps, b, d] with a mask of ones (the kernel's streaming design)
    and takes live and anchor gradients on the same rows."""
    design = problem.linear_design(batch)
    if idx is None:
        x, y, mask = design.x[:, None], design.y[:, None], batch.mask[:, None]
    else:
        x, y, mask = sample_minibatch(
            ClientBatch(design.x, design.y, batch.mask), idx)
    u = torch.zeros_like(w0) if corr is None else corr
    if anchor_scale:
        u = u - design.reg * w0
    return fused_trajectory(
        x, y, mask, w0, u, link=design.link, reg=design.reg, eta=hp.eta,
        anchor_scale=anchor_scale, steps=hp.local_epochs + 1)


def _trajectory(problem: FLProblem, hp: AlgoHParams, w_t: torch.Tensor,
                batch: ClientBatch, idx: torch.Tensor | None,
                anchor_scale: float, corr: torch.Tensor | None):
    """Every client's trajectory of L+1 corrected steps from w_t [d] (see
    _make_residual_fn for the corrections): the fused kernel when resolved,
    else the autodiff residual path. Runs inside the
    ``fl.local_trajectory`` profiler scope, as the reference's named
    scope."""
    with record_function("fl.local_trajectory"):
        if hp.local_impl == "kernel":
            return _fused_trajectory(problem, hp, w_t, batch, anchor_scale,
                                     corr, idx)
        residual = _make_residual_fn(problem, w_t, batch, idx,
                                     anchor_scale == 1.0, corr)
        return _local_trajectory(hp, w_t.expand(batch.x.shape[0], -1),
                                 residual)


# --------------------------------------------------------------------------
# the clients' local work, every client at once
# --------------------------------------------------------------------------

def _client_svrg(problem: FLProblem, hp: AlgoHParams, use_aa: bool, w_t,
                 g_global, batch: ClientBatch, idx=None, hist_s=None,
                 hist_y=None, poison=None):
    """Every client's SVRG trajectory, then (FedOSAA) one AA step. With
    carried columns hist_s/hist_y [K, H, d], they are prepended to the
    round's (m = H + L) and the last H fresh columns are carried on
    (App. A option 1). ``poison`` = (flags [K], noise [K, d], scale): the
    byzantine history fault, applied to the flagged clients' last fresh Y
    column after the trajectory and before the columns are carried on
    (robust/faults.py::poison_last_column). Returns (w_k [K, d], AAStats
    with [K] entries, the new hist_s, hist_y; the old ones where no AA
    step runs)."""
    w_traj, r_traj = _trajectory(problem, hp, w_t, batch, idx, 1.0, g_global)
    if not use_aa:
        return (_last(w_traj), _nan_stats(batch.x.shape[0], w_t), hist_s,
                hist_y)
    s, y_stack = trajectory_to_sy(w_traj, r_traj, hp.aa.residual_ema)
    if poison is not None:
        y_stack = flt.poison_last_column(y_stack, *poison)
    s_all, y_all = s, y_stack
    if hist_s is not None:
        H = hist_s.shape[1]
        s_all, y_all = torch.cat([hist_s, s], 1), torch.cat([hist_y, y_stack], 1)
        hist_s, hist_y = s[:, -H:], y_stack[:, -H:]
    w_k, stats = multisecant_update(w_t, g_global, s_all, y_all, hp.eta, hp.aa,
                                    impl=hp.aa_impl)
    return w_k, stats, hist_s, hist_y


def _client_scaffold(problem: FLProblem, hp: AlgoHParams, use_aa: bool, w_t,
                     c, c_k, batch: ClientBatch, idx=None):
    """Every client's SCAFFOLD trajectory (correction c − c_k), then
    (FedOSAA-SCAFFOLD) one AA step against the server's c. The new c_k is
    the full-batch ∇f_k(w^t) (Alg. 2), kept by the client uncompressed.
    Returns (w_k, new c_k, AAStats)."""
    w_traj, r_traj = _trajectory(problem, hp, w_t, batch, idx, 0.0, c - c_k)
    if use_aa:
        s, y_stack = trajectory_to_sy(w_traj, r_traj, hp.aa.residual_ema)
        w_k, stats = multisecant_update(w_t, c, s, y_stack, hp.eta, hp.aa,
                                        impl=hp.aa_impl)
    else:
        w_k, stats = _last(w_traj), _nan_stats(batch.x.shape[0], w_t)
    return w_k, _stack_grads(problem, w_t, *batch), stats


def _client_avg(problem: FLProblem, hp: AlgoHParams, use_aa: bool, w_t,
                batch: ClientBatch, idx=None):
    """Every client's uncorrected trajectory, then (FedOSAA-AVG, the
    negative control) one AA step against each client's LOCAL gradient
    r_0 = ∇f_k(w^t) [K, d] (no correction exists). The residuals are not
    smoothed (no ``residual_ema``), as in the reference."""
    w_traj, r_traj = _trajectory(problem, hp, w_t, batch, idx, 0.0, None)
    if not use_aa:
        return _last(w_traj), _nan_stats(batch.x.shape[0], w_t)
    s, y_stack = trajectory_to_sy(w_traj, r_traj)
    g_local = r_traj[:, 0].contiguous()     # [K, d], read at a stride of d
    return multisecant_update(w_t, g_local, s, y_stack, hp.eta, hp.aa,
                              impl=hp.aa_impl)


def _client_lbfgs(problem: FLProblem, hp: AlgoHParams, w_t, g_global,
                  batch: ClientBatch, idx=None) -> torch.Tensor:
    """Every client's SVRG trajectory, then the two-loop L-BFGS direction
    on its S/Y (no ``residual_ema``, as in the reference): w_k = w^t −
    H⁻¹∇f(w^t)."""
    w_traj, r_traj = _trajectory(problem, hp, w_t, batch, idx, 1.0, g_global)
    s, y_stack = trajectory_to_sy(w_traj, r_traj)
    return w_t - lbfgs_two_loop(g_global, s, y_stack, hp.eta)


def _cg_solve(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain CG on SPD systems, fixed iteration count (GIANT's q): one
    system b [d], or one per row of b [K, d] with ``matvec`` mapping [K, d]
    to [K, d]. Each system keeps its own step sizes (``rs``, ``alpha`` and
    ``beta`` carry a trailing axis of 1)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = tm.tree_dot(r, r)[..., None]
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(tm.tree_dot(p, ap)[..., None], min=1e-30)
        x = tm.tree_axpy(alpha, p, x)
        r = tm.tree_axpy(-alpha, ap, r)
        rs_new = tm.tree_dot(r, r)[..., None]
        p = tm.tree_axpy(rs_new / torch.clamp(rs, min=1e-30), p, r)
        rs = rs_new
    return x


def _client_giant(problem: FLProblem, hp: AlgoHParams, w_t, g_global,
                  batch: ClientBatch) -> torch.Tensor:
    """Every client's GIANT direction p_k [K, d]: L CG iterations on
    ∇²f_k(w^t) p = ∇f(w^t)."""
    b = g_global.expand(batch.x.shape[0], -1)
    return _cg_solve(lambda v: problem.stacked_hvps(w_t, batch, v), b,
                     hp.local_epochs)


def _client_newton_gmres(problem: FLProblem, hp: AlgoHParams, w_t, g_global,
                         batch: ClientBatch) -> torch.Tensor:
    """Every client's Newton-GMRES direction p_k [K, d]: one restart of
    GMRES (restart L) on ∇²f_k(w^t) p = ∇f(w^t) (core/krylov.py)."""
    b = g_global.expand(batch.x.shape[0], -1)
    return gmres(lambda v: problem.stacked_hvps(w_t, batch, v), b,
                 hp.local_epochs)


#: DANE's backtracking steps, and the line search's (_newton_round_core)
DANE_STEPS = (1.0, 0.5, 0.25, 0.125, 0.0625)
LINE_SEARCH_STEPS = (4.0, 2.0, 1.0, 0.5, 0.25, 0.125, 0.0625)


def _client_dane(problem: FLProblem, hp: AlgoHParams, w_t, g_global,
                 batch: ClientBatch, steps: torch.Tensor) -> torch.Tensor:
    """Every client's exact local minimisation of the DANE surrogate h_k(w)
    = f_k(w) − <∇f_k(w^t) − ∇f(w^t), w> (App. D.1: "no tuning parameter"),
    by ``dane_newton_iters`` damped Newton steps from w^t, each a CG of
    ``dane_cg_iters`` iterations and a backtracking over ``steps``
    (DANE_STEPS, on the device): every client's trial values [K, 5] in one
    batched call, the first step that passes Armijo, or 0 if none does.
    Returns w_k [K, d]."""
    shift = _stack_grads(problem, w_t, *batch) - g_global
    K = batch.x.shape[0]

    def h_val(w: torch.Tensor) -> torch.Tensor:
        """[K] h_k at w [K, d]; [K, m] at w [K, m, d]."""
        if w.dim() == 2:
            return _stack_losses(problem, w, *batch) - tm.tree_dot(shift, w)
        return (_losses_along(problem, w, batch)
                - tm.tree_dot(shift[:, None], w))

    w = w_t.expand(K, -1).contiguous()
    for _ in range(hp.dane_newton_iters):
        g = _stack_grads(problem, w, *batch) - shift
        p = _cg_solve(lambda v, w=w: problem.stacked_hvps(w, batch, v), g,
                      hp.dane_cg_iters)
        f0 = h_val(w)
        gTp = tm.tree_dot(g, p)
        vals = h_val(tm.tree_axpy(-steps[:, None], p[:, None], w[:, None]))
        ok = vals < f0[:, None] - 1e-4 * steps * gTp[:, None]
        # the first step that passes (argmax of the mask), else 0
        a = torch.where(ok.any(-1),
                        steps.index_select(0, ok.to(torch.int8).argmax(-1)),
                        0.0)
        w = tm.tree_axpy(-a[:, None], p, w)
    return w


def _last(w_traj: torch.Tensor) -> torch.Tensor:
    """Every client's last iterate [K, d] of a trajectory [K, L+1, d], as a
    contiguous tensor: the wire's kernels read client k's row at k·d."""
    return w_traj[:, -1].contiguous()


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
    """Cross-client reductions and the wire of the one-device runtime (the
    sharded runtime's core/sharded.py::ShardReduce ends each reduction in a
    collective)."""

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

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every client's rows of a per-client tensor: here, all of them
        already (the sharded reduce all-gathers the ranks' blocks)."""
        return x

    def uplink(self, stacked: torch.Tensor, spec: UplinkSpec,
               anchor: torch.Tensor | None = None, state: "dict | None" = None,
               draw: "Callable[[UplinkSpec, tuple], torch.Tensor] | None" = None,
               post: torch.Tensor | None = None):
        """Channel roundtrip of every client's upload stacked [K, d],
        declared by ``spec`` (repro/core/algorithms.py:837-911).

        The wire carries ``stacked_k − anchor`` for an anchored spec, less
        the carried reference ``state[spec.tag]["ref"]`` when there is one
        (difference coding), plus the error-feedback residual
        ``state[spec.tag]["ef"]``; ``codec.uplink`` does that arithmetic
        around the codec. ``post`` [K, d] (the DP noise) is added to the
        decoded value before the residual is taken, so the residual and
        the reference track the noised wire; with it, the identity codec
        runs that arithmetic too. ``draw(spec, shape)`` gives a stochastic
        codec's uniforms [K, nc, C]. ``state`` is the whole comm dict (or
        None); tags and reserved keys other than ``spec.tag`` pass through.
        Returns (the server's view of the uploads [K, d], the comm dict
        with this tag's buffers advanced)."""
        if spec.anchored != (anchor is not None):
            raise ValueError(
                f"uplink {spec.tag!r}: anchored={spec.anchored} but anchor "
                f"{'missing' if anchor is None else 'given'}")
        codec = self.channel.up_codec(spec.kind)
        if isinstance(codec, IdentityCodec) and post is None:
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
            dec, new_e, new_h = codec.uplink(stacked, u, anchor, ref, ef, post)
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


def _metric_parts(problem, R, w, g, stats: AAStats, x, y, mask, dweight,
                  pweight, comm_bytes: float) -> RoundMetrics:
    """f(w) (weighed by ``dweight``), ‖g‖ and the AA health stats, reduced
    across the round's clients, the effective sample size of ``pweight``,
    and the round's wire bytes. The column counts are nan where a client
    ran no AA step (theta is nan)."""
    no_aa = torch.isnan(stats.theta)
    used = torch.where(no_aa, torch.nan, stats.used_columns.to(torch.float32))
    clipped = torch.where(no_aa, torch.nan,
                          stats.clipped_columns.to(torch.float32))
    return RoundMetrics(
        loss=R.wsum(dweight, _stack_losses(problem, w, x, y, mask)),
        grad_norm=tm.tree_norm(g),
        theta_mean=R.nanmean(stats.theta),
        gram_cond_max=R.nanmax(stats.gram_cond),
        gram_cond_mean=R.nanmean(stats.gram_cond),
        aa_used_min=R.nanmin(used),
        aa_clipped_max=R.nanmax(clipped),
        cohort_ess=R.ess(pweight),
        comm_bytes=torch.tensor(comm_bytes),
        arrivals=torch.tensor(torch.nan),
        staleness_mean=torch.tensor(torch.nan),
        staleness_max=torch.tensor(torch.nan),
    )


# --------------------------------------------------------------------------
# round cores (repro/core/algorithms.py:998-1081)
#
# Each takes the server quantities, the stacked client arrays of the
# round's clients (all K, or a cohort's C), the round's minibatch rows
# ``idx`` (None: full batch) and the wire's ``comm`` state and ``draw``.
# Two weights: ``dweight`` weighs the clients in the global quantities (the
# losses, ∇f, SCAFFOLD's c), ``pweight`` in the model aggregate. The dense
# round and a cohort pass the same weights twice; they part under dropout
# and the async gate (robust/).
# --------------------------------------------------------------------------

def _svrg_round_core(problem, hp, use_aa, R, w_t, x, y, mask, dweight,
                     pweight, comm_bytes: float, comm=None, draw=None, idx=None,
                     hist_s=None, hist_y=None, poison=None):
    """SVRG family: corrected local steps (+ optional AA), delta aggregation.

    Two wire crossings: w^t travels down and the local full-batch gradients
    travel up; then ∇f travels down and the model deltas travel up, anchored
    at the broadcast w^t. The carried AA history is client-local state and
    never touches the wire. The metrics are taken at the broadcast w^t.
    ``poison``: the byzantine history fault (see _client_svrg). Returns
    (new params, metrics, the advanced comm state, the new carried hist_s,
    hist_y)."""
    w_t = R.broadcast(w_t)
    g_k, comm = R.uplink(_stack_grads(problem, w_t, x, y, mask), GRAD_UPLINK,
                         state=comm, draw=draw)
    g_global = R.broadcast(R.wsum(dweight, g_k))
    w_k, stats, hist_s, hist_y = _client_svrg(
        problem, hp, use_aa, w_t, g_global, ClientBatch(x, y, mask), idx,
        hist_s, hist_y, poison)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    new_params = R.wsum(pweight, w_k, anchor=w_t)
    return (new_params, _metric_parts(problem, R, w_t, g_global, stats, x, y,
                                      mask, dweight, pweight, comm_bytes),
            comm, hist_s, hist_y)


def _scaffold_round_core(problem, hp, use_aa, R, w_t, c, c_k, x, y, mask,
                         dweight, pweight, comm_bytes: float, comm=None, draw=None,
                         idx=None):
    """SCAFFOLD family: control-variate steps; c aggregated with the data
    weights.

    One exchange: (w^t, c) travel down, (Δw_k, c_k) travel up together.
    The server keeps the decoded wire view only in the aggregates; the
    client's own control variate stays client-side uncompressed (new c_k).
    The metrics' gradient norm is ‖new c‖. Returns (new params, new c, new
    c_k, metrics, the advanced comm state)."""
    w_t = R.broadcast(w_t)
    c = R.broadcast(c)
    w_k, new_c_k, stats = _client_scaffold(problem, hp, use_aa, w_t, c, c_k,
                                           ClientBatch(x, y, mask), idx)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    c_up, comm = R.uplink(new_c_k, CTRL_UPLINK, state=comm, draw=draw)
    new_params = R.wsum(pweight, w_k, anchor=w_t)
    new_c = R.wsum(dweight, c_up)
    return (new_params, new_c, new_c_k,
            _metric_parts(problem, R, w_t, new_c, stats, x, y, mask, dweight,
                          pweight, comm_bytes), comm)


def _avg_round_core(problem, hp, use_aa, R, w_t, x, y, mask, dweight,
                    pweight, comm_bytes: float, comm=None, draw=None, idx=None):
    """FedAvg family (with the fedosaa_avg negative control): one exchange,
    the model deltas up. The global gradient is a diagnostic only: FedAvg
    ships no gradients, so it crosses no wire. Returns (new params,
    metrics, the advanced comm state)."""
    w_t = R.broadcast(w_t)
    w_k, stats = _client_avg(problem, hp, use_aa, w_t, ClientBatch(x, y, mask),
                             idx)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    new_params = R.wsum(pweight, w_k, anchor=w_t)
    g = R.wsum(dweight, _stack_grads(problem, w_t, x, y, mask))
    return new_params, _metric_parts(problem, R, w_t, g, stats, x, y, mask,
                                     dweight, pweight, comm_bytes), comm


def _lbfgs_round_core(problem, hp, R, w_t, x, y, mask, dweight, pweight,
                      comm_bytes: float, comm=None, draw=None, idx=None):
    """One-step L-BFGS: the SVRG family's two exchanges, the L-BFGS
    direction in place of the AA step. Returns (new params, metrics, the
    advanced comm state)."""
    w_t = R.broadcast(w_t)
    g_k, comm = R.uplink(_stack_grads(problem, w_t, x, y, mask), GRAD_UPLINK,
                         state=comm, draw=draw)
    g_global = R.broadcast(R.wsum(dweight, g_k))
    w_k = _client_lbfgs(problem, hp, w_t, g_global, ClientBatch(x, y, mask),
                        idx)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    new_params = R.wsum(pweight, w_k, anchor=w_t)
    return new_params, _metric_parts(problem, R, w_t, g_global,
                                     _nan_stats(x.shape[0], w_t), x, y, mask,
                                     dweight, pweight, comm_bytes), comm


def _newton_round_core(problem, hp, client_fn, R, w_t, x, y, mask, dweight,
                       pweight, comm_bytes: float, comm=None, draw=None,
                       ls_steps: torch.Tensor | None = None):
    """GIANT / Newton-GMRES: aggregate the clients' Newton directions, then
    optionally the global line search.

    Two wire crossings: the local gradients travel up (difference-coded
    against the carried reference), ∇f travels down, and the directions p_k
    travel up unanchored, with error feedback only (the "dir" uplink); the
    server steps along p = Σ_k w_k p_k, which is not a delta form. With
    ``ls_steps`` (LINE_SEARCH_STEPS on the device) p is broadcast once more
    and every client evaluates its loss at w^t − a·p_b for every step a in
    one batched call; the server steps with its exact p and the first step
    of least weighted loss. Returns (new params, metrics, the advanced comm
    state)."""
    w_t = R.broadcast(w_t)
    batch = ClientBatch(x, y, mask)
    g_k, comm = R.uplink(_stack_grads(problem, w_t, x, y, mask), GRAD_UPLINK,
                         state=comm, draw=draw)
    g_global = R.broadcast(R.wsum(dweight, g_k))
    p_k = client_fn(problem, hp, w_t, g_global, batch)
    p_k, comm = R.uplink(p_k, DIR_UPLINK, state=comm, draw=draw)
    p = R.wsum(pweight, p_k)
    if ls_steps is None:
        new_params = tm.tree_axpy(-1.0, p, w_t)
    else:
        p_b = R.broadcast(p)
        vals = R.wsum(dweight, _losses_along(
            problem, tm.tree_axpy(-ls_steps[:, None], p_b, w_t), batch))
        a = ls_steps.index_select(0, vals.argmin().reshape(1))
        new_params = tm.tree_axpy(-a, p, w_t)
    return new_params, _metric_parts(problem, R, w_t, g_global,
                                     _nan_stats(x.shape[0], w_t), x, y, mask,
                                     dweight, pweight, comm_bytes), comm


def _dane_round_core(problem, hp, R, w_t, x, y, mask, dweight, pweight,
                     comm_bytes: float, comm=None, draw=None,
                     steps: torch.Tensor | None = None):
    """DANE: the SVRG family's two exchanges (gradients up, then model
    deltas anchored at w^t up) around every client's local minimisation of
    its surrogate (``steps``: DANE_STEPS on the device); a delta-form
    aggregate. Returns (new params, metrics, the advanced comm state)."""
    w_t = R.broadcast(w_t)
    g_k, comm = R.uplink(_stack_grads(problem, w_t, x, y, mask), GRAD_UPLINK,
                         state=comm, draw=draw)
    g_global = R.broadcast(R.wsum(dweight, g_k))
    w_k = _client_dane(problem, hp, w_t, g_global, ClientBatch(x, y, mask),
                       steps)
    w_k, comm = R.uplink(w_k, DELTA_UPLINK, anchor=w_t, state=comm, draw=draw)
    new_params = R.wsum(pweight, w_k, anchor=w_t)
    return new_params, _metric_parts(problem, R, w_t, g_global,
                                     _nan_stats(x.shape[0], w_t), x, y, mask,
                                     dweight, pweight, comm_bytes), comm


# --------------------------------------------------------------------------
# cohorts (repro/core/algorithms.py:664-777)
# --------------------------------------------------------------------------

def resolve_cohort_size(hp: AlgoHParams, num_clients: int) -> int | None:
    """The round's cohort size C, or None for the dense all-K round. An
    explicit ``hp.cohort_size`` wins (C = K runs the cohort machinery, the
    identity cohort) and must lie in [1, K]; else ``participation`` < 1
    gives C = max(1, round(p·K)), and p >= 1 the dense round."""
    if hp.cohort_size is not None:
        c = int(hp.cohort_size)
        if not 1 <= c <= num_clients:
            raise ValueError(
                f"cohort_size={c} must be in [1, num_clients={num_clients}]")
        return c
    if hp.participation >= 1.0:
        return None
    return max(1, int(round(hp.participation * num_clients)))


def _cohort_indices(weight: torch.Tensor, cohort_size: int,
                    u: torch.Tensor) -> torch.Tensor:
    """C = ``cohort_size`` distinct client indices [C] int64, drawn without
    replacement with p ∝ ``weight`` [K] from the uniforms ``u`` [K] (f64,
    in [0, 1)): the C largest Gumbel keys log w_k − log(−log u_k). That is
    the distribution of successive weighted draws without replacement (the
    reference's ``jax.random.choice(replace=False, p=weight)``), taken on
    the device with no host read (C < K)."""
    keys = torch.log(weight.to(torch.float64)) - torch.log(-torch.log(u))
    return torch.topk(keys, cohort_size).indices


def _cohort_weights(weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The cohort's weights ``weight[idx]`` renormalised to sum 1."""
    cw = weight.index_select(0, idx)
    return cw / torch.clamp(cw.sum(), min=1e-30)


def _sample_cohort(weight: torch.Tensor, cohort_size: int, u: torch.Tensor):
    """The round's cohort: ([C] indices, [C] weights). C >= K returns
    arange(K) and the RAW weights: renormalising would move their last ulp
    and break the identity cohort's bit-identity with the dense round."""
    K = weight.shape[0]
    if cohort_size >= K:
        return torch.arange(K, device=weight.device), weight
    idx = _cohort_indices(weight, cohort_size, u)
    return idx, _cohort_weights(weight, idx)


class CohortPlan(NamedTuple):
    """One round's client axis: the [C, ...] views the round core reads and
    what the commit needs to scatter its updates back."""

    idx: "torch.Tensor | None"  # [C] cohort indices; None: the dense round
    x: torch.Tensor             # [C, ...] the clients' data
    y: torch.Tensor
    mask: torch.Tensor
    dweight: torch.Tensor       # [C] weights of the losses and ∇f
    pweight: torch.Tensor       # [C] weights of the model aggregate
    store: ClientStateStore     # the K-sized store (the scatter's target)
    cohort: ClientStateStore    # its [C, ...] rows, which the core reads


def _plan_round(clients, csize: int | None, state: ServerState,
                idx: "torch.Tensor | None") -> CohortPlan:
    """The round's client axis. Dense (``csize`` None): the full stacks and
    store pass through untouched. The identity cohort (C = K): the original
    tensors are the cohort's view (no gather) with the raw weights; the
    scatter still runs. C < K: the data and the store rows at ``idx`` [C]
    (the round's "cohort" draw), with the renormalised weights."""
    store = ClientStateStore.from_state(state)
    w = clients.weight
    if csize is None:
        return CohortPlan(None, clients.x, clients.y, clients.mask, w, w,
                          store, store)
    if csize >= clients.num_clients:
        return CohortPlan(idx, clients.x, clients.y, clients.mask, w, w,
                          store, store)
    with record_function("fl.cohort_gather"):
        cw = _cohort_weights(w, idx)
        return CohortPlan(idx, clients.x.index_select(0, idx),
                          clients.y.index_select(0, idx),
                          clients.mask.index_select(0, idx), cw, cw, store,
                          store.gather(idx))


def _commit_plan(plan: CohortPlan, **updates) -> dict:
    """ServerState field updates from a round core's per-client outputs
    (c_k, hist_s, hist_y, comm; [C, ...] in a cohort round). Dense: passed
    through. A cohort: scattered into the K-sized store; the rows outside
    the cohort keep their bits, and a field the core did not return (None)
    is the store's own tensor."""
    if plan.idx is None:
        return updates
    rows = ClientStateStore(**{f: updates.get(f)
                               for f in ClientStateStore._fields})
    with record_function("fl.scatter"):
        new = plan.store.scatter(plan.idx, rows)
    return {k: getattr(new, k) for k in updates}


def _draw_seed(seed: int, t: int, fold: int) -> int:
    """The seed of one draw of round t (host arithmetic only)."""
    return int(np.random.SeedSequence([seed, t, fold]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class _Draw(NamedTuple):
    """One draw of a round: the dense round's shape, its dtype, the seed
    and fold of its generator, and its kind: "uniform" (torch.rand),
    "normal" (torch.randn), "tiny" (a uniform clamped to at least f32's
    tiny), "minibatch" (f64 uniforms turned into row indices), "cohort"
    (f64 uniforms turned into C client indices)."""

    shape: tuple
    dtype: torch.dtype
    fold: int
    kind: str
    seed: int


def make_round_fn(algo: str, problem: FLProblem, hp: AlgoHParams,
                  channel: "CommChannel | str | None" = None, seed: int = 0,
                  device: "str | torch.device" = DEFAULT_DEVICE,
                  faults: "flt.FaultPlan | None" = None,
                  async_cfg: "async_agg.AsyncConfig | None" = None):
    """Return round(state, draws=None) -> (state, RoundMetrics) for
    ``algo`` on ``problem`` (whose data must already be on ``device``),
    every wire crossing through ``channel`` (None: the lossless identity).

    This is the one-device runtime: the K clients stacked on ``device``.
    Its distributed twin, core/sharded.py::make_sharded_round_fn, runs the
    same round body on each rank's block of clients of a
    ``torch.distributed`` group and ends every cross-client reduction with
    a collective (the reference's ``make_sharded_round_fn`` over the
    ("pod", "data") mesh axes).

    A round's draws: a stochastic codec's uniforms, one [K, nc, C] f32
    tensor per uplink (named by its tag), and in minibatch mode the rows of
    every local step, one [K, L+1, batch_size] int64 tensor (named
    ``MINIBATCH``; problem.py::sample_minibatch_indices). Each is drawn
    from a torch.Generator on the device seeded from (seed, t, its fold:
    the uplink's, or ``MINIBATCH_FOLD``); row k is client k. The
    reference's key streams cannot be reproduced in torch, so a caller that
    needs its draws (the parity tests) passes ``draws={name: tensor}``,
    every draw of the round, instead.

    A cohort round (``resolve_cohort_size``: C clients of K) draws first
    its clients, ``COHORT``: [C] int64 indices (Gumbel top-k over [K] f64
    uniforms of fold ``COHORT_FOLD``; arange(K) for the identity cohort).
    Its other draws are rows ``idx`` of the dense round's [K, ...] draws,
    so a cohort client k draws what client k would draw in a dense round,
    whoever else was drawn (the reference's ``rngs_K[idx]``), and the round
    sees [C, ...] draws; ``draws`` passes them so.

    ``faults`` (robust/faults.py) injects a FaultPlan's dropout, stale
    anchors, byzantine uplinks or history, DP noise and latencies;
    ``async_cfg`` (robust/async_agg.py) closes the round at a deadline:
    late clients' post-codec updates wait in buffer rows and fold in later,
    weighted down by their staleness. Their draws join the round's
    (robust/faults.py::fault_draws: ``"fault.drop"``, ``"fault.stale"``,
    ``"fault.latency"`` [K] f32; ``"fault.byz.<tag>"``,
    ``"fault.dp.<tag>"``, ``"fault.poison"`` [K, d] standard normals in the
    params' dtype), each seeded from (``faults.seed``, t, its fold), so a
    plan's seed keys its stream whatever ``seed`` is. The state must carry
    the plan's rows: ``init_fault_comm`` with ``stale_rate`` > 0 and
    ``init_async_comm`` with an active gate (run_federated attaches them).
    None or an inactive plan or config builds the round without them, bit
    for bit, with the same draws. GIANT and Newton-GMRES aggregate
    directions, not deltas: they take faults and refuse an active gate.
    With the gate on, the round's ``arrivals`` and ``staleness_*`` metrics
    are device tensors; ``round.host_metrics`` names the host ones.

    A chunk of rounds gets its draws ahead of time through two attributes
    of the returned function: ``round.draw_specs``, {name: (shape, dtype)}
    for each draw of a round (empty on a deterministic full-batch round),
    and ``round.fill_draws(bufs, t0)``, which writes into ``bufs[name][i]``
    what round t0 + i would draw, by the same generator calls. The engine
    (core/engine.py) fills its static [B, ...] buffers so before each
    replay of its CUDA graph and passes slot i's views as ``draws``: a
    graph would otherwise replay the draws seeded at capture.

    On the card, with ``aa_impl`` "kernel" (or "auto", its default), a
    round makes no host read: every kernel and torch op is enqueued and
    nothing is read back (chip_smoke.py holds a round to it under
    ``torch.cuda.set_sync_debug_mode("error")``), so the engine can capture
    it. The "tree" AA path's batched ``torch.linalg.eigh`` checks its info
    on the host once a round. The Newton family's rounds have no branch on
    data either: CG and GMRES run their full iteration counts (GMRES keeps
    each client's steps with ``torch.where``), and the line search's and
    DANE's backtracking pick their steps on the device.

    ``hp.line_search`` adds the global line search to GIANT and
    Newton-GMRES (and its broadcast to their bytes); the other algorithms
    ignore it, as the reference's do. The Newton family takes no minibatch
    and no carried history (``batch_size``, ``carry_history``): the
    reference ignores them there, the port refuses them."""
    return _build_round(algo, problem, hp, channel, seed, device, faults,
                        async_cfg)


def _build_round(algo, problem, hp, channel, seed, device, faults, async_cfg,
                 make_reduce=None, shard=None, weight=None):
    """The round function of make_round_fn and of its sharded twin
    (core/sharded.py::make_sharded_round_fn): one body for both.

    ``problem`` holds the clients the round computes on: all K, or with
    ``shard`` (a sharded.ClientShard) this rank's block of them, whose
    weights are their global ones; ``weight`` [K] is then all K clients'
    weights. ``make_reduce(channel)`` gives the cross-client reduce
    (CrossClientReduce by default; the sharded ShardReduce ends each sum in
    a collective).

    Under a shard the round's [K]-sized plan is global and the same on
    every rank: every draw is the dense round's full tensor, of which the
    rank takes its rows, except the fault plan's per-client scalars
    (dropout, staleness, latency), which stay [K]; the fault realization,
    the weights the dropout and the deadline gate derive from it and the
    gate's partition are computed on the [K] vectors (the buffer ages, the
    one per-client state they need, by one all-gather), and the rank takes
    its rows of them for the round core and the epilogues."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; choose from {ALGORITHMS}")
    if algo in NEWTON_ALGOS and (hp.batch_size is not None
                                 or hp.carry_history > 0):
        raise ValueError(f"{algo} takes full-batch Hessian products and "
                         f"carries no AA history: batch_size="
                         f"{hp.batch_size}, carry_history={hp.carry_history}"
                         " are trajectory-family knobs")
    if hp.batch_size is not None and hp.batch_size < 1:
        raise ValueError(f"batch_size must be >= 1 (or None), got {hp.batch_size}")
    if not 0 <= hp.carry_history <= hp.local_epochs:
        # the carried columns are the last H of a round's L fresh ones
        raise ValueError(f"carry_history must be in [0, local_epochs="
                         f"{hp.local_epochs}], got {hp.carry_history}")
    # an absent or inactive plan or gate builds the plain round
    faults = faults if faults is not None and faults.active else None
    async_cfg = async_cfg if async_cfg is not None and async_cfg.active else None
    if async_cfg is not None and algo in LINE_SEARCH_ALGOS:
        raise ValueError(
            f"AsyncConfig requires a delta-form model aggregation; {algo!r} "
            "aggregates Newton directions and cannot buffer client deltas")
    dev = _check_device(problem, device)
    # resolve the knobs once, so the round bodies see "tree"/"kernel"
    hp = dataclasses.replace(hp, aa_impl=resolve_aa_impl(hp.aa_impl),
                             local_impl=resolve_local_impl(hp.local_impl, problem))
    channel = make_channel(channel)
    params0 = problem.init(None)
    comm_bytes = comm_bytes_per_round(algo, params0, channel, hp.line_search)
    R = (make_reduce or CrossClientReduce)(channel)
    C = problem.clients
    # all K clients' count and weights, and this rank's rows of them (None:
    # the round computes on every client)
    rows = None if shard is None else shard.rows
    K = C.num_clients if shard is None else shard.num_clients
    weight = C.weight if shard is None else weight
    d = params0.shape[-1]
    csize = resolve_cohort_size(hp, K)
    # the clients a round computes on, and whether their draws are rows of
    # the dense round's (C < K) or the dense round's own (dense, C = K)
    n_round = C.num_clients if csize is None else csize
    gathers = csize is not None and csize < K
    family = ("svrg" if algo in ("fedsvrg", "fedosaa_svrg") else
              "scaffold" if algo in SCAFFOLD_ALGOS else
              "avg" if algo in ("fedavg", "fedosaa_avg") else
              "newton" if algo in LINE_SEARCH_ALGOS else algo)
    use_aa = algo.startswith("fedosaa_")
    poisons = (faults is not None and faults.poisons_history and use_aa
               and family == "svrg")
    # every draw of a round
    specs: "dict[str, _Draw]" = {}
    if csize is not None:
        specs[COHORT] = _Draw((K,), torch.int64, COHORT_FOLD, "cohort", seed)
    for spec in UPLINK_SCHEMAS[algo]:
        shape = channel.up_codec(spec.kind).draw_shape(d)
        if shape is not None:
            specs[spec.tag] = _Draw((K, *shape), torch.float32, spec.fold,
                                    "uniform", seed)
    if hp.batch_size is not None:
        specs[MINIBATCH] = _Draw((K, hp.local_epochs + 1, hp.batch_size),
                                 torch.int64, MINIBATCH_FOLD, "minibatch", seed)
    fault_names = ()
    if faults is not None:
        for name, (kind, fold) in flt.fault_draws(
                faults, UPLINK_SCHEMAS[algo], poisons).items():
            if kind == "noise":
                specs[name] = _Draw((K, d), params0.dtype, fold, "normal",
                                    faults.seed)
            else:
                specs[name] = _Draw((K,), torch.float32, fold, kind,
                                    faults.seed)
            fault_names += (name,)
    # the draws a sharded round takes whole: the fault plan's [K] scalars
    whole = () if shard is None else tuple(
        n for n in fault_names if len(specs[n].shape) == 1)
    # the shapes a round takes: [C, ...] in a cohort round, a rank's rows
    draw_specs = {name: (sp.shape if name in whole
                         else (n_round, *sp.shape[1:]), sp.dtype)
                  for name, sp in specs.items()}
    # reseeded for each draw
    gen = torch.Generator(device=dev)
    tiny = torch.finfo(torch.float32).tiny

    def draw_of(name: str, t: int, idx: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """Round t's draw ``name``; with ``idx``, its rows ``idx``."""
        sp = specs[name]
        if sp.kind == "cohort" and not gathers:
            v = torch.arange(K, device=dev)         # the identity cohort
        else:
            gen.manual_seed(_draw_seed(sp.seed, t, sp.fold))
            if sp.kind == "normal":
                v = torch.randn(sp.shape, generator=gen, device=dev,
                                dtype=sp.dtype)
            else:
                v = torch.rand(sp.shape, generator=gen, device=dev, dtype=(
                    torch.float64 if sp.kind in ("cohort", "minibatch")
                    else torch.float32))
            if sp.kind == "tiny":
                v = torch.clamp(v, min=tiny)
            if sp.kind == "cohort":
                v = _cohort_indices(C.weight, csize, v)
            elif idx is not None:
                v = v.index_select(0, idx)
            elif rows is not None and name not in whole:
                v = v[rows]
            if sp.kind == "minibatch":
                mask = C.mask if idx is None else C.mask.index_select(0, idx)
                v = sample_minibatch_indices(mask, v)
        return v if out is None else out.copy_(v)

    def fill_draws(bufs: "dict[str, torch.Tensor]", t0: int) -> None:
        for i in range(next(iter(bufs.values())).shape[0] if bufs else 0):
            idx = None
            if COHORT in bufs:
                idx = draw_of(COHORT, t0 + i, out=bufs[COHORT][i])
            for name, buf in bufs.items():
                if name != COHORT:
                    draw_of(name, t0 + i, idx if gathers else None, out=buf[i])

    # the step sizes a round tries, and the dense round's client ids, made
    # on the device once (a graph replays no host-to-device copy)
    ls_steps = dane_steps = None
    if family == "newton" and hp.line_search:
        ls_steps = torch.tensor(LINE_SEARCH_STEPS, dtype=params0.dtype,
                                device=dev)
    if family == "dane":
        dane_steps = torch.tensor(DANE_STEPS, dtype=params0.dtype, device=dev)
    all_ids = torch.arange(K, device=dev) if faults is not None else None
    client_fn = _client_giant if algo == "giant" else _client_newton_gmres

    def local(v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a vector over the round's clients."""
        return v if rows is None else v[rows]

    def local_fr(fr):
        """This rank's rows of a realization (its noise draws already are)."""
        if rows is None or fr is None:
            return fr
        return fr._replace(drop=local(fr.drop), stale=local(fr.stale),
                           byz=local(fr.byz), latency=local(fr.latency))

    def local_ar(ar):
        """This rank's rows of the gate's partition (the deadline is one)."""
        if rows is None:
            return ar
        return type(ar)(*(local(v) if v.dim() else v for v in ar))

    def reserved(plan: CohortPlan, key: str, init: str) -> torch.Tensor:
        """The cohort's rows of a reserved comm key, or a clear refusal."""
        comm = plan.cohort.comm
        if comm is None or key not in comm:
            raise ValueError(f"the state carries no {key!r} rows: attach them "
                             f"with robust.{init} (run_federated does)")
        return comm[key]

    def fault_ctx(plan: CohortPlan, take, rows_of):
        """(reduce, dweight, pweight, realization) of the round: the
        realization from its draws, the dropped clients' weights zeroed
        (SCAFFOLD's dweight too: its control variates ride the lost
        uplink; the other families' gradients landed before the drop), and
        the reduce wrapped with the uplink faults. The weights and the
        realization cover the round's clients (all K under a shard)."""
        if faults is None:
            return R, plan.dweight, plan.pweight, None
        fr = flt.realize(faults, {n: take(n, rows_of) for n in fault_names},
                         all_ids if plan.idx is None else plan.idx)
        dw, pw = plan.dweight, plan.pweight
        if faults.drop_rate > 0.0:
            pw = flt.drop_weights(fr.drop, pw)
            if family == "scaffold":
                dw = flt.drop_weights(fr.drop, dw)
        anchors = None
        if faults.stale_rate > 0.0:
            anchors = reserved(plan, flt.FAULT_ANCHOR_KEY, "init_fault_comm")
        return flt.FaultyReduce(R, faults, local_fr(fr), anchors), dw, pw, fr

    def fault_epilogue(plan: CohortPlan, fr, w_t, upd: dict) -> dict:
        """The stale anchors refreshed, then the dropped rows frozen (a
        dropped client's refreshed anchor freezes back too); ``fr`` is
        this rank's rows of the realization."""
        if faults is None:
            return upd
        if faults.stale_rate > 0.0 and upd.get("comm") is not None:
            upd = {**upd, "comm": flt.advance_anchor(upd["comm"], fr.stale, w_t)}
        if faults.drop_rate > 0.0:
            upd = flt.freeze_dropped(fr.drop, plan.cohort, upd)
        return upd

    def async_ctx(plan: CohortPlan, Rr, fr, dw, pw):
        """The gate's partition of the round's clients by latency (all on
        time without a latency plan), the core's weights (the fresh
        clients'; SCAFFOLD's dweight renormalized over them), and the
        reduce wrapped to capture the model uplink's post-codec rows."""
        if async_cfg is None:
            return Rr, dw, pw, None
        latency = fr.latency if fr is not None else torch.zeros_like(pw)
        drop = fr.drop if (faults is not None and faults.drop_rate > 0.0) \
            else None
        age = R.all_rows(reserved(plan, async_agg.ASYNC_AGE_KEY,
                                  "init_async_comm"))
        ar = async_agg.plan_async(async_cfg, latency, age, pw, drop=drop)
        if family == "scaffold":
            # the control variates ride the model uplink: only fresh
            # arrivals enter c (a fold's c_up is lost)
            dwz = torch.where(ar.fresh, dw, 0.0)
            dw = dwz / torch.clamp(dwz.sum(), min=1e-30)
        return async_agg.CaptureReduce(Rr), dw, ar.fresh_weights, ar

    def async_epilogue(plan: CohortPlan, ar, Rc, w_t, new_params, upd):
        """The buffer fold into the params and the buffer transition, after
        fault_epilogue (the dropped-row freeze must not undo the buffer
        writes); a non-fresh client's c_k reverts; busy clients' history
        rows are guarded. Returns (params, updates, the async stats)."""
        if async_cfg is None:
            return new_params, upd, None
        stats = async_agg.async_round_stats(ar)
        ar = local_ar(ar)
        comm_in = plan.cohort.comm
        buf = comm_in[async_agg.ASYNC_BUF_KEY]
        new_params = async_agg.fold_buffered(new_params, ar.fold_weights, buf,
                                             R)
        # encode at send: the deferred client's row is its post-codec delta
        # against this round's anchor, captured off the model uplink
        new_buf, new_age = async_agg.advance_buffer(
            ar, Rc.captured - w_t, buf, comm_in[async_agg.ASYNC_AGE_KEY])
        comm = dict(upd["comm"] if upd.get("comm") is not None else comm_in)
        comm[async_agg.ASYNC_BUF_KEY] = new_buf
        comm[async_agg.ASYNC_AGE_KEY] = new_age
        upd = {**upd, "comm": comm}
        if upd.get("c_k") is not None:
            upd["c_k"] = flt.tree_select(~ar.fresh, plan.cohort.c_k, upd["c_k"])
        if async_cfg.guard_history:
            upd = async_agg.guard_history_rows(ar.fold | ar.retain,
                                               plan.cohort, upd)
        return new_params, upd, stats

    def round_fn(state: ServerState, draws: "dict | None" = None):
        def take(name: str, rows: torch.Tensor | None = None) -> torch.Tensor:
            shape = draw_specs[name][0]
            if draws is None:
                return draw_of(name, state.t, rows)
            if name not in draws:
                raise ValueError(f"draws lack {name!r}; a round of {algo} "
                                 f"draws {sorted(specs)}")
            if tuple(draws[name].shape) != shape:
                raise ValueError(f"draw {name!r} of shape "
                                 f"{tuple(draws[name].shape)}, expected {shape}")
            return draws[name]

        idx = None
        if csize is not None:
            with record_function("fl.cohort_plan"):
                idx = take(COHORT)
        # a cohort's draws are rows idx of the dense round's
        rows_of = idx if gathers else None

        def draw(spec: UplinkSpec, shape: tuple) -> torch.Tensor:
            return take(spec.tag, rows_of)

        plan = _plan_round(C, csize, state, idx)
        if shard is not None:
            # the plan's weights are all K clients'
            plan = plan._replace(dweight=weight, pweight=weight)
        mb = take(MINIBATCH, rows_of) if hp.batch_size is not None else None
        with record_function("fl.faults"):
            Rr, dw, pw, fr = fault_ctx(plan, take, rows_of)
            Rr, dw, pw, ar = async_ctx(plan, Rr, fr, dw, pw)
        fr_rows = local_fr(fr)
        cohort = plan.cohort
        args = (plan.x, plan.y, plan.mask, local(dw), local(pw), comm_bytes,
                cohort.comm, draw, mb)
        upd = {}
        c_old = state.c
        if family == "svrg":
            carry = hp.carry_history > 0 and state.hist_s is not None
            poison = ((fr_rows.byz, fr_rows.noise[flt.POISON], faults.byz_scale)
                      if poisons else None)
            new_params, metrics, comm, hist_s, hist_y = _svrg_round_core(
                problem, hp, use_aa, Rr, state.params, *args,
                cohort.hist_s if carry else None,
                cohort.hist_y if carry else None, poison)
            if carry:
                upd = dict(hist_s=hist_s, hist_y=hist_y)
        elif family == "scaffold":
            if state.c is None or state.c_k is None:
                raise ValueError(f"{algo} carries control variates: build its "
                                 f"state with init_state(..., algo={algo!r})")
            new_params, c, c_k, metrics, comm = _scaffold_round_core(
                problem, hp, use_aa, Rr, state.params, state.c, cohort.c_k,
                *args)
            upd = dict(c_k=c_k)
            state = state._replace(c=c)
        elif family == "avg":
            new_params, metrics, comm = _avg_round_core(
                problem, hp, use_aa, Rr, state.params, *args)
        elif family == "newton":
            new_params, metrics, comm = _newton_round_core(
                problem, hp, client_fn, Rr, state.params, *args[:-1],
                ls_steps=ls_steps)
        elif family == "dane":
            new_params, metrics, comm = _dane_round_core(
                problem, hp, Rr, state.params, *args[:-1], steps=dane_steps)
        else:
            new_params, metrics, comm = _lbfgs_round_core(
                problem, hp, Rr, state.params, *args)
        upd = dict(comm=comm, **upd)
        with record_function("fl.faults"):
            upd = fault_epilogue(plan, fr_rows, state.params, upd)
            new_params, upd, astats = async_epilogue(
                plan, ar, Rr, state.params, new_params, upd)
        if astats is not None:
            if family == "scaffold":
                # c's aggregate is not delta-form: a round with no fresh
                # arrival keeps the old c
                state = state._replace(
                    c=torch.where(ar.fresh.any(), state.c, c_old))
            metrics = metrics._replace(arrivals=astats[0],
                                       staleness_mean=astats[1],
                                       staleness_max=astats[2])
        upd = _commit_plan(plan, **upd)
        return state._replace(params=new_params, t=state.t + 1, **upd), metrics

    round_fn.draw_specs = draw_specs
    round_fn.fill_draws = fill_draws
    round_fn.host_metrics = (("comm_bytes",) if async_cfg is not None
                             else HOST_METRICS)
    return round_fn
