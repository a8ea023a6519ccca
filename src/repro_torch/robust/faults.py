"""Fault injection for the federated round (counterpart of
repro/robust/faults.py).

A ``FaultPlan`` declares which adversarial conditions a round injects. Each
round realizes it from its own draws (``fault_draws`` names them;
core/algorithms.py::make_round_fn draws each from a generator seeded from
``(plan.seed, t, fold)``), so two runs of one plan inject the same
rounds bit for bit, and a run's ``seed`` does not move them. A draw covers
all K clients and a cohort round takes its rows, so a client's fate in a
round is keyed by its global id, wherever it sits in the cohort. The
reference's ``jax.random`` key streams cannot be reproduced in torch; a
caller that needs its realization (the parity tests) passes it as the
round's draws.

Fault kinds
-----------
* **dropout** (``drop_rate``) — the client computes its round but its
  uplink never lands: its aggregation weight is zeroed (the survivors
  renormalize) and every per-client state row it would have written (AA
  history, control variate, codec buffers, the stale anchor) keeps its
  pre-round bits.
* **staleness** (``stale_rate``) — the client uploads a delta computed
  against an aged anchor ``w^{t-s}``: each client carries an anchor row
  (``FAULT_ANCHOR_KEY`` in the comm state, so it rides the cohort
  gather/scatter); a stale draw keeps it aged (consecutive draws compound
  s), a fresh draw refreshes it to the round's ``w^t``.
* **byzantine** (the ``byz_clients`` lowest ids, ``byz_mode``):
  ``"sign_flip"`` uploads ``−byz_scale·v``; ``"noise"`` a random direction
  of norm ``byz_scale·‖v‖``; ``"history"`` corrupts the client's last
  recorded AA residual column after its trajectory (the attack the
  ``AAConfig.clip_rtol`` screen defends; the SVRG family's FedOSAA only).
* **DP noise** (``dp_sigma``) — Gaussian noise added to the decoded uplink
  value, before the error-feedback residual is taken, so EF and
  difference-coding references track the noised wire.
* **latency** (``latency_scale`` > 0) — per-round compute times from a
  heavy-tailed ``latency_dist`` ("lognormal": ``scale·exp(shape·z)``;
  "pareto": ``scale·u^(−1/shape)``). They perturb nothing alone: the
  deadline gate (robust/async_agg.py) reads them.

``FaultyReduce`` wraps the round's ``CrossClientReduce`` and applies the
uplink-level faults; the weights, the freeze and the anchor refresh are
applied by make_round_fn around the unchanged round cores.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

BYZ_MODES = ("sign_flip", "noise", "history")

LATENCY_DISTS = ("lognormal", "pareto")

#: the reserved comm-state key of the per-client [K, d] anchor rows (codec
#: tags are short names, so the dunder name cannot collide)
FAULT_ANCHOR_KEY = "__fault_anchor__"

#: the names of a round's fault draws, and the folds of their seeds
#: (distinct from the uplinks' 101–104, the minibatch's 105 and the
#: cohort's 106); the byzantine and DP noise take one draw per uplink tag,
#: at these bases plus the uplink's fold
DROP, STALE, LATENCY, POISON = ("fault.drop", "fault.stale", "fault.latency",
                                "fault.poison")
DRAW_FOLDS = {DROP: 111, STALE: 112, LATENCY: 113, POISON: 114}
BYZ_FOLD_BASE, DP_FOLD_BASE = 200, 300


def byz_draw(tag: str) -> str:
    """The name of uplink ``tag``'s byzantine noise draw."""
    return f"fault.byz.{tag}"


def dp_draw(tag: str) -> str:
    """The name of uplink ``tag``'s DP noise draw."""
    return f"fault.dp.{tag}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule for a federated run.

    ``seed`` keys the whole injection stream. Rates are independent
    per-round, per-client Bernoulli draws; the byzantine clients are the
    fixed ``byz_clients`` lowest ids (persistent attackers)."""

    seed: int = 0
    drop_rate: float = 0.0
    stale_rate: float = 0.0
    byz_clients: int = 0
    byz_mode: str = "sign_flip"
    byz_scale: float = 10.0
    dp_sigma: float = 0.0
    latency_dist: str = "lognormal"
    latency_scale: float = 0.0  # 0 = no latency simulation
    latency_shape: float = 1.0  # lognormal sigma / pareto tail index

    def __post_init__(self):
        if self.byz_mode not in BYZ_MODES:
            raise ValueError(
                f"unknown byz_mode {self.byz_mode!r}; choose from {BYZ_MODES}")
        if self.latency_dist not in LATENCY_DISTS:
            raise ValueError(f"unknown latency_dist {self.latency_dist!r}; "
                             f"choose from {LATENCY_DISTS}")
        for name in ("drop_rate", "stale_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.byz_clients < 0:
            raise ValueError(f"byz_clients must be >= 0, got {self.byz_clients}")
        if self.dp_sigma < 0.0:
            raise ValueError(f"dp_sigma must be >= 0, got {self.dp_sigma}")
        if self.latency_scale < 0.0:
            raise ValueError(
                f"latency_scale must be >= 0, got {self.latency_scale}")
        if self.latency_shape <= 0.0:
            raise ValueError(
                f"latency_shape must be > 0, got {self.latency_shape}")

    @property
    def active(self) -> bool:
        """False: the plan is a no-op and make_round_fn makes the
        fault-free round, with the fault-free draws."""
        return (self.drop_rate > 0.0 or self.stale_rate > 0.0
                or self.byz_clients > 0 or self.dp_sigma > 0.0
                or self.latency_scale > 0.0)

    @property
    def simulates_latency(self) -> bool:
        return self.latency_scale > 0.0

    @property
    def poisons_history(self) -> bool:
        return self.byz_clients > 0 and self.byz_mode == "history"

    @property
    def perturbs_uplink(self) -> bool:
        return self.byz_clients > 0 and self.byz_mode != "history"


def fault_draws(plan: FaultPlan, uplinks: tuple,
                poison: bool) -> "dict[str, tuple[str, int]]":
    """The draws a round of ``plan`` takes: name -> (kind, fold). Kinds:
    "uniform" ([K] f32 in [0, 1): dropout, staleness), "normal" ([K] f32
    standard normals: lognormal latencies), "tiny" ([K] f32 uniforms
    clamped to at least f32's tiny: pareto latencies), "noise" ([K, d]
    standard normals in the params' dtype: the byzantine noise and the DP
    noise of each of the round's ``uplinks``, its UplinkSpec records, and
    with ``poison`` the history poison's)."""
    out = {}
    if plan.drop_rate > 0.0:
        out[DROP] = ("uniform", DRAW_FOLDS[DROP])
    if plan.stale_rate > 0.0:
        out[STALE] = ("uniform", DRAW_FOLDS[STALE])
    if plan.simulates_latency:
        out[LATENCY] = ("normal" if plan.latency_dist == "lognormal"
                        else "tiny", DRAW_FOLDS[LATENCY])
    for spec in uplinks:
        if plan.perturbs_uplink and plan.byz_mode == "noise":
            out[byz_draw(spec.tag)] = ("noise", BYZ_FOLD_BASE + spec.fold)
        if plan.dp_sigma > 0.0:
            out[dp_draw(spec.tag)] = ("noise", DP_FOLD_BASE + spec.fold)
    if poison:
        out[POISON] = ("noise", DRAW_FOLDS[POISON])
    return out


class FaultRealization(NamedTuple):
    """One round's realized faults for its C clients."""

    drop: torch.Tensor     # [C] bool — the uplink never lands
    stale: torch.Tensor    # [C] bool — the delta is re-based on the aged anchor
    byz: torch.Tensor      # [C] bool — the client is byzantine
    latency: torch.Tensor  # [C] f32 — simulated compute time (0 if not modeled)
    noise: dict            # draw name -> [C, d] standard normals


def realize(plan: FaultPlan, draws: "dict[str, torch.Tensor]",
            ids: torch.Tensor) -> FaultRealization:
    """Round's [C] realization from its fault draws (rows ``ids`` of the
    dense draws in a cohort round) and the clients' global ids ``ids``."""
    C, dev = ids.shape[0], ids.device
    off = torch.zeros((C,), dtype=torch.bool, device=dev)
    drop = draws[DROP] < plan.drop_rate if plan.drop_rate > 0.0 else off
    stale = draws[STALE] < plan.stale_rate if plan.stale_rate > 0.0 else off
    if plan.simulates_latency:
        z = draws[LATENCY]
        if plan.latency_dist == "lognormal":
            latency = plan.latency_scale * torch.exp(plan.latency_shape * z)
        else:
            latency = plan.latency_scale * z ** (-1.0 / plan.latency_shape)
    else:
        latency = torch.zeros((C,), dtype=torch.float32, device=dev)
    noise = {name: v for name, v in draws.items() if v.dim() == 2}
    return FaultRealization(drop, stale, ids < plan.byz_clients, latency,
                            noise)


def _bc(flags: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [C] flag vector against a [C, ...] tensor."""
    return flags.reshape(flags.shape + (1,) * (like.dim() - 1))


def tree_select(flags: torch.Tensor, old, new):
    """Row-wise ``old`` where ``flags``, else ``new``, for a [C, ...] tensor
    or a nested dict of them (None stays None). A tensor that is ``old``
    itself (a field the round did not advance) is returned as is."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: tree_select(flags, old[k], v) for k, v in new.items()}
    if new is old:
        return new
    return torch.where(_bc(flags, new), old, new)


# -- dropout ----------------------------------------------------------------

def drop_weights(drop: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Zero the dropped clients' weights and renormalize over the
    survivors; an all-dropped round gives all-zero weights, and the
    delta-form aggregate then keeps w^t exactly."""
    w = torch.where(drop, 0.0, weights)
    return w / torch.clamp(w.sum(), min=1e-30)


def freeze_dropped(drop: torch.Tensor, cohort, updates: dict) -> dict:
    """The dropped clients' rows of ``updates`` (ClientStateStore field
    name -> the round's new [C, ...] rows) back at their pre-round values
    in ``cohort``: the client computed, but nothing it produced lands."""
    return {name: tree_select(drop, getattr(cohort, name), new)
            for name, new in updates.items()}


# -- staleness --------------------------------------------------------------

def init_fault_comm(comm: "dict | None", params: torch.Tensor,
                    num_clients: int) -> dict:
    """The comm state with every client's anchor row at ``params``."""
    anchor = params.unsqueeze(0).repeat(num_clients, 1)
    return {**(comm or {}), FAULT_ANCHOR_KEY: anchor}


def advance_anchor(comm: dict, stale: torch.Tensor, w_t: torch.Tensor) -> dict:
    """After the round: fresh clients re-anchor on the round's w^t, stale
    ones keep their aged row (staleness compounds over consecutive stale
    draws)."""
    a = comm[FAULT_ANCHOR_KEY]
    return {**comm, FAULT_ANCHOR_KEY: torch.where(_bc(stale, a), a,
                                                  w_t.expand_as(a))}


# -- byzantine --------------------------------------------------------------

def poison_last_column(y_stack: torch.Tensor, flag: torch.Tensor,
                       noise: torch.Tensor, scale: float) -> torch.Tensor:
    """byz_mode="history": add to each flagged client's last AA residual
    column y_stack[:, -1] ([C, m, d]) the noise direction ``noise`` [C, d]
    scaled to ``scale·‖y_0‖`` (calibrated on the client's own first
    column). An unflagged client's column gets exactly 0.0 added."""
    nn = torch.clamp(torch.linalg.vector_norm(noise, dim=-1), min=1e-30)
    ref = torch.clamp(torch.linalg.vector_norm(y_stack[:, 0], dim=-1),
                      min=1e-30)
    mag = torch.where(flag, scale * ref / nn, 0.0)
    last = y_stack[:, -1] + mag[:, None] * noise.to(y_stack.dtype)
    return torch.cat([y_stack[:, :-1], last[:, None]], 1)


def _byz_uplink(plan: FaultPlan, byz: torch.Tensor,
                noise: "torch.Tensor | None", stacked: torch.Tensor,
                anchor: "torch.Tensor | None") -> torch.Tensor:
    """The byzantine clients' uploads perturbed (sign_flip, noise) on the
    wire quantity (the delta for an anchored uplink); honest rows pass
    bit-untouched."""
    v = stacked if anchor is None else stacked - anchor
    if plan.byz_mode == "sign_flip":
        pert = -plan.byz_scale * v
    else:
        nn = torch.clamp(torch.linalg.vector_norm(noise, dim=-1), min=1e-30)
        vn = torch.linalg.vector_norm(v, dim=-1)
        pert = (plan.byz_scale * vn / nn)[:, None] * noise
    if anchor is not None:
        pert = pert + anchor
    return torch.where(_bc(byz, stacked), pert, stacked)


# -- the faulty wire --------------------------------------------------------

class FaultyReduce:
    """A ``CrossClientReduce`` view with the round's uplink faults: the
    byzantine perturbation, then the stale re-basing, then the codec with
    the DP noise added to its decoded value. Everything else delegates to
    the wrapped reduce."""

    def __init__(self, inner, plan: FaultPlan, fr: FaultRealization,
                 anchor_rows: "torch.Tensor | None" = None):
        self.inner = inner
        self.plan = plan
        self.fr = fr
        self.anchor_rows = anchor_rows  # [C, d] aged anchors (stale mode)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def uplink(self, stacked, spec, anchor=None, state=None, draw=None):
        plan, fr = self.plan, self.fr
        if plan.perturbs_uplink:
            stacked = _byz_uplink(plan, fr.byz, fr.noise.get(byz_draw(spec.tag)),
                                  stacked, anchor)
        if (plan.stale_rate > 0.0 and anchor is not None
                and self.anchor_rows is not None):
            # the stale client computed against its aged anchor; the server
            # re-bases the delta on w^t: the drift w^t − w^{t-s} lands too
            stacked = torch.where(_bc(fr.stale, stacked),
                                  stacked + (anchor - self.anchor_rows), stacked)
        post = None
        if plan.dp_sigma > 0.0:
            post = fr.noise[dp_draw(spec.tag)] * plan.dp_sigma
        return self.inner.uplink(stacked, spec, anchor=anchor, state=state,
                                 draw=draw, post=post)
