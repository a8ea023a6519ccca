"""Deadline-gated, staleness-discounted aggregation (counterpart of
repro/robust/async_agg.py).

robust/faults.py simulates each client's compute latency (the
``latency_*`` fields of ``FaultPlan``); an :class:`AsyncConfig` decides
what the server does with it, turning the barriered round into a
FedBuff-style deadline-gated one:

* a client whose latency beats the (possibly extended) deadline lands
  **fresh**: its post-codec update enters the aggregate as in the
  synchronous round;
* a late client's post-codec update is parked in its **buffer row**
  (``ASYNC_BUF_KEY`` / ``ASYNC_AGE_KEY`` in the comm state, so it rides the
  cohort gather/scatter) and **folds** into the first later round in which
  the client is drawn and on time, weighted down by its staleness s (the
  rounds it waited) as ``(1+s)^-alpha``;
* a client busy with a buffered round starts no fresh work: a drawn,
  busy and late client just ages (``retain``).

If fewer than ``min_arrivals`` latencies beat the deadline, the deadline
extends to the ``min_arrivals``-th order statistic, on the device (a
``torch.sort``, no host read). A round with no contributor gives all-zero
weights, and the delta-form aggregate keeps ``w^t`` bit for bit.

With dropout: a dropped on-time client contributes and buffers nothing; a
dropped fold keeps its buffer row, which ages; a late client buffers
whether or not the wire would have dropped it.

``guard_history=True`` keeps busy clients' ``hist_s``/``hist_y`` rows at
their pre-round bits, so a trajectory the deadline says never finished
does not enter the recorded AA history.

An inactive config (``deadline == 0``) makes the synchronous round.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.robust.faults import _bc, tree_select

#: the reserved comm-state keys of the per-client buffered post-codec
#: deltas [K, d] and their ages [K] int32 (0: empty)
ASYNC_BUF_KEY = "__async_buf__"
ASYNC_AGE_KEY = "__async_age__"


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Declarative deadline gate for the federated round.

    deadline        simulated-time budget a round; 0 disables the gate.
    min_arrivals    extend the deadline to the m-th latency order statistic
                    whenever fewer than m clients beat it (m clamped to the
                    round's clients); a dropped client counts toward it.
    staleness_alpha discount exponent: a fold aged s rounds weighs
                    ``(1+s)^-alpha`` times its base weight.
    guard_history   keep busy clients' AA history rows at their pre-round
                    bits; False lets them write (``clip_rtol`` screening
                    is then measured against it).
    """

    deadline: float = 0.0
    min_arrivals: int = 0
    staleness_alpha: float = 0.5
    guard_history: bool = True

    def __post_init__(self):
        if self.deadline < 0.0:
            raise ValueError(f"deadline must be >= 0, got {self.deadline}")
        if self.min_arrivals < 0:
            raise ValueError(
                f"min_arrivals must be >= 0, got {self.min_arrivals}")
        if self.staleness_alpha < 0.0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got {self.staleness_alpha}")

    @property
    def active(self) -> bool:
        """False: the synchronous round."""
        return self.deadline > 0.0


class AsyncRealization(NamedTuple):
    """One round's deadline-gate partition of its C clients: each is in
    exactly one of fresh, fold, defer, retain and idle (on time, dropped,
    empty buffer); ``contribute`` = fresh | fold."""

    contribute: torch.Tensor     # bool — lands this round (fresh or fold)
    fresh: torch.Tensor          # bool — on time, empty buffer: lands now
    fold: torch.Tensor           # bool — on time, full buffer: buffer lands
    defer: torch.Tensor          # bool — late, empty buffer: update buffers
    retain: torch.Tensor         # bool — busy and not folding: buffer ages
    staleness: torch.Tensor      # age of what landed (0 for fresh rows)
    weights: torch.Tensor        # discounted renormalized weights
    fresh_weights: torch.Tensor  # weights · fresh (the round core's)
    fold_weights: torch.Tensor   # weights · fold (the buffer fold's)
    deadline: torch.Tensor       # scalar — the deadline after extension


def discounted_weights(base: torch.Tensor, contribute: torch.Tensor,
                       staleness: torch.Tensor, alpha: float) -> torch.Tensor:
    """The contributors' weights ``base·(1+s)^-alpha``, renormalized over
    them; all zeros when nobody contributes."""
    s = torch.clamp(staleness.to(base.dtype), min=0.0)
    w = torch.where(contribute, base * (1.0 + s) ** (-alpha), 0.0)
    return w / torch.clamp(w.sum(), min=1e-30)


def plan_async(cfg: AsyncConfig, latency: torch.Tensor, age: torch.Tensor,
               pweight: torch.Tensor,
               drop: "torch.Tensor | None" = None) -> AsyncRealization:
    """Partition the round's clients ([C] ops on the device) from their
    latencies, buffer ages (0: empty), base weights and optional dropout
    mask. A pure function of its arguments: the wall-clock replay calls it
    with the draws the round saw."""
    lat = latency.to(torch.promote_types(latency.dtype, torch.float32))
    d_eff = torch.full((), cfg.deadline, dtype=lat.dtype, device=lat.device)
    if cfg.min_arrivals > 0:
        m = min(int(cfg.min_arrivals), lat.shape[0])
        d_eff = torch.maximum(d_eff, torch.sort(lat).values[m - 1])
    ontime = lat <= d_eff
    landed = ontime if drop is None else ontime & ~drop
    busy = age > 0
    fresh = landed & ~busy
    fold = landed & busy
    # a late client buffers client-side whether or not the wire drops it
    defer = ~ontime & ~busy
    retain = busy & ~fold
    contribute = fresh | fold
    staleness = torch.where(fold, age, 0).to(pweight.dtype)
    w = discounted_weights(pweight, contribute, staleness, cfg.staleness_alpha)
    return AsyncRealization(
        contribute=contribute, fresh=fresh, fold=fold, defer=defer,
        retain=retain, staleness=staleness, weights=w,
        fresh_weights=torch.where(fresh, w, 0.0),
        fold_weights=torch.where(fold, w, 0.0), deadline=d_eff)


# -- carried buffer state ----------------------------------------------------

def init_async_comm(comm: "dict | None", params: torch.Tensor,
                    num_clients: int) -> dict:
    """The comm state with zero buffer rows [K, d] and zero ages [K] int32."""
    buf = params.new_zeros((num_clients, *params.shape))
    age = torch.zeros((num_clients,), dtype=torch.int32, device=params.device)
    return {**(comm or {}), ASYNC_BUF_KEY: buf, ASYNC_AGE_KEY: age}


def fold_buffered(params: torch.Tensor, fold_weights: torch.Tensor,
                  buf: torch.Tensor, reduce=None) -> torch.Tensor:
    """``params + Σ_k w_k · buf_k``: all-zero weights add exactly 0.0. The
    sum is a cross-client one: with ``reduce`` (a CrossClientReduce) it is
    ``reduce.wsum``, which under the sharded runtime ends in a collective
    over the ranks' rows."""
    if reduce is None:
        total = torch.tensordot(fold_weights.to(buf.dtype), buf, dims=1)
    else:
        total = reduce.wsum(fold_weights, buf)
    return params + total.to(params.dtype)


def advance_buffer(ar: AsyncRealization, delta: torch.Tensor,
                   buf: torch.Tensor, age: torch.Tensor):
    """The buffer rows after the round: defer → the fresh post-codec delta,
    age 1; retain → kept, age + 1; otherwise emptied, age 0."""
    new_buf = torch.where(_bc(ar.defer, buf), delta.to(buf.dtype),
                          torch.where(_bc(ar.retain, buf), buf,
                                      torch.zeros_like(buf)))
    new_age = torch.where(ar.defer, 1,
                          torch.where(ar.retain, age + 1, 0)).to(age.dtype)
    return new_buf, new_age


def guard_history_rows(busy: torch.Tensor, cohort, updates: dict) -> dict:
    """``updates`` with the busy clients' ``hist_s``/``hist_y`` rows back
    at their pre-round values in ``cohort``."""
    out = dict(updates)
    for name in ("hist_s", "hist_y"):
        if out.get(name) is not None:
            out[name] = tree_select(busy, getattr(cohort, name), out[name])
    return out


def async_round_stats(ar: AsyncRealization):
    """(arrivals, staleness_mean, staleness_max) over the round's
    contributors, as f32 device scalars; nan staleness when nothing
    landed."""
    n = ar.contribute.sum()
    s = ar.staleness
    sm = torch.where(n > 0, torch.where(ar.contribute, s, 0.0).sum()
                     / torch.clamp(n, min=1).to(s.dtype), torch.nan)
    sx = torch.where(n > 0, torch.where(ar.contribute, s, -torch.inf).max(),
                     torch.nan)
    return (n.to(torch.float32), sm.to(torch.float32), sx.to(torch.float32))


# -- the capturing wire ------------------------------------------------------

class CaptureReduce:
    """A reduce view that keeps the anchored model aggregation's stacked
    post-codec updates for the buffer write: every delta-form round core
    makes exactly one anchored ``wsum``. A deferred client encoded its
    update when it finished; only the delivery is late, so its
    error-feedback residual advances as usual. Built inside each round, so
    each call (and each graph capture) keeps its own."""

    def __init__(self, inner):
        self.inner = inner
        self.captured = None  # [C, d] post-codec stacked model updates

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def wsum(self, weights, stacked, anchor=None):
        if anchor is not None:
            self.captured = stacked
        return self.inner.wsum(weights, stacked, anchor=anchor)
