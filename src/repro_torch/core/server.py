"""Federated training loop (counterpart of repro/core/server.py).

``run_federated`` iterates one round of the chosen algorithm and collects
the metric history the paper plots (relative error vs. aggregation round,
communication, wall time). This slice ports the per-round loop; the
device-resident chunked engine, telemetry sinks, fault plans and
checkpointing come with later slices.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.comm import CommChannel, make_channel
from repro_torch.core.algorithms import (AlgoHParams, _cg_solve, init_state,
                                         make_round_fn)
from repro_torch.core.problem import FLProblem
from repro_torch.utils import tree_math as tm


@dataclasses.dataclass
class History:
    algo: str
    rounds: np.ndarray            # [T]
    loss: np.ndarray              # f(w^t)
    grad_norm: np.ndarray
    rel_error: np.ndarray         # ‖w^t − w*‖/‖w*‖ after the round (nan if no w*)
    theta_mean: np.ndarray        # AA gain per round (nan for non-AA algos)
    comm_bytes: np.ndarray        # cumulative bytes on the wire (codec-exact)
    wall_time: np.ndarray         # cumulative seconds (per-round, measured)
    final_params: torch.Tensor | None = None
    channel: str = "identity"     # CommChannel.name of the run's wire
    gram_cond_max: np.ndarray | None = None  # worst AA Gram conditioning

    def summary(self) -> str:
        return (
            f"{self.algo:18s} rounds={len(self.rounds):4d} "
            f"loss={self.loss[-1]:.6e} |g|={self.grad_norm[-1]:.3e} "
            f"relerr={self.rel_error[-1]:.3e} "
            f"gcond={self.gram_cond_max[-1]:.2e} "
            f"comm={self.comm_bytes[-1]:.3e}B[{self.channel}] "
            f"wall={self.wall_time[-1]:.2f}s")


def run_federated(
    problem: FLProblem,
    algo: str,
    hp: AlgoHParams,
    num_rounds: int,
    w_star: torch.Tensor | None = None,
    w0: torch.Tensor | None = None,
    stop_rel_error: float | None = None,
    stop_grad_norm: float | None = None,
    generator: "torch.Generator | None" = None,
    device: "str | torch.device" = DEFAULT_DEVICE,
    channel: "CommChannel | str | None" = None,
    seed: int = 0,
) -> History:
    """Iterate ``num_rounds`` of ``algo`` and collect the metric history.

    Every wire crossing goes through ``channel`` (a ``--comm-codec`` spec
    such as ``"int8"``, or None for the lossless identity); ``seed`` seeds a
    stochastic codec's draws. One round per call of the round function, one
    host read of its metrics per round (the wall time of a round includes
    that read, so it ends after the device has finished the round). Stops
    early on a non-finite loss, or when the rel-error / gradient-norm
    targets are met.
    """
    channel = make_channel(channel)
    state = init_state(problem, generator, device, channel, algo)
    if w0 is not None:
        state = state._replace(params=w0)
    round_fn = make_round_fn(algo, problem, hp, channel, seed, device)
    w_star_norm = float(tm.tree_norm(w_star)) if w_star is not None else None

    rows = []
    comm_total = 0.0
    t_total = 0.0
    for t in range(num_rounds):
        t0 = time.perf_counter()
        state, m = round_fn(state)
        rel_t = (tm.tree_norm(state.params - w_star) / max(w_star_norm, 1e-30)
                 if w_star is not None else torch.full_like(m.loss, torch.nan))
        # the round's one device -> host read
        vals = torch.stack([v.to(torch.float64) for v in (
            m.loss, m.grad_norm, rel_t, m.theta_mean, m.gram_cond_max)]).cpu()
        dt = time.perf_counter() - t0
        t_total += dt
        loss, gnorm, rel, theta, gcond = vals.tolist()
        comm_total += float(m.comm_bytes)
        rows.append((t, loss, gnorm, rel, theta, gcond, comm_total, t_total))
        if not np.isfinite(loss):
            break
        if stop_rel_error is not None and rel < stop_rel_error:
            break
        if stop_grad_norm is not None and gnorm < stop_grad_norm:
            break

    arr = np.asarray(rows, dtype=np.float64).reshape(-1, 8)
    return History(
        algo=algo, rounds=arr[:, 0], loss=arr[:, 1], grad_norm=arr[:, 2],
        rel_error=arr[:, 3], theta_mean=arr[:, 4], gram_cond_max=arr[:, 5],
        comm_bytes=arr[:, 6], wall_time=arr[:, 7],
        final_params=state.params, channel=channel.name)


def solve_reference(problem: FLProblem, iters: int = 2000,
                    tol: float = 1e-12) -> torch.Tensor:
    """w* to high precision by centralized Newton-CG (for the relative-error
    metric): each Newton step solves ∇²f(w) p = ∇f(w) with 100 CG iterations
    on the weighted sum of the clients' Hessian-vector products."""
    w = problem.init(None)
    weight = problem.clients.weight.to(w.dtype)
    for _ in range(iters):
        g = problem.global_grad(w)
        gnorm = float(tm.tree_norm(g))
        p = _cg_solve(lambda v: weight @ problem.client_hvps(w, v), g, 100)
        w = w - p
        if gnorm < tol:
            break
    return w
