"""Federated training driver (counterpart of repro/core/server.py).

``run_federated`` iterates rounds of the chosen algorithm and collects the
metric history the paper plots (relative error vs. aggregation round,
communication, wall time): round by round (``chunk=None``), or in chunks of
rounds through the engine (core/engine.py; on the card one CUDA graph a
chunk). Both feed the same telemetry rows to ``sinks`` (repro_torch/obs).
``hp.cohort_size`` or ``hp.participation`` < 1 runs every round on a
sampled cohort of the clients (core/algorithms.py); ``faults=`` and
``async_cfg=`` inject a FaultPlan and gate the rounds at a deadline
(repro_torch/robust). ``checkpoint=`` (a checkpoint.CheckpointPolicy) saves
the whole round state on its cadence, ``resume=`` ("auto" or a checkpoint
path) continues a run from a saved state bit for bit, and
``checkpoint_fs=`` swaps the filesystem (robust/fs_faults.FaultyFs injects
storage faults); ``checkpoint_config_fingerprint`` is the run identity a
checkpoint carries and a resume demands back. ``runtime="sharded"`` splits
the clients over the ranks of a ``torch.distributed`` group
(core/sharded.py); ``"vmap"`` stacks them on one device.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.checkpoint import (LOCAL_FS, CheckpointManager,
                                    CheckpointPolicy, load_checkpoint,
                                    load_latest)
from repro_torch.comm import CommChannel, make_channel
from repro_torch.comm.schema import uplink_byte_breakdown
from repro_torch.core import engine
from repro_torch.core.algorithms import (UPLINK_SCHEMAS, AlgoHParams,
                                         _cg_solve, init_state, make_round_fn,
                                         resolve_cohort_size)
from repro_torch.core.problem import FLProblem
from repro_torch.robust import (AsyncConfig, FaultPlan, init_async_comm,
                                init_fault_comm)
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
    arrivals: np.ndarray | None = None  # deadline-gated landings per round
                                  # (nan everywhere with the gate off)
    staleness_mean: np.ndarray | None = None  # mean landed buffer age (nan
                                  # if n/a)
    staleness_max: np.ndarray | None = None   # oldest landed buffer age

    @property
    def comm_floats(self) -> np.ndarray:
        """fp32-equivalent floats on the wire (bytes / 4), the paper's
        Table 1 unit."""
        return self.comm_bytes / 4.0

    def summary(self) -> str:
        return (
            f"{self.algo:18s} rounds={len(self.rounds):4d} "
            f"loss={self.loss[-1]:.6e} |g|={self.grad_norm[-1]:.3e} "
            f"relerr={self.rel_error[-1]:.3e} "
            f"gcond={self.gram_cond_max[-1]:.2e} "
            f"comm={self.comm_bytes[-1]:.3e}B[{self.channel}] "
            f"wall={self.wall_time[-1]:.2f}s")


def checkpoint_config_fingerprint(algo: str, runtime: str, channel_name: str,
                                  num_clients: int, cohort_size: int,
                                  faults=None, async_cfg=None) -> dict:
    """The run-identity dict embedded in every checkpoint manifest and
    demanded back at resume (the reference's, key for key): a checkpoint
    written under one algorithm / runtime / channel / cohort / fault
    schedule / async gate must not be silently continued under another (the
    carried AA history, EF residuals and buffers would be statistically
    meaningless). JSON-normalized so the comparison survives the manifest's
    serialization round-trip."""
    fp = {
        "algo": algo,
        "runtime": runtime,
        "channel": channel_name,
        "num_clients": int(num_clients),
        "cohort_size": int(cohort_size) if cohort_size is not None else None,
        "faults": dataclasses.asdict(faults) if faults is not None else None,
        "async": dataclasses.asdict(async_cfg)
        if async_cfg is not None else None,
    }
    return json.loads(json.dumps(fp))


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
    chunk: int | None = None,
    sinks=(),
    trace_capture=None,
    faults: FaultPlan | None = None,
    async_cfg: AsyncConfig | None = None,
    checkpoint: CheckpointPolicy | None = None,
    resume: "str | None" = None,
    checkpoint_fs=None,
    runtime: str = "vmap",
    group=None,
) -> History:
    """Iterate ``num_rounds`` of ``algo`` and collect the metric history.

    ``runtime="vmap"`` (the default) stacks the K clients on one device
    (core/algorithms.py::make_round_fn). ``runtime="sharded"`` is its
    distributed twin (core/sharded.py::make_sharded_round_fn): every rank
    of ``group`` (None: the default group, which the caller initialises)
    calls run_federated with the same arguments and the global
    ``problem``, keeps its block of the clients' rows on ``device`` and
    computes the replicated params, so ``w_star``, the rel-error, the
    History and ``final_params`` are the same on every rank; the sinks and
    ``trace_capture`` run on rank 0 only (a sink's stop request reaches
    every rank by a broadcast), the header says ``"runtime": "sharded"``,
    and a checkpoint holds one shard file per rank.

    Every wire crossing goes through ``channel`` (a ``--comm-codec`` spec
    such as ``"int8"``, or None for the lossless identity); ``seed`` seeds a
    stochastic codec's draws. Stops early on a non-finite loss, or when the
    rel-error / gradient-norm targets are met.

    ``chunk=None`` runs the per-round loop: one call of the round function
    and one host read of its metrics per round (a round's wall time
    includes that read, so it ends after the device has finished the
    round). ``chunk=B`` (>= 1) runs the engine (core/engine.run_rounds): B
    rounds per call, one host read per chunk, the chunk's wall divided
    equally over its executed rounds; on the card a chunk is one CUDA graph.
    The History rows are the same either way, bit for bit; only the wall
    times differ.

    ``sinks`` (repro_torch/obs MetricsSinks) get a header, one row per
    round and a footer on either path; a sink's ``stop_requested`` stops
    the run after the round (loop) or the chunk (engine). ``trace_capture``
    (obs.TraceCapture) opens torch.profiler windows at round or chunk
    boundaries.

    ``faults`` (robust.FaultPlan) injects its dropout, stale anchors,
    byzantine uplinks or history, DP noise and latencies in every round;
    ``async_cfg`` (robust.AsyncConfig) gates the rounds at its deadline,
    late updates waiting in buffer rows (core/algorithms.make_round_fn).
    A plan with ``stale_rate`` > 0 gets every client's anchor row at the
    starting params, an active gate empty buffer rows, both in the comm
    state, so they ride the cohort gather/scatter and the engine's graph.
    None or an inactive plan or config runs the plain rounds bit for bit.
    ``History.arrivals`` and ``staleness_*`` hold the gate's per-round
    activity; the run header carries both configs (``dataclasses.asdict``,
    None when absent).

    ``checkpoint`` (checkpoint.CheckpointPolicy) saves the whole state — the
    params, ``t``, the comm buffers with the anchor and buffer rows and
    ages, SCAFFOLD's control variates, the carried AA columns — every
    ``checkpoint.every`` rounds (at the engine's chunk boundaries; after a
    round of the loop) into its directory, in its mode (``async``: the
    write overlaps the next chunk; ``sync``; ``sync_gather``, the blocking
    baseline). ``resume="auto"`` (which needs ``checkpoint`` to name the
    directory) restores the newest complete checkpoint there, or starts
    fresh when there is none; a path restores that checkpoint; None or
    ``"none"`` starts fresh. The freshly initialized state (with its anchor
    and buffer rows) is the template, and a checkpoint whose fingerprint
    (``checkpoint_config_fingerprint``) differs from this run's raises
    ``CheckpointConfigMismatch``. ``num_rounds`` is the run's total budget:
    a resumed run starts at the manifest's round, its History rows and the
    sinks' rows (and the header's ``start_round``) count from there, and a
    resume at or past the budget returns an empty History. Every draw of a
    round is keyed by (seed, ``t``), so the resumed rows and state equal
    the uninterrupted run's bit for bit. ``checkpoint_fs`` replaces the
    filesystem (checkpoint.LocalFs; robust.FaultyFs injects storage
    faults). A failed save is counted and alarmed in the footer and the run
    goes on.
    """
    if chunk is not None and chunk < 1:
        # the per-round loop is chunk=None; a chunk of 0 names neither path
        raise ValueError(f"chunk must be >= 1 (or None for the per-round "
                         f"loop), got {chunk}")
    from repro_torch.obs.sinks import (ROW_FIELDS, SCHEMA_VERSION,
                                       build_footer, build_round_row)

    if runtime not in ("vmap", "sharded"):
        raise ValueError(f"unknown runtime {runtime!r}; choose 'vmap' or "
                         "'sharded'")
    channel = make_channel(channel)
    sinks = list(sinks)
    shard = None
    if runtime == "sharded":
        from repro_torch.core.sharded import (RankZeroStop,
                                              make_sharded_round_fn)

        round_fn = make_sharded_round_fn(algo, problem, hp, group, channel,
                                         seed, device, faults=faults,
                                         async_cfg=async_cfg)
        shard = round_fn.shard
        rows = round_fn.rank_problem
        if shard.rank != 0:
            sinks, trace_capture = [], None
        sinks = [RankZeroStop(sinks, group)] + sinks
    else:
        round_fn = make_round_fn(algo, problem, hp, channel, seed, device,
                                 faults=faults, async_cfg=async_cfg)
        rows = problem
    state = init_state(rows, generator, device, channel, algo, hp)
    if w0 is not None:
        state = state._replace(params=w0)
    K = rows.clients.num_clients
    if faults is not None and faults.active and faults.stale_rate > 0.0:
        # every client's anchor starts at the starting point
        state = state._replace(comm=init_fault_comm(state.comm, state.params, K))
    if async_cfg is not None and async_cfg.active:
        # every client starts with an empty buffer (age 0)
        state = state._replace(comm=init_async_comm(state.comm, state.params, K))
    device_fields, host_fields = engine.metric_fields(round_fn)
    run_info = {
        "algo": algo,
        "runtime": runtime,
        "channel": channel.name,
        "backend": state.params.device.type,
        "num_clients": problem.clients.num_clients,
        "cohort_size": resolve_cohort_size(hp, problem.clients.num_clients),
        "uplink_bytes": uplink_byte_breakdown(
            channel, UPLINK_SCHEMAS[algo], state.params),
        "faults": dataclasses.asdict(faults) if faults is not None else None,
        "async": (dataclasses.asdict(async_cfg) if async_cfg is not None
                  else None),
    }
    state, start_round, ckpt_mgr = _checkpointing(
        state, run_info, checkpoint, resume, checkpoint_fs, faults, async_cfg,
        shard)

    if chunk is not None:
        state, trace = engine.run_rounds(
            round_fn, state, max(0, num_rounds - start_round), chunk=chunk,
            w_star=w_star, stop_rel_error=stop_rel_error,
            stop_grad_norm=stop_grad_norm, sinks=sinks, run_info=run_info,
            trace_capture=trace_capture, start_round=start_round,
            checkpoint=ckpt_mgr)
        return History(
            algo=algo, rounds=np.arange(start_round,
                                        start_round + trace.num_rounds,
                                        dtype=np.float64),
            loss=trace.loss, grad_norm=trace.grad_norm,
            rel_error=trace.rel_error, theta_mean=trace.theta_mean,
            comm_bytes=np.cumsum(trace.comm_bytes), wall_time=trace.wall_time,
            final_params=state.params, channel=channel.name,
            gram_cond_max=trace.gram_cond_max, arrivals=trace.arrivals,
            staleness_mean=trace.staleness_mean,
            staleness_max=trace.staleness_max)

    w_star_norm = float(tm.tree_norm(w_star)) if w_star is not None else None
    for s in sinks:
        s.open({
            "v": SCHEMA_VERSION, "kind": "header", "fields": list(ROW_FIELDS),
            "num_rounds": num_rounds, "chunk": None,
            "start_round": start_round, **run_info,
        })
    cols = {f: [] for f in engine.METRIC_FIELDS}
    rows = []
    comm_total = 0.0
    t_total = 0.0
    stopped = False
    try:
        for t in range(start_round, num_rounds):
            if trace_capture is not None:
                trace_capture.on_chunk_start(t, 1)
            t0 = time.perf_counter()
            state, m = round_fn(state)
            rel_t = engine.rel_error(state.params, w_star, w_star_norm, m.loss)
            # the round's one device -> host read
            vals = torch.stack([getattr(m, f).to(torch.float64)
                                for f in device_fields]
                               + [rel_t.to(torch.float64)]).cpu().tolist()
            dt = time.perf_counter() - t0
            t_total += dt
            mrow = dict(zip(device_fields, vals))
            mrow.update((f, float(getattr(m, f))) for f in host_fields)
            rel = vals[-1]
            comm_total += mrow["comm_bytes"]
            for f in engine.METRIC_FIELDS:
                cols[f].append(mrow[f])
            rows.append((t, rel, comm_total, t_total))
            for s in sinks:
                s.emit([build_round_row(t, mrow, rel, comm_total, dt, t_total)])
            if trace_capture is not None:
                trace_capture.on_chunk_end(t + 1)
            if ckpt_mgr is not None:
                ckpt_mgr.maybe_save(state, t + 1, dt)
            if (not np.isfinite(mrow["loss"])
                    or (stop_rel_error is not None and rel < stop_rel_error)
                    or (stop_grad_norm is not None
                        and mrow["grad_norm"] < stop_grad_norm)
                    or any(getattr(s, "stop_requested", False) for s in sinks)):
                stopped = True
                break
    finally:
        if trace_capture is not None:
            trace_capture.close()
        if ckpt_mgr is not None:
            ckpt_mgr.finalize()
        alarms = [e for s in sinks for e in getattr(s, "events", [])]
        if ckpt_mgr is not None:
            alarms.extend(ckpt_mgr.events)
        footer = build_footer(
            len(rows), stopped, alarms,
            checkpoint=ckpt_mgr.telemetry() if ckpt_mgr is not None
            else None)
        for s in sinks:
            s.close(footer)

    arr = np.asarray(rows, dtype=np.float64).reshape(-1, 4)
    col = {f: np.asarray(v, dtype=np.float64) for f, v in cols.items()}
    return History(
        algo=algo, rounds=arr[:, 0], loss=col["loss"],
        grad_norm=col["grad_norm"], rel_error=arr[:, 1],
        theta_mean=col["theta_mean"], comm_bytes=arr[:, 2],
        wall_time=arr[:, 3], final_params=state.params, channel=channel.name,
        gram_cond_max=col["gram_cond_max"], arrivals=col["arrivals"],
        staleness_mean=col["staleness_mean"],
        staleness_max=col["staleness_max"])


def _checkpointing(state, run_info: dict, checkpoint, resume, fs, faults,
                   async_cfg, shard=None):
    """The resumed state (or ``state``), the round it starts at, and the
    run's CheckpointManager (None without a policy); under a ``shard``
    the rank's rows restore and the rank writes its own shard file."""
    if checkpoint is None and resume in (None, "none"):
        return state, 0, None
    fs = fs if fs is not None else LOCAL_FS
    fingerprint = checkpoint_config_fingerprint(
        run_info["algo"], run_info["runtime"], run_info["channel"],
        run_info["num_clients"], run_info["cohort_size"], faults, async_cfg)
    start_round = 0
    if resume not in (None, "none"):
        if resume == "auto":
            if checkpoint is None:
                raise ValueError('resume="auto" needs a checkpoint policy (it '
                                 "names the directory to scan)")
            found = load_latest(checkpoint.directory, state, fs=fs,
                                expect_config=fingerprint, shard=shard)
        else:
            found = load_checkpoint(resume, state, fs=fs,
                                    expect_config=fingerprint, shard=shard)
        if found is not None:
            state, manifest = found
            start_round = int(manifest["round"])
    mgr = (CheckpointManager(checkpoint, config=fingerprint, fs=fs,
                             last_saved=start_round, shard=shard)
           if checkpoint is not None else None)
    return state, start_round, mgr


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
