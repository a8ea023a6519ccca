"""Chunked round engine (counterpart of repro/core/engine.py): B rounds per
call, stop criteria evaluated on the device, one host read per chunk.

The per-round loop (core/server.py) launches every round's kernels and
torch ops from Python and reads the round's metrics back each round; at
paper scale the host holds most of a round's wall time. This engine runs
``chunk`` rounds as one unit:

  * on the card, the chunk is ONE captured CUDA graph (``torch.cuda.
    CUDAGraph``), replayed once per chunk: the host enqueues B rounds with
    one launch. The runner owns static state buffers; the caller's state is
    copied in at the first call and the graph updates them in place (the
    reference's donation becomes this in-place ownership);
  * on the CPU, the same chunk body runs eagerly;
  * per-round metrics (and the rel-error against ``w_star``) stack on the
    device into one readout tensor; the host reads it once per chunk;
  * the stop criteria (rel-error target, grad-norm target, non-finite
    loss) are evaluated on the device: once one fires, the carried state
    passes through the rest of the chunk untouched, so the final state is
    the one the per-round loop ends with when it breaks.

The body applies each round unconditionally and then selects the carried
state with ``torch.where(live, new, old)``, where ``live = ~done & (i <
n_live)``; it never branches (a graph cannot, and the reference found that
a branch broke bit-exactness under XLA). Slots past a stop, or past
``n_live`` in a short last chunk, compute a round on the frozen state and
discard it: at most chunk − 1 rounds per run. ``n_live`` is a device
scalar, set with ``fill_`` before each replay, so a short last chunk
replays the same graph. The stopping round's row is kept, as the loop
emits the row before it breaks.

What stays on the host. ``state.t`` is a Python int: the engine advances
it by the executed rounds after the chunk's read. The host-tensor metrics
(``round.host_metrics``, ``algorithms.HOST_METRICS`` by default: the wire
bytes, counted from shapes, and the deadline gate's metrics when it is
off) are read at capture, and the engine sums the bytes per live round;
the others join the device readout. A round's draws
(``round.draw_specs``: a stochastic codec's f32 uniforms, a minibatch
round's int64 row indices) are drawn before each replay into static
[B, ...] buffers, by the same generator calls the loop makes for rounds
t0..t0+B−1 (``round.fill_draws``), and slot i reads its own: the draws,
and so every int8 and minibatch run, equal the loop's.

The carried state is every tensor of ``ServerState``: the params, the comm
buffers (the robustness layer's anchor rows, buffer rows and int32 ages
among them), SCAFFOLD's control variates and the carried AA columns, each
where the state has it (``_tensors``, ``_map_state``). A tensor the round
returned as the same object (a field it never advanced) passes the select
and the copy back into the static buffers untouched, as the reference's
``tree_where`` does: under cohorts (core/client_store.py) the K-sized
store stays in the runner's static buffers, each round gathers its
cohort's rows and scatters them back inside the captured chunk, and the
cohort indices are one more draw (``"cohort"``, filled before each replay
with the rest).

On the card there is no eager fallback: a round that cannot be captured (a
host read inside it, as ``aa_impl="tree"``'s batched eigh makes) raises
from the capture with its cause. Kernel launches under capture go into a
``_build.LaunchRecord``; each replay adds it to ``_build.LAUNCHES``, so the
counters count launches that reached the card, every slot of every replay
included. The warm-up round before the capture (on a scratch copy of the
state, on the capture stream, as torch's graph docs require) is counted
apart, in ``runner.warmup_launches``.

``run_rounds`` works with any ``round(state, draws) -> (state,
RoundMetrics)`` from ``make_round_fn`` or core/sharded.py's
``make_sharded_round_fn``; pass a prebuilt ``runner`` to keep its graph
across calls (a later call overwrites the state it returned). A sharded
round on an NCCL group is captured with its all-reduces in the graph (the
warm-up round's collectives, on the capture stream, set up the
communicator first); on a gloo group on the card the capture raises the
round's ``capture_refusal``, and the per-round loop is its path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.algorithms import HOST_METRICS, ServerState
from repro_torch.kernels import _build
from repro_torch.utils import tree_math as tm

#: RoundMetrics fields mirrored into RoundTrace columns, in order — the
#: engine reads them off the stacked metrics generically, so a new metric
#: becomes a trace column (and a telemetry row field) by being added to
#: RoundMetrics and here.
METRIC_FIELDS = (
    "loss", "grad_norm", "theta_mean", "gram_cond_max", "gram_cond_mean",
    "aa_used_min", "aa_clipped_max", "cohort_ess", "comm_bytes",
    "arrivals", "staleness_mean", "staleness_max",
)
#: the metrics a synchronous round reads from the device, in the readout's
#: column order; then the rel-error, live and done columns
DEVICE_FIELDS = tuple(f for f in METRIC_FIELDS if f not in HOST_METRICS)


def metric_fields(round_fn) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(device fields, host fields) of ``round_fn``'s metrics: the host ones
    are its ``host_metrics`` (HOST_METRICS for a round without it)."""
    host = tuple(getattr(round_fn, "host_metrics", HOST_METRICS))
    return tuple(f for f in METRIC_FIELDS if f not in host), host


@dataclasses.dataclass
class RoundTrace:
    """Per-round history of an engine run (host-side numpy, one row per
    EXECUTED round — skipped slots are dropped)."""

    loss: np.ndarray           # [T]
    grad_norm: np.ndarray      # [T]
    theta_mean: np.ndarray     # [T]
    gram_cond_max: np.ndarray  # [T]
    gram_cond_mean: np.ndarray # [T]
    aa_used_min: np.ndarray    # [T]
    aa_clipped_max: np.ndarray # [T] clip_rtol screen activity (nan if n/a)
    cohort_ess: np.ndarray     # [T]
    comm_bytes: np.ndarray     # [T] per-round (NOT cumulative) wire bytes
    arrivals: np.ndarray       # [T] deadline-gated landings (nan: async off)
    staleness_mean: np.ndarray # [T] mean landed buffer age (nan if n/a)
    staleness_max: np.ndarray  # [T] oldest landed buffer age (nan if n/a)
    rel_error: np.ndarray      # [T] ‖w−w*‖/‖w*‖ (nan when w_star not given)
    round_wall: np.ndarray     # [T] seconds attributed to this round (each
                               # chunk's measured wall time divided equally
                               # over its executed rounds)
    wall_time: np.ndarray      # [T] cumulative seconds
    stopped: bool              # a stop criterion fired (vs round budget spent)

    @property
    def num_rounds(self) -> int:
        return len(self.loss)


def rel_error(params: torch.Tensor, w_star: torch.Tensor | None,
              w_star_norm: float | None, like: torch.Tensor) -> torch.Tensor:
    """‖params − w*‖/‖w*‖ on the device (nan like ``like`` without w*): the
    loop and the engine compute it by this one expression, so their rows
    agree bit for bit."""
    if w_star is None:
        return torch.full_like(like, torch.nan)
    return tm.tree_norm(params - w_star) / max(w_star_norm, 1e-30)


def _fetch(readout: torch.Tensor) -> np.ndarray:
    """The chunk's one device→host read."""
    return readout.cpu().numpy()


#: the ServerState fields that hold a tensor (or None), besides ``comm``
_TENSOR_FIELDS = ("params", "c", "c_k", "hist_s", "hist_y")


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tensor or a nested dict of them, by sorted key."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _map_tree(fn, *trees):
    """``fn`` over matching tensors of tensors or nested dicts of them (the
    keys of the first)."""
    if isinstance(trees[0], dict):
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tensors(state: ServerState) -> list[torch.Tensor]:
    """The state's tensors in a fixed order: the tensor fields it has
    (params, c, c_k, hist_s, hist_y), then the comm state's (its
    ``{tag: {name: tensor}}`` buffers and the reserved keys' tensors)."""
    out = [getattr(state, f) for f in _TENSOR_FIELDS
           if getattr(state, f) is not None]
    return out + (_leaves(state.comm) if state.comm is not None else [])


def _map_state(fn, *states: ServerState) -> ServerState:
    """``fn`` over the states' matching tensors (every field the first
    state has; a None field stays None); ``t`` from the first."""
    first = states[0]
    comm = None
    if first.comm is not None:
        comm = _map_tree(fn, *(s.comm for s in states))
    fields = {f: fn(*(getattr(s, f) for s in states)) for f in _TENSOR_FIELDS
              if getattr(first, f) is not None}
    return first._replace(comm=comm, **fields)


class ChunkRunner:
    """``chunk`` rounds of ``round_fn`` per call, on the card as one CUDA
    graph (see the module docstring); build it with ``make_chunk_runner``.

    ``runner(state, n_live) -> (state, done, metrics, rel, live)``, all but
    the state read back in ONE device→host copy:
      state   — after min(n_live, first-stop) rounds, ``t`` advanced by
                them; on the card its tensors are the runner's own buffers,
                which the next call updates in place;
      done    — a stop criterion fired inside the chunk;
      metrics — {field: [chunk] float64} for every METRIC_FIELDS name;
      rel     — [chunk] rel-error after each round (nan without w_star);
      live    — [chunk] bool: the slot's round entered the carried state.
                Rows of non-live slots are garbage and must be dropped.

    On the card, ``warmup_ms`` and ``capture_ms`` time the first call's
    warm-up round and capture, and ``warmup_launches`` holds the warm-up's
    kernel launches (``_build.LaunchRecord``), counted apart from
    ``_build.LAUNCHES``; ``record`` holds one replay's launches.
    """

    def __init__(self, round_fn: Callable, chunk: int, *,
                 w_star: torch.Tensor | None = None,
                 stop_rel_error: float | None = None,
                 stop_grad_norm: float | None = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.round_fn = round_fn
        self.chunk = chunk
        self.w_star = w_star
        self.w_star_norm = (float(tm.tree_norm(w_star)) if w_star is not None
                            else None)
        self.stop_rel_error = stop_rel_error
        self.stop_grad_norm = stop_grad_norm
        self.device_fields, self.host_fields = metric_fields(round_fn)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static: ServerState | None = None
        self.warmup_ms = self.capture_ms = None
        self.warmup_launches = self.record = None

    def _body(self, state: ServerState, n_live: torch.Tensor,
              draws: "dict[str, torch.Tensor]"):
        """The chunk, eagerly: ``chunk`` unconditional rounds, each selected
        into the carried state while live. Returns (state, the [chunk,
        len(device_fields) + 3] float64 readout, the host metrics of each
        slot). The CPU path calls it; the card captures it."""
        done = torch.zeros((), dtype=torch.bool, device=state.params.device)
        rows, host = [], []
        for i in range(self.chunk):
            new, m = self.round_fn(
                state, {name: b[i] for name, b in draws.items()} or None)
            rel = rel_error(new.params, self.w_star, self.w_star_norm, m.loss)
            live = ~done & (n_live > i)
            state = _map_state(
                lambda a, b: a if a is b else torch.where(live, a, b),
                new, state)
            # the loop's break order: the row is emitted, then the stop fires
            stop = ~torch.isfinite(m.loss)
            if self.stop_rel_error is not None:
                stop = stop | (rel.to(torch.float64) < self.stop_rel_error)
            if self.stop_grad_norm is not None:
                stop = stop | (m.grad_norm.to(torch.float64)
                               < self.stop_grad_norm)
            done = done | (live & stop)
            rows.append(torch.stack(
                [getattr(m, f).to(torch.float64) for f in self.device_fields]
                + [rel.to(torch.float64), live.to(torch.float64),
                   done.to(torch.float64)]))
            host.append([float(getattr(m, f)) for f in self.host_fields])
        return state, torch.stack(rows), host

    def _draw_buffers(self, device) -> "dict[str, torch.Tensor]":
        """[chunk, ...] buffers of each of the round's draws, in its dtype."""
        return {name: torch.empty((self.chunk, *shape), dtype=dtype,
                                  device=device)
                for name, (shape, dtype) in self.round_fn.draw_specs.items()}

    def _capture(self, state: ServerState) -> None:
        """Own static copies of ``state``, warm up one round on a scratch
        copy on the capture stream, then capture the chunk body. A round
        that names a ``capture_refusal`` (the sharded round on a gloo
        group) raises it; a round's ``capture_error_mode`` (the sharded
        round on NCCL: "thread_local") is the capture's."""
        refusal = getattr(self.round_fn, "capture_refusal", None)
        if refusal:
            raise ValueError(f"engine: {refusal}")
        dev = state.params.device
        self.static = _map_state(torch.clone, state)
        self.n_live = torch.zeros((), dtype=torch.int64, device=dev)
        self.draws = self._draw_buffers(dev)
        self.round_fn.fill_draws(self.draws, state.t)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), _build.recording() as warm:
            scratch = _map_state(torch.clone, self.static)
            self.round_fn(scratch, {name: b[0] for name, b in
                                    self.draws.items()} or None)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        self.warmup_launches = warm
        del scratch
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with (_build.recording() as record,
                  torch.cuda.graph(graph, stream=stream,
                                   capture_error_mode=getattr(
                                       self.round_fn, "capture_error_mode",
                                       "global"))):
                out, self.readout, self.host = self._body(
                    self.static, self.n_live, self.draws)
                # the chunk's final state back into the buffers the next
                # replay reads
                for dst, src in zip(_tensors(self.static), _tensors(out)):
                    if src is not dst:
                        dst.copy_(src)
        except RuntimeError as e:
            raise RuntimeError(
                f"engine: the round cannot be captured as a CUDA graph (a "
                f"host read or another operation capture forbids): {e}") from e
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph, self.record = graph, record

    def _load(self, state: ServerState) -> None:
        """Copy a state that is not the runner's own into its buffers."""
        for dst, src in zip(_tensors(self.static), _tensors(state)):
            if src is not dst:
                dst.copy_(src)

    def __call__(self, state: ServerState, n_live: int):
        t0 = state.t
        if state.params.device.type == "cpu":
            draws = self._draw_buffers(state.params.device)
            self.round_fn.fill_draws(draws, state.t)
            state, readout, host = self._body(
                state, torch.tensor(n_live), draws)
            out = _fetch(readout)
        else:
            if self.graph is None:
                self._capture(state)
            else:
                self._load(state)
                self.round_fn.fill_draws(self.draws, state.t)
            self.n_live.fill_(n_live)
            self.graph.replay()
            _build.count_replay(self.record)
            out = _fetch(self.readout)
            host = self.host
            state = self.static
        n_dev = len(self.device_fields)
        live = out[:, n_dev + 1] != 0
        metrics = {f: out[:, j] for j, f in enumerate(self.device_fields)}
        for j, f in enumerate(self.host_fields):
            metrics[f] = np.array([row[j] for row in host])
        state = state._replace(t=t0 + int(live.sum()))
        return state, bool(out[-1, n_dev + 2]), metrics, out[:, n_dev], live


def make_chunk_runner(round_fn: Callable, chunk: int, *,
                      w_star: torch.Tensor | None = None,
                      stop_rel_error: float | None = None,
                      stop_grad_norm: float | None = None) -> ChunkRunner:
    """A ``ChunkRunner`` of ``chunk`` rounds of ``round_fn`` (from
    ``make_round_fn``), stopping on a non-finite loss and on the targets
    given. Raises unless ``chunk`` >= 1."""
    return ChunkRunner(round_fn, chunk, w_star=w_star,
                       stop_rel_error=stop_rel_error,
                       stop_grad_norm=stop_grad_norm)


def run_rounds(
    round_fn: Callable,
    state: ServerState,
    num_rounds: int,
    *,
    chunk: int = 8,
    w_star: torch.Tensor | None = None,
    stop_rel_error: float | None = None,
    stop_grad_norm: float | None = None,
    runner: ChunkRunner | None = None,
    sinks=(),
    run_info: "dict | None" = None,
    trace_capture=None,
    start_round: int = 0,
    checkpoint=None,
):
    """Run up to ``num_rounds`` rounds in chunks of ``chunk``; one host read
    per chunk. Returns ``(final_state, RoundTrace)`` — the state stays on
    the device, the trace is host numpy with one row per executed round
    (the per-round loop's rows, bit for bit).

    ``runner`` — optionally a prebuilt ``make_chunk_runner(...)`` whose
    graph should be reused. It MUST have been built from the same
    ``round_fn`` with the same chunk/stop configuration; when omitted, one
    is built here.

    Telemetry (repro_torch/obs — every hook is optional):
      sinks         — MetricsSinks. Opened with a header row (run_info merged
                      in), fed one row per executed round from THIS chunk's
                      read — attaching sinks adds no device→host transfer
                      and leaves the chunk's math untouched — and closed
                      with a footer. A sink whose ``stop_requested`` turns
                      truthy (health alarms) stops the run at the next chunk
                      boundary.
      run_info      — extra header fields (algo/runtime/channel/uplink byte
                      breakdown — see core/server.py).
      trace_capture — obs/profiling.TraceCapture; notified at chunk
                      boundaries to open/close torch.profiler windows.
      start_round   — global index of the first round (resumed runs), offsets
                      the "round" field of emitted rows.
      checkpoint    — a checkpoint.CheckpointManager: after each chunk's
                      read, ``maybe_save(state, start_round + executed,
                      chunk wall)`` snapshots the state when a save is due
                      (on the card, non-blocking copies out of the runner's
                      buffers, ordered before the next replay by the
                      stream) and hands the write to its thread; the
                      in-flight save is joined in the ``finally``, its
                      stall and failure events join the footer's alarms and
                      its telemetry fills the footer's checkpoint fields.
                      The chunk keeps its one host read.
    """
    from repro_torch.obs.sinks import (ROW_FIELDS, SCHEMA_VERSION,
                                       build_footer, build_round_row)

    chunk = max(1, min(chunk, num_rounds))
    if runner is None:
        runner = make_chunk_runner(
            round_fn, chunk, w_star=w_star, stop_rel_error=stop_rel_error,
            stop_grad_norm=stop_grad_norm)
    chunk = runner.chunk
    sinks = list(sinks)
    for s in sinks:
        s.open({
            "v": SCHEMA_VERSION, "kind": "header", "fields": list(ROW_FIELDS),
            "num_rounds": num_rounds, "chunk": chunk,
            "start_round": start_round, **(run_info or {}),
        })
    cols: dict[str, list] = {f: [] for f in METRIC_FIELDS}
    rel_col: list[float] = []
    rw_col: list[float] = []
    wall_col: list[float] = []
    t_total = 0.0
    comm_total = 0.0
    executed = 0
    stopped = False
    try:
        while executed < num_rounds and not stopped:
            n_live = min(chunk, num_rounds - executed)
            if trace_capture is not None:
                trace_capture.on_chunk_start(start_round + executed, n_live)
            t0 = time.perf_counter()
            # the runner's one host read of this chunk ends the timed span
            state, done, ms, rels, lives = runner(state, n_live)
            elapsed = time.perf_counter() - t0
            idx = np.flatnonzero(lives)
            per_round = elapsed / max(len(idx), 1)
            rows = []
            for i in idx:
                t_total += per_round
                mrow = {f: float(ms[f][i]) for f in METRIC_FIELDS}
                comm_total += mrow["comm_bytes"]
                for f in METRIC_FIELDS:
                    cols[f].append(mrow[f])
                rel_col.append(float(rels[i]))
                rw_col.append(per_round)
                wall_col.append(t_total)
                if sinks:
                    rows.append(build_round_row(
                        start_round + executed + len(rows), mrow,
                        float(rels[i]), comm_total, per_round, t_total))
            executed += len(idx)
            stopped = done
            for s in sinks:
                s.emit(rows)
            if any(getattr(s, "stop_requested", False) for s in sinks):
                stopped = True
            if trace_capture is not None:
                trace_capture.on_chunk_end(start_round + executed)
            if checkpoint is not None:
                # the state is the runner's own buffers, which the next
                # replay overwrites: maybe_save copies them out first
                checkpoint.maybe_save(state, start_round + executed, elapsed)
    finally:
        if trace_capture is not None:
            trace_capture.close()
        if checkpoint is not None:
            checkpoint.finalize()
        alarms = [e for s in sinks for e in getattr(s, "events", [])]
        if checkpoint is not None:
            alarms.extend(checkpoint.events)
        footer = build_footer(
            executed, stopped, alarms,
            checkpoint=checkpoint.telemetry() if checkpoint is not None
            else None)
        for s in sinks:
            s.close(footer)
    trace = RoundTrace(
        **{f: np.asarray(cols[f]) for f in METRIC_FIELDS},
        rel_error=np.asarray(rel_col),
        round_wall=np.asarray(rw_col),
        wall_time=np.asarray(wall_col),
        stopped=stopped,
    )
    return state, trace
