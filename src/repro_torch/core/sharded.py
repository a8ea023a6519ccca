"""Distributed FL round runtime on ``torch.distributed`` (counterpart of
repro/core/sharded.py).

``make_sharded_round_fn`` is the distributed twin of
core/algorithms.py::make_round_fn: the same round body (the six round cores,
the wire, faults and the deadline gate; one private function,
``algorithms._build_round``, serves both), with the K stacked clients split
over the ranks of a process group instead of stacked on one device. Rank r
holds the contiguous block of clients ``[r·K/W, (r+1)·K/W)``, the
reference's ``P(("pod", "data"))`` split.

How it maps:

  * every per-client row lives on its rank's device: the data (x, y,
    mask), SCAFFOLD's c_k, the carried AA columns, each comm tag's ef/ref
    rows and the robustness layer's reserved rows (fault anchors, async
    buffers and their ages);
  * the server's quantities (params, c, t) are replicated: every rank holds
    them and computes the same values;
  * the round's [K]-sized plan is global. The weights are N_k/N over all K
    clients (``shard_clients`` slices a global ``StackedClients``; it does
    not renormalise a rank's block). Every draw comes from the generator
    calls the vmap runtime makes, the full [K, ...] tensor, of which the
    rank takes its rows, so its int8 uniforms, minibatch rows and fault
    draws are the vmap runtime's rows bit for bit. The fault realization,
    the weights derived from it and the gate's partition are computed on
    the [K] vectors, identically on every rank; the buffer ages, the one
    input that is per-client state, arrive by one all-gather;
  * every cross-client reduction (the aggregates, the global gradient,
    SCAFFOLD's c, the line search's losses, the gate's buffer fold, the
    metrics) goes through ``ShardReduce``: the local reduction over the
    rank's rows, then ``all_reduce`` over the group, in a
    ``record_function("fl.psum")`` scope, as the reference's psums.

The kernels keep running: a rank holds whole clients, so the trajectory,
the Gram pass, the AA step and the int8 uplink run on its rows as they do
on one device; only the aggregates cross ranks (the reference's sharded
path gives up its Pallas kernels, ``aa_impl``/``local_impl`` "tree").

At W = 1 every collective is an identity and the round is the vmap round
bit for bit, in the params and every state tensor (its metrics within
rounding: ``nanmean`` sums in another order). On the card with an NCCL
group the engine captures the round's collectives in its CUDA graph (in
``thread_local`` capture mode: NCCL's watchdog thread queries events while
the main thread captures); a gloo group stages CUDA tensors through the
host, which a graph cannot hold, and the engine refuses it
(``round.capture_refusal``): run such a round by the loop.

Not yet on this runtime: cohorts. A sampled cohort moves client rows across
ranks (the reference's GSPMD reshard of the gathered rows), an all-to-all
of rows that is ROADMAP.md's next item; ``make_sharded_round_fn`` refuses
one.

``init_file_world`` and ``spawn_world`` start a world of processes that
rendezvous on a ``FileStore`` (no TCP port), as the tests and
chip_smoke.py do.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import time

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.comm import CommChannel
from repro_torch.core.algorithms import (ALGORITHMS, AlgoHParams,
                                         CrossClientReduce, _build_round,
                                         resolve_cohort_size)
from repro_torch.core.client_store import ClientStateStore
from repro_torch.core.problem import FLProblem, StackedClients

#: the ServerState fields that hold per-client rows (the checkpoint's leaf
#: keys start with "." and the field's name); the others are replicated
PER_CLIENT_FIELDS = tuple(f".{f}" for f in ClientStateStore._fields)


class ShardReduce(CrossClientReduce):
    """Cross-client reductions for the sharded runtime: each reduces over
    the rank's rows as the vmap runtime's does, then finishes with a
    collective over ``group`` (None: the default group); on a world of one
    the arithmetic is CrossClientReduce's."""

    def __init__(self, group=None, channel: "CommChannel | None" = None):
        super().__init__(channel)
        self.group = group

    def _all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        with record_function("fl.psum"):
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def wsum(self, weights, stacked, anchor=None):
        weights = weights.to(stacked.dtype)
        if anchor is None:
            return self._all_reduce(torch.tensordot(weights, stacked, dims=1))
        return anchor + self._all_reduce(
            torch.tensordot(weights, stacked - anchor, dims=1))

    def nanmean(self, x):
        finite = ~torch.isnan(x)
        sums = self._all_reduce(torch.stack(
            [torch.where(finite, x, 0.0).sum(), finite.to(x.dtype).sum()]))
        return torch.where(sums[1] > 0,
                           sums[0] / torch.clamp(sums[1], min=1), torch.nan)

    def nanmax(self, x):
        m = self._all_reduce(torch.where(torch.isnan(x), -torch.inf, x).max(),
                             dist.ReduceOp.MAX)
        return torch.where(torch.isneginf(m), torch.nan, m)

    def nanmin(self, x):
        m = self._all_reduce(torch.where(torch.isnan(x), torch.inf, x).min(),
                             dist.ReduceOp.MIN)
        return torch.where(torch.isposinf(m), torch.nan, m)

    def ess(self, weights):
        w2 = self._all_reduce((weights * weights).sum())
        return 1.0 / torch.clamp(w2, min=1e-30)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """All K rows of a per-client tensor, the ranks' blocks in order."""
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(self.group))]
        with record_function("fl.psum"):
            dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class ClientShard:
    """This rank's block of the K clients: rank r of W holds the global
    ids ``[r·K/W, (r+1)·K/W)``, rows ``rows`` of every [K, ...] tensor."""

    rank: int
    world: int
    group: object          # the process group (None: the default group)
    num_clients: int       # K, all ranks' clients

    @property
    def rows(self) -> slice:
        per = self.num_clients // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    @property
    def ids(self) -> range:
        """The global ids of this rank's clients."""
        return range(self.rows.start, self.rows.stop)

    def per_client(self, key: str) -> bool:
        """Whether checkpoint leaf ``key`` holds per-client rows."""
        return key.split("/")[0] in PER_CLIENT_FIELDS

    def leaf_boxes(self, key: str, shape: tuple) -> "tuple[tuple, list]":
        """(global shape, this rank's boxes) of checkpoint leaf ``key``,
        whose local shape is ``shape``: a per-client leaf is [K, ...] and
        the rank writes its rows ``((k0, k1), (0, n), ...)``; a replicated
        leaf is written by rank 0 alone, whole (the port's counterpart of
        the reference's leaf_addressable_shards and dedupe_shard_boxes)."""
        if self.per_client(key):
            full = (self.num_clients, *shape[1:])
            r = self.rows
            return full, [((r.start, r.stop), *((0, n) for n in shape[1:]))]
        return shape, ([tuple((0, n) for n in shape)] if self.rank == 0
                       else [])


def gloo_twin(group=None):
    """A gloo group over ``group``'s ranks (None: the whole world): the
    host-side collectives (the stop broadcast, the checkpoint commit) run
    there, apart from the round's. Like ``dist.new_group``, every rank of
    the world must call it in the same order."""
    ranks = None if group is None else dist.get_process_group_ranks(group)
    return dist.new_group(ranks=ranks, backend="gloo")


def _group_ready(group) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "the sharded runtime needs an initialised process group: call "
            "torch.distributed.init_process_group (or init_file_world) "
            "first; it does not start one itself")


def num_client_shards(group=None) -> int:
    """The number of client blocks: the group's world size."""
    _group_ready(group)
    return dist.get_world_size(group)


def client_shard(num_clients: int, group=None) -> ClientShard:
    """This rank's ClientShard of ``num_clients`` clients over ``group``;
    refuses an uninitialised group and a K that does not divide."""
    W = num_client_shards(group)
    if num_clients % W != 0:
        raise ValueError(
            f"num_clients={num_clients} does not divide over {W} client "
            "shards; pad the client stack to a multiple")
    return ClientShard(dist.get_rank(group), W, group, num_clients)


def shard_clients(clients: StackedClients, group=None,
                  device: "str | torch.device | None" = None) -> StackedClients:
    """This rank's rows of a global ``StackedClients``, on ``device`` (the
    clients' own by default), with their GLOBAL weights N_k/N: a rank's
    block is not renormalised."""
    sl = client_shard(clients.num_clients, group).rows
    dev = clients.device if device is None else resolve_device(device)
    return StackedClients(*(getattr(clients, f)[sl].to(dev)
                            for f in ("x", "y", "mask", "weight")))


def make_sharded_round_fn(algo: str, problem: FLProblem, hp: AlgoHParams,
                          group=None,
                          channel: "CommChannel | str | None" = None,
                          seed: int = 0,
                          device: "str | torch.device" = DEFAULT_DEVICE,
                          faults=None, async_cfg=None):
    """Return round(state, draws=None) -> (state, RoundMetrics) for ``algo``
    on the global ``problem``, this rank computing on its block of the
    clients of ``group`` (None: the default group), on ``device``.

    The contract is make_round_fn's (``draw_specs``, ``fill_draws``,
    ``host_metrics``, the same draws and refusals), with each draw of the
    rank's [K/W, ...] shape, except the fault plan's per-client scalars
    ("fault.drop", "fault.stale", "fault.latency"), which stay [K]: the
    weights they set are global. The state is the rank's: the replicated
    params (and c), its rows of every per-client tensor; build it with
    ``init_state(round.rank_problem, ...)``. ``round.shard`` is the rank's
    ClientShard; ``round.capture_refusal`` says why the engine cannot
    capture the round (a gloo group on the card), or is None.

    Refuses (ValueError) an unknown algorithm, a process group that is not
    initialised, a K that does not divide over the ranks, and a cohort."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; choose from {ALGORITHMS}")
    K = problem.clients.num_clients
    shard = client_shard(K, group)
    if resolve_cohort_size(hp, K) is not None:
        raise ValueError(
            "the sharded runtime does not run cohorts yet: a sampled cohort "
            "moves client rows across ranks (an all-to-all), the next item "
            "of ROADMAP.md; run cohorts on the vmap runtime")
    dev = resolve_device(device)
    local = dataclasses.replace(problem,
                                clients=shard_clients(problem.clients, group,
                                                      dev))
    round_fn = _build_round(
        algo, local, hp, channel, seed, dev, faults, async_cfg,
        make_reduce=lambda ch: ShardReduce(group, ch), shard=shard,
        weight=problem.clients.weight.to(dev))
    # "nccl", "gloo", or a per-device list such as "cpu:gloo,cuda:nccl"
    backend = str(dist.get_backend(group))
    nccl = "nccl" in backend
    round_fn.shard = shard
    round_fn.rank_problem = local
    round_fn.capture_refusal = None
    if dev.type == "cuda" and not nccl:
        round_fn.capture_refusal = (
            f"the round's collectives run on a {backend!r} group, which "
            "stages CUDA tensors through the host: a CUDA graph cannot "
            "capture them. Use an NCCL group, or the per-round loop "
            "(chunk=None)")
    # NCCL's watchdog thread queries the events of earlier collectives;
    # only a thread-local capture lets it while the round is captured
    round_fn.capture_error_mode = "thread_local" if nccl else "global"
    return round_fn


class RankZeroStop:
    """The telemetry sink run_federated puts first on every rank of a
    sharded run: ``stop_requested`` is rank 0's sinks' stop request (the
    sinks run on rank 0 only), broadcast over a gloo group, so every rank
    stops after the same round. The loop and the engine read it once a
    round or a chunk on every rank alike, since the stop tests before it
    read replicated values."""

    def __init__(self, sinks, group=None):
        self.sinks = list(sinks)
        self.group = gloo_twin(group)

    def open(self, header: dict) -> None:
        pass

    def emit(self, rows: list) -> None:
        pass

    def close(self, footer: dict) -> None:
        pass

    @property
    def stop_requested(self) -> bool:
        flag = torch.tensor([any(getattr(s, "stop_requested", False)
                                 for s in self.sinks)], dtype=torch.uint8)
        dist.broadcast(flag, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        return bool(flag.item())


# ---------------------------------------------------------------------------
# worlds of processes on one host
# ---------------------------------------------------------------------------

#: the environment spawn_world gives each process: its rank, the world size
#: and the FileStore path the world meets on
RANK_ENV, WORLD_ENV, STORE_ENV = "RANK", "WORLD_SIZE", "REPRO_TORCH_STORE"


def init_file_world(store_path: str | None = None, rank: int | None = None,
                    world: int | None = None, backend: str = "gloo",
                    timeout_s: float = 60.0):
    """Join a world of ``world`` processes that meet on a ``FileStore`` at
    ``store_path`` (a file path no earlier world used), as rank ``rank``;
    each defaults to the environment spawn_world sets. A collective that
    waits longer than ``timeout_s`` raises. Returns the default group."""
    store_path = store_path or os.environ[STORE_ENV]
    rank = int(os.environ[RANK_ENV]) if rank is None else rank
    world = int(os.environ[WORLD_ENV]) if world is None else world
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def spawn_world(argv: "list[str]", world: int, store_path: str,
                timeout_s: float = 120.0, env: "dict | None" = None,
                cwd: str | None = None) -> "list[subprocess.CompletedProcess]":
    """Run ``world`` copies of the command ``argv`` at once, copy r with
    RANK=r, WORLD_SIZE=world and REPRO_TORCH_STORE=``store_path`` in its
    environment (``init_file_world()`` reads them), and wait for all of
    them. A copy still running after ``timeout_s`` is killed with the rest
    (its return code is then negative). Returns each copy's result, its
    output and errors as text, by rank."""
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    for r in range(world):
        out = open(f"{store_path}.rank{r}.log", "w+")
        procs.append(subprocess.Popen(
            argv, cwd=cwd, stdout=out, stderr=subprocess.STDOUT, text=True,
            env={**base, RANK_ENV: str(r), WORLD_ENV: str(world),
                 STORE_ENV: store_path}))
        logs.append(out)
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for p, out in zip(procs, logs):
        out.seek(0)
        results.append(subprocess.CompletedProcess(
            argv, p.returncode, out.read(), ""))
        out.close()
    return results


__all__ = [
    "ClientShard",
    "PER_CLIENT_FIELDS",
    "RankZeroStop",
    "ShardReduce",
    "client_shard",
    "gloo_twin",
    "init_file_world",
    "make_sharded_round_fn",
    "num_client_shards",
    "shard_clients",
    "spawn_world",
]
