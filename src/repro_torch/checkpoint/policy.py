"""Async checkpoint policy (counterpart of repro/checkpoint/policy.py):
chunk-boundary snapshots, background commits, one-in-flight backpressure,
graceful failure.

``CheckpointPolicy`` is the declarative knob set (directory / every / keep /
mode); ``CheckpointManager`` is the engine-side driver:

  * ``maybe_save(state, round_idx, chunk_wall)`` runs after the engine's
    one host read of a chunk (or after a round of the per-round loop).
    When a save is due it snapshots the state (sharded_ckpt.snapshot_shards):
    on the card, ``non_blocking`` copies into pinned host buffers on the
    current stream and a CUDA event after them — no host wait, and the next
    chunk's graph replay, which overwrites the runner's buffers the state
    lives in, is ordered after the copies by the stream itself. It then
    dispatches serialization + checksums + atomic commit + GC to ONE
    background thread, which waits on the event before it reads the host
    buffers, so the write overlaps the next chunk. Two sets of pinned
    buffers are used in turn (at most one save is in flight), so no save
    pays for a pinned allocation after the first two.
  * **backpressure, wait-and-warn**: at most one save is in flight. If the
    next save comes due while the previous one is still writing, the
    manager snapshots into the free buffer set, then WAITS for the writer
    (state consistency beats save frequency) and records a
    ``checkpoint_stalled`` event — the save exceeded the chunk wall time,
    i.e. the chunk compute no longer hides the write. The event rides the
    run footer's alarm list like any obs/alarms event.
  * **graceful failure**: a save that exhausts its I/O retries (ENOSPC, a
    dying disk) is counted and alarmed (``checkpoint_failed``), its staging
    remnant is swept, and the run continues — the next due save starts
    clean. A :class:`repro_torch.robust.fs_faults.SimulatedKill` is NOT
    handled: the manager marks itself dead and stops writing, modeling the
    process death it simulates.
  * ``mode="sync_gather"`` is the deliberately-bad baseline the benchmark
    compares against: a blocking ``.cpu()`` of the whole state and an
    inline legacy npz save — the stall the async path exists to remove.

Under the sharded runtime (``shard=``, a core/sharded.py ClientShard) every
rank runs a manager: each snapshots its own boxes and the commit is
collective (sharded_ckpt.write_checkpoint's ``group``), on a gloo group of
the manager's own, so the writer thread's collectives never interleave with
the round's on the main group. The ranks' cadences agree (the same rounds),
so they call the commit in the same order; rank 0 alone prunes.

Telemetry: ``telemetry()`` returns the SCHEMA_VERSION-4 footer fields
(checkpoint_save_ms / checkpoint_bytes / checkpoint_failures); ``events``
holds the structured alarm records; ``saves_completed`` counts commits.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any

from repro_torch.checkpoint.atomic import LOCAL_FS, LocalFs
from repro_torch.checkpoint.sharded_ckpt import (_host_array, _rebuild,
                                                 prune_checkpoints,
                                                 snapshot_shards,
                                                 write_checkpoint)

Pytree = Any

logger = logging.getLogger("repro_torch.checkpoint")

MODES = ("async", "sync", "sync_gather")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """When and where to checkpoint.

    every — save at the first chunk boundary at/after each multiple of
    ``every`` rounds (the engine only has host control at chunk boundaries;
    with ``every`` a multiple of the chunk size the boundary is exact).
    keep — retention: committed checkpoints beyond the newest ``keep`` are
    GC'd after each successful commit (0 = keep everything).
    """

    directory: str
    every: int = 10
    keep: int = 3
    mode: str = "async"
    retries: int = 3
    backoff_s: float = 0.05

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.keep < 0:
            raise ValueError(f"keep must be >= 0, got {self.keep}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode}")


class CheckpointManager:
    """Drives a CheckpointPolicy from the engine's chunk loop. Not
    thread-safe beyond its own single worker: one manager per run."""

    def __init__(self, policy: CheckpointPolicy, *,
                 config: dict | None = None, fs: LocalFs = LOCAL_FS,
                 last_saved: int = 0, shard=None):
        self.policy = policy
        self.shard = shard
        self._group = None
        if shard is not None:
            if policy.mode == "sync_gather":
                raise ValueError(
                    "mode 'sync_gather' writes one process's whole state; "
                    "the sharded runtime saves each rank's rows: use "
                    "'async' or 'sync'")
            from repro_torch.core.sharded import gloo_twin

            # every rank builds its manager, so every rank makes the group
            self._group = gloo_twin(shard.group)
        self.config = config or {}
        self.fs = fs
        self.events: "list[dict]" = []
        self.dead = False          # a (simulated) kill landed mid-save
        self._worker: threading.Thread | None = None
        # round of the last DISPATCHED save; a resumed run seeds this with
        # its resume round so the cadence stays aligned across preemptions
        self._last_saved = last_saved
        self._save_ms_total = 0.0
        self._bytes_total = 0
        self._failures = 0
        self._saves = 0
        self._lock = threading.Lock()
        # the two pinned buffer sets, {leaf key: host tensor}, used in turn
        self._pinned = ({}, {})
        self._turn = 0

    # -- engine hooks -----------------------------------------------------
    def maybe_save(self, state: Pytree, round_idx: int,
                   chunk_wall: float | None = None) -> bool:
        """Call at every chunk boundary with the state AFTER ``round_idx``
        global rounds. Returns True when a save was dispatched."""
        if self.dead:
            return False
        if round_idx - self._last_saved < self.policy.every:
            return False
        snapshot = snap_ms = None
        if self.policy.mode != "sync_gather":
            # the copies go into the set the in-flight writer (if any) does
            # not read, so they may be enqueued before the wait below
            t0 = time.perf_counter()
            snapshot = snapshot_shards(state, self._pinned[self._turn],
                                       self.shard)
            self._turn ^= 1
            snap_ms = 1e3 * (time.perf_counter() - t0)
        self._wait_for_inflight(round_idx, chunk_wall)
        if self.dead:
            return False
        self._last_saved = round_idx
        # the save's clock: its snapshot, then everything after the wait
        t0 = time.perf_counter() - 1e-3 * (snap_ms or 0.0)
        if getattr(self.fs, "on_save_start", None) is not None:
            self.fs.on_save_start()   # crash-injection save counter
        if self.policy.mode == "sync_gather":
            self._sync_gather_save(state, round_idx, t0)
            return True
        if self.policy.mode == "sync":
            self._write(snapshot, round_idx, t0, snap_ms)
            return True
        self._worker = threading.Thread(
            target=self._write, args=(snapshot, round_idx, t0, snap_ms),
            name=f"ckpt-save-{round_idx}", daemon=True)
        self._worker.start()
        return True

    def finalize(self) -> None:
        """Join any in-flight save (end of run / driver finally-block)."""
        w = self._worker
        if w is not None and w.is_alive():
            w.join()
        self._worker = None

    def telemetry(self) -> dict:
        """The v4 footer fields."""
        with self._lock:
            return {
                "checkpoint_save_ms": round(self._save_ms_total, 3),
                "checkpoint_bytes": int(self._bytes_total),
                "checkpoint_failures": int(self._failures),
            }

    @property
    def saves_completed(self) -> int:
        with self._lock:
            return self._saves

    # -- internals --------------------------------------------------------
    def _wait_for_inflight(self, round_idx: int, chunk_wall: float | None):
        w = self._worker
        if w is None or not w.is_alive():
            return
        t0 = time.perf_counter()
        w.join()
        waited_ms = 1e3 * (time.perf_counter() - t0)
        event = {
            "rule": "checkpoint_stalled",
            "field": "checkpoint_save_ms",
            "op": "gt",
            "threshold": None if chunk_wall is None
            else round(1e3 * chunk_wall, 3),
            "round": int(round_idx),
            "value": round(waited_ms, 3),
            "action": "warn",
        }
        self.events.append(event)
        logger.warning(
            "alarm checkpoint_stalled: save still in flight at round %d — "
            "backpressure engaged, waited %.1fms (chunk wall %.1fms)",
            round_idx, waited_ms,
            1e3 * chunk_wall if chunk_wall is not None else float("nan"))

    def _write(self, snapshot, round_idx: int, t0: float, snap_ms: float):
        from repro_torch.robust.fs_faults import SimulatedKill

        try:
            path, nbytes = write_checkpoint(
                self.policy.directory, snapshot, round_idx,
                config=self.config, fs=self.fs,
                process_index=0 if self.shard is None else self.shard.rank,
                group=self._group, retries=self.policy.retries,
                backoff_s=self.policy.backoff_s)
            if self.shard is None or self.shard.rank == 0:
                prune_checkpoints(self.policy.directory, self.policy.keep,
                                  fs=self.fs)
        except SimulatedKill:
            # the process "died" between save-start and commit: stop doing
            # anything at all (the torn .tmp-* stays on disk for recovery
            # tests to trip over, exactly like a real preemption)
            self.dead = True
            return
        except Exception as e:
            with self._lock:
                self._failures += 1
                self._save_ms_total += 1e3 * (time.perf_counter() - t0)
            event = {
                "rule": "checkpoint_failed",
                "field": "checkpoint_failures",
                "op": "gt",
                "threshold": 0.0,
                "round": int(round_idx),
                "value": float(self._failures),
                "action": "warn",
            }
            self.events.append(event)
            logger.warning("alarm checkpoint_failed: save at round %d "
                           "failed after retries: %s", round_idx, e)
            return
        with self._lock:
            self._saves += 1
            self._bytes_total += nbytes
            self._save_ms_total += 1e3 * (time.perf_counter() - t0)
        logger.info("checkpoint committed: %s (%.1f KiB, %.1fms incl. "
                    "%.1fms snapshot)", path, nbytes / 1024,
                    1e3 * (time.perf_counter() - t0), snap_ms)

    def _sync_gather_save(self, state, round_idx: int, t0: float):
        """The legacy stall, kept as the benchmark baseline: a blocking
        ``.cpu()`` of the whole state + blocking npz save."""
        from repro_torch.checkpoint.checkpoint import save_checkpoint

        host_state = _rebuild(state, lambda _, leaf: _host_array(leaf))
        path = os.path.join(self.policy.directory, "sync_gather",
                            f"state_{round_idx:08d}")
        save_checkpoint(path, host_state, step=round_idx, fs=self.fs)
        nbytes = 0
        npz = path + ".npz"
        if self.fs.exists(npz):
            try:
                nbytes = len(self.fs.read_bytes(npz))
            except OSError:
                pass
        with self._lock:
            self._saves += 1
            self._bytes_total += nbytes
            self._save_ms_total += 1e3 * (time.perf_counter() - t0)


__all__ = ["MODES", "CheckpointManager", "CheckpointPolicy"]
