"""Filesystem fault injection for the checkpoint save path (the robustness
layer's storage half; a copy of repro/robust/fs_faults.py).

The same discipline as faults.py, applied to I/O instead of the wire: a
declarative :class:`FSFaultPlan` names which storage failures to inject, and
the realization is DETERMINISTIC — every injected event is keyed by
``(seed, step)`` where ``step`` is the plan's monotonically increasing write
counter, so a given plan replays bit-identically across runs. No wall-clock,
no global randomness.

Fault kinds
-----------
* **torn writes** (``torn_write_rate``) — the write persists only a prefix
  of its bytes (the draw also picks the cut point), then reports an I/O
  error: what a power cut mid-``write(2)`` leaves behind. The atomic-commit
  protocol must make such a file unobservable under its final name.
* **ENOSPC** (``enospc_writes``) — the named write steps fail with
  ``OSError(ENOSPC)`` on every attempt (retries included): a full disk is
  not transient. The save must degrade gracefully — failure counted,
  alarmed, next save clean.
* **transient errors** (``flaky_writes``) — the named write steps fail ONCE
  with ``EIO`` and succeed on retry: what the exponential-backoff retry in
  checkpoint/atomic.py exists for.
* **kill** (``kill_at_save``) — the N-th checkpoint save dies between
  save-start and manifest commit: after ``kill_after_writes`` staged writes
  the process "dies" — :class:`SimulatedKill` is raised (in-process tests;
  the save manager treats it as death: nothing further is written, the temp
  directory stays torn), or with ``kill_hard=True`` the PROCESS exits
  immediately via ``os._exit`` (the subprocess kill-resume smoke). Either
  way the commit rename never happens, so discovery must fall back to the
  newest complete checkpoint.

``FaultyFs`` wraps any :class:`repro_torch.checkpoint.atomic.LocalFs`;
everything it does not perturb delegates to the wrapped instance.
"""
from __future__ import annotations

import dataclasses
import errno
import hashlib
import os

from repro_torch.checkpoint.atomic import LocalFs

#: exit code the hard-kill path dies with — distinguishable from a python
#: traceback (1) and from SIGKILL (137) in the kill-resume smoke
KILL_EXIT_CODE = 43


class SimulatedKill(BaseException):
    """Process death injected between save-start and commit. Derives from
    BaseException so no ``except Exception`` recovery path can swallow it —
    exactly like a real SIGKILL, the save it interrupts simply never
    finishes."""


@dataclasses.dataclass(frozen=True)
class FSFaultPlan:
    """Declarative, replayable storage-failure schedule.

    ``torn_write_rate`` draws per write step; ``enospc_writes`` /
    ``flaky_writes`` name explicit write-step indices (0-based, counted over
    every ``write_bytes`` the wrapped fs sees); ``kill_at_save`` counts
    checkpoint SAVES (1-based, advanced by the save manager via
    ``on_save_start``) and ``kill_after_writes`` positions the death inside
    that save's write sequence.
    """

    seed: int = 0
    torn_write_rate: float = 0.0
    enospc_writes: "tuple[int, ...]" = ()
    flaky_writes: "tuple[int, ...]" = ()
    kill_at_save: int = 0       # 0 = never
    kill_after_writes: int = 1  # die after this many writes of that save
    kill_hard: bool = False     # os._exit instead of SimulatedKill

    def __post_init__(self):
        if not 0.0 <= self.torn_write_rate <= 1.0:
            raise ValueError("torn_write_rate must be in [0, 1], got "
                             f"{self.torn_write_rate}")
        if self.kill_at_save < 0 or self.kill_after_writes < 0:
            raise ValueError("kill_at_save / kill_after_writes must be >= 0")


def _draw(seed: int, step: int, salt: str) -> float:
    """Uniform [0,1) keyed by (seed, step, salt) — hash-based, so the stream
    is identical across processes and runs (no RNG object state)."""
    h = hashlib.sha256(f"{seed}:{step}:{salt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


class FaultyFs(LocalFs):
    """A ``LocalFs`` view with the plan's storage faults applied.

    Write steps are counted over the whole lifetime of the instance; the
    save manager calls :meth:`on_save_start` so save-scoped faults (the
    kill) know which save is in flight.
    """

    def __init__(self, plan: FSFaultPlan, inner: LocalFs | None = None):
        self.plan = plan
        self.inner = inner or LocalFs()
        self.write_step = 0
        self.save_index = 0           # 1-based once a save starts
        self._save_writes = 0
        self._flaked: set[int] = set()

    # -- save lifecycle (called by the checkpoint manager) ----------------
    def on_save_start(self) -> None:
        self.save_index += 1
        self._save_writes = 0

    def _maybe_kill(self) -> None:
        p = self.plan
        if p.kill_at_save and self.save_index == p.kill_at_save \
                and self._save_writes >= p.kill_after_writes:
            if p.kill_hard:
                os._exit(KILL_EXIT_CODE)
            raise SimulatedKill(
                f"injected kill at save {self.save_index} after "
                f"{self._save_writes} writes")

    # -- faulted primitives ----------------------------------------------
    def write_bytes(self, path: str, data: bytes) -> None:
        step = self.write_step
        self.write_step += 1
        self._save_writes += 1
        p = self.plan
        if step in p.enospc_writes:
            raise OSError(errno.ENOSPC, "injected ENOSPC", path)
        if step in p.flaky_writes and step not in self._flaked:
            self._flaked.add(step)
            raise OSError(errno.EIO, "injected transient EIO", path)
        if p.torn_write_rate > 0.0 \
                and _draw(p.seed, step, "torn") < p.torn_write_rate:
            cut = int(_draw(p.seed, step, "cut") * len(data))
            self.inner.write_bytes(path, data[:cut])
            raise OSError(errno.EIO, "injected torn write", path)
        self.inner.write_bytes(path, data)
        self._maybe_kill()

    def replace(self, src: str, dst: str) -> None:
        self._maybe_kill()  # death between last shard write and the rename
        self.inner.replace(src, dst)

    # -- clean delegations ------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        return self.inner.read_bytes(path)

    def makedirs(self, path: str) -> None:
        self.inner.makedirs(path)

    def listdir(self, path: str) -> "list[str]":
        return self.inner.listdir(path)

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def rmtree(self, path: str) -> None:
        self.inner.rmtree(path)

    def fsync_dir(self, path: str) -> None:
        self.inner.fsync_dir(path)


__all__ = ["KILL_EXIT_CODE", "FSFaultPlan", "FaultyFs", "SimulatedKill"]
