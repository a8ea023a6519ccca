"""On-demand profiler trace windows around engine chunks (counterpart of
repro/obs/profiling.py; the same chunk-boundary state machine).

``TraceCapture`` wraps the drivers' chunk (or round) boundaries in
``torch.profiler.profile`` windows. Because the engine runs whole chunks
at once, the window is aligned OUTWARD to chunk boundaries: asking for
rounds [T, T+N) starts the profiler before the first chunk that overlaps
the window and stops it after the first chunk boundary at or past T+N.
Time inside the trace is attributed to round phases by the
``record_function`` scopes in core/algorithms.py and core/anderson.py
("fl.local_trajectory", "fl.aa_step", "fl.uplink", and in a cohort round
"fl.cohort_plan", "fl.cohort_gather", "fl.scatter").

Those scopes are host-side: they mark the eager round (the CPU path and
the per-round loop). A chunk replayed from a CUDA graph shows its kernels
under one ``cudaGraphLaunch``, without ``fl.*`` scopes.

Two arming modes:

  * static window — ``TraceConfig(start_round=T, num_rounds=N)``;
  * trigger file — touch ``TraceConfig.trigger_file`` while a long run is in
    flight and the next chunk gets traced (the file is consumed/unlinked so
    each touch yields one window).

Each window is exported as a Chrome trace,
``<trace_dir>/window<i>_round<T>.pt.trace.json``; ``trace_contains`` greps
those files for a scope name.
"""
from __future__ import annotations

import glob
import logging
import os
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger("repro_torch.obs.profiling")

#: what every exported window's file name ends with
TRACE_SUFFIX = ".pt.trace.json"


@dataclass(frozen=True)
class TraceConfig:
    """Trace-window request. ``num_rounds=0`` with no trigger file disables
    capture entirely (the drivers skip constructing a TraceCapture)."""

    trace_dir: str
    start_round: int = 0
    num_rounds: int = 0
    trigger_file: str | None = None

    @property
    def enabled(self) -> bool:
        return self.num_rounds > 0 or self.trigger_file is not None


class TraceCapture:
    """Chunk-boundary state machine driving torch.profiler windows.

    Drivers call ``on_chunk_start(first_round, n_live)`` before launching a
    chunk and ``on_chunk_end(next_round)`` after its host read; the
    per-round loop uses the same hooks with ``n_live=1``. ``close()`` is a
    safety stop for early exits so a run never leaks an open profiler.
    """

    def __init__(self, config: TraceConfig):
        self.config = config
        self.active = False
        self.windows: list[tuple[int, int]] = []
        self._started_at: int | None = None
        self._prof: profile | None = None
        # remaining static window; trigger file arms one extra chunk window
        self._pending_start = config.start_round
        self._pending_rounds = config.num_rounds

    def _trigger_pulled(self) -> bool:
        path = self.config.trigger_file
        if not path or not os.path.exists(path):
            return False
        try:
            os.unlink(path)
        except OSError:
            pass
        return True

    def on_chunk_start(self, first_round: int, n_live: int) -> None:
        if self.active:
            return
        window_hit = (
            self._pending_rounds > 0
            and first_round + n_live > self._pending_start
            and first_round < self._pending_start + self._pending_rounds
        )
        if window_hit:
            stop_after = self._pending_start + self._pending_rounds
        elif self._trigger_pulled():
            stop_after = first_round + n_live
        else:
            return
        os.makedirs(self.config.trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self.active = True
        self._started_at = first_round
        self._stop_after = stop_after
        logger.info("trace started at round %d (stop after round %d) -> %s",
                    first_round, stop_after - 1, self.config.trace_dir)

    def _stop(self, next_round: int) -> None:
        self._prof.stop()
        path = os.path.join(
            self.config.trace_dir,
            f"window{len(self.windows)}_round{self._started_at}{TRACE_SUFFIX}")
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.active = False
        self.windows.append((self._started_at, next_round))

    def on_chunk_end(self, next_round: int) -> None:
        if not self.active or next_round < self._stop_after:
            return
        self._stop(next_round)
        if self._pending_rounds > 0 and next_round >= (
                self._pending_start + self._pending_rounds):
            self._pending_rounds = 0  # static window fully covered
        logger.info("trace stopped before round %d", next_round)

    def close(self) -> None:
        if self.active:
            self._stop(-1)


def find_trace_files(trace_dir: str, suffix: str = TRACE_SUFFIX) -> list:
    """Exported trace windows under ``trace_dir``."""
    return sorted(glob.glob(os.path.join(trace_dir, f"*{suffix}")))


def trace_contains(trace_dir: str, name: str) -> bool:
    """True if any exported window mentions ``name`` (e.g. a
    ``record_function`` scope): a string-level grep of the Chrome trace,
    where every event's name is stored verbatim."""
    needle = name.encode()
    for path in find_trace_files(trace_dir):
        with open(path, "rb") as f:
            if needle in f.read():
                return True
    return False


__all__ = ["TraceCapture", "TraceConfig", "find_trace_files", "trace_contains"]
