"""Metric streaming: the MetricsSink protocol and its implementations
(counterpart of repro/obs/sinks.py; the same schema, rows and files).

The engine (core/engine.py) reads the card once per chunk; sinks are fed
from THAT read: ``emit`` receives plain-python row dicts built from data the
driver already fetched, so attaching any number of sinks adds no
device→host transfer (tests/test_torch_engine.py counts the reads). The
per-round loop (core/server.py) feeds the same rows at round granularity.
The reference's ``LiveTap`` is not ported: it re-enters the host inside a
chunk, which a CUDA graph's replay cannot do.

Row schema (versioned — bump SCHEMA_VERSION on any incompatible change;
v2 added aa_clipped_max, the robustness layer's clip-screen activity; v3
added arrivals/staleness_mean/staleness_max, the deadline gate's per-round
activity — null whenever the deadline gate is off; v4 added the
checkpoint telemetry triple to the footer — always present, zeros when
checkpointing is off):

  header row  {"v": 4, "kind": "header", "fields": [...], ...run metadata:
               algo / runtime / channel / num_clients / cohort_size / chunk /
               num_rounds / uplink_bytes (per-UplinkSpec byte breakdown from
               the comm schema) / backend}
  round row   {"v": 4, "kind": "round", "round": t, <ROW_FIELDS>}
  footer row  {"v": 4, "kind": "footer", "rounds": T, "stopped": bool,
               "alarms": [...], "checkpoint_save_ms", "checkpoint_bytes",
               "checkpoint_failures" (the CheckpointManager's telemetry;
               zeros without checkpointing)}

Round-row fields (ROW_FIELDS):

  loss, grad_norm      — global objective / gradient norm at w^t
  rel_error            — ‖w−w*‖/‖w*‖ (null without a reference solve)
  theta_mean           — mean AA optimization gain across clients
  gram_cond_max/_mean  — AA Gram conditioning aggregates across clients (the
                         diagnostic that predicts FedOSAA divergence)
  aa_used_min          — fewest Gram eigen-directions surviving filtering on
                         any client (0 = column-filtering collapse)
  aa_clipped_max       — most history columns the clip_rtol screen dropped
                         on any client (0 = screen off or inactive)
  cohort_ess           — effective sample size 1/Σw² of the round's
                         aggregation weights
  comm_bytes           — this round's wire bytes (codec-exact)
  arrivals             — deadline-gated rounds: clients whose update landed
                         this round (null: the deadline gate is off)
  staleness_mean/_max  — mean / oldest buffer age over the round's landed
                         contributions (null when the gate is off)
  comm_bytes_total     — cumulative wire bytes
  round_wall_s         — wall-clock attributed to this round (the engine
                         divides each chunk's measured time equally over its
                         executed rounds; the loop measures per round)
  wall_time_s          — cumulative wall-clock seconds

JSONL files hold strict JSON: non-finite floats are serialized as null
(``scripts/check_metrics_jsonl.py`` validates emitted files).
"""
from __future__ import annotations

import json
import math
import os
from typing import Protocol, runtime_checkable

SCHEMA_VERSION = 4

#: canonical per-round row fields, in emission order (after "round")
ROW_FIELDS = (
    "loss",
    "grad_norm",
    "rel_error",
    "theta_mean",
    "gram_cond_max",
    "gram_cond_mean",
    "aa_used_min",
    "aa_clipped_max",
    "cohort_ess",
    "comm_bytes",
    "arrivals",
    "staleness_mean",
    "staleness_max",
    "comm_bytes_total",
    "round_wall_s",
    "wall_time_s",
)


def build_round_row(round_idx: int, metrics: "dict[str, float]", rel: float,
                    comm_total: float, round_wall_s: float,
                    wall_total_s: float) -> dict:
    """One versioned round row from a round's scalar metrics.

    ``metrics`` is the RoundMetrics fields as python floats (the engine and
    the loop both have them host-side after their metric sync); driver-side
    quantities (rel-error, cumulative comm/wall) ride alongside.
    """
    return {
        "v": SCHEMA_VERSION,
        "kind": "round",
        "round": int(round_idx),
        "loss": metrics["loss"],
        "grad_norm": metrics["grad_norm"],
        "rel_error": rel,
        "theta_mean": metrics["theta_mean"],
        "gram_cond_max": metrics["gram_cond_max"],
        "gram_cond_mean": metrics["gram_cond_mean"],
        "aa_used_min": metrics["aa_used_min"],
        "aa_clipped_max": metrics["aa_clipped_max"],
        "cohort_ess": metrics["cohort_ess"],
        "comm_bytes": metrics["comm_bytes"],
        "arrivals": metrics["arrivals"],
        "staleness_mean": metrics["staleness_mean"],
        "staleness_max": metrics["staleness_max"],
        "comm_bytes_total": comm_total,
        "round_wall_s": round_wall_s,
        "wall_time_s": wall_total_s,
    }


def build_footer(rounds: int, stopped: bool, alarms: "list[dict]",
                 checkpoint: dict | None = None) -> dict:
    """The versioned run footer. ``checkpoint`` is a checkpoint manager's
    telemetry dict (``checkpoint.CheckpointManager.telemetry()``); the three
    fields are always emitted (zeros when no checkpointing ran) so v4
    consumers never branch on presence."""
    ckpt = checkpoint or {}
    return {
        "v": SCHEMA_VERSION,
        "kind": "footer",
        "rounds": int(rounds),
        "stopped": bool(stopped),
        "alarms": alarms,
        "checkpoint_save_ms": float(ckpt.get("checkpoint_save_ms", 0.0)),
        "checkpoint_bytes": int(ckpt.get("checkpoint_bytes", 0)),
        "checkpoint_failures": int(ckpt.get("checkpoint_failures", 0)),
    }


@runtime_checkable
class MetricsSink(Protocol):
    """Where streamed rows go. ``open`` is called once with the run header,
    ``emit`` with each drained batch of round rows (one chunk's executed
    rounds on the engine path, one row on the loop path), ``close`` once with
    the footer. Implementations may expose ``stop_requested`` (checked after
    every emit) to request early stop at the next chunk boundary — the
    host-side twin of the engine's in-graph stop criteria."""

    def open(self, header: dict) -> None: ...
    def emit(self, rows: "list[dict]") -> None: ...
    def close(self, footer: dict) -> None: ...


class MemorySink:
    """Collects header/rows/footer in python lists (tests, notebooks)."""

    def __init__(self):
        self.header: dict | None = None
        self.rows: list[dict] = []
        self.footer: dict | None = None

    def open(self, header: dict) -> None:
        self.header = header

    def emit(self, rows: "list[dict]") -> None:
        self.rows.extend(rows)

    def close(self, footer: dict) -> None:
        self.footer = footer


class StdoutSink:
    """Prints one compact line per round (every ``every``-th row)."""

    def __init__(self, every: int = 1):
        self.every = max(1, int(every))

    def open(self, header: dict) -> None:
        print(f"[obs] run {header.get('algo', '?')} "
              f"runtime={header.get('runtime', '?')} "
              f"channel={header.get('channel', '?')} "
              f"chunk={header.get('chunk')}")

    def emit(self, rows: "list[dict]") -> None:
        for row in rows:
            if row["round"] % self.every:
                continue
            print(f"[obs] round={row['round']:4d} loss={row['loss']:.6e} "
                  f"|g|={row['grad_norm']:.3e} relerr={row['rel_error']:.3e} "
                  f"gcond={row['gram_cond_max']:.2e} "
                  f"comm={row['comm_bytes_total']:.3e}B "
                  f"wall={row['wall_time_s']:.2f}s")

    def close(self, footer: dict) -> None:
        print(f"[obs] done rounds={footer.get('rounds')} "
              f"stopped={footer.get('stopped')}")


def _jsonable(value):
    """Strict-JSON scalar: non-finite floats become null."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


class JsonlSink:
    """Streams rows to a JSON-lines file: header, round rows, footer — one
    strict-JSON object per line (non-finite floats → null). The file handle
    stays open across emits so a crashed run still holds every drained chunk.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def _write(self, obj: dict) -> None:
        line = json.dumps(
            {k: _jsonable(v) for k, v in obj.items()}, allow_nan=False)
        self._f.write(line + "\n")

    def open(self, header: dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "w")
        self._write(header)
        self._f.flush()

    def emit(self, rows: "list[dict]") -> None:
        for row in rows:
            self._write(row)
        self._f.flush()

    def close(self, footer: dict) -> None:
        if self._f is None:
            return
        self._write(footer)
        self._f.close()
        self._f = None


def make_sink(spec: str) -> MetricsSink:
    """Parse a CLI sink spec: ``jsonl:<path>``, ``stdout[:every]``, ``memory``."""
    kind, _, arg = spec.partition(":")
    if kind == "jsonl":
        if not arg:
            raise ValueError("jsonl sink needs a path: jsonl:<path>")
        return JsonlSink(arg)
    if kind == "stdout":
        return StdoutSink(every=int(arg) if arg else 1)
    if kind == "memory":
        return MemorySink()
    raise ValueError(f"unknown sink spec {spec!r}; "
                     "choose jsonl:<path> | stdout[:every] | memory")


__all__ = [
    "ROW_FIELDS",
    "SCHEMA_VERSION",
    "JsonlSink",
    "MemorySink",
    "MetricsSink",
    "StdoutSink",
    "build_footer",
    "build_round_row",
    "make_sink",
]
