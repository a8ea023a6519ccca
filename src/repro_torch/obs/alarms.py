"""Health monitors: declarative alarm rules over streamed metric rows
(counterpart of repro/obs/alarms.py; the same rules and event dicts).

``AlarmMonitor`` IS a ``MetricsSink`` — attach it alongside the file/stdout
sinks and it evaluates every drained round row against its rules. A firing
rule logs a structured warning (one ``logging`` record with the rule name,
round, field, and observed value); a rule with ``action="stop"`` additionally
sets ``stop_requested``, which the drivers check at the next chunk/round
boundary and fold into the existing early-stop path — health alarms never
reach into the captured chunk.

Rule operators:

  gt / lt      — field compared against ``threshold`` (non-finite values
                 never satisfy gt/lt; use ``nonfinite`` for those)
  nonfinite    — field is nan/inf (divergence tripwire)
  no_improve   — field's best value has not improved by ``min_improve``
                 (relative) within the last ``window`` rounds (plateau
                 detector; needs ``window``+1 rows before it can fire)

``DEFAULT_RULES`` are the reference's: non-finite loss (stop — the run is
already garbage), AA Gram conditioning past 1e12 (the divergence
predictor), AA column filtering collapsing to zero used directions (the
extrapolation silently became plain FedAvg), a rel-error plateau,
aa_clipping_active (the clip_rtol screen dropped history columns this
round; the per-rule cooldown turns a persistently active screen into a
periodic warning) and staleness_runaway (the deadline gate's oldest landed
contribution past 10 rounds; the field is null/NaN while the gate is off,
which never fires a threshold op).
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

logger = logging.getLogger("repro_torch.obs.alarms")

_OPS = ("gt", "lt", "nonfinite", "no_improve")
_ACTIONS = ("warn", "stop")


@dataclass(frozen=True)
class AlarmRule:
    """One declarative health check over a round-row field."""

    name: str
    field: str
    op: str
    threshold: float | None = None
    window: int = 20
    min_improve: float = 1e-3
    action: str = "warn"

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: op must be one of {_OPS}")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"rule {self.name!r}: action must be one of {_ACTIONS}")
        if self.op in ("gt", "lt") and self.threshold is None:
            raise ValueError(f"rule {self.name!r}: {self.op} needs threshold")


DEFAULT_RULES = (
    AlarmRule("loss_nonfinite", "loss", "nonfinite", action="stop"),
    AlarmRule("gram_cond_blowup", "gram_cond_max", "gt", threshold=1e12),
    AlarmRule("aa_columns_collapsed", "aa_used_min", "lt", threshold=1.0),
    AlarmRule("rel_error_plateau", "rel_error", "no_improve",
              window=50, min_improve=1e-3),
    AlarmRule("aa_clipping_active", "aa_clipped_max", "gt", threshold=0.0),
    AlarmRule("staleness_runaway", "staleness_max", "gt", threshold=10.0),
)


def _is_finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


class AlarmMonitor:
    """MetricsSink that evaluates rules on every round row.

    ``events`` accumulates structured fire records; ``stop_requested`` turns
    True when a ``stop`` rule fires. Each rule fires at most once per
    ``cooldown`` rounds so a persistently-bad metric doesn't flood the log.
    """

    def __init__(self, rules=DEFAULT_RULES, cooldown: int = 25):
        self.rules = tuple(rules)
        self.cooldown = int(cooldown)
        self.events: list[dict] = []
        self.stop_requested = False
        self._last_fired: dict[str, int] = {}
        # per-rule rolling state for no_improve: (best_value, round_of_best)
        self._best: dict[str, tuple[float, int]] = {}

    # -- MetricsSink protocol -------------------------------------------
    def open(self, header: dict) -> None:
        pass

    def close(self, footer: dict) -> None:
        pass

    def emit(self, rows) -> None:
        for row in rows:
            if row.get("kind") != "round":
                continue
            for rule in self.rules:
                self._check(rule, row)

    # -- rule evaluation ------------------------------------------------
    def _check(self, rule: AlarmRule, row: dict) -> None:
        value = row.get(rule.field)
        t = row["round"]
        fired = False
        if rule.op == "nonfinite":
            fired = value is None or (
                isinstance(value, float) and not math.isfinite(value))
        elif rule.op == "gt":
            fired = _is_finite(value) and value > rule.threshold
        elif rule.op == "lt":
            fired = _is_finite(value) and value < rule.threshold
        elif rule.op == "no_improve":
            fired = self._check_plateau(rule, value, t)
        if not fired:
            return
        last = self._last_fired.get(rule.name)
        if last is not None and t - last < self.cooldown:
            return
        self._last_fired[rule.name] = t
        self._fire(rule, row, value)

    def _check_plateau(self, rule: AlarmRule, value, t: int) -> bool:
        if not _is_finite(value):
            return False
        best = self._best.get(rule.name)
        if best is None:
            self._best[rule.name] = (value, t)
            return False
        best_v, best_t = best
        if value < best_v * (1.0 - rule.min_improve):
            self._best[rule.name] = (value, t)
            return False
        return t - best_t >= rule.window

    def _fire(self, rule: AlarmRule, row: dict, value) -> None:
        event = {
            "rule": rule.name,
            "field": rule.field,
            "op": rule.op,
            "threshold": rule.threshold,
            "round": row["round"],
            "value": value,
            "action": rule.action,
        }
        self.events.append(event)
        logger.warning(
            "alarm %s: %s %s (threshold=%s) at round %d value=%s action=%s",
            rule.name, rule.field, rule.op, rule.threshold,
            row["round"], value, rule.action,
        )
        if rule.action == "stop":
            self.stop_requested = True


__all__ = ["DEFAULT_RULES", "AlarmMonitor", "AlarmRule"]
