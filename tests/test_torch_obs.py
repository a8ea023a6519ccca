"""The port's telemetry (repro_torch/obs) against the reference's
(repro/obs), on the CPU.

Sinks: the same row dicts give byte-identical JSONL files and equal
in-memory frames, non-finite values included, and a port run's JSONL
passes the reference's validator (scripts/check_metrics_jsonl.py).
Alarms: the same row streams give equal events. Trace capture: the same
chunk-boundary calls give the same windows; a CPU window holds the
round's ``record_function`` phases.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro_torch import obs
from repro_torch.core import (AlgoHParams, init_state, make_round_fn,
                              run_federated, run_rounds, solve_reference)
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
HP = AlgoHParams(eta=0.5, local_epochs=3)


@pytest.fixture(scope="module")
def setup():
    X, y = make_binary_classification("synthetic_small", n=400, seed=0)
    clients = partition(X, y, 8, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")
    return prob, solve_reference(prob, iters=50)


def metric_rows(build_round_row, n=6):
    """Round rows from one seeded metric stream, with nan, inf and -inf."""
    rng = np.random.default_rng(0)
    rows, comm, wall = [], 0.0, 0.0
    for t in range(n):
        m = {f: float(v) for f, v in zip(
            ("loss", "grad_norm", "theta_mean", "gram_cond_max",
             "gram_cond_mean", "aa_used_min", "aa_clipped_max", "cohort_ess",
             "comm_bytes", "arrivals", "staleness_mean", "staleness_max"),
            rng.random(12))}
        m["arrivals"] = m["staleness_mean"] = m["staleness_max"] = math.nan
        if t == 2:
            m["theta_mean"], m["gram_cond_max"] = math.nan, math.inf
        if t == 4:
            m["loss"] = -math.inf
        comm += m["comm_bytes"]
        wall += 0.25
        rows.append(build_round_row(t, m, float(rng.random()), comm, 0.25,
                                    wall))
    return rows


def header(schema):
    return {"v": schema.SCHEMA_VERSION, "kind": "header",
            "fields": list(schema.ROW_FIELDS), "algo": "fedosaa_svrg",
            "runtime": "vmap", "channel": "int8+ef", "num_clients": 8,
            "uplink_bytes": {"grad": 116.0}, "chunk": 2, "num_rounds": 6,
            "start_round": 0, "backend": "cpu"}


def test_schema_and_rows_equal_the_reference():
    assert obs.SCHEMA_VERSION == ref_obs.SCHEMA_VERSION == 4
    assert obs.ROW_FIELDS == ref_obs.ROW_FIELDS
    ours = metric_rows(obs.build_round_row)
    ref = metric_rows(ref_obs.build_round_row)
    assert json.dumps(ours) == json.dumps(ref)
    from repro.obs.sinks import build_footer as ref_footer
    from repro_torch.obs.sinks import build_footer
    alarms = [{"rule": "x", "round": 3, "value": math.nan}]
    assert (json.dumps(build_footer(6, True, alarms))
            == json.dumps(ref_footer(6, True, alarms)))


def test_jsonl_files_byte_identical(tmp_path):
    from repro.obs.sinks import build_footer as ref_footer
    from repro_torch.obs.sinks import build_footer
    files = []
    for name, pkg, footer in (("port", obs, build_footer),
                              ("ref", ref_obs, ref_footer)):
        path = str(tmp_path / name / "m.jsonl")
        sink = pkg.JsonlSink(path)
        rows = metric_rows(pkg.build_round_row)
        sink.open(header(pkg))
        sink.emit(rows[:2])
        sink.emit(rows[2:])
        sink.close(footer(len(rows), False, []))
        files.append(Path(path).read_bytes())
    assert files[0] == files[1]
    lines = files[0].decode().splitlines()
    assert len(lines) == 8
    row = json.loads(lines[3], parse_constant=lambda c: pytest.fail(c))
    assert row["theta_mean"] is None and row["gram_cond_max"] is None
    assert json.loads(lines[5])["loss"] is None


def test_memory_sink_frames_equal(tmp_path):
    frames = []
    for pkg in (obs, ref_obs):
        sink = pkg.MemorySink()
        sink.open(header(pkg))
        sink.emit(metric_rows(pkg.build_round_row))
        sink.close({"kind": "footer"})
        frames.append(json.dumps([sink.header, sink.rows, sink.footer]))
    assert frames[0] == frames[1]


def test_make_sink_specs_and_protocol(tmp_path):
    assert isinstance(obs.make_sink("memory"), obs.MemorySink)
    assert obs.make_sink("stdout:5").every == 5
    assert isinstance(obs.make_sink(f"jsonl:{tmp_path}/m.jsonl"), obs.JsonlSink)
    with pytest.raises(ValueError, match="path"):
        obs.make_sink("jsonl")
    with pytest.raises(ValueError, match="unknown sink"):
        obs.make_sink("carrier_pigeon")
    for s in (obs.MemorySink(), obs.StdoutSink(), obs.JsonlSink("x"),
              obs.AlarmMonitor()):
        assert isinstance(s, obs.MetricsSink)


def _row(t, **kw):
    base = {"v": 4, "kind": "round", "round": t, "loss": 0.5}
    base.update(kw)
    return base


#: row streams that fire every kind of rule, fed in chunks
ALARM_STREAMS = {
    "nonfinite_stop": [[_row(0)], [_row(1, loss=float("nan"))],
                       [_row(2, loss=None)]],
    "gram_cond_warn": [[_row(0, gram_cond_max=1e13),
                        _row(1, gram_cond_max=float("nan"))]],
    "column_collapse": [[_row(0, aa_used_min=0.0), _row(1, aa_used_min=3.0)]],
    "clipping_and_staleness": [[_row(t, aa_clipped_max=1.0,
                                     staleness_max=11.0) for t in range(60)]],
    "plateau": [[_row(t, rel_error=1.0) for t in range(40)],
                [_row(t, rel_error=1.0) for t in range(40, 80)]],
    "improving": [[_row(t, rel_error=0.9 ** t) for t in range(80)]],
}


@pytest.mark.parametrize("stream", sorted(ALARM_STREAMS))
def test_alarm_events_equal_the_reference(stream):
    """DEFAULT_RULES (cooldown 25), then a cooldown of 10 on one hot rule."""
    mons = [obs.AlarmMonitor(), ref_obs.AlarmMonitor()]
    for chunk in ALARM_STREAMS[stream]:
        for mon in mons:
            mon.emit(chunk)
    assert mons[0].events == mons[1].events
    assert mons[0].stop_requested == mons[1].stop_requested
    if stream == "nonfinite_stop":
        assert mons[0].stop_requested and mons[0].events
    hot = [pkg.AlarmMonitor(rules=(pkg.AlarmRule("hot", "loss", "gt",
                                                 threshold=0.0),), cooldown=10)
           for pkg in (obs, ref_obs)]
    for mon in hot:
        mon.emit([_row(t, loss=1.0) for t in range(23)])
    assert [e["round"] for e in hot[0].events] == [0, 10, 20]
    assert hot[0].events == hot[1].events


def test_default_rules_equal_the_reference():
    import dataclasses
    assert ([dataclasses.asdict(r) for r in obs.DEFAULT_RULES]
            == [dataclasses.asdict(r) for r in ref_obs.DEFAULT_RULES])
    for bad, match in (({"op": "between"}, "op"), ({"op": "gt"}, "threshold"),
                       ({"op": "nonfinite", "action": "explode"}, "action")):
        with pytest.raises(ValueError, match=match):
            obs.AlarmRule("x", "loss", **bad)


@pytest.mark.parametrize("chunk", [None, 2])
def test_run_jsonl_passes_the_reference_validator(setup, tmp_path, chunk):
    """A port run (the loop, and the engine in chunks of 2) streams a
    header, one row per round and a footer that
    scripts/check_metrics_jsonl.py accepts."""
    prob, w_star = setup
    path = str(tmp_path / "metrics.jsonl")
    h = run_federated(prob, "fedosaa_svrg", HP, 5, w_star=w_star,
                      channel="int8", chunk=chunk, device="cpu",
                      sinks=[obs.JsonlSink(path), obs.AlarmMonitor()])
    lines = Path(path).read_text().splitlines()
    assert len(lines) == 7
    head = json.loads(lines[0])
    assert (head["algo"], head["runtime"], head["channel"], head["chunk"],
            head["num_clients"], head["backend"]) == (
        "fedosaa_svrg", "vmap", "int8+ef", chunk, 8, "cpu")
    assert head["uplink_bytes"] == {"grad": 44.0, "delta": 44.0}  # d=40
    rows = [json.loads(line) for line in lines[1:-1]]
    np.testing.assert_array_equal([r["loss"] for r in rows], h.loss)
    assert all(r["arrivals"] is None for r in rows)
    res = subprocess.run(
        [sys.executable, "scripts/check_metrics_jsonl.py", path], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr


def drive(tc, calls):
    for kind, *args in calls:
        getattr(tc, kind)(*args)
    return tc.windows, tc.active


#: chunk-boundary call sequences: (static window, trigger file, leaked
#: window closed early), each applied to both state machines
TRACE_CASES = {
    "static": (dict(start_round=2, num_rounds=3),
               [("on_chunk_start", 0, 2), ("on_chunk_end", 2),
                ("on_chunk_start", 2, 2), ("on_chunk_end", 4),
                ("on_chunk_start", 4, 2), ("on_chunk_end", 6),
                ("on_chunk_start", 6, 2), ("on_chunk_end", 8), ("close",)]),
    "trigger": (dict(trigger_file="TRACE_NOW"),
                [("on_chunk_start", 0, 4), ("on_chunk_end", 4), ("touch",),
                 ("on_chunk_start", 4, 4), ("on_chunk_end", 8),
                 ("on_chunk_start", 8, 4), ("on_chunk_end", 12), ("close",)]),
    "leaked": (dict(start_round=0, num_rounds=100),
               [("on_chunk_start", 0, 4), ("on_chunk_end", 4), ("close",)]),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_capture_state_machine_equals_the_reference(case, tmp_path,
                                                          monkeypatch):
    """The same calls open and close the same windows; the reference's
    jax.profiler calls are stubbed (its own tests exercise them)."""
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    cfg, calls = TRACE_CASES[case]
    out = []
    for name, pkg in (("port", obs), ("ref", ref_obs)):
        kw = dict(cfg)
        trigger = tmp_path / name / "TRACE_NOW"
        if "trigger_file" in kw:
            kw["trigger_file"] = str(trigger)
        tc = pkg.TraceCapture(pkg.TraceConfig(trace_dir=str(tmp_path / name
                                                            / "t"), **kw))
        trigger.parent.mkdir(parents=True, exist_ok=True)
        tc.touch = lambda p=trigger: p.write_text("")
        out.append(drive(tc, calls))
        assert not trigger.exists()
    assert out[0] == out[1]
    windows = {"static": [(2, 6)], "trigger": [(4, 8)], "leaked": [(0, -1)]}
    assert out[0] == (windows[case], False)
    assert len(obs.find_trace_files(str(tmp_path / "port" / "t"))) == 1


def test_disabled_config(tmp_path):
    for pkg in (obs, ref_obs):
        assert not pkg.TraceConfig(trace_dir=str(tmp_path)).enabled
        assert pkg.TraceConfig(trace_dir=str(tmp_path), num_rounds=2).enabled
        assert pkg.TraceConfig(trace_dir=str(tmp_path),
                               trigger_file="x").enabled


def test_cpu_window_holds_the_round_phases(setup, tmp_path):
    """A static window over an engine run on the CPU: a Chrome trace with
    the fl.local_trajectory, fl.aa_step and fl.uplink scopes."""
    prob, _ = setup
    rf = make_round_fn("fedosaa_svrg", prob, HP, "int8", device="cpu")
    state = init_state(prob, device="cpu", channel="int8",
                       algo="fedosaa_svrg")
    tdir = str(tmp_path / "trace")
    tc = obs.TraceCapture(obs.TraceConfig(trace_dir=tdir, start_round=0,
                                          num_rounds=2))
    _, trace = run_rounds(rf, state, 4, chunk=2, trace_capture=tc)
    assert trace.num_rounds == 4
    assert tc.windows == [(0, 2)] and not tc.active
    assert len(obs.find_trace_files(tdir)) == 1
    for scope in ("fl.local_trajectory", "fl.aa_step", "fl.uplink"):
        assert obs.trace_contains(tdir, scope), scope
    assert not obs.trace_contains(tdir, "fl.no_such_scope")
