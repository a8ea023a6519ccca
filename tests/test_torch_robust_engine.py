"""The robustness layer through the engine (core/engine.py) and
core/server.py::run_federated on the CPU.

  * an inactive FaultPlan and an inactive AsyncConfig are bit for bit no
    plan and no config, by the per-round loop and by the engine: every
    History row, the final params and the draws;
  * the engine equals the per-round loop bit for bit under each fault kind
    and under the deadline gate, dense and in a cohort: the whole carried
    state, the anchor rows, the buffer rows and the int32 ages included
    (the chunk's live/stop select carries them unchanged, and each round's
    fault draws are filled before the chunk), and, through run_federated
    under the gate (whose metrics join the device readout) and dropout,
    every telemetry row and History column;
  * run_federated attaches the anchor and buffer rows where the plan and
    the gate need them, fills ``History.arrivals``/``staleness_*`` from
    the rows, and puts both configs in the run header.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (AAConfig, AlgoHParams, init_state,
                              make_round_fn, run_federated, run_rounds)
from repro_torch.core import engine
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.obs import MemorySink
from repro_torch.robust import (ASYNC_AGE_KEY, ASYNC_BUF_KEY,
                                FAULT_ANCHOR_KEY, AsyncConfig, FaultPlan,
                                init_async_comm, init_fault_comm)

from test_torch_engine import assert_same_history, assert_same_rows
from torch_threads import one_torch_thread  # noqa: F401

K, L, ROUNDS = 8, 3, 5
HP = AlgoHParams(eta=0.5, local_epochs=L, aa=AAConfig(clip_rtol=1e-3))
GATE = AsyncConfig(deadline=2.0, min_arrivals=2)
LATENCY = dict(latency_scale=1.0, latency_shape=1.5)
#: (name, algorithm, plan, gate, channel, AlgoHParams knobs)
CASES = [
    ("drop", "fedosaa_svrg", dict(seed=1, drop_rate=0.4), None, "int8",
     {"carry_history": 2}),
    ("stale", "fedosaa_svrg", dict(seed=2, stale_rate=0.4), None, "int8", {}),
    ("sign_flip", "fedosaa_svrg", dict(byz_clients=2, byz_scale=3.0), None,
     None, {}),
    ("noise", "scaffold", dict(byz_clients=2, byz_mode="noise",
                               byz_scale=3.0), None, "int8", {}),
    ("history", "fedosaa_svrg", dict(byz_clients=2, byz_mode="history",
                                     byz_scale=1e6), None, None,
     {"carry_history": 2}),
    ("dp", "lbfgs", dict(dp_sigma=1e-3), None, "int8", {}),
    ("gate", "fedosaa_svrg", dict(seed=5, drop_rate=0.2, **LATENCY), GATE,
     "int8", {"carry_history": 2}),
    ("gate_scaffold", "fedosaa_scaffold", dict(seed=5, **LATENCY), GATE,
     None, {}),
    ("gate_dane", "dane", dict(seed=5, stale_rate=0.3, **LATENCY), GATE,
     "int8", {"dane_newton_iters": 1, "dane_cg_iters": 3}),
    ("gate_cohort", "fedavg", dict(seed=3, drop_rate=0.3, stale_rate=0.3,
                                   **LATENCY), GATE, "int8",
     {"cohort_size": 4}),
    ("giant_cohort", "giant", dict(seed=3, drop_rate=0.3, dp_sigma=1e-3),
     None, "int8", {"cohort_size": 4}),
]


@pytest.fixture(scope="module")
def setup():
    X, y = make_binary_classification("synthetic_small", n=800, seed=0)
    clients = partition(X, y, K, "imbalance", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")
    d = clients.x.shape[-1]
    return prob, torch.linspace(-1.0, 1.0, d, dtype=torch.float64)


def start(prob, algo, hp, channel, plan, gate):
    state = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    if plan.stale_rate > 0.0:
        state = state._replace(comm=init_fault_comm(state.comm, state.params,
                                                    K))
    if gate is not None:
        state = state._replace(comm=init_async_comm(state.comm, state.params,
                                                    K))
    return state


def assert_states_equal(a, b, what=""):
    for f in ("params", "c", "c_k", "hist_s", "hist_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        assert x is None or torch.equal(x, y), (what, f)
    assert a.t == b.t
    la, lb = engine._leaves(a.comm or {}), engine._leaves(b.comm or {})
    assert sorted(a.comm or {}) == sorted(b.comm or {}), what
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), what


@pytest.mark.parametrize("name,algo,plan,gate,channel,knobs", CASES,
                         ids=[c[0] for c in CASES])
def test_engine_equals_the_loop(setup, name, algo, plan, gate, channel,
                                knobs):
    prob, w_star = setup
    hp = dataclasses.replace(HP, **knobs)
    plan = FaultPlan(**plan)
    rf = make_round_fn(algo, prob, hp, channel, device="cpu", faults=plan,
                       async_cfg=gate)
    s_loop = start(prob, algo, hp, channel, plan, gate)
    for _ in range(ROUNDS):
        s_loop, _ = rf(s_loop)
    s_eng, trace = run_rounds(rf, start(prob, algo, hp, channel, plan, gate),
                              ROUNDS, chunk=3, w_star=w_star)
    assert trace.num_rounds == ROUNDS
    assert_states_equal(s_loop, s_eng, name)
    if gate is not None:
        assert s_eng.comm[ASYNC_AGE_KEY].dtype == torch.int32
        assert np.all(trace.arrivals >= 0)
    if plan.stale_rate > 0.0:
        assert FAULT_ANCHOR_KEY in s_eng.comm
    if gate is None and name != "drop":
        return
    # and through run_federated (the gate's device metrics in the rows):
    # rows and History, loop against engine
    sinks = MemorySink(), MemorySink()
    h0, h1 = (run_federated(prob, algo, hp, ROUNDS, w_star=w_star,
                            device="cpu", channel=channel, faults=plan,
                            async_cfg=gate, chunk=chunk, sinks=[sink])
              for chunk, sink in zip((None, 3), sinks))
    assert_same_history(h0, h1)
    assert_same_rows(*sinks)
    assert torch.equal(h1.final_params, s_eng.params)
    assert sinks[1].header["faults"] == dataclasses.asdict(plan)
    assert sinks[1].header["async"] == (dataclasses.asdict(gate) if gate
                                        else None)


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("channel", [None, "int8"])
def test_inactive_plan_and_gate_are_none(setup, chunk, channel):
    prob, w_star = setup
    hp = dataclasses.replace(HP, carry_history=2)
    runs = [run_federated(prob, "fedosaa_svrg", hp, ROUNDS, w_star=w_star,
                          device="cpu", channel=channel, chunk=chunk, **kw)
            for kw in ({}, dict(faults=FaultPlan(seed=3),
                                async_cfg=AsyncConfig(min_arrivals=2)))]
    assert_same_history(*runs)
    assert torch.equal(runs[0].final_params, runs[1].final_params)
    assert np.isnan(runs[1].arrivals).all()
    f0 = make_round_fn("fedosaa_svrg", prob, hp, channel, device="cpu")
    f1 = make_round_fn("fedosaa_svrg", prob, hp, channel, device="cpu",
                       faults=FaultPlan(), async_cfg=AsyncConfig())
    assert f0.draw_specs == f1.draw_specs
    assert f0.host_metrics == f1.host_metrics


def test_the_readout_carries_the_gate_metrics(setup, monkeypatch):
    """With the gate on, arrivals and staleness join the chunk's one device
    readout (three more columns) and comm_bytes stays a host metric."""
    prob, w_star = setup
    reads = []
    fetch = engine._fetch

    def counting(readout):
        reads.append(tuple(readout.shape))
        return fetch(readout)

    monkeypatch.setattr(engine, "_fetch", counting)
    plan = FaultPlan(seed=5, **LATENCY)
    rf = make_round_fn("fedosaa_svrg", prob, HP, device="cpu", faults=plan,
                       async_cfg=GATE)
    dev, host = engine.metric_fields(rf)
    assert host == ("comm_bytes",) and "arrivals" in dev
    _, trace = run_rounds(rf, start(prob, "fedosaa_svrg", HP, None, plan, GATE),
                          4, chunk=4, w_star=w_star)
    assert reads == [(4, len(engine.DEVICE_FIELDS) + 3 + 3)]
    assert np.all(np.isfinite(trace.arrivals))
    assert np.all(np.isfinite(trace.comm_bytes))


def test_run_federated_attaches_the_rows(setup):
    prob, _ = setup
    h = run_federated(prob, "fedosaa_svrg", HP, 3, device="cpu",
                      faults=FaultPlan(seed=1, stale_rate=0.5),
                      async_cfg=GATE, chunk=2)
    assert len(h.arrivals) == 3 and np.all(h.arrivals == K)
    assert np.all(h.staleness_max == 0.0)
    # a state without the rows cannot run a stale plan or the gate
    for kw, key in ((dict(faults=FaultPlan(stale_rate=0.5)), FAULT_ANCHOR_KEY),
                    (dict(async_cfg=GATE), ASYNC_AGE_KEY)):
        rf = make_round_fn("fedosaa_svrg", prob, HP, "int8", device="cpu",
                           **kw)
        with pytest.raises(ValueError, match=key):
            rf(init_state(prob, device="cpu", channel="int8",
                          algo="fedosaa_svrg"))
    s = init_async_comm(None, torch.zeros(3, dtype=torch.float64), 4)
    assert s[ASYNC_BUF_KEY].shape == (4, 3) and s[ASYNC_AGE_KEY].dtype == torch.int32
