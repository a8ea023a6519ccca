"""The deadline gate in the port (repro_torch/robust/async_agg.py, wired into
core/algorithms.py::make_round_fn) against the JAX package's
repro/robust/async_agg.py, and its contracts on the port alone.

  * AsyncConfig's validation and ``active``, case for case the reference's;
  * ``plan_async``'s five masks, its staleness and its deadline equal to
    the reference's for the same latencies, ages, weights and drops (f64,
    the extension to the ``min_arrivals``-th order statistic included),
    its weights and ``discounted_weights`` within rel 1e-14, and
    ``async_round_stats`` equal;
  * a round with every client late keeps the params bit for bit and
    buffers every delta (age 1); a later loose deadline folds them back
    (ages to 0, staleness 1); a retained row keeps its bits and ages;
  * the history guard: busy clients' carried AA columns keep their bits
    with it on, and are written with it off;
  * SCAFFOLD under a zero-fresh round keeps c, and its late clients' c_k
    revert;
  * GIANT and Newton-GMRES refuse an active gate; DANE takes it;
  * the gate's arrivals and staleness reach the sinks, and both alarms
    (staleness_runaway, aa_clipping_active) fire on a gated, clipped run.

The round against the reference's, fed its latencies, is in
tests/test_torch_faults.py (``latency_gate`` and the all-kinds cases).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.robust import AsyncConfig as JaxAsyncConfig
from repro.robust import async_agg as jax_async
from repro_torch.core import AAConfig, AlgoHParams, init_state, make_round_fn
from repro_torch.core import run_federated
from repro_torch.obs import AlarmMonitor, MemorySink
from repro_torch.robust import (ASYNC_AGE_KEY, ASYNC_BUF_KEY, AsyncConfig,
                                FaultPlan, async_round_stats,
                                discounted_weights, init_async_comm,
                                plan_async)

from test_torch_cohort import ETA, K, L, port_problem, ref64  # noqa: F401

#: every latency about 5 (sigma 0.01): a deadline of 0.5 makes every client
#: late, one of 50 every client on time
SLOW = FaultPlan(seed=1, latency_scale=5.0, latency_shape=0.01)
TIGHT, LOOSE = AsyncConfig(deadline=0.5), AsyncConfig(deadline=50.0)
HEAVY = FaultPlan(seed=5, latency_scale=1.0, latency_shape=1.5)


@pytest.mark.parametrize("kw", [{}, dict(deadline=-1.0),
                                dict(deadline=1.0, min_arrivals=-1),
                                dict(deadline=1.0, staleness_alpha=-0.5),
                                dict(deadline=0.5, min_arrivals=3,
                                     staleness_alpha=2.0,
                                     guard_history=False)], ids=str)
def test_config_validation_and_active_match_reference(kw):
    try:
        ref = JaxAsyncConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            AsyncConfig(**kw)
        return
    ours = AsyncConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.active == ref.active


MASKS = ("contribute", "fresh", "fold", "defer", "retain")


@pytest.mark.parametrize("seed", range(6))
def test_plan_async_matches_reference(ref64, seed):
    """Random latencies (lognormal), ages in 0..3, f64 weights and drops:
    masks, staleness and deadline equal, weights within rel 1e-14."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    lat = np.exp(1.5 * rng.standard_normal(n)).astype(np.float32)
    age = rng.integers(0, 4, n).astype(np.int32)
    pw = rng.random(n) + 1e-3
    pw /= pw.sum()
    drop = rng.random(n) < 0.3
    cfg = dict(deadline=float(rng.choice([0.5, 1.0, 2.0])),
               min_arrivals=int(rng.integers(0, n + 2)),
               staleness_alpha=float(rng.choice([0.0, 0.5, 1.7])))
    for d in (None, drop):
        ref = jax_async.plan_async(
            JaxAsyncConfig(**cfg), jnp.asarray(lat), jnp.asarray(age),
            jnp.asarray(pw), drop=None if d is None else jnp.asarray(d))
        ours = plan_async(AsyncConfig(**cfg), torch.from_numpy(lat),
                          torch.from_numpy(age), torch.from_numpy(pw),
                          drop=None if d is None else torch.from_numpy(d))
        for f in MASKS:
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(ours.staleness.numpy(),
                                      np.asarray(ref.staleness))
        assert float(ours.deadline) == float(ref.deadline)
        for f in ("weights", "fresh_weights", "fold_weights"):
            np.testing.assert_allclose(getattr(ours, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-14, atol=0, err_msg=f)
        # every client in exactly one of fresh, fold, defer, retain, idle
        parts = (ours.fresh.int() + ours.fold.int() + ours.defer.int()
                 + ours.retain.int())
        assert bool((parts <= 1).all())
        for a, b in zip(async_round_stats(ours), jax_async.async_round_stats(ref)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("mode", ["random", "none", "all"])
def test_discounted_weights_match_reference(ref64, mode):
    rng = np.random.default_rng(7)
    for n in (1, 5, 16):
        contribute = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
                      "random": rng.random(n) < 0.5}[mode]
        s = rng.integers(0, 1000, n).astype(np.float64)
        base = rng.random(n) + 1e-3
        base /= base.sum()
        for alpha in (0.0, 0.5, 3.3):
            ref = np.asarray(jax_async.discounted_weights(
                jnp.asarray(base), jnp.asarray(contribute), jnp.asarray(s),
                alpha))
            ours = discounted_weights(torch.from_numpy(base),
                                      torch.from_numpy(contribute),
                                      torch.from_numpy(s), alpha).numpy()
            np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=0)
            assert np.all(ours[~contribute] == 0.0) and np.all(ours >= 0)
            if contribute.any():
                assert abs(ours.sum() - 1.0) < 1e-14
            else:
                assert ours.sum() == 0.0


def test_min_arrivals_extends_the_deadline():
    ar = plan_async(AsyncConfig(deadline=0.5, min_arrivals=2),
                    torch.tensor([5.0, 3.0, 9.0, 1.0]),
                    torch.zeros(4, dtype=torch.int32), torch.full((4,), 0.25))
    assert float(ar.deadline) == 3.0 and int(ar.fresh.sum()) == 2
    assert abs(float(ar.fresh_weights.sum()) - 1.0) < 1e-6


def gated(prob, cfg, plan=SLOW, algo="fedosaa_svrg", channel=None, **kw):
    hp = AlgoHParams(eta=ETA, local_epochs=L, **kw)
    rf = make_round_fn(algo, prob, hp, channel, device="cpu", faults=plan,
                       async_cfg=cfg)
    state = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    return rf, state._replace(comm=init_async_comm(state.comm, state.params,
                                                   K))


def test_zero_arrivals_round_buffers_everyone(port_problem):
    rf, state = gated(port_problem, TIGHT, channel="int8")
    s, m = rf(state)
    assert torch.equal(s.params, state.params)
    assert float(m.arrivals) == 0.0 and np.isnan(float(m.staleness_mean))
    assert torch.equal(s.comm[ASYNC_AGE_KEY], torch.ones(K, dtype=torch.int32))
    assert bool((s.comm[ASYNC_BUF_KEY].abs().sum(-1) > 0).all())
    # encode at send: the wire's error feedback advanced all the same
    assert not torch.equal(s.comm["delta"]["ef"], state.comm["delta"]["ef"])


def test_defer_then_fold_and_retain_ages(port_problem):
    rf_tight, state = gated(port_problem, TIGHT)
    rf_loose, _ = gated(port_problem, LOOSE)
    s1, _ = rf_tight(state)
    s2, m2 = rf_loose(s1)
    assert not torch.equal(s1.params, s2.params)
    assert float(m2.arrivals) == float(K) and float(m2.staleness_max) == 1.0
    assert torch.equal(s2.comm[ASYNC_AGE_KEY], torch.zeros(K, dtype=torch.int32))
    assert not s2.comm[ASYNC_BUF_KEY].any()
    # retained: a busy late client keeps its buffered bits and ages
    s3, m3 = rf_tight(s1)
    assert torch.equal(s3.comm[ASYNC_AGE_KEY],
                       torch.full((K,), 2, dtype=torch.int32))
    assert torch.equal(s3.comm[ASYNC_BUF_KEY], s1.comm[ASYNC_BUF_KEY])
    assert torch.equal(s3.params, s1.params)


@pytest.mark.parametrize("guard", [True, False])
def test_history_guard(port_problem, guard):
    """Round 1 at deadline 1 under heavy-tailed latencies: the fast land,
    the stragglers buffer. Round 2 at a loose deadline folds them: their
    carried columns keep their bits with the guard, move without it; the
    fresh clients' move either way."""
    cfg = AsyncConfig(deadline=1.0, guard_history=guard)
    loose = AsyncConfig(deadline=1e6, guard_history=guard)
    rf, state = gated(port_problem, cfg, HEAVY, carry_history=2)
    rf_loose, _ = gated(port_problem, loose, HEAVY, carry_history=2)
    s1, _ = rf(state)
    busy = s1.comm[ASYNC_AGE_KEY] > 0
    assert busy.any() and (~busy).any()
    s2, _ = rf_loose(s1)
    for f in ("hist_s", "hist_y"):
        a, b = getattr(s1, f), getattr(s2, f)
        assert torch.equal(a[busy], b[busy]) == guard, f
        assert not torch.equal(a[~busy], b[~busy]), f


@pytest.mark.parametrize("algo", ["scaffold", "fedosaa_scaffold"])
def test_scaffold_zero_fresh_round_keeps_c(port_problem, algo):
    rf, state = gated(port_problem, TIGHT, algo=algo)
    warm = make_round_fn(algo, port_problem, AlgoHParams(eta=ETA, local_epochs=L),
                         device="cpu")
    s0, _ = warm(state)           # a nonzero c and c_k to keep
    s1, _ = rf(s0)
    assert torch.equal(s1.c, s0.c) and torch.equal(s1.c_k, s0.c_k)
    assert torch.equal(s1.params, s0.params)


@pytest.mark.parametrize("algo", ["giant", "newton_gmres"])
def test_newton_directions_refuse_the_gate(port_problem, algo):
    with pytest.raises(ValueError, match="delta-form"):
        make_round_fn(algo, port_problem, AlgoHParams(), device="cpu",
                      async_cfg=AsyncConfig(deadline=1.0))
    # faults alone, and an inactive gate, are taken
    make_round_fn(algo, port_problem, AlgoHParams(), device="cpu",
                  faults=FaultPlan(drop_rate=0.2), async_cfg=AsyncConfig())


def test_dane_takes_the_gate(port_problem):
    rf, state = gated(port_problem, AsyncConfig(deadline=2.0, min_arrivals=2),
                      HEAVY, algo="dane", dane_newton_iters=2, dane_cg_iters=5)
    s, m = rf(state)
    assert 2 <= float(m.arrivals) <= K and torch.isfinite(s.params).all()
    assert rf.host_metrics == ("comm_bytes",)


def test_gate_metrics_and_alarms_reach_the_sinks(port_problem):
    """A gated, clipped run with a byzantine history client: the rows carry
    arrivals and staleness, the History their columns, and the alarm monitor
    fires staleness_runaway (an oldest landed age past 10) and
    aa_clipping_active."""
    sink, mon = MemorySink(), AlarmMonitor()
    plan = FaultPlan(seed=5, latency_scale=1.0, latency_shape=1.5,
                     byz_clients=1, byz_mode="history", byz_scale=1e6)
    # a deadline no latency beats, extended to the fastest client's
    # (min_arrivals=1): about one client lands a round, a late one waits
    # until it is the fastest, and the oldest landed age passes 10
    h = run_federated(port_problem, "fedosaa_svrg",
                      AlgoHParams(eta=ETA, local_epochs=L,
                                  aa=AAConfig(clip_rtol=1e-3)),
                      16, device="cpu", faults=plan,
                      async_cfg=AsyncConfig(deadline=1e-3, min_arrivals=1),
                      sinks=[sink, mon])
    assert len(h.arrivals) == 16 and np.all(h.arrivals >= 1)
    assert [r["arrivals"] for r in sink.rows] == list(h.arrivals)
    assert all("staleness_max" in r for r in sink.rows)
    rules = {e["rule"] for e in mon.events}
    assert {"staleness_runaway", "aa_clipping_active"} <= rules, rules
    assert sink.header["async"] == dataclasses.asdict(
        AsyncConfig(deadline=1e-3, min_arrivals=1))
    assert sink.header["faults"]["byz_mode"] == "history"
