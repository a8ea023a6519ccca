"""Fault injection in the port (repro_torch/robust/faults.py, wired into
core/algorithms.py::make_round_fn) against the JAX package's
repro/robust/faults.py.

At the reference's test scale (synthetic_small, n=800, K=8 ``imbalance``,
L=3, f64, the reference with its f64-accumulating tree_math helpers: the
``ref64`` fixture of tests/test_torch_cohort.py). Parity is ‖Δw‖/‖w‖.

  * FaultPlan's validation and properties, case for case the reference's;
  * one round from the reference's state after two faulted rounds, fed
    the reference's realization: its drop and stale uniforms and latency
    normals (drawn from its round key as its ``realize`` draws them; the
    port's masks and latencies are held to ``realize``'s own), and its
    byzantine, DP and history-poison noise (its ``tree_random_like`` on
    its per-client keys), within 1e-7, the anchor, buffer, error-feedback
    and reference rows, c_k and the carried columns with it, the ages and
    the gate's metrics equal:
      - each fault kind alone on FedOSAA-SVRG (the history poison with 2
        carried columns, and at C=4 of 8);
      - all of them at once (dropout, stale anchors, byzantine noise, DP,
        latencies and the deadline gate; the Newton pair without the gate)
        on the int8 wire, for all ten algorithms at C=4 of 8 and dense for
        FedOSAA-SVRG, both SCAFFOLDs, GIANT and DANE;
  * the port's realization from its own draws: masks keyed by global id,
    the same plan seed giving the same round whatever the run's seed;
  * dropped rows bit-frozen, an all-dropped round keeping the params bit
    for bit, stale anchors refreshing and compounding;
  * the f32 acceptance pair at the reference's size: one byzantine history
    client at 1e24 drives the undefended run non-finite, the clip_rtol
    defense keeps it finite and falling, and the undefended int8 run stays
    finite (its codes sanitize the NaN delta, as the reference's do); in
    f64 the undefended run stays finite, as the reference's does with f64
    accumulation (the contract finding chip_smoke.py's gate follows);
  * the int8 codes of NaN and Inf, and the uplink's post-codec addend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import algorithms as jax_algos
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.core import run_federated as jax_run_federated
from repro.core.anderson import AAConfig as JaxAAConfig
from repro.robust import AsyncConfig as JaxAsyncConfig
from repro.robust import FaultPlan as JaxFaultPlan
from repro.robust import faults as jax_faults
from repro.robust import init_async_comm as jax_init_async_comm
from repro.robust import init_fault_comm as jax_init_fault_comm
from repro_torch.core import (ALGORITHMS, UPLINK_SCHEMAS, AAConfig,
                              AlgoHParams, init_state, make_round_fn,
                              run_federated)
from repro_torch.core.algorithms import COHORT, LINE_SEARCH_ALGOS
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.robust import (ASYNC_AGE_KEY, ASYNC_BUF_KEY,
                                FAULT_ANCHOR_KEY, AsyncConfig, FaultPlan,
                                init_async_comm, init_fault_comm, realize)
from repro_torch.robust import faults as flt

from test_torch_cohort import (ETA, KNOBS, SCAFFOLD, K, L, port_problem,  # noqa: F401
                               problems, ref64, start_state)

from torch_threads import one_torch_thread  # noqa: F401

C = 4
CLIP = 1e-3
#: one plan per fault kind (the reference's FAULT_KINDS,
#: tests/test_robust.py), and the latency plan under the gate
KINDS = {
    "drop": dict(seed=11, drop_rate=0.4),
    "stale": dict(seed=11, stale_rate=0.4),
    "byz_sign_flip": dict(byz_clients=2, byz_mode="sign_flip", byz_scale=3.0),
    "byz_noise": dict(byz_clients=2, byz_mode="noise", byz_scale=3.0),
    "byz_history": dict(byz_clients=2, byz_mode="history", byz_scale=1e6),
    "dp": dict(dp_sigma=1e-3),
    "latency_gate": dict(seed=5, latency_scale=1.0, latency_shape=1.5),
}
#: every kind but the history poison at once, and the gate
MIXED = dict(seed=7, drop_rate=0.3, stale_rate=0.3, byz_clients=1,
             byz_mode="noise", byz_scale=3.0, dp_sigma=1e-3,
             latency_scale=1.0, latency_shape=1.5)
GATE = dict(deadline=2.0, min_arrivals=2, staleness_alpha=0.5)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

PLAN_CASES = [
    {}, dict(drop_rate=1.5), dict(stale_rate=-0.1), dict(byz_clients=-1),
    dict(byz_clients=1, byz_mode="nonsense"), dict(dp_sigma=-1.0),
    dict(latency_scale=-1.0), dict(latency_shape=0.0),
    dict(latency_dist="weibull"), dict(drop_rate=0.1), dict(stale_rate=0.1),
    dict(byz_clients=1), dict(byz_clients=1, byz_mode="history"),
    dict(byz_clients=1, byz_mode="noise"), dict(dp_sigma=0.1),
    dict(latency_scale=0.5, latency_dist="pareto"),
]


@pytest.mark.parametrize("kw", PLAN_CASES, ids=str)
def test_plan_validation_and_properties_match_reference(kw):
    try:
        ref = JaxFaultPlan(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            FaultPlan(**kw)
        return
    ours = FaultPlan(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for p in ("active", "simulates_latency", "poisons_history",
              "perturbs_uplink"):
        assert getattr(ours, p) == getattr(ref, p), p


# --------------------------------------------------------------------------
# one round against the reference, fed its realization
# --------------------------------------------------------------------------

def reference_draws(names, jp, state, jplan, algo, channel, d, csize):
    """The port's draws ``names`` of the reference's round from ``state``:
    its cohort, its int8 uniforms, its fault uniforms and latency normals
    (from its round key, as its ``realize`` draws them) and its per-client
    noise (its ``tree_random_like`` on its ``realize`` keys), at the
    cohort's rows. Also returns the reference's realization."""
    _, part_rng, cl_rng = jax.random.split(state.rng, 3)
    rows = np.arange(K)
    draws = {}
    if csize is not None:
        idx, _ = jax_algos._sample_cohort(jp.clients.weight, csize, part_rng)
        rows = np.asarray(idx)
        draws[COHORT] = torch.from_numpy(rows.astype(np.int64))
    keys = jax.random.split(cl_rng, K)
    nc = -(-d // 256)
    for s in UPLINK_SCHEMAS[algo]:
        if s.tag in names:
            draws[s.tag] = torch.from_numpy(np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
                    keys[k], s.fold), 0), (nc, 256), jnp.float32))
                for k in rows]))
    fr = jax_faults.realize(jplan, state.t, K,
                            None if csize is None else jnp.asarray(rows))
    round_key = jax.random.fold_in(jax.random.PRNGKey(jplan.seed), state.t)

    def dense(fold, normal=False):
        f = jax.random.normal if normal else jax.random.uniform
        return torch.from_numpy(np.asarray(
            f(jax.random.fold_in(round_key, fold), (K,)))[rows])

    def noise(fold=None, dp=False):
        def one(k):
            if fold is not None:
                k = jax.random.fold_in(k, fold)
            if dp:
                k = jax.random.fold_in(k, 7)
            return jax_tm.tree_random_like(k, jnp.zeros((d,), jnp.float64))
        return torch.from_numpy(np.asarray(jax.vmap(one)(fr.keys)))

    folds = {s.tag: s.fold for s in UPLINK_SCHEMAS[algo]}
    for name in names:
        if name == flt.DROP:
            draws[name] = dense(1)
        elif name == flt.STALE:
            draws[name] = dense(2)
        elif name == flt.LATENCY:
            draws[name] = dense(4, normal=jplan.latency_dist == "lognormal")
        elif name == flt.POISON:
            draws[name] = noise()
        elif name.startswith("fault.byz."):
            draws[name] = noise(folds[name.split(".")[-1]])
        elif name.startswith("fault.dp."):
            draws[name] = noise(folds[name.split(".")[-1]], dp=True)
    return draws, fr, rows


def reference_round(jp, algo, plan_kw, gate_kw, channel, csize, **hp_kw):
    """The reference's state after two rounds of ``algo`` under the plan
    (and the gate), its third round's new state and metrics, and what the
    port's round needs to take it on."""
    jplan = JaxFaultPlan(**plan_kw)
    jgate = JaxAsyncConfig(**gate_kw) if gate_kw else None
    extra = KNOBS if algo == "dane" else {}
    jhp = JaxHParams(eta=ETA, local_epochs=L, cohort_size=csize,
                     aa_impl="tree", local_impl="tree",
                     aa=JaxAAConfig(clip_rtol=CLIP), **extra, **hp_kw)
    state = jax_init_state(jp, jax.random.PRNGKey(0), jhp, channel, algo)
    if jplan.stale_rate > 0.0:
        state = state._replace(comm=jax_init_fault_comm(
            state.comm, state.params, K))
    if jgate is not None:
        state = state._replace(comm=jax_init_async_comm(
            state.comm, state.params, K))
    rf = jax.jit(jax_make_round_fn(algo, jp, jhp, channel, faults=jplan,
                                   async_cfg=jgate))
    for _ in range(2):
        state, _ = rf(state)
    new, m = rf(state)
    return state, new, m, jplan


def assert_round_matches(pp, jp, algo, plan_kw, gate_kw, channel, csize,
                         **hp_kw):
    state, ref_new, ref_m, jplan = reference_round(
        jp, algo, plan_kw, gate_kw, channel, csize, **hp_kw)
    extra = KNOBS if algo == "dane" else {}
    hp = AlgoHParams(eta=ETA, local_epochs=L, cohort_size=csize,
                     aa=AAConfig(clip_rtol=CLIP), **extra, **hp_kw)
    ours = make_round_fn(algo, pp, hp, channel, device="cpu",
                         faults=FaultPlan(**plan_kw),
                         async_cfg=AsyncConfig(**gate_kw) if gate_kw else None)
    d = pp.clients.x.shape[-1]
    draws, fr, rows = reference_draws(set(ours.draw_specs), jp, state, jplan,
                                      algo, channel, d, csize)
    assert set(draws) == set(ours.draw_specs), (set(ours.draw_specs), set(draws))
    # the port's realization of these draws is the reference's
    mine = realize(FaultPlan(**plan_kw), {n: v for n, v in draws.items()
                                          if n.startswith("fault.")},
                   torch.from_numpy(rows.astype(np.int64)))
    for f in ("drop", "stale", "byz"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(fr, f)), err_msg=f)
    np.testing.assert_allclose(mine.latency.numpy(), np.asarray(fr.latency),
                               rtol=1e-6)
    start = start_state(state, algo, **hp_kw)
    new, m = ours(start, draws)

    ref_w = np.asarray(ref_new.params)
    w_norm = np.linalg.norm(ref_w)
    dw = np.linalg.norm(new.params.numpy() - ref_w) / w_norm
    assert dw <= 1e-7, dw
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-9)
    for f in ("arrivals", "staleness_mean", "staleness_max"):
        np.testing.assert_array_equal(float(getattr(m, f)),
                                      float(getattr(ref_m, f)), err_msg=f)
    for f in ("c", "c_k", "hist_s", "hist_y"):
        a = getattr(ref_new, f)
        if getattr(new, f) is None or a is None:
            continue
        a = np.asarray(a)
        err = np.abs(getattr(new, f).numpy() - a).max()
        assert err <= 1e-7 * max(w_norm, np.abs(a).max()), (f, err)
    assert sorted(new.comm or {}) == sorted(ref_new.comm or {})
    for tag, bufs in (ref_new.comm or {}).items():
        if tag == ASYNC_AGE_KEY:
            np.testing.assert_array_equal(new.comm[tag].numpy(),
                                          np.asarray(bufs))
            continue
        pairs = ([(tag, new.comm[tag], bufs)] if tag.startswith("__") else
                 [((tag, n), new.comm[tag][n], a) for n, a in bufs.items()])
        for what, got, a in pairs:
            a = np.asarray(a)
            err = np.abs(got.numpy() - a).max()
            assert err <= 1e-7 * max(w_norm, np.abs(a).max()), (what, err)


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_fault_kind_matches_reference(problems, kind):
    jp, pp = problems
    gate = GATE if kind == "latency_gate" else None
    kw = {"carry_history": 2} if kind == "byz_history" else {}
    assert_round_matches(pp, jp, "fedosaa_svrg", KINDS[kind], gate, None,
                         None, **kw)


def test_history_poison_in_a_cohort_matches_reference(problems):
    jp, pp = problems
    assert_round_matches(pp, jp, "fedosaa_svrg", KINDS["byz_history"], None,
                         None, C, carry_history=2)


#: all ten at C=4 of 8; dense, the families whose fault code differs
#: (FedOSAA-SVRG's per-kind cases are dense too)
ALL_KINDS_CASES = ([(a, C) for a in ALGORITHMS]
                   + [(a, None) for a in ("fedosaa_svrg", "scaffold",
                                          "fedosaa_scaffold", "giant",
                                          "dane")])


@pytest.mark.parametrize("algo,csize", ALL_KINDS_CASES,
                         ids=[f"{a}-{'C4' if c else 'dense'}"
                              for a, c in ALL_KINDS_CASES])
def test_all_kinds_at_once_match_reference(problems, algo, csize):
    """Dropout, stale anchors, byzantine noise, DP noise and latencies,
    with the deadline gate (the Newton pair refuses it), on the int8 wire:
    SCAFFOLD's dropped and non-fresh control variates, the Newton
    directions' unanchored uplinks, DANE's delta under the gate."""
    jp, pp = problems
    gate = None if algo in LINE_SEARCH_ALGOS else GATE
    assert_round_matches(pp, jp, algo, MIXED, gate, "int8", csize)


# --------------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------------

def test_fault_draws_keyed_by_global_id_and_plan_seed(port_problem):
    """A cohort round's fault draws are rows idx of the dense round's, the
    byzantine set is the lowest ids, and the plan's seed (not the run's)
    keys the stream."""
    plan = FaultPlan(seed=3, drop_rate=0.4, stale_rate=0.4, byz_clients=3,
                     byz_mode="noise", dp_sigma=1e-3, latency_scale=1.0,
                     latency_dist="pareto", latency_shape=2.0)
    hp = AlgoHParams(eta=ETA, local_epochs=L)
    dense = make_round_fn("fedosaa_svrg", port_problem, hp, "int8",
                          device="cpu", faults=plan)
    coh = make_round_fn("fedosaa_svrg", port_problem,
                        dataclasses.replace(hp, cohort_size=C), "int8",
                        device="cpu", faults=plan)
    other = make_round_fn("fedosaa_svrg", port_problem, hp, "int8", seed=9,
                          device="cpu", faults=plan)
    names = {flt.DROP, flt.STALE, flt.LATENCY, "fault.byz.grad",
             "fault.byz.delta", "fault.dp.grad", "fault.dp.delta"}
    assert names <= set(dense.draw_specs)
    d = port_problem.clients.x.shape[-1]
    assert dense.draw_specs["fault.dp.delta"] == ((K, d), torch.float64)
    assert coh.draw_specs[flt.DROP] == ((C,), torch.float32)
    bufs = [{n: torch.empty((2, *s), dtype=dt)
             for n, (s, dt) in f.draw_specs.items()}
            for f in (dense, coh, other)]
    for f, b in zip((dense, coh, other), bufs):
        f.fill_draws(b, 4)
    bd, bc, bo = bufs
    for i in range(2):
        idx = bc[COHORT][i]
        for n in names:
            assert torch.equal(bc[n][i], bd[n][i][idx]), n
            assert torch.equal(bo[n][i], bd[n][i]), n
        assert bool((bd[flt.LATENCY][i] >= torch.finfo(torch.float32).tiny)
                    .all())
        fr = realize(plan, {n: bc[n][i] for n in names}, idx)
        assert torch.equal(fr.byz, idx < 3)
    for n in names:
        assert not torch.equal(bd[n][0], bd[n][1]), n
    # the codec's uniforms follow the run's seed
    assert not torch.equal(bo["grad"][0], bd["grad"][0])


def test_inactive_plan_is_the_plain_round(port_problem):
    """FaultPlan() builds the plain round: its draws, state and metrics bit
    for bit (the engine's side is in test_torch_robust_engine.py)."""
    hp = AlgoHParams(eta=ETA, local_epochs=L, carry_history=2)
    f0 = make_round_fn("fedosaa_svrg", port_problem, hp, "int8", device="cpu")
    f1 = make_round_fn("fedosaa_svrg", port_problem, hp, "int8", device="cpu",
                       faults=FaultPlan(seed=5))
    assert f0.draw_specs == f1.draw_specs
    s = init_state(port_problem, device="cpu", channel="int8",
                   algo="fedosaa_svrg", hp=hp)
    s0, m0 = f0(s)
    s1, m1 = f1(s)
    for f in ("params", "hist_s", "hist_y"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    for tag in s0.comm:
        for n in s0.comm[tag]:
            assert torch.equal(s0.comm[tag][n], s1.comm[tag][n])
    for a, b in zip(m0, m1):
        assert torch.equal(a, b) or bool(torch.isnan(a) & torch.isnan(b))


# --------------------------------------------------------------------------
# dropout and stale anchors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["fedosaa_svrg", "fedosaa_scaffold"])
def test_dropped_rows_bit_frozen(port_problem, algo):
    """Three int8 rounds at drop 0.5: a dropped client's comm rows (error
    feedback, references), carried columns, c_k and anchor keep their
    pre-round bits; the survivors' move."""
    plan = FaultPlan(seed=1, drop_rate=0.5, stale_rate=0.3)
    kw = {"carry_history": 2} if algo == "fedosaa_svrg" else {}
    hp = AlgoHParams(eta=ETA, local_epochs=L, **kw)
    rf = make_round_fn(algo, port_problem, hp, "int8", device="cpu",
                       faults=plan)
    state = init_state(port_problem, device="cpu", channel="int8", algo=algo,
                       hp=hp)
    state = state._replace(comm=init_fault_comm(state.comm, state.params, K))
    checked = 0
    for t in range(3):
        bufs = {flt.DROP: torch.empty((1, K))}
        rf.fill_draws(bufs, t)
        drop = bufs[flt.DROP][0] < 0.5
        new, _ = rf(state)
        for f in ("c_k", "hist_s", "hist_y"):
            a, b = getattr(state, f), getattr(new, f)
            if a is not None:
                assert torch.equal(a[drop], b[drop]), (t, f)
                assert not torch.equal(a[~drop], b[~drop]), (t, f)
        for tag, bufs_ in new.comm.items():
            for n, b in ([(tag, bufs_)] if tag.startswith("__")
                         else bufs_.items()):
                a = (state.comm[tag] if tag.startswith("__")
                     else state.comm[tag][n])
                assert torch.equal(a[drop], b[drop]), (t, tag, n)
        checked += int(drop.any())
        state = new
    assert checked >= 2


@pytest.mark.parametrize("algo", ["fedosaa_svrg", "scaffold", "giant",
                                  "dane"])
def test_all_dropped_round_keeps_params(port_problem, algo):
    plan = FaultPlan(drop_rate=1.0)
    extra = KNOBS if algo == "dane" else {}
    hp = AlgoHParams(eta=ETA, local_epochs=L, **extra)
    rf = make_round_fn(algo, port_problem, hp, device="cpu", faults=plan)
    state = init_state(port_problem, device="cpu", algo=algo, hp=hp)
    new, m = rf(state)
    assert torch.equal(new.params, state.params)
    assert np.isfinite(float(m.loss))


def test_stale_anchors_refresh_and_compound(port_problem):
    """Round 0's anchors are w^0 for everyone; after round 1 the round-1
    stale clients keep w^0 (two stale draws in a row keep it twice) and the
    fresh ones hold round 1's starting params."""
    plan = FaultPlan(seed=2, stale_rate=0.5)
    hp = AlgoHParams(eta=ETA, local_epochs=L)
    rf = make_round_fn("fedosaa_svrg", port_problem, hp, device="cpu",
                       faults=plan)
    s0 = init_state(port_problem, device="cpu", algo="fedosaa_svrg")
    s0 = s0._replace(comm=init_fault_comm(s0.comm, s0.params, K))
    s1, _ = rf(s0)
    s2, _ = rf(s1)
    bufs = {flt.STALE: torch.empty((2, K))}
    rf.fill_draws(bufs, 0)
    st0, st1 = (bufs[flt.STALE][i] < 0.5 for i in range(2))
    assert st1.any() and (~st1).any()
    a1, a2 = s1.comm[FAULT_ANCHOR_KEY], s2.comm[FAULT_ANCHOR_KEY]
    assert torch.equal(a2[st1], a1[st1])
    assert torch.equal(a2[~st1], s1.params.expand(K, -1)[~st1])
    both = st0 & st1
    assert torch.equal(a2[both], s0.params.expand(K, -1)[both])


def test_stale_round_zero_is_clean(port_problem):
    """Round 0's anchors are all w^0: the re-basing shift is zero and the
    round equals the clean one; later rounds part."""
    hp = AlgoHParams(eta=ETA, local_epochs=L)
    clean = run_federated(port_problem, "fedosaa_svrg", hp, 4, device="cpu")
    stale = run_federated(port_problem, "fedosaa_svrg", hp, 4, device="cpu",
                          faults=FaultPlan(seed=2, stale_rate=0.5))
    np.testing.assert_allclose(clean.loss[:2], stale.loss[:2], rtol=1e-12)
    assert abs(clean.loss[-1] - stale.loss[-1]) > 1e-9


# --------------------------------------------------------------------------
# the acceptance pair, f32 (tests/test_robust.py:389-420)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_problem():
    X, y = make_binary_classification("synthetic_small", n=800, seed=0)
    clients = partition(X, y, K, "iid", seed=0, device="cpu")
    return make_logreg_problem(clients, 1e-3, device="cpu")


HISTORY_1E24 = FaultPlan(byz_clients=1, byz_mode="history", byz_scale=1e24)


def test_clip_defends_history_poison_f32(f32_problem):
    """Past f32's Gram overflow the undefended run goes non-finite; the
    clip_rtol=1e-3 run stays finite and its loss falls."""
    und = run_federated(f32_problem, "fedosaa_svrg",
                        AlgoHParams(eta=0.5, local_epochs=5), 5, device="cpu",
                        faults=HISTORY_1E24)
    dfd = run_federated(f32_problem, "fedosaa_svrg",
                        AlgoHParams(eta=0.5, local_epochs=5,
                                    aa=AAConfig(clip_rtol=1e-3)), 5,
                        device="cpu", faults=HISTORY_1E24)
    assert not np.isfinite(und.loss[-1])
    assert np.isfinite(dfd.loss).all()
    assert dfd.loss[-1] < dfd.loss[0]


def test_int8_sanitizes_undefended_history_poison_f32(f32_problem):
    h = run_federated(f32_problem, "fedosaa_svrg",
                      AlgoHParams(eta=0.5, local_epochs=5), 5, device="cpu",
                      faults=HISTORY_1E24, channel="int8")
    assert np.isfinite(h.loss).all()


def test_int8_codes_of_nan_and_inf_match_reference():
    """A NaN value's code is 0 (XLA's conversion; its chunk's scale is 1),
    a chunk holding ±Inf has scale Inf and all-zero codes (Inf/Inf is
    NaN): the plain version gives the reference's codes and scales, and
    the kernel is held to the plain version bit for bit on the card."""
    from repro.kernels.quant.ref import quantize_ref as jax_quantize_ref
    from repro_torch.kernels.quant import quantize_ref
    x = torch.tensor([[[float("nan"), 1.0, -2.0, 0.5],
                       [float("inf"), 3.0, -1.0, 0.0],
                       [-float("inf"), 1.0, 2.0, 3.0]]])
    u = torch.rand((1, 3, 4), generator=torch.Generator().manual_seed(0))
    q, s = quantize_ref(x, u)
    qj, sj = jax_quantize_ref(jnp.asarray(x[0].numpy()), jnp.asarray(u[0].numpy()))
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(sj))
    assert int(q[0, 0, 0]) == 0 and float(s[0, 0, 0]) == 1.0
    assert not q[0, 1:].any() and torch.isinf(s[0, 1:]).all()


def test_post_addend_matches_the_composition():
    """The int8 uplink's ``post`` operand: the fused plain version equals
    Codec.uplink's arithmetic around the roundtrip, with the addend joining
    the decoded value before the residual; without it, the call is the
    one without the operand."""
    from repro_torch.comm.codecs import Codec, Int8SRCodec
    from repro_torch.kernels.quant import int8_sr_uplink
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 300), generator=g, dtype=torch.float64)
    anchor = torch.randn((300,), generator=g, dtype=torch.float64)
    ref, ef, post = (0.1 * torch.randn((5, 300), generator=g,
                                       dtype=torch.float64) for _ in range(3))
    u = torch.rand((5, 2, 256), generator=g)
    codec = Int8SRCodec()
    for bufs in (dict(ref=ref, ef=ef), dict(anchor=anchor, ef=ef), dict(ef=ef)):
        fused = int8_sr_uplink(x, u, post=post, **bufs)
        comp = Codec.uplink(codec, x, u, post=post, **bufs)
        plain = int8_sr_uplink(x, u, **bufs)
        for a, b in zip(fused, comp):
            assert (a is None and b is None) or torch.equal(a, b)
        assert not torch.equal(fused[0], plain[0])
        torch.testing.assert_close(fused[1], plain[1] - post, rtol=0,
                                   atol=1e-15)


def test_f64_undefended_history_stays_finite_as_the_f64_reference(problems):
    """The contract finding behind chip_smoke.py's history gate: the
    reference's undefended run dies of its f32 Gram accumulation
    overflowing at 1e24, not of the attack itself. With f64 accumulation
    (the port's, and the reference's under ``ref64``) the Gram stays finite
    (~1e46), the relative Tikhonov term swamps the honest columns, and both
    runs stay finite and fall, their losses within 1e-3 (the solve over a
    Gram holding a ~1e46 column amplifies the two eigen-solvers' last-ulp
    differences to ~1e-4 of the loss)."""
    jp, pp = problems
    plan = dict(byz_clients=1, byz_mode="history", byz_scale=1e24)
    ref = jax_run_federated(jp, "fedosaa_svrg",
                            JaxHParams(eta=0.5, local_epochs=5,
                                       aa_impl="tree", local_impl="tree"), 5,
                            rng=0, faults=JaxFaultPlan(**plan))
    ours = run_federated(pp, "fedosaa_svrg",
                         AlgoHParams(eta=0.5, local_epochs=5), 5,
                         device="cpu", faults=FaultPlan(**plan))
    assert np.isfinite(ref.loss).all() and np.isfinite(ours.loss).all()
    assert ours.loss[-1] < ours.loss[0]
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-3)
