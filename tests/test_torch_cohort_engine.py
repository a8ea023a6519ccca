"""The engine (core/engine.py) under cohorts, and run_federated's cohort-facing
API, on the CPU.

The chunk body runs eagerly here; it must equal the per-round loop bit for
bit under cohorts as it does on the dense round (tests/test_torch_engine.py):
the rows, the final params and the whole K-sized store (c_k, the carried
AA columns, the comm buffers), with the cohort a draw the engine fills
before each chunk. At the reference's cohort size (synthetic_small, n=800,
K=8 ``imbalance``, L=3, f64), C=4, 7 rounds in chunks of 3.

Also the API the reference's callers read (``History.comm_floats``,
``AAConfig.min_history``, the header's ``cohort_size``), the cohort's
profiler scopes, and the chunk's select passing an untouched field by
identity.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import anderson as jax_anderson
from repro.core import server as jax_server
from repro_torch.core import (AAConfig, AlgoHParams, RoundMetrics,
                              ServerState, comm_bytes_per_round, init_state,
                              make_chunk_runner, make_round_fn,
                              multisecant_update, run_federated, run_rounds)
from repro_torch.core.algorithms import COHORT
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.obs import MemorySink

from test_torch_engine import assert_same_state, loop_and_engine

K, C, L = 8, 4, 3
HP = AlgoHParams(eta=0.5, local_epochs=L, cohort_size=C)
#: (name, algorithm, knobs, channel): the engine = loop cases
COHORT_CASES = [
    ("fedosaa_svrg_int8", "fedosaa_svrg", {}, "int8"),
    ("fedosaa_scaffold", "fedosaa_scaffold", {}, None),
    ("fedosaa_svrg_carry2", "fedosaa_svrg", {"carry_history": 2}, None),
    ("fedosaa_svrg_minibatch", "fedosaa_svrg", {"batch_size": 16}, None),
    ("giant", "giant", {}, None),
    ("fedosaa_scaffold_p0.5_int8", "fedosaa_scaffold",
     {"cohort_size": None, "participation": 0.5}, "int8"),
]


@pytest.fixture(scope="module")
def setup():
    X, y = make_binary_classification("synthetic_small", n=800, seed=0)
    clients = partition(X, y, K, "imbalance", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")
    # any fixed w* exercises the rows' rel-error column: the comparisons
    # here are engine against loop, not against the optimum (which
    # solve_reference's Hessian-vector products take seconds to reach)
    d = clients.x.shape[-1]
    return prob, torch.linspace(-1.0, 1.0, d, dtype=torch.float64)


def cohorts_of(rf, t0, rounds):
    """The cohort of each round t0 .. t0 + rounds − 1, as the engine fills
    them."""
    bufs = {COHORT: torch.empty((rounds, *rf.draw_specs[COHORT][0]),
                                dtype=torch.int64)}
    rf.fill_draws(bufs, t0)
    return [set(b.tolist()) for b in bufs[COHORT]]


@pytest.mark.parametrize("name,algo,knobs,channel", COHORT_CASES,
                         ids=[c[0] for c in COHORT_CASES])
def test_cohort_engine_equals_the_loop(setup, name, algo, knobs, channel):
    """Rows, final params and the whole store bit for bit, 7 rounds in
    chunks of 3 (the last one short); the rows of clients no round drew
    keep their initial bits."""
    prob, w_star = setup
    hp = dataclasses.replace(HP, **knobs)
    loop_and_engine(prob, w_star, algo, 7, 3, hp=hp, channel=channel)
    assert_same_state(prob, w_star, algo, channel, 3, hp=hp)
    rf = make_round_fn(algo, prob, hp, channel, device="cpu")
    s0 = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    state, _ = run_rounds(rf, s0, 7, chunk=3)
    never = sorted(set(range(K)) - set().union(*cohorts_of(rf, 0, 7)))
    store = [(f, getattr(s0, f), getattr(state, f))
             for f in ("c_k", "hist_s", "hist_y")]
    store += [(f"{tag}/{n}", b, state.comm[tag][n])
              for tag, sub in (s0.comm or {}).items() for n, b in sub.items()]
    for what, a, b in store:
        if a is not None:
            assert torch.equal(a[never], b[never]), what


def test_participation_header_and_rows(setup):
    """participation=0.5 reports cohort_size 4 in the header and a cohort's
    effective sample size in each row; the dense run reports None."""
    prob, w_star = setup
    for hp, want in ((AlgoHParams(eta=0.5, local_epochs=L,
                                  participation=0.5), C),
                     (AlgoHParams(eta=0.5, local_epochs=L), None)):
        sink = MemorySink()
        h = run_federated(prob, "fedosaa_svrg", hp, 3, w_star=w_star,
                          device="cpu", chunk=2, sinks=[sink])
        assert sink.header["cohort_size"] == want
        assert len(h.rounds) == 3
        ess = [r["cohort_ess"] for r in sink.rows]
        assert all(1.0 <= e <= (want or K) for e in ess)


def test_history_comm_floats_is_the_reference_property(setup):
    """The reference's History.comm_floats, called on the port's History,
    is the port's: bytes / 4 (the paper's Table 1 unit), as
    benchmarks/common.py reads it."""
    prob, w_star = setup
    h = run_federated(prob, "fedosaa_svrg", HP, 3, w_star=w_star,
                      device="cpu", channel="int8")
    ref = jax_server.History.comm_floats.fget(h)
    np.testing.assert_array_equal(h.comm_floats, ref)
    np.testing.assert_array_equal(h.comm_floats, h.comm_bytes / 4.0)
    per_round = comm_bytes_per_round("fedosaa_svrg", h.final_params, "int8")
    assert float(h.comm_floats[-1]) == 3 * per_round / 4


def test_aa_config_takes_min_history():
    """AAConfig(min_history=...) in the reference's field order; read
    nowhere, as in the reference: the step is unchanged."""
    fields = [f.name for f in dataclasses.fields(AAConfig)]
    ref_fields = [f.name for f in dataclasses.fields(jax_anderson.AAConfig)]
    assert fields == ref_fields
    assert AAConfig().min_history == jax_anderson.AAConfig().min_history == 1
    cfg = AAConfig(min_history=3, tikhonov=1e-8)
    assert cfg.min_history == 3
    rng = np.random.default_rng(0)
    w, g = (torch.from_numpy(rng.standard_normal(6)) for _ in range(2))
    s, y = (torch.from_numpy(rng.standard_normal((2, 4, 6))) for _ in range(2))
    a, _ = multisecant_update(w, g, s, y, 0.5, cfg)
    b, _ = multisecant_update(w, g, s, y, 0.5, AAConfig(tikhonov=1e-8))
    assert torch.equal(a, b)


def test_cohort_round_has_the_reference_scopes(setup):
    """A C < K round runs its draw, gather and scatter inside the
    reference's profiler scopes (obs/profiling.py attributes time by
    them); the dense round has none of them."""
    prob, _ = setup
    scopes = {"fl.cohort_plan", "fl.cohort_gather", "fl.scatter"}
    for hp, want in ((HP, scopes), (dataclasses.replace(HP, cohort_size=None),
                                    set())):
        rf = make_round_fn("fedosaa_svrg", prob, hp, "int8", device="cpu")
        state = init_state(prob, device="cpu", channel="int8",
                           algo="fedosaa_svrg")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rf(state)
        names = {e.name for e in prof.events()}
        assert scopes & names == want
        assert "fl.uplink" in names


def test_chunk_select_passes_untouched_fields_by_identity():
    """A state tensor a round returns as the same object (a store field it
    never advanced) leaves the chunk as that object: the select makes no
    torch.where over it (the reference's tree_where)."""
    store = torch.ones(5, 3)
    state = ServerState(torch.zeros(3), 0, {"g": {"ef": store}})
    zero = torch.tensor(0.0)

    def round_fn(s, draws=None):
        return (s._replace(params=s.params + 1.0, t=s.t + 1),
                RoundMetrics(*([zero] * len(RoundMetrics._fields))))

    round_fn.draw_specs, round_fn.fill_draws = {}, lambda bufs, t0: None
    out, _, _ = make_chunk_runner(round_fn, 3)._body(state, torch.tensor(2),
                                                     {})
    assert out.comm["g"]["ef"] is store
    assert torch.equal(out.params, torch.full((3,), 2.0))
