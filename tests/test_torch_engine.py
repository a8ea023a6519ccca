"""The port's chunked round engine (core/engine.py) on the CPU, where the
chunk body runs eagerly: against the port's own per-round loop bit for bit,
and against the JAX package's engine (repro/core/engine.py).

The engine's contract is the reference's (tests/test_engine.py): the rows
and the final state of a chunked run are the loop's, with stops that fire
mid-chunk ending on the loop's round. The port holds it exactly: both
paths run the same torch ops on the same values (the chunk body selects
the carried state with torch.where, which copies bits), and a stochastic
codec's uniforms come from the same generator calls. Against the JAX
engine, f64 with the reference's f64 helpers patched in (as in
tests/test_torch_round.py): FedSVRG's rows within rtol 1e-9; FedOSAA-SVRG,
whose ill-conditioned AA Gram solve amplifies summation order, by its
stopping round and its first row within 1e-7.

The launch counters' replay logic (kernels/_build.py) is tested here too,
with the capture flag mocked: no card is needed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import run_federated as jax_run_federated
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.core import (NEWTON_ALGOS, TRAJECTORY_ALGOS, AlgoHParams,
                              convert, engine, init_state, make_chunk_runner,
                              make_round_fn, run_federated, run_rounds,
                              solve_reference)
from repro_torch.kernels import _build
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.obs import ROW_FIELDS, AlarmMonitor, MemorySink

from torch_threads import one_torch_thread  # noqa: F401

HP = AlgoHParams(eta=0.5, local_epochs=3)


def trajectory_cases(algos):
    return [(a, ch, c) for a in algos for ch in (None, "int8")
            for c in (1, 3, 4, 16)]


#: the (algorithm, channel, chunk) cases of the engine's parity test
#: (test_chunked_run_equals_the_loop), in three files of similar time: the
#: trajectory family at every chunk, FedSVRG, FedOSAA-SVRG, L-BFGS and
#: FedAvg in test_torch_engine_family_svrg.py, SCAFFOLD, FedOSAA-SCAFFOLD
#: and FedOSAA-AVG in test_torch_engine_family_scaffold.py; the Newton
#: family and GIANT with the line search at a chunk of 3 (a short last
#: chunk), their rounds' eager Hessian-vector products being the CPU's
#: slowest, and two of them on the topk and bf16 wires, in
#: test_torch_engine_family_newton.py. DANE takes 2 Newton steps of 5 CG
#: iterations (as the reference's tests/test_algorithms.py runs it).
SVRG_CASES = trajectory_cases(("fedsvrg", "fedosaa_svrg", "lbfgs", "fedavg"))
SCAFFOLD_CASES = trajectory_cases(("scaffold", "fedosaa_scaffold",
                                   "fedosaa_avg"))
NEWTON_CASES = ([(a, ch, 3) for a in NEWTON_ALGOS + ("giant+line_search",)
                 for ch in (None, "int8")]
                + [("giant", "topk:0.05", 3), ("newton_gmres", "bf16", 3)])
ENGINE_CASES = SVRG_CASES + SCAFFOLD_CASES + NEWTON_CASES
CASE_HP = {"dane": dataclasses.replace(HP, dane_newton_iters=2,
                                       dane_cg_iters=5),
           "giant+line_search": dataclasses.replace(HP, line_search=True)}
#: History columns compared bit for bit (wall times are the paths' own)
HISTORY_FIELDS = ("rounds", "loss", "grad_norm", "rel_error", "theta_mean",
                  "comm_bytes", "gram_cond_max", "arrivals", "staleness_mean",
                  "staleness_max")


@pytest.fixture(scope="module")
def setup():
    """synthetic_small, n=400, K=8 iid, gamma=1e-3, f64: the reference's
    arrays in both packages (``jax`` is the reference's problem)."""
    X, y = jax_make("synthetic_small", n=400, seed=0)
    jc = jax_partition(X, y, 8, "iid", seed=0)
    clients = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight,
                                      device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")
    return prob, solve_reference(prob, iters=50), jc


def assert_same_history(h0, h1):
    assert len(h0.rounds) == len(h1.rounds)
    for f in HISTORY_FIELDS:
        np.testing.assert_array_equal(getattr(h1, f), getattr(h0, f),
                                      err_msg=f)
    assert torch.equal(h1.final_params, h0.final_params)


def assert_same_rows(s0, s1):
    """The same sink rows but for the wall times."""
    assert len(s0.rows) == len(s1.rows)
    for r0, r1 in zip(s0.rows, s1.rows):
        for f in ("round",) + ROW_FIELDS[:-2]:
            np.testing.assert_array_equal(r1[f], r0[f], err_msg=f)
    assert s0.footer == s1.footer


def loop_and_engine(prob, w_star, algo, rounds, chunk, hp=HP, **kw):
    s0, s1 = MemorySink(), MemorySink()
    h0 = run_federated(prob, algo, hp, rounds, w_star=w_star, device="cpu",
                       sinks=[s0], **kw)
    h1 = run_federated(prob, algo, hp, rounds, w_star=w_star, device="cpu",
                       chunk=chunk, sinks=[s1], **kw)
    assert_same_history(h0, h1)
    assert_same_rows(s0, s1)
    return h0, h1


def assert_same_state(prob, w_star, algo, channel, chunk, hp=HP, rounds=7):
    """The carried state of ``rounds`` rounds by the loop and by the engine:
    the params, the comm buffers, the control variates and the carried AA
    columns, bit for bit, each where the algorithm carries it."""
    rf = make_round_fn(algo, prob, hp, channel, device="cpu")
    s_loop = init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp)
    for _ in range(rounds):
        s_loop, _ = rf(s_loop)
    s_eng, trace = run_rounds(
        rf, init_state(prob, device="cpu", channel=channel, algo=algo, hp=hp),
        rounds, chunk=chunk, w_star=w_star)
    assert trace.num_rounds == rounds and s_eng.t == s_loop.t == rounds
    for f in ("params", "c", "c_k", "hist_s", "hist_y"):
        a, b = getattr(s_loop, f), getattr(s_eng, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    assert (s_loop.c is not None) == (algo in ("scaffold", "fedosaa_scaffold"))
    assert (s_loop.hist_s is not None) == (hp.carry_history > 0)
    assert sorted(s_eng.comm or {}) == sorted(s_loop.comm or {})
    for tag, bufs in (s_loop.comm or {}).items():
        assert sorted(s_eng.comm[tag]) == sorted(bufs)
        for name, buf in bufs.items():
            assert torch.equal(s_eng.comm[tag][name], buf), (tag, name)


def check_chunked_run(setup, algo, channel, chunk):
    """test_chunked_run_equals_the_loop's case: every History row, the
    final params and the carried state (the int8 comm buffers, SCAFFOLD's
    control variates), bit for bit, over 7 rounds of ``algo`` (or GIANT
    with the line search): chunks of 1, of 3 and of 4 (the last chunk
    short) and one chunk longer than the run."""
    prob, w_star, _ = setup
    hp = CASE_HP.get(algo, HP)
    algo = algo.split("+")[0]
    loop_and_engine(prob, w_star, algo, 7, chunk, hp=hp, channel=channel)
    assert_same_state(prob, w_star, algo, channel, chunk, hp=hp)


def test_engine_cases_cover_every_algorithm():
    """The three files of test_chunked_run_equals_the_loop run every
    algorithm, each case once."""
    assert len(set(ENGINE_CASES)) == len(ENGINE_CASES) == 66
    assert ({a.split("+")[0] for a, _, _ in ENGINE_CASES}
            == set(TRAJECTORY_ALGOS + NEWTON_ALGOS))


@pytest.mark.parametrize("knob,algo,channel", [
    *[("minibatch", a, None) for a in TRAJECTORY_ALGOS],
    ("minibatch", "fedosaa_scaffold", "int8"),
    ("carry", "fedosaa_svrg", None), ("carry", "fedosaa_svrg", "int8"),
    ("carry", "fedsvrg", None)])
def test_minibatch_and_carried_history_equal_the_loop(setup, knob, algo,
                                                      channel):
    """Minibatch rounds (the rows drawn per round are a draw the engine
    fills before each chunk, as the int8 uniforms) and carried AA history
    (state the chunk carries): rows, final params and state, bit for bit,
    7 rounds in chunks of 3."""
    prob, w_star, _ = setup
    hp = dataclasses.replace(HP, **({"batch_size": 16} if knob == "minibatch"
                                    else {"carry_history": 2}))
    loop_and_engine(prob, w_star, algo, 7, 3, hp=hp, channel=channel)
    assert_same_state(prob, w_star, algo, channel, 3, hp=hp)


def test_rel_error_stop_mid_chunk(setup):
    prob, w_star, _ = setup
    h0, h1 = loop_and_engine(prob, w_star, "fedosaa_svrg", 30, 7,
                             stop_rel_error=0.09)
    assert len(h0.rounds) < 30 and len(h0.rounds) % 7 != 0
    assert h0.rel_error[-1] < 0.09 <= h0.rel_error[-2]


def test_grad_norm_stop_mid_chunk(setup):
    prob, w_star, _ = setup
    h0, h1 = loop_and_engine(prob, w_star, "fedsvrg", 30, 8,
                             stop_grad_norm=0.0555)
    assert len(h0.rounds) < 30 and len(h0.rounds) % 8 != 0
    assert h0.grad_norm[-1] < 0.0555 <= h0.grad_norm[-2]


def test_partial_final_chunk(setup):
    """5 rounds in chunks of 4: the short last chunk runs one live slot and
    drops the others' rows."""
    prob, w_star, _ = setup
    _, h = loop_and_engine(prob, w_star, "fedosaa_svrg", 5, 4,
                           channel="int8")
    assert len(h.rounds) == 5


def test_rejects_bad_chunk(setup):
    prob, _, _ = setup
    rf = make_round_fn("fedsvrg", prob, HP, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        make_chunk_runner(rf, 0)
    with pytest.raises(ValueError, match="chunk"):
        run_federated(prob, "fedsvrg", HP, 2, chunk=0, device="cpu")


def test_exactly_one_read_per_chunk(setup, monkeypatch):
    """The chunk's readout is the only device→host read, sinks attached."""
    prob, w_star, _ = setup
    reads = []
    fetch = engine._fetch

    def counting(readout):
        reads.append(tuple(readout.shape))
        return fetch(readout)

    monkeypatch.setattr(engine, "_fetch", counting)
    rf = make_round_fn("fedosaa_svrg", prob, HP, "int8", device="cpu")
    state = init_state(prob, device="cpu", channel="int8", algo="fedosaa_svrg")
    sink = MemorySink()
    _, trace = run_rounds(rf, state, 8, chunk=4, w_star=w_star,
                          sinks=[sink, AlarmMonitor()])
    assert trace.num_rounds == 8 and len(sink.rows) == 8
    width = len(engine.DEVICE_FIELDS) + 3
    assert reads == [(4, width), (4, width)]


def test_row_indices_contiguous_and_offset(setup):
    prob, w_star, _ = setup
    rf = make_round_fn("fedosaa_svrg", prob, HP, device="cpu")
    sink = MemorySink()
    run_rounds(rf, init_state(prob, device="cpu"), 5, chunk=2, w_star=w_star,
               sinks=[sink])
    assert [r["round"] for r in sink.rows] == [0, 1, 2, 3, 4]
    for f in ("comm_bytes_total", "wall_time_s"):
        col = [r[f] for r in sink.rows]
        assert all(b >= a for a, b in zip(col, col[1:])), f
    assert sink.header["fields"] == list(ROW_FIELDS)
    assert sink.footer["rounds"] == 5 and sink.footer["stopped"] is False
    sink = MemorySink()
    run_rounds(rf, init_state(prob, device="cpu"), 3, chunk=2, w_star=w_star,
               sinks=[sink], start_round=10)
    assert [r["round"] for r in sink.rows] == [10, 11, 12]
    assert sink.header["start_round"] == 10


def test_runner_continues_across_calls(setup):
    """The raw runner: the second call starts from the first's state (t
    advanced by the live rounds), and a short chunk's dead slots leave the
    state as the live ones left it."""
    prob, w_star, _ = setup
    rf = make_round_fn("fedosaa_svrg", prob, HP, device="cpu")
    runner = make_chunk_runner(rf, 3, w_star=w_star)
    state, done, ms, rels, live = runner(init_state(prob, device="cpu"), 3)
    assert state.t == 3 and not done and live.all()
    state2, _, ms2, _, live2 = runner(state, 2)
    assert state2.t == 5 and live2.tolist() == [True, True, False]
    assert ms2["loss"][0] < ms["loss"][0]
    s = init_state(prob, device="cpu")
    for _ in range(5):
        s, _ = rf(s)
    assert torch.equal(state2.params, s.params)


def test_stop_alarm_halts_at_chunk_boundary(setup):
    from repro_torch.obs import AlarmRule
    prob, w_star, _ = setup
    rf = make_round_fn("fedosaa_svrg", prob, HP, device="cpu")
    mon = AlarmMonitor(rules=(AlarmRule("tripwire", "loss", "gt",
                                        threshold=-1e30, action="stop"),))
    sink = MemorySink()
    _, trace = run_rounds(rf, init_state(prob, device="cpu"), 8, chunk=2,
                          w_star=w_star, sinks=[sink, mon])
    assert trace.num_rounds == 2 and trace.stopped
    assert sink.footer["stopped"] is True and sink.footer["rounds"] == 2
    assert any(e["rule"] == "tripwire" for e in sink.footer["alarms"])


# --------------------------------------------------------------------------
# against the JAX package's engine
# --------------------------------------------------------------------------

@pytest.fixture
def ref_f64(monkeypatch):
    """The reference with x64 on and its f64-accumulating helpers (see
    tests/test_torch_round.py)."""
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
    monkeypatch.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
    monkeypatch.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
    monkeypatch.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def both_engines(setup, algo, rounds, **kw):
    prob, w_star, jc = setup
    jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
    ref = jax_run_federated(
        jp, algo, JaxHParams(eta=0.5, local_epochs=3, aa_impl="tree",
                             local_impl="tree"),
        rounds, w_star=jnp.asarray(w_star.numpy()), chunk=4, **kw)
    ours = run_federated(prob, algo, HP, rounds, w_star=w_star, chunk=4,
                         device="cpu", **kw)
    return ref, ours


def test_fedsvrg_rows_match_the_jax_engine(setup, ref_f64):
    ref, ours = both_engines(setup, "fedsvrg", 6)
    assert len(ours.rounds) == len(ref.rounds) == 6
    for f in ("loss", "grad_norm", "rel_error", "comm_bytes"):
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=1e-9, err_msg=f)
    for f in ("theta_mean", "gram_cond_max", "arrivals"):
        assert np.isnan(getattr(ours, f)).all() and np.isnan(getattr(ref, f)).all()
    np.testing.assert_allclose(ours.final_params.numpy(),
                               np.asarray(ref.final_params), rtol=1e-9)


def test_fedosaa_stops_with_the_jax_engine(setup, ref_f64):
    ref, ours = both_engines(setup, "fedosaa_svrg", 30, stop_rel_error=0.09)
    assert len(ours.rounds) == len(ref.rounds) < 30
    for f in ("loss", "grad_norm", "rel_error", "theta_mean",
              "gram_cond_max", "comm_bytes"):
        np.testing.assert_allclose(getattr(ours, f)[0], getattr(ref, f)[0],
                                   rtol=1e-7, err_msg=f)


# --------------------------------------------------------------------------
# the launch counters under CUDA graph capture (kernels/_build.py)
# --------------------------------------------------------------------------

@pytest.fixture
def fake_launches(monkeypatch):
    """``_build.launch`` with the C call stubbed out and the capture flag
    under the test's control; the counters restored after."""
    saved = dict(_build.LAUNCHES), {k: dict(v) for k, v in
                                     _build.DESIGN_LAUNCHES.items()}
    capturing = [False]
    monkeypatch.setattr(_build, "_call", lambda *a: None)
    monkeypatch.setattr(_build, "_capturing", lambda: capturing[0])
    _build.reset_launches()
    yield capturing
    _build.LAUNCHES.update(saved[0])
    for k, v in saved[1].items():
        _build.DESIGN_LAUNCHES[k].update(v)


def test_capture_tallies_into_the_record_and_replays_add_it(fake_launches):
    capturing = fake_launches
    _build.launch("gram", "repro_gram")
    assert _build.LAUNCHES["gram"] == 1
    capturing[0] = True
    with _build.recording() as record:
        for _ in range(3):          # a chunk of three rounds
            _build.launch("trajectory", "repro_trajectory", design="resident")
            _build.launch("gram", "repro_gram")
            _build.launch("aa_step", "repro_aa_step")
        _build.launch("int8_uplink", "repro_int8_uplink")
    capturing[0] = False
    # nothing reached the card at capture
    assert _build.LAUNCHES["gram"] == 1 and _build.LAUNCHES["trajectory"] == 0
    assert record.launches == {"trajectory": 3, "gram": 3, "aa_step": 3,
                               "int8_uplink": 1}
    assert record.designs == {"trajectory": {"resident": 3}}
    for _ in range(2):
        _build.count_replay(record)
    assert _build.LAUNCHES["trajectory"] == 6 and _build.LAUNCHES["gram"] == 7
    assert _build.LAUNCHES["int8_uplink"] == 2
    assert _build.DESIGN_LAUNCHES["trajectory"] == {"resident": 6,
                                                    "streaming": 0}


def test_launch_under_capture_outside_a_record_raises(fake_launches):
    capturing = fake_launches
    capturing[0] = True
    with pytest.raises(RuntimeError, match="uncounted"):
        _build.launch("gram", "repro_gram")
    assert _build.LAUNCHES["gram"] == 0


def test_records_nest_and_count_apart(fake_launches):
    """Set-up work recorded apart (the engine's warm-up round) stays out of
    LAUNCHES, and an inner record does not leak into the outer one."""
    with _build.recording() as outer:
        _build.launch("gram", "repro_gram")
        with _build.recording() as inner:
            _build.launch("aa_step", "repro_aa_step")
        _build.launch("gram", "repro_gram")
    assert outer.launches == {"gram": 2} and inner.launches == {"aa_step": 1}
    assert all(v == 0 for v in _build.LAUNCHES.values())
