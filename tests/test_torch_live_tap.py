"""The live tap (repro_torch/obs/sinks.py::LiveTap) through
make_chunk_runner, run_rounds and run_federated on the CPU, against the
JAX package's (repro/obs/sinks.py::LiveTap, compiled into its chunk by
``jax.debug.callback``).

The reference's contract (tests/test_obs.py::TestLiveTap): a chunk of 4
with 3 live slots gives tap rows for slots [0, 1, 2] only, each equal to
the same run's stacked metrics, and the tapped chunk matches the tapless
one at rtol 1e-6 (its callback moves XLA's fusion by an ulp). The port has
no compiler to move an ulp, so it holds the tapped chunk to the tapless
one bit for bit. Against the reference, f64 with its f64 helpers
(tests/test_torch_engine.py's ``ref_f64`` and ``both_engines``' setup):
FedSVRG's tap rows within rtol 1e-9, FedOSAA-SVRG's first row within 1e-7
(its ill-conditioned AA solve amplifies summation order), the same slots
on both sides and the same printed lines.

On the card the chunk copies each slot's readout row into pinned memory
and a host node of its CUDA graph hands it to the tap; here that path's
row assembly runs with the host nodes deferred to after the chunk, as a
replay runs them (test_card_rows_equal_the_eager_rows). The card itself
runs it in tests/test_torch_cuda.py (``-m cuda``) and chip_smoke.py's
phase 4h. The sharded runtime's rank-0 tap is held in
tests/test_torch_sharded_ranks.py's world of 2.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import LiveTap as RefLiveTap
from repro_torch.core import (engine, init_state, make_chunk_runner,
                              make_round_fn, run_federated, run_rounds)
from repro_torch.core.algorithms import RoundMetrics
from repro_torch.kernels import _build
from repro_torch.obs import LiveTap, MemorySink
from test_torch_engine import HP, ref_f64, setup  # noqa: F401

from torch_threads import one_torch_thread  # noqa: F401

#: the tap row's fields: RoundMetrics', the slot and the rel-error
ROW_KEYS = set(RoundMetrics._fields) | {"slot", "rel_error"}


def runner_pair(setup, algo="fedosaa_svrg", channel=None, chunk=4):
    """A round function, its start state and a tapless and a tapped runner
    of ``chunk`` slots."""
    prob, w_star, _ = setup
    rf = make_round_fn(algo, prob, HP, channel, device="cpu")
    state = init_state(prob, device="cpu", channel=channel, algo=algo)
    tap = LiveTap()
    return (rf, state, make_chunk_runner(rf, chunk, w_star=w_star),
            make_chunk_runner(rf, chunk, w_star=w_star, tap=tap), tap)


def assert_rows_are_the_readout(rows, metrics, rel, live):
    """Every row equals its slot of the chunk's readout bit for bit (nan
    where nan), and the rows are the live slots in order."""
    assert [r["slot"] for r in rows] == np.flatnonzero(live).tolist()
    for r in rows:
        assert set(r) == ROW_KEYS
        i = r["slot"]
        assert isinstance(i, int)
        for f in RoundMetrics._fields:
            np.testing.assert_array_equal(r[f], metrics[f][i], err_msg=f)
        np.testing.assert_array_equal(r["rel_error"], rel[i])


def assert_same_chunk(a, b):
    """Two runner calls' outputs: the state's tensors, done, every metric
    column, rel and live, bit for bit."""
    (sa, da, ma, ra, la), (sb, db, mb, rb, lb) = a, b
    assert sa.t == sb.t and da == db
    ta, tb = engine._tensors(sa), engine._tensors(sb)
    assert len(ta) == len(tb)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert sorted(ma) == sorted(mb)
    for f in ma:
        np.testing.assert_array_equal(mb[f], ma[f], err_msg=f)
    np.testing.assert_array_equal(rb, ra)
    np.testing.assert_array_equal(lb, la)


# --------------------------------------------------------------------------
# the reference's contract on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channel", [None, "int8"])
def test_tap_rows_are_the_readout_and_the_chunk_is_the_tapless_one(setup,
                                                                   channel):
    """Chunk 4, 3 live slots: rows for slots [0, 1, 2] only, each equal to
    that run's readout bit for bit (the host field comm_bytes included);
    the tapped chunk's state and readout equal the tapless chunk's."""
    rf, state, plain, tapped, tap = runner_pair(setup, channel=channel)
    want = plain(state, 3)
    got = tapped(state, 3)
    assert_same_chunk(want, got)
    _, _, metrics, rel, live = got
    assert live.tolist() == [True, True, True, False]
    assert [r["slot"] for r in tap.rows] == [0, 1, 2]
    assert_rows_are_the_readout(tap.rows, metrics, rel, live)
    assert tap.rows[0]["comm_bytes"] > 0


@pytest.mark.parametrize("channel", [None, "int8"])
def test_card_rows_equal_the_eager_rows(setup, monkeypatch, channel):
    """The card's path of the tap, without a card: the chunk body with
    ``_tap_node`` (each slot's readout row copied into a host buffer, then
    a host node), the host nodes deferred until the chunk has run, as a
    replay runs them, each called through the ctypes trampoline
    (``_build.HOST_FN``: slot 0's data arrives as NULL). Every slot, the
    non-live one too, reaches the tap as floats equal to its readout row
    (the host metrics from the capture's host list); the LiveTap's rows
    are the eager tap's, bit for bit."""
    rf, state, _, eager_runner, eager_tap = runner_pair(setup, channel=channel)
    eager = eager_runner(state, 3)
    seen, tap = [], LiveTap()

    def record(*args):
        seen.append(args)
        tap(*args)

    nodes = []
    monkeypatch.setattr(_build, "host_node",
                        lambda fn, data: nodes.append((fn, data)))
    card = make_chunk_runner(rf, 4, w_star=setup[1], tap=record)
    card._tap_host = torch.full((4, len(card.device_fields) + 3), torch.nan,
                                dtype=torch.float64)
    card._tap_rows = card._tap_host.numpy()
    card._tap_fn = _build.HOST_FN(card._host_tap)
    draws = card._draw_buffers("cpu")
    rf.fill_draws(draws, state.t)
    _, readout, card.host = card._body(state, torch.tensor(3), draws,
                                       card._tap_node)
    assert [d for _, d in nodes] == [0, 1, 2, 3] and seen == []
    for fn, data in nodes:
        fn(data)
    assert card.tap_error is None
    torch.testing.assert_close(card._tap_host, readout, rtol=0, atol=0,
                               equal_nan=True)
    metrics, rel = eager[2], eager[3]
    assert [(i, live) for i, _, _, live in seen] == [
        (0, True), (1, True), (2, True), (3, False)]
    for i, m, r, _ in seen:
        for f in RoundMetrics._fields:
            assert type(getattr(m, f)) is float, f
            np.testing.assert_array_equal(getattr(m, f), metrics[f][i],
                                          err_msg=f)
        np.testing.assert_array_equal(r, rel[i])
    assert_rows_are_the_readout(tap.rows, *eager[2:])
    assert len(tap.rows) == len(eager_tap.rows) == 3


def test_card_host_node_keeps_the_taps_exception(setup):
    """A tap that raises on CUDA's callback thread cannot raise there: the
    host node keeps the first exception for the runner to raise after the
    chunk's read."""
    rf, state, _, _, _ = runner_pair(setup)
    runner = make_chunk_runner(rf, 2, tap=lambda *a: 1 / 0)
    runner._tap_rows = np.zeros((2, len(runner.device_fields) + 3))
    runner.host = [[0.0] * len(runner.host_fields)] * 2
    runner._host_tap(None)
    runner._host_tap(1)
    assert isinstance(runner.tap_error, ZeroDivisionError)


def test_eager_tap_exception_propagates(setup):
    rf, state, _, _, _ = runner_pair(setup)

    def boom(*a):
        raise ValueError("tap")

    with pytest.raises(ValueError, match="tap"):
        run_rounds(rf, state, 2, chunk=2, tap=boom)


def test_one_read_per_chunk_with_a_tap(setup, monkeypatch):
    """The eager tap reads the slot's tensors; the chunk keeps its one
    readout read."""
    reads = []
    fetch = engine._fetch

    def counting(readout):
        reads.append(tuple(readout.shape))
        return fetch(readout)

    monkeypatch.setattr(engine, "_fetch", counting)
    rf, state, _, _, tap = runner_pair(setup, channel="int8")
    _, trace = run_rounds(rf, state, 8, chunk=4, w_star=setup[1], tap=tap)
    assert trace.num_rounds == len(tap.rows) == 8
    assert reads == [(4, len(engine.DEVICE_FIELDS) + 3)] * 2


# --------------------------------------------------------------------------
# the other paths
# --------------------------------------------------------------------------

def test_run_rounds_short_last_chunk_drops_the_nonlive_slots(setup):
    """6 rounds in chunks of 4: slots 0-3, then 0-1; the rows are the
    trace's, bit for bit, and the run is the tapless one's."""
    prob, w_star, _ = setup
    rf, state, _, _, tap = runner_pair(setup)
    s_tap, tr_tap = run_rounds(rf, state, 6, chunk=4, w_star=w_star, tap=tap)
    s_plain, tr_plain = run_rounds(rf, init_state(prob, device="cpu"), 6,
                                   chunk=4, w_star=w_star)
    assert [r["slot"] for r in tap.rows] == [0, 1, 2, 3, 0, 1]
    for f in RoundMetrics._fields:
        np.testing.assert_array_equal([r[f] for r in tap.rows],
                                      getattr(tr_tap, f), err_msg=f)
        np.testing.assert_array_equal(getattr(tr_tap, f),
                                      getattr(tr_plain, f), err_msg=f)
    np.testing.assert_array_equal([r["rel_error"] for r in tap.rows],
                                  tr_tap.rel_error)
    assert torch.equal(s_tap.params, s_plain.params)


def test_run_rounds_ignores_the_tap_with_a_prebuilt_runner(setup):
    """As the reference: the tap goes into the runner run_rounds builds; a
    runner passed in keeps its own (here none)."""
    rf, state, plain, _, tap = runner_pair(setup)
    run_rounds(rf, state, 4, chunk=4, runner=plain, tap=tap)
    assert tap.rows == []


def test_the_loop_path_calls_no_tap(setup):
    prob, w_star, _ = setup
    tap = LiveTap()
    h = run_federated(prob, "fedsvrg", HP, 3, w_star=w_star, device="cpu",
                      tap=tap)
    assert len(h.rounds) == 3 and tap.rows == []


def test_tapped_run_federated_equals_the_tapless_one(setup):
    """run_federated(chunk=4, tap=) against the tapless engine and the
    loop: the History bit for bit; the sink rows are the tap's rows."""
    prob, w_star, _ = setup
    tap, s_tap, s_plain = LiveTap(), MemorySink(), MemorySink()
    kw = dict(w_star=w_star, device="cpu", channel="int8")
    h_tap = run_federated(prob, "fedosaa_svrg", HP, 7, chunk=4, tap=tap,
                          sinks=[s_tap], **kw)
    h_plain = run_federated(prob, "fedosaa_svrg", HP, 7, chunk=4,
                            sinks=[s_plain], **kw)
    for f in ("loss", "grad_norm", "rel_error", "theta_mean", "comm_bytes",
              "gram_cond_max"):
        np.testing.assert_array_equal(getattr(h_tap, f), getattr(h_plain, f),
                                      err_msg=f)
    assert torch.equal(h_tap.final_params, h_plain.final_params)
    assert [r["slot"] for r in tap.rows] == [0, 1, 2, 3, 0, 1, 2]
    for row, sink_row in zip(tap.rows, s_tap.rows):
        for f in ("loss", "grad_norm", "theta_mean", "comm_bytes",
                  "rel_error"):
            np.testing.assert_array_equal(row[f], sink_row[f], err_msg=f)


# --------------------------------------------------------------------------
# against the JAX package's tap
# --------------------------------------------------------------------------

def tapped_engines(setup, algo, rounds, print_rows=False, **kw):
    """tests/test_torch_engine.py's ``both_engines`` with a LiveTap on each
    side: the reference's History and tap (after ``jax.effects_barrier``),
    the port's, and what each side printed."""
    from repro.core import AlgoHParams as JaxHParams
    from repro.core import run_federated as jax_run_federated
    from repro.models.logreg import make_logreg_problem as jax_logreg

    prob, w_star, jc = setup
    jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
    ref_tap, tap = RefLiveTap(print_rows), LiveTap(print_rows)
    ref_out, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        ref = jax_run_federated(
            jp, algo, JaxHParams(eta=0.5, local_epochs=3, aa_impl="tree",
                                 local_impl="tree"),
            rounds, w_star=jnp.asarray(w_star.numpy()), chunk=4, tap=ref_tap,
            **kw)
        jax.effects_barrier()
    with contextlib.redirect_stdout(out):
        ours = run_federated(prob, algo, HP, rounds, w_star=w_star, chunk=4,
                             device="cpu", tap=tap, **kw)
    return (ref, ref_tap, ref_out.getvalue()), (ours, tap, out.getvalue())


def test_fedsvrg_tap_rows_match_the_reference(setup, ref_f64):
    """FedSVRG, 6 rounds in chunks of 4: the same slots (0-3, then 0-1)
    and keys on both sides, every field within rtol 1e-9 (nan where nan);
    each side's rows are its own History's."""
    (ref, ref_tap, _), (ours, tap, _) = tapped_engines(setup, "fedsvrg", 6)
    assert [r["slot"] for r in tap.rows] == [r["slot"] for r in ref_tap.rows]
    assert [r["slot"] for r in tap.rows] == [0, 1, 2, 3, 0, 1]
    assert set(tap.rows[0]) == set(ref_tap.rows[0]) == ROW_KEYS
    for f in ROW_KEYS - {"slot"}:
        np.testing.assert_allclose([r[f] for r in tap.rows],
                                   [r[f] for r in ref_tap.rows], rtol=1e-9,
                                   err_msg=f)
    for f in ("loss", "grad_norm", "rel_error"):
        np.testing.assert_array_equal([r[f] for r in tap.rows],
                                      getattr(ours, f), err_msg=f)
    # the History's bytes are cumulative, a row's the round's
    np.testing.assert_array_equal(np.cumsum([r["comm_bytes"] for r in tap.rows]),
                                  ours.comm_bytes)


def test_fedosaa_tap_stops_with_the_reference(setup, ref_f64):
    """FedOSAA-SVRG to rel-error 0.09 (a stop inside a chunk): the same
    slots on both sides, the rows after the stop dropped, and row 0 within
    rtol 1e-7 (the AA solve amplifies summation order after it, as
    test_fedosaa_stops_with_the_jax_engine holds)."""
    (ref, ref_tap, _), (ours, tap, _) = tapped_engines(
        setup, "fedosaa_svrg", 30, stop_rel_error=0.09)
    slots = [r["slot"] for r in tap.rows]
    assert slots == [r["slot"] for r in ref_tap.rows]
    assert len(slots) == len(ours.rounds) == len(ref.rounds) < 30
    assert len(slots) % 4 != 0
    for f in ROW_KEYS - {"slot"}:
        np.testing.assert_allclose(tap.rows[0][f], ref_tap.rows[0][f],
                                   rtol=1e-7, err_msg=f)


def test_print_rows_prints_the_reference_lines(setup, ref_f64):
    """``print_rows``: one ``[obs:tap] slot=... loss=... relerr=...`` line
    per live slot, the reference's lines character for character."""
    (_, _, ref_out), (_, tap, out) = tapped_engines(setup, "fedsvrg", 6,
                                                    print_rows=True)
    lines = out.splitlines()
    assert len(lines) == len(tap.rows) == 6
    assert lines[0].startswith("[obs:tap] slot=0 loss=")
    assert lines == ref_out.splitlines()
