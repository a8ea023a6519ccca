"""The port's trajectory family (SCAFFOLD, FedAvg, their FedOSAA variants,
one-step L-BFGS; minibatch local steps; carried AA history) against the
JAX package's core/algorithms.py, one round from a common state
(core/convert.py::server_state), on both of the port's local paths ("tree":
autodiff residuals; "kernel": the fused trajectory kernel's plain version),
on the identity wire and on int8 fed the reference's uniforms, and in
minibatch mode fed the reference's row indices.

As in tests/test_torch_round.py, the reference runs with x64 on and its
f32-accumulating tree_math helpers swapped for f64 ones (the ``ref64``
fixture; nothing in the JAX package changes), on its tree paths. Each
reference round function is compiled once per module and shared.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import algorithms as jax_algos
from repro.core import anderson as jax_aa
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.core import run_federated as jax_run_federated
from repro.core.problem import sample_minibatch_indices as jax_sample_indices
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.core import (ALGORITHMS, COMM_TABLE, TRAJECTORY_ALGOS,
                              UPLINK_SCHEMAS, AlgoHParams, comm_bytes_per_round,
                              comm_floats_per_round, convert, init_state,
                              lbfgs_two_loop, make_round_fn, run_federated,
                              solve_reference)
from repro_torch.core.algorithms import MINIBATCH
from repro_torch.models.logreg import make_logreg_problem

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N, K, D, L = 2000, 4, 54, 3
NEW_ALGOS = ("scaffold", "fedosaa_scaffold", "fedavg", "fedosaa_avg", "lbfgs")
IMPLS = ("tree", "kernel")


@pytest.fixture(scope="module")
def ref64():
    """x64 on and the reference's tree_math helpers accumulating in f64,
    for the whole module (its compiled rounds are shared across tests)."""
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
        mp.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
        mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
        mp.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", was)


@pytest.fixture(scope="module")
def problems(ref64):
    """Synthetic covtype, n=2000, K=4 iid, gamma=1e-3, f64, in both
    packages from the same arrays: (reference problem, port problem)."""
    X, y = jax_make("covtype", n=N, seed=0)
    jc = jax_partition(X, y, K, "iid", seed=0)
    jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
    pc = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight, device="cpu")
    return jp, make_logreg_problem(pc, 1e-3, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def reference(problems):
    """reference(algo, channel, warm, **hp) -> (the state after ``warm``
    rounds, the state and metrics one round later), cached."""
    jp, _ = problems
    cache = {}

    def run(algo, channel=None, warm=2, **kw):
        key = (algo, channel, warm, tuple(sorted(kw.items())))
        if key not in cache:
            jhp = JaxHParams(eta=1.0, local_epochs=L, aa_impl="tree",
                             local_impl="tree", **kw)
            state = jax_init_state(jp, jax.random.PRNGKey(0), jhp, channel,
                                   algo)
            rf = jax.jit(jax_make_round_fn(algo, jp, jhp, channel))
            for _ in range(warm):
                state, _ = rf(state)
            cache[key] = (state, *rf(state))
        return cache[key]

    return run


def client_keys(rng):
    """Each client's round key: split(rng, 3)[2] -> split(., K)
    (repro/core/algorithms.py, the round's prologue)."""
    return jax.random.split(jax.random.split(rng, 3)[2], K)


def reference_uniforms(rng, fold: int, chunk: int = 256):
    """The int8 codec's uniforms of uplink ``fold`` for every client
    (see tests/test_torch_round.py::reference_uniforms)."""
    nc = -(-D // chunk)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k, fold), 0), (nc, chunk),
        jnp.float32)) for k in client_keys(rng)]))


def reference_indices(rng, mask, batch_size: int):
    """The rows of every local step of every client: the client's key ->
    split(., L+1)[step] -> sample_minibatch_indices (repro/core/
    algorithms.py::_local_trajectory and _fused_trajectory), [K, L+1, b]."""
    return torch.from_numpy(np.stack([np.stack([
        np.asarray(jax_sample_indices(mask[k], r, batch_size))
        for r in jax.random.split(key, L + 1)])
        for k, key in enumerate(client_keys(rng))]).astype(np.int64))


def port_round(problems, algo, state, channel, local, **kw):
    """One round of the port from the reference's ``state``, fed the
    reference's draws; returns (new state, metrics)."""
    jp, pp = problems
    scaffold = algo in ("scaffold", "fedosaa_scaffold")
    carry = kw.get("carry_history", 0) > 0
    start = convert.server_state(
        state.params, state.t, state.comm,
        c=state.c if scaffold else None, c_k=state.c_k if scaffold else None,
        hist_s=state.hist_s if carry else None,
        hist_y=state.hist_y if carry else None, device="cpu")
    draws = {}
    if channel == "int8":
        draws = {s.tag: reference_uniforms(state.rng, s.fold)
                 for s in UPLINK_SCHEMAS[algo]}
    if kw.get("batch_size"):
        draws[MINIBATCH] = reference_indices(state.rng, jp.clients.mask,
                                             kw["batch_size"])
    rf = make_round_fn(algo, pp, AlgoHParams(eta=1.0, local_epochs=L,
                                             local_impl=local, **kw),
                       channel=channel, device="cpu")
    return rf(start, draws or None)


def assert_rel(port, ref, tol, what):
    ref = np.asarray(ref, np.float64)
    err = np.abs(port.numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def assert_round(algo, channel, new, m, ref_new, ref_m):
    """Params within 1e-7 of ‖w‖, the loss within rel 1e-12, the wire
    buffers and (SCAFFOLD) the control variates."""
    ref_w = np.asarray(ref_new.params)
    w_norm = np.linalg.norm(ref_w)
    dw = np.linalg.norm(new.params.numpy() - ref_w) / w_norm
    assert dw <= 1e-7, dw
    assert new.t == int(ref_new.t)
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-12)
    np.testing.assert_allclose(float(m.grad_norm), float(ref_m.grad_norm),
                               rtol=1e-7)
    assert float(m.comm_bytes) == float(ref_m.comm_bytes)
    if algo.startswith("fedosaa_"):
        np.testing.assert_allclose(float(m.theta_mean), float(ref_m.theta_mean),
                                   rtol=1e-6)
    else:
        assert np.isnan(float(m.theta_mean)) and np.isnan(float(ref_m.theta_mean))
    if algo in ("scaffold", "fedosaa_scaffold"):
        # c_k is ∇f_k(w^t) at the common w^t; c their weighted sum of the
        # decoded uploads
        assert_rel(new.c_k, ref_new.c_k, 1e-12, "c_k")
        assert_rel(new.c, ref_new.c, 1e-7, "c")
    else:
        assert new.c is None and new.c_k is None
    ref_comm = ref_new.comm
    if channel is None:
        assert new.comm is None and ref_comm is None
        return
    assert sorted(new.comm) == sorted(ref_comm)
    for tag, bufs in ref_comm.items():
        assert sorted(new.comm[tag]) == sorted(bufs)
        for name, a in bufs.items():
            scale = max(w_norm, float(np.abs(np.asarray(a)).max()))
            err = np.abs(new.comm[tag][name].numpy() - np.asarray(a)).max()
            assert err <= 1e-7 * scale, (tag, name, err)


@pytest.mark.parametrize("channel", [None, "int8"], ids=["identity", "int8"])
@pytest.mark.parametrize("local", IMPLS)
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_round_matches_reference(problems, reference, algo, local, channel):
    """n=2000, K=4, L=3, f64, from the reference's state after two rounds."""
    state, ref_new, ref_m = reference(algo, channel)
    new, m = port_round(problems, algo, state, channel, local)
    assert_round(algo, channel, new, m, ref_new, ref_m)


@pytest.mark.parametrize("local", IMPLS)
@pytest.mark.parametrize("algo,channel", [(a, None) for a in TRAJECTORY_ALGOS]
                         + [("fedosaa_svrg", "int8"), ("scaffold", "int8")])
def test_minibatch_round_matches_reference(problems, reference, algo, channel,
                                           local):
    """Minibatch local steps (batch_size=64), fed the reference's per-step
    rows: live and anchor gradients on the same rows, by both local
    paths (the fused one on the kernel's per-step row layout)."""
    state, ref_new, ref_m = reference(algo, channel, batch_size=64)
    new, m = port_round(problems, algo, state, channel, local, batch_size=64)
    assert_round(algo, channel, new, m, ref_new, ref_m)


@pytest.mark.parametrize("channel", [None, "int8"], ids=["identity", "int8"])
@pytest.mark.parametrize("local", IMPLS)
def test_carried_history_round_matches_reference(problems, reference, local,
                                                 channel):
    """FedOSAA-SVRG with carry_history=2 (m = 2 + 3 columns), from the
    reference's state after two rounds, so the carried columns are real:
    the params, and the carried columns it hands on."""
    state, ref_new, ref_m = reference("fedosaa_svrg", channel, carry_history=2)
    assert np.abs(np.asarray(state.hist_s)).max() > 0
    new, m = port_round(problems, "fedosaa_svrg", state, channel, local,
                        carry_history=2)
    assert_round("fedosaa_svrg", channel, new, m, ref_new, ref_m)
    assert new.hist_s.shape == (K, 2, D)
    assert_rel(new.hist_s, ref_new.hist_s, 1e-9, "hist_s")
    assert_rel(new.hist_y, ref_new.hist_y, 1e-9, "hist_y")


def test_fedsvrg_passes_carried_history_through(problems, reference):
    """Without an AA step the carried columns are handed on unchanged, as
    the reference's _client_svrg does."""
    state, ref_new, _ = reference("fedsvrg", None, carry_history=2)
    new, _ = port_round(problems, "fedsvrg", state, None, "kernel",
                        carry_history=2)
    assert torch.equal(new.hist_s, convert.tensor(state.hist_s, "cpu"))
    np.testing.assert_array_equal(new.hist_y.numpy(), np.asarray(ref_new.hist_y))


@pytest.mark.parametrize("algo", ["scaffold", "fedavg"])
def test_multi_round_matches_reference(problems, ref64, algo):
    """25 rounds with no AA step in the loop: the final rel-error within rel
    1e-9 of the reference's, against one w*."""
    jp, pp = problems
    w_star = solve_reference(pp, iters=50)
    hp = dict(eta=1.0, local_epochs=L)
    ref = jax_run_federated(jp, algo, JaxHParams(**hp, aa_impl="tree",
                                                 local_impl="tree"), 25,
                            w_star=jnp.asarray(w_star.numpy()))
    ours = run_federated(pp, algo, AlgoHParams(**hp), 25, w_star=w_star,
                         device="cpu")
    assert len(ours.rel_error) == len(ref.rel_error) == 25
    np.testing.assert_allclose(ours.rel_error[-1], ref.rel_error[-1], rtol=1e-9)
    np.testing.assert_allclose(ours.loss, np.asarray(ref.loss), rtol=1e-12)
    assert ours.rel_error[-1] < ours.rel_error[0]


def test_lbfgs_two_loop_matches_reference(ref64):
    """Random S/Y for K=3 clients, m=5, d=54, in f64; client 1's newest
    pair has y = 0 (the s·y and y·y guards) and client 2's second pair too
    (the s·y guard alone)."""
    rng = np.random.default_rng(3)
    Kc, m = 3, 5
    g = rng.standard_normal(D)
    s = 0.1 * rng.standard_normal((Kc, m, D))
    y = s + 0.05 * rng.standard_normal((Kc, m, D))
    y[1, -1] = 0.0
    y[2, 1] = 0.0
    ours = lbfgs_two_loop(torch.from_numpy(g), torch.from_numpy(s),
                          torch.from_numpy(y), 0.7)
    ref = np.stack([np.asarray(jax_aa.lbfgs_two_loop(
        jnp.asarray(g), jnp.asarray(s[k]), jnp.asarray(y[k]), 0.7))
        for k in range(Kc)])
    assert_rel(ours, ref, 1e-12, "lbfgs_two_loop")


def test_comm_table_matches_schemas_and_table1():
    """Each algorithm's uplink schema has its COMM_TABLE float units of
    records; on the fp32 channel its bytes are 4 × comm_floats_per_round,
    the committed benchmarks/results/table1_comm.json rows at d=54; the
    table, the schemas and the two algorithm lists are the reference's."""
    assert TRAJECTORY_ALGOS == jax_algos.TRAJECTORY_ALGOS
    assert ALGORITHMS == jax_algos.ALGORITHMS
    committed = {r["name"].split("/")[1]: r for r in json.loads(
        (ROOT / "benchmarks/results/table1_comm.json").read_text())}
    params = torch.zeros(D, dtype=torch.float64)
    for algo in ALGORITHMS:
        cost = COMM_TABLE[algo]
        assert tuple(cost) == tuple(jax_algos.COMM_TABLE[algo])
        assert len(UPLINK_SCHEMAS[algo]) == cost.float_units
        assert ([tuple(s) for s in UPLINK_SCHEMAS[algo]]
                == [tuple(s) for s in jax_algos.UPLINK_SCHEMAS[algo]])
        fp32 = comm_bytes_per_round(algo, params, "fp32")
        assert fp32 == 4 * comm_floats_per_round(algo, D)
        assert fp32 == committed[algo]["comm_bytes"]
        assert cost.round_trips == committed[algo]["round_trips"]


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_kernel_inputs_are_contiguous(problems, monkeypatch, algo):
    """The wrappers of the fused AA step and the int8 uplink pass data
    pointers on and raise on a strided view on the card (check_cuda);
    every tensor a round of each algorithm hands them here on the CPU must
    be contiguous (FedAvg's last iterate and FedOSAA-AVG's g = r_0 are
    views of the trajectory until made contiguous). The trajectory family
    runs full batch and minibatch rounds, the Newton family full batch
    (DANE with 2 Newton steps of 5 CG iterations); each also as a cohort
    round (C=2 of 4: gathered data, draws and comm rows)."""
    import repro_torch.comm.codecs as port_codecs
    import repro_torch.core.anderson as port_aa

    seen = []

    def checked(fn, name):
        def call(*args, **kw):
            for a in (*args, *kw.values()):
                if isinstance(a, torch.Tensor):
                    seen.append(name)
                    assert a.is_contiguous(), (name, tuple(a.shape), a.stride())
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(port_codecs, "int8_sr_uplink",
                        checked(port_codecs.int8_sr_uplink, "int8_uplink"))
    monkeypatch.setattr(port_aa.aa_ops, "aa_step",
                        checked(port_aa.aa_ops.aa_step, "aa_step"))
    _, pp = problems
    base = (({}, {"batch_size": 16}) if algo in TRAJECTORY_ALGOS else
            ({"dane_newton_iters": 2, "dane_cg_iters": 5},))
    for kw in base + tuple({**k, "cohort_size": 2} for k in base):
        rf = make_round_fn(algo, pp, AlgoHParams(eta=1.0, local_epochs=L, **kw),
                           channel="int8", device="cpu")
        state = init_state(pp, device="cpu", channel="int8", algo=algo)
        for _ in range(2):
            state, _ = rf(state)
    assert "int8_uplink" in seen
    assert ("aa_step" in seen) == algo.startswith("fedosaa_")
