"""Cohort rounds in the port (core/algorithms.py: resolve_cohort_size,
_sample_cohort, the cohort plan; core/client_store.py) against the JAX
package and against the port's own dense round.

At the reference's cohort size (tests/test_cohort.py): synthetic_small,
n=800, K=8 clients of the ``imbalance`` partition, L=3, f64, the reference
with its f64-accumulating tree_math helpers patched in (the ``ref64``
fixture, as tests/test_torch_algorithms.py). Parity is ‖Δw‖/‖w‖.

  * one C=4 round from the reference's state, fed the reference's cohort
    indices (its ``_sample_cohort`` on its round key, derived as the
    reference's ``_replay_prologue``) and its int8 uniforms at those rows,
    within 1e-7 for all ten algorithms on the identity wire and three on
    int8; the scattered rows within 1e-7, the other rows bit-frozen;
  * C = K bit for bit the dense round, port against port, ten algorithms
    on two wires: the whole state and every device metric;
  * a C < K round equals the dense core fed the renormalised weights at
    the cohort and 0 elsewhere, within 1e-10;
  * each round core with two different weight vectors (dweight ≠ pweight)
    within 1e-7 of the reference's core;
  * unsampled clients' comm and control-variate rows bit-frozen over three
    int8 rounds;
  * a cohort round and an engine chunk at K=4096, C=16 make no floating
    tensor with a leading dimension K (ops recorded under a
    TorchDispatchMode), and 8 engine rounds take the global loss below
    0.7 of its initial value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import algorithms as jax_algos
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.core import (ALGORITHMS, UPLINK_SCHEMAS, AlgoHParams,
                              convert, init_state, make_chunk_runner,
                              make_round_fn, resolve_cohort_size, run_rounds)
from repro_torch.core import AAConfig
from repro_torch.core import algorithms as algos
from repro_torch.core.algorithms import COHORT, CrossClientReduce
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.logreg import make_logreg_problem

from torch_threads import one_torch_thread  # noqa: F401

K, C, L = 8, 4, 3
ETA = 0.5
#: DANE at 2 Newton steps of 5 CG iterations (the reference's own tests')
KNOBS = dict(dane_newton_iters=2, dane_cg_iters=5)
INT8_ALGOS = ("fedosaa_svrg", "fedosaa_scaffold", "giant")
SCAFFOLD = ("scaffold", "fedosaa_scaffold")


@pytest.fixture(scope="module")
def ref64():
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
    """synthetic_small, n=800, K=8 imbalance, gamma=1e-3, f64, from the
    same arrays: (reference problem, port problem)."""
    X, y = jax_make("synthetic_small", n=800, seed=0)
    jc = jax_partition(X, y, K, "imbalance", seed=0)
    jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
    pc = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight, device="cpu")
    return jp, make_logreg_problem(pc, 1e-3, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def port_problem():
    """The port's own problem at the same size (no reference needed)."""
    X, y = make_binary_classification("synthetic_small", n=800, seed=0)
    clients = partition(X, y, K, "imbalance", seed=0, device="cpu")
    return make_logreg_problem(clients, 1e-3, dtype=torch.float64,
                               device="cpu")


def hparams(algo, cls=AlgoHParams, **kw):
    extra = KNOBS if algo == "dane" else {}
    return cls(eta=ETA, local_epochs=L, **extra, **kw)


# --------------------------------------------------------------------------
# resolve_cohort_size and _sample_cohort
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_clients", [1, 8, 100])
@pytest.mark.parametrize("participation", [1.0, 1.5, 0.5, 0.1, 0.001, 0.33])
@pytest.mark.parametrize("cohort_size", [None, 1, 4, 8, 100, 0, 101])
def test_resolve_cohort_size_matches_reference(participation, cohort_size,
                                               num_clients):
    """An explicit size wins and must lie in [1, K]; p >= 1 is dense; else
    max(1, round(p·K)): the reference's answer, or its error."""
    ours = AlgoHParams(participation=participation, cohort_size=cohort_size)
    ref = JaxHParams(participation=participation, cohort_size=cohort_size)
    try:
        want = jax_algos.resolve_cohort_size(ref, num_clients)
    except ValueError:
        with pytest.raises(ValueError, match="cohort_size"):
            resolve_cohort_size(ours, num_clients)
        return
    assert resolve_cohort_size(ours, num_clients) == want


def test_identity_cohort_is_arange_and_the_raw_weights(port_problem):
    w = port_problem.clients.weight
    idx, cw = algos._sample_cohort(w, K, torch.rand(K, dtype=torch.float64))
    assert torch.equal(idx, torch.arange(K)) and cw is w


@pytest.mark.parametrize("c", [1, 3, 4, 7])
def test_sampled_cohort_is_distinct_and_renormalised(port_problem, c):
    w = port_problem.clients.weight
    for seed in range(5):
        u = torch.rand(K, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)
        idx, cw = algos._sample_cohort(w, c, u)
        assert idx.dtype == torch.int64 and idx.shape == (c,)
        assert len(set(idx.tolist())) == c and 0 <= int(idx.min())
        assert int(idx.max()) < K
        assert abs(float(cw.to(torch.float64).sum()) - 1.0) <= 1e-6
        assert torch.equal(cw, w[idx] / w[idx].sum())
        # f64 weights sum to 1 within 1e-15
        w64 = w.to(torch.float64)
        _, cw64 = algos._sample_cohort(w64, c, u)
        assert abs(float(cw64.sum()) - 1.0) <= 1e-15


def test_cohort_draw_follows_the_weights():
    """Gumbel top-k draws without replacement with p ∝ w: over 20,000 draws
    of C=1 the frequencies are the weights, and client k's inclusion at C=2
    is the exact successive-draw probability."""
    w = torch.tensor([0.5, 0.25, 0.15, 0.1], dtype=torch.float32)
    u = torch.rand((20_000, 4), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    one = torch.stack([algos._cohort_indices(w, 1, r) for r in u])
    freq = torch.bincount(one[:, 0], minlength=4).double() / len(u)
    assert torch.allclose(freq, w.double(), atol=0.01)
    two = torch.stack([algos._cohort_indices(w, 2, r) for r in u])
    wd = w.double()
    incl = torch.stack([(two == k).any(-1) for k in range(4)], -1)
    incl = incl.double().mean(0)
    want = torch.stack([wd[k] + sum(wd[j] * wd[k] / (1 - wd[j])
                                    for j in range(4) if j != k)
                        for k in range(4)])
    assert torch.allclose(incl, want, atol=0.01)


def test_round_draws_cohort_rows_of_the_dense_draws(port_problem):
    """A cohort client draws what it would draw in the dense round: the
    cohort round's uniforms and minibatch rows are rows idx of the dense
    round's, and the round's cohort is its "cohort" draw."""
    hp = AlgoHParams(eta=ETA, local_epochs=L, batch_size=5)
    dense = make_round_fn("fedosaa_svrg", port_problem, hp, "int8",
                          device="cpu")
    coh = make_round_fn("fedosaa_svrg", port_problem,
                        dataclasses.replace(hp, cohort_size=C), "int8",
                        device="cpu")
    assert coh.draw_specs[COHORT] == ((C,), torch.int64)
    assert (coh.draw_specs["grad"][0][0] == coh.draw_specs["minibatch"][0][0]
            == C)
    bd = {n: torch.empty((2, *s), dtype=dt)
          for n, (s, dt) in dense.draw_specs.items()}
    bc = {n: torch.empty((2, *s), dtype=dt)
          for n, (s, dt) in coh.draw_specs.items()}
    dense.fill_draws(bd, 5)
    coh.fill_draws(bc, 5)
    for i in range(2):
        idx = bc[COHORT][i]
        assert len(set(idx.tolist())) == C
        for name in bd:
            assert torch.equal(bc[name][i], bd[name][i][idx]), name
    assert not torch.equal(bc[COHORT][0], bc[COHORT][1])


# --------------------------------------------------------------------------
# one C < K round against the reference
# --------------------------------------------------------------------------

def reference_cohort_draws(jp, rng, algo, channel, d):
    """The reference's draws of the round keyed by ``rng``: its cohort
    (``_sample_cohort`` on the round's participation key) and, on int8,
    each uplink's uniforms of every client at the cohort's rows (the
    client's round key, folded by the uplink's fold, then leaf 0)."""
    _, part_rng, cl_rng = jax.random.split(rng, 3)
    idx, _ = jax_algos._sample_cohort(jp.clients.weight, C, part_rng)
    idx = np.asarray(idx)
    draws = {COHORT: torch.from_numpy(idx.astype(np.int64))}
    if channel == "int8":
        keys = jax.random.split(cl_rng, K)
        nc = -(-d // 256)
        for s in UPLINK_SCHEMAS[algo]:
            draws[s.tag] = torch.from_numpy(np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
                    keys[k], s.fold), 0), (nc, 256), jnp.float32))
                for k in idx]))
    return idx, draws


def start_state(state, algo, **kw):
    scaffold = algo in SCAFFOLD
    carry = kw.get("carry_history", 0) > 0
    return convert.server_state(
        state.params, state.t, state.comm,
        c=state.c if scaffold else None, c_k=state.c_k if scaffold else None,
        hist_s=state.hist_s if carry else None,
        hist_y=state.hist_y if carry else None, device="cpu")


def assert_rows(port, ref, scale, what):
    err = np.abs(port.numpy() - np.asarray(ref)).max()
    assert err <= 1e-7 * scale, (what, err, scale)


@pytest.mark.parametrize("algo,channel", [(a, None) for a in ALGORITHMS]
                         + [(a, "int8") for a in INT8_ALGOS])
def test_cohort_round_matches_reference(problems, algo, channel):
    """From the reference's state after two cohort rounds: params within
    1e-7, the loss and the cohort's effective sample size; the cohort's
    c_k and comm rows within 1e-7, the others as they were, bit for bit."""
    jp, pp = problems
    jhp = hparams(algo, JaxHParams, cohort_size=C, aa_impl="tree",
                  local_impl="tree")
    state = jax_init_state(jp, jax.random.PRNGKey(0), jhp, channel, algo)
    rf = jax.jit(jax_make_round_fn(algo, jp, jhp, channel))
    for _ in range(2):
        state, _ = rf(state)
    ref_new, ref_m = rf(state)
    idx, draws = reference_cohort_draws(jp, state.rng, algo, channel,
                                        pp.clients.x.shape[-1])
    start = start_state(state, algo)
    ours = make_round_fn(algo, pp, hparams(algo, cohort_size=C), channel,
                         device="cpu")
    new, m = ours(start, draws)

    ref_w = np.asarray(ref_new.params)
    w_norm = np.linalg.norm(ref_w)
    dw = np.linalg.norm(new.params.numpy() - ref_w) / w_norm
    assert dw <= 1e-7, dw
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-9)
    np.testing.assert_allclose(float(m.cohort_ess), float(ref_m.cohort_ess),
                               rtol=1e-6)
    off = np.setdiff1d(np.arange(K), idx)
    if algo in SCAFFOLD:
        assert_rows(new.c_k[idx], np.asarray(ref_new.c_k)[idx], w_norm, "c_k")
        assert torch.equal(new.c_k[off], start.c_k[off])
        np.testing.assert_array_equal(np.asarray(ref_new.c_k)[off],
                                      np.asarray(state.c_k)[off])
    if channel is None:
        assert new.comm is None
        return
    for tag, bufs in ref_new.comm.items():
        for name, a in bufs.items():
            a = np.asarray(a)
            scale = max(w_norm, float(np.abs(a).max()))
            assert_rows(new.comm[tag][name][idx], a[idx], scale, (tag, name))
            assert torch.equal(new.comm[tag][name][off],
                               start.comm[tag][name][off]), (tag, name)
            moved = new.comm[tag][name][idx]
            assert not torch.equal(moved, start.comm[tag][name][idx])


# --------------------------------------------------------------------------
# the identity cohort, bit for bit the dense round
# --------------------------------------------------------------------------

def assert_state_equal(a, b, what):
    for f in ("params", "c", "c_k", "hist_s", "hist_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        assert x is None or torch.equal(x, y), (what, f)
    assert a.t == b.t
    assert sorted(a.comm or {}) == sorted(b.comm or {})
    for tag, bufs in (a.comm or {}).items():
        for name, buf in bufs.items():
            assert torch.equal(buf, b.comm[tag][name]), (what, tag, name)


@pytest.mark.parametrize("channel", [None, "int8"], ids=["identity", "int8"])
@pytest.mark.parametrize("algo", ALGORITHMS + ("fedosaa_svrg+carry",))
def test_identity_cohort_is_the_dense_round(port_problem, algo, channel):
    """cohort_size=K runs the draw, the plan and the scatter, and gives the
    dense round's state (params, c, c_k, carried columns, comm) and every
    metric bit for bit, over two rounds."""
    kw = {"carry_history": 2} if algo.endswith("+carry") else {}
    algo = algo.split("+")[0]
    hp = hparams(algo, **kw)
    hpk = dataclasses.replace(hp, cohort_size=K)
    fd = make_round_fn(algo, port_problem, hp, channel, device="cpu")
    fk = make_round_fn(algo, port_problem, hpk, channel, device="cpu")
    assert COHORT in fk.draw_specs and COHORT not in fd.draw_specs
    sd = init_state(port_problem, device="cpu", channel=channel, algo=algo,
                    hp=hp)
    sk = init_state(port_problem, device="cpu", channel=channel, algo=algo,
                    hp=hpk)
    for t in range(2):
        sd, md = fd(sd)
        sk, mk = fk(sk)
        assert_state_equal(sd, sk, f"{algo} round {t}")
        for f, a, b in zip(md._fields, md, mk):
            assert torch.equal(a, b) or (torch.isnan(a).all()
                                         and torch.isnan(b).all()), (algo, f)


# --------------------------------------------------------------------------
# a sampled cohort against the masked dense round, port against port
# --------------------------------------------------------------------------

#: (Tikhonov, tolerance) of the masked-dense comparison. The two paths sum
#: the clients' gradients in a different order (∇f differs by an ulp,
#: ~1e-18), and the AA solve amplifies that by its Gram's conditioning: at
#: the reference's Tikhonov 1e-8 (cond ~1.6e8 here) the params part by
#: ~1.6e-10, held at the reference's own rtol 1e-6; at 1e-6 (cond ~3e6)
#: by ~5e-13, held at 1e-10.
MASKED_DENSE = [(1e-6, 1e-10), (1e-8, 1e-6)]


def cohort_and_masked(port_problem, algo, tikhonov):
    """A cohort round of ``algo`` from the state a round in, its cohort,
    the masked dense weights and the dense round's knobs."""
    hp = AlgoHParams(eta=ETA, local_epochs=L, cohort_size=C,
                     aa=AAConfig(tikhonov=tikhonov))
    rf = make_round_fn(algo, port_problem, hp, device="cpu")
    state = init_state(port_problem, device="cpu", algo=algo)
    state, _ = rf(state)
    bufs = {COHORT: torch.empty((1, C), dtype=torch.int64)}
    rf.fill_draws(bufs, state.t)
    idx = bufs[COHORT][0]
    new, m = rf(state)
    w = port_problem.clients.weight
    wm = torch.zeros_like(w).index_copy(0, idx, w[idx] / w[idx].sum())
    hpr = dataclasses.replace(hp, aa_impl="kernel", local_impl="kernel",
                              cohort_size=None)
    Cl = port_problem.clients
    R = CrossClientReduce()
    return state, new, m, idx, wm, hpr, Cl, R


def assert_close(a, b, tol, what):
    err = float((a - b).abs().max())
    assert err <= tol * float(b.abs().max()), (what, err)


@pytest.mark.parametrize("tikhonov,tol", MASKED_DENSE)
def test_svrg_cohort_equals_the_masked_dense_core(port_problem, tikhonov, tol):
    state, new, m, idx, wm, hpr, Cl, R = cohort_and_masked(
        port_problem, "fedosaa_svrg", tikhonov)
    params, parts, *_ = algos._svrg_round_core(
        port_problem, hpr, True, R, state.params, Cl.x, Cl.y, Cl.mask, wm, wm,
        0.0)
    assert_close(new.params, params, tol, "params")
    np.testing.assert_allclose(float(m.loss), float(parts.loss), rtol=1e-10)


@pytest.mark.parametrize("tikhonov,tol", MASKED_DENSE)
def test_scaffold_cohort_equals_the_masked_dense_core(port_problem, tikhonov,
                                                      tol):
    state, new, m, idx, wm, hpr, Cl, R = cohort_and_masked(
        port_problem, "fedosaa_scaffold", tikhonov)
    params, c, c_k, parts, _ = algos._scaffold_round_core(
        port_problem, hpr, True, R, state.params, state.c, state.c_k, Cl.x,
        Cl.y, Cl.mask, wm, wm, 0.0)
    assert_close(new.params, params, tol, "params")
    assert_close(new.c, c, 1e-10, "c")
    assert_close(new.c_k[idx], c_k[idx], 1e-10, "c_k")
    np.testing.assert_allclose(float(m.loss), float(parts.loss), rtol=1e-10)


# --------------------------------------------------------------------------
# the weight split: dweight != pweight, each core against the reference's
# --------------------------------------------------------------------------

CORES = ("svrg", "scaffold", "avg", "lbfgs", "giant", "giant+line_search",
         "newton_gmres", "dane")


@pytest.mark.parametrize("core", CORES)
def test_weight_split_matches_reference_core(problems, core):
    """Each round core called with the data weights as dweight and another
    normalised vector as pweight, from a common state, on the identity
    wire: params within 1e-7 of the reference's core, the loss (dweight)
    and the effective sample size (pweight)."""
    jp, pp = problems
    rng = np.random.default_rng(7)
    dweight = np.asarray(jp.clients.weight, np.float64)
    pweight = rng.dirichlet(np.ones(K))
    w_t = 0.1 * rng.standard_normal(pp.clients.x.shape[-1])
    name = core.split("+")[0]
    line_search = core.endswith("+line_search")
    algo = {"svrg": "fedosaa_svrg", "scaffold": "fedosaa_scaffold",
            "avg": "fedosaa_avg"}.get(name, name)
    kw = dict(line_search=line_search, **(KNOBS if name == "dane" else {}))
    jhp = JaxHParams(eta=ETA, local_epochs=L, aa_impl="tree",
                     local_impl="tree", **kw)
    hp = AlgoHParams(eta=ETA, local_epochs=L, aa_impl="kernel",
                     local_impl="kernel", **kw)
    jc, pc = jp.clients, pp.clients
    jR, R = jax_algos.CrossClientReduce(), CrossClientReduce()
    rngs = jax.random.split(jax.random.PRNGKey(0), K)
    jd, jw = jnp.asarray(dweight), jnp.asarray(pweight)
    td, tw = torch.from_numpy(dweight), torch.from_numpy(pweight)
    jwt, twt = jnp.asarray(w_t), torch.from_numpy(w_t)
    jargs = (jc.x, jc.y, jc.mask)
    targs = (pc.x, pc.y, pc.mask)
    if name == "svrg":
        ref_p, ref_parts, *_ = jax_algos._svrg_round_core(
            jp, jhp, True, jR, jwt, *jargs, jd, jw, rngs)
        p, m, *_ = algos._svrg_round_core(pp, hp, True, R, twt, *targs, td,
                                          tw, 0.0)
    elif name == "scaffold":
        c = 0.01 * rng.standard_normal(w_t.shape)
        c_k = 0.01 * rng.standard_normal((K, *w_t.shape))
        ref_p, ref_c, _, ref_parts, _ = jax_algos._scaffold_round_core(
            jp, jhp, True, jR, jwt, jnp.asarray(c), *jargs, jnp.asarray(c_k),
            jd, jw, rngs)
        p, new_c, _, m, _ = algos._scaffold_round_core(
            pp, hp, True, R, twt, torch.from_numpy(c), torch.from_numpy(c_k),
            *targs, td, tw, 0.0)
        np.testing.assert_allclose(new_c.numpy(), np.asarray(ref_c),
                                   rtol=1e-7, atol=1e-12)
    elif name == "avg":
        ref_p, ref_parts, _ = jax_algos._avg_round_core(
            jp, jhp, True, jR, jwt, *jargs, jd, jw, rngs)
        p, m, _ = algos._avg_round_core(pp, hp, True, R, twt, *targs, td, tw,
                                        0.0)
    elif name == "lbfgs":
        ref_p, ref_parts, _ = jax_algos._lbfgs_round_core(
            jp, jhp, jR, jwt, *jargs, jd, jw, rngs)
        p, m, _ = algos._lbfgs_round_core(pp, hp, R, twt, *targs, td, tw, 0.0)
    elif name == "dane":
        ref_p, ref_parts, _ = jax_algos._dane_round_core(
            jp, jhp, jR, jwt, *jargs, jd, jw, rngs)
        p, m, _ = algos._dane_round_core(
            pp, hp, R, twt, *targs, td, tw, 0.0,
            steps=torch.tensor(algos.DANE_STEPS, dtype=torch.float64))
    else:
        jfn = (jax_algos._client_giant if name == "giant"
               else jax_algos._client_newton_gmres)
        tfn = (algos._client_giant if name == "giant"
               else algos._client_newton_gmres)
        ref_p, ref_parts, _ = jax_algos._newton_round_core(
            jp, jhp, jfn, jR, jwt, *jargs, jd, jw, rngs)
        p, m, _ = algos._newton_round_core(
            pp, hp, tfn, R, twt, *targs, td, tw, 0.0,
            ls_steps=(torch.tensor(algos.LINE_SEARCH_STEPS,
                                   dtype=torch.float64)
                      if line_search else None))
    ref_p = np.asarray(ref_p)
    dw = np.linalg.norm(p.numpy() - ref_p) / np.linalg.norm(ref_p)
    assert dw <= 1e-7, dw
    np.testing.assert_allclose(float(m.loss), float(ref_parts.loss),
                               rtol=1e-12)
    np.testing.assert_allclose(float(m.cohort_ess), float(ref_parts.cohort_ess),
                               rtol=1e-12)
    assert abs(float(m.cohort_ess) - 1.0 / float((tw * tw).sum())) < 1e-12


# --------------------------------------------------------------------------
# frozen rows over rounds
# --------------------------------------------------------------------------

def test_unsampled_rows_stay_frozen(port_problem):
    """Three int8 rounds of FedOSAA-SCAFFOLD at participation 0.5 (C=4 of
    8): every round, the comm rows (delta and ctrl error feedback) and c_k
    rows of the clients outside its cohort keep their bits, and its
    cohort's rows move."""
    algo = "fedosaa_scaffold"
    hp = AlgoHParams(eta=ETA, local_epochs=L, participation=0.5)
    rf = make_round_fn(algo, port_problem, hp, "int8", device="cpu")
    state = init_state(port_problem, device="cpu", channel="int8", algo=algo)
    for _ in range(3):
        bufs = {COHORT: torch.empty((1, C), dtype=torch.int64)}
        rf.fill_draws(bufs, state.t)
        idx = bufs[COHORT][0]
        off = torch.tensor(sorted(set(range(K)) - set(idx.tolist())))
        new, _ = rf(state)
        bufs_old = [state.c_k] + [b for sub in state.comm.values()
                                  for b in sub.values()]
        bufs_new = [new.c_k] + [b for sub in new.comm.values()
                                for b in sub.values()]
        assert sorted(new.comm) == ["ctrl", "delta"]
        for a, b in zip(bufs_old, bufs_new):
            assert torch.equal(a[off], b[off])
        # the cohort's rows move: c_k, and the wire's error feedback
        assert not torch.equal(state.c_k[idx], new.c_k[idx])
        assert any(not torch.equal(a[idx], b[idx])
                   for a, b in zip(bufs_old[1:], bufs_new[1:]))
        state = new


# --------------------------------------------------------------------------
# O(C·d): no [K, ...] floating tensor in a round or a chunk at K=4096
# --------------------------------------------------------------------------

BIG_K, BIG_C = 4096, 16


class DenseOps(TorchDispatchMode):
    """Records every op whose output is a floating tensor with ndim >= 2
    and a leading dimension K."""

    def __init__(self, k):
        super().__init__()
        self.k, self.found = k, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[0] == self.k and t.is_floating_point()):
                self.found.append((str(func), tuple(t.shape)))
        return out


@pytest.fixture(scope="module")
def big():
    """synthetic_small, n=32768, K=4096 iid (8 rows a client), f32, and
    FedOSAA-SVRG at C=16, eta=0.5, L=2 (the reference's
    TestNoDenseComputeInCohortRound and ext_cohort point)."""
    X, y = make_binary_classification("synthetic_small", n=32768, seed=0)
    clients = partition(X, y, BIG_K, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, device="cpu")
    hp = AlgoHParams(eta=0.5, local_epochs=2, cohort_size=BIG_C)
    return prob, make_round_fn("fedosaa_svrg", prob, hp, device="cpu")


def test_round_makes_no_dense_float_tensor(big):
    prob, rf = big
    state = init_state(prob, device="cpu")
    mode = DenseOps(BIG_K)
    with mode:
        state, m = rf(state)
    assert not mode.found, mode.found[:10]
    assert np.isfinite(float(m.loss))


def test_engine_chunk_makes_no_dense_float_tensor(big):
    prob, rf = big
    runner = make_chunk_runner(rf, 2)
    state = init_state(prob, device="cpu")
    draws = runner._draw_buffers(state.params.device)
    rf.fill_draws(draws, state.t)
    assert draws[COHORT].shape == (2, BIG_C)
    mode = DenseOps(BIG_K)
    with mode:
        out, readout, _ = runner._body(state, torch.tensor(2), draws)
    assert not mode.found, mode.found[:10]
    assert out.params.shape == state.params.shape
    assert torch.isfinite(readout).any()


def test_k4096_engine_run_converges(big):
    """8 engine rounds in chunks of 4: the global (all-K, data-weighted)
    loss ends below 0.7 of its initial value (the reference's criterion;
    a round's own loss is its 16 clients')."""
    prob, rf = big
    state = init_state(prob, device="cpu")
    l0 = float(prob.global_loss(state.params))
    state, trace = run_rounds(rf, state, 8, chunk=4)
    assert trace.num_rounds == 8 and np.all(np.isfinite(trace.loss))
    assert float(prob.global_loss(state.params)) < 0.7 * l0
