"""The port's Newton family (GIANT, Newton-GMRES, DANE), its GIANT line
search and the "dir" uplink, against the JAX package's
core/algorithms.py, and its Krylov solvers against the ones the reference
calls: the batched CG against the reference's ``_cg_solve`` and the batched
GMRES (core/krylov.py) against ``jax.scipy.sparse.linalg.gmres(...,
solve_method="incremental")``.

One round of each algorithm starts from the reference's state after two
rounds (core/convert.py::server_state), on the identity, fp32, bf16, int8
and topk wires (int8 fed the reference's uniforms, derived in the test
from its key chain), comm buffers compared. As in tests/test_torch_algorithms.py the
reference runs with x64 on and its f32-accumulating tree_math helpers
swapped for f64 ones (the ``ref64`` fixture; nothing in the JAX package
changes): its CG and DANE's h(w) and gᵀp dot in f32 otherwise. Each
reference round function is compiled once per module and shared. DANE runs
3 Newton steps of 10 CG iterations here (the defaults, 20 of 100, run on
the card in chip_smoke.py). Table 1 and the paper's contracts on the
Newton family are in tests/test_torch_newton_contracts.py.
"""
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
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.core import (NEWTON_ALGOS, UPLINK_SCHEMAS, AlgoHParams,
                              convert, make_round_fn, solve_reference)
from repro_torch.core import server as port_server
from repro_torch.core.algorithms import _cg_solve
from repro_torch.core.krylov import _gmres_incremental, gmres
from repro_torch.models.logreg import make_logreg_problem
from repro_torch.utils import tree_math as tm

from torch_threads import one_torch_thread  # noqa: F401

N, K, D, L = 2000, 4, 54, 3
DANE = dict(dane_newton_iters=3, dane_cg_iters=10)
#: (algorithm, AlgoHParams knobs) of the one-round parity cases
CASES = [("giant", {}), ("giant", {"line_search": True}),
         ("newton_gmres", {}), ("newton_gmres", {"line_search": True}),
         ("dane", DANE)]


@pytest.fixture(scope="module")
def x64():
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


@pytest.fixture(scope="module")
def ref64(x64):
    """The reference's tree_math helpers accumulating in f64, for the
    whole module (its compiled rounds are shared across tests)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
        mp.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
        mp.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
        mp.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)
        yield


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
    """reference(algo, channel, **hp) -> (the state after two rounds, the
    state and metrics one round later), cached."""
    jp, _ = problems
    cache = {}

    def run(algo, channel=None, **kw):
        key = (algo, channel, tuple(sorted(kw.items())))
        if key not in cache:
            jhp = JaxHParams(eta=1.0, local_epochs=L, aa_impl="tree",
                             local_impl="tree", **kw)
            state = jax_init_state(jp, jax.random.PRNGKey(0), jhp, channel,
                                   algo)
            rf = jax.jit(jax_make_round_fn(algo, jp, jhp, channel))
            for _ in range(2):
                state, _ = rf(state)
            cache[key] = (state, *rf(state))
        return cache[key]

    return run


def reference_uniforms(rng, fold: int, chunk: int = 256):
    """The int8 codec's uniforms of uplink ``fold`` for every client: the
    round's client keys split(split(rng, 3)[2], K), each folded with the
    uplink's fold and then 0 (see tests/test_torch_round.py)."""
    nc = -(-D // chunk)
    keys = jax.random.split(jax.random.split(rng, 3)[2], K)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k, fold), 0), (nc, chunk),
        jnp.float32)) for k in keys]))


# --------------------------------------------------------------------------
# the Krylov solvers
# --------------------------------------------------------------------------

def _spd(rng, Kc, d, shift=0.1):
    m = rng.standard_normal((Kc, d, d))
    return np.einsum("kij,klj->kil", m, m) / d + shift * np.eye(d)


def _jax_gmres(A, b, restart):
    return np.stack([np.asarray(jax.scipy.sparse.linalg.gmres(
        lambda v, a=jnp.asarray(a): a @ v, jnp.asarray(bk), maxiter=1,
        restart=restart, tol=0.0, solve_method="incremental")[0])
        for a, bk in zip(A, b)])


def _port_gmres(A, b, restart):
    At = torch.from_numpy(A)
    return gmres(lambda v: (At @ v[..., None]).squeeze(-1),
                 torch.from_numpy(b), restart).numpy()


@pytest.mark.parametrize("d,restart", [(30, 10), (5, 10), (12, 12)],
                         ids=["d>restart", "d<restart", "d=restart"])
def test_gmres_matches_jax(x64, d, restart):
    """Random f64 SPD systems of four clients within 1e-12 of JAX's
    incremental GMRES: client 1's b is 0 (no step runs, x = 0); client 2's
    Krylov space closes after one step (A b = 2 b exactly: the new vector
    is 0, a breakdown, and its steps after it are masked)."""
    rng = np.random.default_rng(d)
    A, b = _spd(rng, 4, d), rng.standard_normal((4, d))
    b[1] = 0.0
    A[2] = np.diag(np.r_[2.0, np.linspace(1.0, 3.0, d - 1)])
    b[2] = 0.0
    b[2, 0] = 3.0
    ref = _jax_gmres(A, b, restart)
    ours = _port_gmres(A, b, restart)
    assert np.abs(ours - ref).max() <= 1e-12 * np.abs(ref).max()
    assert not ours[1].any()
    np.testing.assert_allclose(ours[2], b[2] / 2.0, rtol=1e-15)


def test_gmres_stops_each_system_on_its_own(x64):
    """A system whose loop stops at its first step (breakdown) runs beside
    one that takes every step: the stopped one keeps its exact answer (a
    step past the stop would turn its row of R from the identity's into 0
    and the solve into nan), and each result is what it is alone (to the
    batched products' rounding)."""
    rng = np.random.default_rng(7)
    d = 20
    A, b = _spd(rng, 2, d), rng.standard_normal((2, d))
    A[0] = np.eye(d) * 3.0
    both = _port_gmres(A, b, 8)
    for k in range(2):
        alone = _port_gmres(A[k:k + 1], b[k:k + 1], 8)
        np.testing.assert_allclose(both[k], alone[0], rtol=0,
                                   atol=1e-13 * np.abs(alone).max())
    np.testing.assert_allclose(both[0], b[0] / 3.0, rtol=1e-15)


def test_gmres_incremental_takes_the_restart_as_given(x64):
    """``gmres`` caps the restart at d (JAX's ``min(restart, size)``);
    ``_gmres_incremental`` takes it as given."""
    rng = np.random.default_rng(3)
    A, b = _spd(rng, 2, 6), rng.standard_normal((2, 6))
    At = torch.from_numpy(A)
    x = _gmres_incremental(lambda v: (At @ v[..., None]).squeeze(-1),
                           torch.from_numpy(b), 6).numpy()
    ref = _jax_gmres(A, b, 6)
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()


def test_batched_cg_matches_reference(ref64):
    """Four SPD systems at once within 1e-12 of the reference's CG on each,
    one of them with b = 0 (its clamps keep it at 0). The two differ in
    summation order only, which CG's recurrences amplify with the
    condition number: these systems' is about 10."""
    rng = np.random.default_rng(11)
    d, iters = 24, 15
    A, b = _spd(rng, 4, d, shift=0.5), rng.standard_normal((4, d))
    b[3] = 0.0
    At = torch.from_numpy(A)
    ours = _cg_solve(lambda v: (At @ v[..., None]).squeeze(-1),
                     torch.from_numpy(b), iters).numpy()
    ref = np.stack([np.asarray(jax_algos._cg_solve(
        lambda v, a=jnp.asarray(a): a @ v, jnp.asarray(bk), iters))
        for a, bk in zip(A, b)])
    assert np.abs(ours - ref).max() <= 1e-12 * np.abs(ref).max()
    assert not ours[3].any()


def _scalar_cg(matvec, b, iters):
    """The port's CG before it took a batch of systems: one [d] system,
    0-d step sizes."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = tm.tree_dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(tm.tree_dot(p, ap), min=1e-30)
        x = tm.tree_axpy(alpha, p, x)
        r = tm.tree_axpy(-alpha, ap, r)
        rs_new = tm.tree_dot(r, r)
        p = tm.tree_axpy(rs_new / torch.clamp(rs, min=1e-30), p, r)
        rs = rs_new
    return x


def test_solve_reference_is_unchanged_by_the_batched_cg(problems, monkeypatch):
    """solve_reference's centralised Newton-CG on a [d] system: bit for bit
    what it was with the one-system CG."""
    _, pp = problems
    w = solve_reference(pp, iters=3)
    monkeypatch.setattr(port_server, "_cg_solve", _scalar_cg)
    assert torch.equal(w, solve_reference(pp, iters=3))


@pytest.mark.parametrize("scale", [0.1, 1.0, 1e3], ids=["small", "unit", "saturated"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared-w", "per-client-w"])
@pytest.mark.parametrize("model", ["logreg", "linreg"])
def test_closed_form_hvps_match_the_jvp(model, shared, scale):
    """FLProblem.stacked_hvps of a linear-design model, Xᵀ(mask · c′(Xw) ·
    Xv)/n + γv, within rel 1e-12 (in norm, f64) of the jvp of the gradient
    (``hvp``), the path it replaced: at w of scale 1e3 most logistic
    logits saturate (|z| past 708, where softplus's clamp acts). A
    model without the protocol (the MLP) keeps the jvp, bit for bit."""
    from torch.func import vmap

    from repro_torch.data import make_binary_classification, make_mnist_like, partition
    from repro_torch.models.linreg import make_linreg_problem
    from repro_torch.models.mlp import make_mlp_problem

    X, y = make_binary_classification("covtype", n=N, seed=0)
    make = make_logreg_problem if model == "logreg" else make_linreg_problem
    pp = make(partition(X, y, K, "iid", seed=0, device="cpu"), 1e-3,
              dtype=torch.float64, device="cpu")
    batch = pp._batch()
    gen = torch.Generator().manual_seed(7)
    w = scale * torch.randn((D,) if shared else (K, D), generator=gen,
                            dtype=torch.float64)
    v = torch.randn(K, D, generator=gen, dtype=torch.float64)
    got = pp.stacked_hvps(w, batch, v)
    want = vmap(pp.hvp, in_dims=(None if shared else 0, 0, 0))(w, batch, v)
    assert float((got - want).norm() / want.norm()) <= 1e-12
    if scale == 1e3 and model == "logreg":
        assert float(((batch.x @ w.unsqueeze(-1)).abs() > 708.0).double().mean()) > 0.5
    if shared:
        assert torch.equal(pp.client_hvps(w, v[0]),
                           pp.stacked_hvps(w, batch, v[0].expand(K, -1)))
    Xm, ym = make_mnist_like(n=64, seed=0)
    mp = make_mlp_problem(partition(Xm, ym.astype(np.float32), 2, "iid",
                                    device="cpu"), dtype=torch.float64,
                          device="cpu")
    wm = mp.init(torch.Generator().manual_seed(1))
    vm = torch.randn(2, wm.numel(), generator=gen, dtype=torch.float64)
    mb = mp._batch()
    assert torch.equal(mp.stacked_hvps(wm, mb, vm),
                       vmap(mp.hvp, in_dims=(None, 0, 0))(wm, mb, vm))


# --------------------------------------------------------------------------
# one round against the reference
# --------------------------------------------------------------------------

def port_round(problems, algo, state, channel, **kw):
    """One round of the port from the reference's ``state``, fed the
    reference's int8 uniforms; returns (new state, metrics)."""
    _, pp = problems
    start = convert.server_state(state.params, state.t, state.comm,
                                 device="cpu")
    draws = None
    if channel == "int8":
        draws = {s.tag: reference_uniforms(state.rng, s.fold)
                 for s in UPLINK_SCHEMAS[algo]}
    rf = make_round_fn(algo, pp, AlgoHParams(eta=1.0, local_epochs=L, **kw),
                       channel=channel, device="cpu")
    return rf(start, draws)


@pytest.mark.parametrize("channel", [None, "fp32", "bf16", "int8",
                                     "topk:0.05"],
                         ids=["identity", "fp32", "bf16", "int8", "topk"])
@pytest.mark.parametrize("algo,kw", CASES,
                         ids=["giant", "giant-ls", "newton_gmres",
                              "newton_gmres-ls", "dane"])
def test_round_matches_reference(problems, reference, algo, kw, channel):
    """n=2000, K=4, L=3, f64: the params within 1e-7 of ‖w‖, the loss
    within rel 1e-12, ‖∇f‖ within 1e-7, the bytes exactly, no AA stats, and
    the wire's buffers ("grad": ref + ef; "dir" or "delta": ef) within 1e-7
    of their scale."""
    state, ref_new, ref_m = reference(algo, channel, **kw)
    new, m = port_round(problems, algo, state, channel, **kw)
    ref_w = np.asarray(ref_new.params)
    w_norm = np.linalg.norm(ref_w)
    dw = np.linalg.norm(new.params.numpy() - ref_w) / w_norm
    assert dw <= 1e-7, dw
    assert new.t == int(ref_new.t)
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-12)
    np.testing.assert_allclose(float(m.grad_norm), float(ref_m.grad_norm),
                               rtol=1e-7)
    assert float(m.comm_bytes) == float(ref_m.comm_bytes)
    assert np.isnan(float(m.theta_mean)) and np.isnan(float(ref_m.theta_mean))
    assert new.c is None and new.hist_s is None
    if channel is None:
        assert new.comm is None and ref_new.comm is None
        return
    ref_comm = {t: b for t, b in ref_new.comm.items()}
    assert sorted(new.comm) == sorted(ref_comm)
    for tag, bufs in ref_comm.items():
        assert sorted(new.comm[tag]) == sorted(bufs)
        for name, a in bufs.items():
            scale = max(w_norm, float(np.abs(np.asarray(a)).max()))
            err = np.abs(new.comm[tag][name].numpy() - np.asarray(a)).max()
            assert err <= 1e-7 * scale, (tag, name, err)
    if channel == "int8" and algo != "dane":
        assert sorted(new.comm) == ["dir", "grad"]
        assert sorted(new.comm["dir"]) == ["ef"]
        assert new.comm["dir"]["ef"].abs().max() > 0


def test_line_search_picks_a_step_and_charges_its_broadcast(problems,
                                                            reference):
    """GIANT's line search from the reference's state: the step it takes
    is one of the seven (the new params lie on w − a·p for the a the
    reference took), and its bytes are the Table 1 units plus one
    broadcast of d values."""
    state, ref_new, ref_m = reference("giant", None, line_search=True)
    plain, _ = port_round(problems, "giant", state, None)
    new, m = port_round(problems, "giant", state, None, line_search=True)
    w = np.asarray(state.params)
    p = w - plain.params.numpy()
    a_ref = (w - np.asarray(ref_new.params)) @ p / (p @ p)
    a = (w - new.params.numpy()) @ p / (p @ p)
    assert min(abs(a_ref - s) for s in (4, 2, 1, .5, .25, .125, .0625)) < 1e-6
    np.testing.assert_allclose(a, a_ref, rtol=1e-6)
    assert float(m.comm_bytes) == 3 * D * 8


def test_newton_family_refuses_trajectory_knobs(problems):
    _, pp = problems
    for algo in NEWTON_ALGOS:
        for kw in ({"batch_size": 16}, {"carry_history": 1}):
            with pytest.raises(ValueError, match="trajectory-family"):
                make_round_fn(algo, pp, AlgoHParams(eta=1.0, local_epochs=L,
                                                    **kw), device="cpu")
