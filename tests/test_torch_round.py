"""The port's FL round and training loop against the JAX package's, from
the same state (core/convert.py), and the slice's acceptance configuration
on the CPU.

Why round parity is one round and multi-round parity is by outcome. The AA
Gram matrices of these runs have condition numbers of 5e8 to 1e11, so any
change in summation order is amplified: two runs of the reference itself
(local_impl "tree" against its fused path) agree bit for bit for five
rounds and then part by up to 7.2e-6 in one round. Multi-round runs are
therefore compared by the rounds they take to a rel-error target and by the
loss they converge to. One round from a common state is compared at
1e-7, against the reference with its AA contractions accumulating in f64
(the ``ref_f64`` fixture; see tests/test_torch_anderson.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import AlgoHParams as JaxHParams
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.data import make_binary_classification as jax_make
from repro.data import partition as jax_partition
from repro.models.linreg import linreg_exact_solution as jax_linreg_exact
from repro.models.logreg import make_logreg_problem as jax_logreg
from repro_torch.core import (AlgoHParams, ClientBatch, make_round_fn,
                              run_federated, solve_reference)
from repro_torch.core import convert
from repro_torch.data import make_binary_classification, partition
from repro_torch.models.linreg import linreg_exact_solution, make_linreg_problem
from repro_torch.models.logreg import make_logreg_problem

#: the JAX reference's converged loss on the acceptance configuration
#: (benchmarks/results/ext_robustness.json, identity/clean/off)
REFERENCE_LOSS = 0.3031490665062957
IMPLS = [("tree", "tree"), ("kernel", "kernel")]


@pytest.fixture
def ref_f64(monkeypatch):
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


def both_problems(n, K, seed=0):
    X, y = jax_make("covtype", n=n, seed=seed)
    jc = jax_partition(X, y, K, "iid", seed=seed)
    jp = jax_logreg(jc, 1e-3, dtype=jnp.float64)
    pc = convert.stacked_clients(jc.x, jc.y, jc.mask, jc.weight, device="cpu")
    pp = make_logreg_problem(pc, 1e-3, dtype=torch.float64, device="cpu")
    return jp, pp


class TestOneRound:
    @pytest.mark.parametrize("impl", IMPLS, ids=["tree", "kernel"])
    @pytest.mark.parametrize("algo", ["fedosaa_svrg", "fedsvrg"])
    def test_round_matches_reference(self, ref_f64, algo, impl):
        """n=200, K=4, L=3, f64; the common state is the reference's after
        two rounds, so the round starts away from w=0."""
        jp, pp = both_problems(200, 4)
        jhp = JaxHParams(eta=1.0, local_epochs=3, aa_impl="tree",
                         local_impl="tree")
        state = jax_init_state(jp, jax.random.PRNGKey(0), None, None, algo)
        round_fn = jax.jit(jax_make_round_fn(algo, jp, jhp))
        for _ in range(2):
            state, _ = round_fn(state)
        ref_state, ref_m = round_fn(state)

        local, aa_impl = impl
        ours = make_round_fn(algo, pp, AlgoHParams(
            eta=1.0, local_epochs=3, local_impl=local, aa_impl=aa_impl),
            device="cpu")
        start = convert.server_state(state.params, state.t, device="cpu")
        new, m = ours(start)
        ref_w = np.asarray(ref_state.params)
        dw = np.linalg.norm(new.params.numpy() - ref_w) / np.linalg.norm(ref_w)
        assert dw <= 1e-7, dw
        assert new.t == int(ref_state.t)
        np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-12)
        np.testing.assert_allclose(float(m.grad_norm), float(ref_m.grad_norm),
                                   rtol=1e-12)
        if algo == "fedosaa_svrg":
            np.testing.assert_allclose(float(m.theta_mean),
                                       float(ref_m.theta_mean), rtol=1e-6)
        else:
            assert np.isnan(float(m.theta_mean))
            assert np.isnan(float(ref_m.theta_mean))
        assert float(m.comm_bytes) == float(ref_m.comm_bytes) == 2 * 54 * 8

    def test_unpatched_reference_differs_by_f32_rounding(self):
        """Without f64 helpers the reference's AA step carries f32 rounding,
        which the ill-conditioned Gram solve amplifies: one round of the
        port is then far outside the 1e-7 above."""
        was = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)
        try:
            jp, pp = both_problems(200, 4)
            jhp = JaxHParams(eta=1.0, local_epochs=3, aa_impl="tree",
                             local_impl="tree")
            state = jax_init_state(jp, jax.random.PRNGKey(0), None, None,
                                   "fedosaa_svrg")
            ref_state, _ = jax.jit(jax_make_round_fn("fedosaa_svrg", jp, jhp))(
                state)
            ours = make_round_fn("fedosaa_svrg", pp, AlgoHParams(
                eta=1.0, local_epochs=3), device="cpu")
            new, _ = ours(convert.server_state(state.params, state.t,
                                               device="cpu"))
        finally:
            jax.config.update("jax_enable_x64", was)
        ref_w = np.asarray(ref_state.params)
        dw = np.linalg.norm(new.params.numpy() - ref_w) / np.linalg.norm(ref_w)
        assert dw > 1e-4, dw

    def test_problem_oracles_match(self, ref_f64):
        jp, pp = both_problems(300, 3)
        rng = np.random.default_rng(0)
        w, v = rng.standard_normal((2, 54)) * 0.1
        tw, tv = torch.from_numpy(w), torch.from_numpy(v)
        jw, jv = jnp.asarray(w), jnp.asarray(v)
        np.testing.assert_allclose(pp.client_grads(tw).numpy(),
                                   np.asarray(jp.client_grads(jw)), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(float(pp.global_loss(tw)),
                                   float(jp.global_loss(jw)), rtol=1e-14)
        np.testing.assert_allclose(pp.global_grad(tw).numpy(),
                                   np.asarray(jp.global_grad(jw)), rtol=1e-12,
                                   atol=1e-15)
        c = pp.clients
        for k in range(3):
            ours = pp.hvp(tw, ClientBatch(c.x[k], c.y[k], c.mask[k]), tv)
            ref = jp.hvp(jw, jp.clients.client(k), jv)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def acceptance_problem():
    """The ext_robustness clean/off configuration: synthetic covtype,
    n=10,000, K=10 iid, gamma=1e-3, f64."""
    X, y = make_binary_classification("covtype", n=10_000, seed=0)
    clients = partition(X, y, 10, "iid", seed=0, device="cpu")
    prob = make_logreg_problem(clients, 1e-3, dtype=torch.float64, device="cpu")
    return prob, solve_reference(prob, iters=100)


def test_acceptance_configuration(acceptance_problem):
    """eta=1, L=10, the kernels' plain versions ("auto"): rel-error 1e-6
    within 18 rounds (the reference takes 16 on its tree path, 17 on its
    fused one), and the reference's converged loss to 1e-12."""
    prob, w_star = acceptance_problem
    h = run_federated(prob, "fedosaa_svrg", AlgoHParams(eta=1.0, local_epochs=10),
                      20, w_star=w_star, stop_rel_error=1e-8, device="cpu")
    hit = np.nonzero(h.rel_error < 1e-6)[0]
    assert len(hit) and hit[0] + 1 <= 18, h.rel_error
    assert abs(h.loss[-1] - REFERENCE_LOSS) <= 1e-12 * REFERENCE_LOSS
    np.testing.assert_allclose(h.loss[0], 0.6931471908886433, rtol=1e-15)
    assert np.all(np.diff(h.comm_bytes) == 864.0)


def test_fedsvrg_slower_than_fedosaa(acceptance_problem):
    """The paper's claim on this configuration: the AA step cuts the rounds."""
    prob, w_star = acceptance_problem
    hp = AlgoHParams(eta=1.0, local_epochs=10)
    h_aa = run_federated(prob, "fedosaa_svrg", hp, 8, w_star=w_star,
                         device="cpu")
    h_gd = run_federated(prob, "fedsvrg", hp, 8, w_star=w_star, device="cpu")
    assert h_aa.rel_error[-1] < 1e-2 * h_gd.rel_error[-1]
    assert np.isnan(h_gd.theta_mean).all()


@pytest.mark.parametrize("local_impl", ["tree", "kernel"])
def test_linreg_fedsvrg_reaches_exact_solution(local_impl):
    X, y = make_binary_classification("synthetic_small", n=800, seed=1)
    clients = partition(X, y, 4, "imbalance", seed=1, device="cpu")
    prob = make_linreg_problem(clients, 1e-2, dtype=torch.float64, device="cpu")
    w_exact = linreg_exact_solution(clients, 1e-2)
    # the reference's closed form, from the same arrays
    ref = jax_linreg_exact(
        jax_partition(X, y, 4, "imbalance", seed=1), 1e-2)
    np.testing.assert_allclose(w_exact.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    hp = AlgoHParams(eta=1.0, local_epochs=10, local_impl=local_impl)
    h = run_federated(prob, "fedsvrg", hp, 120, w_star=w_exact,
                      stop_rel_error=1e-10, device="cpu")
    assert h.rel_error[-1] < 1e-10, h.rel_error


def reference_uniforms(rng, K: int, fold: int, n: int, chunk: int = 256):
    """The uniforms the reference's int8 codec draws for uplink ``fold`` of
    every client in the round that starts from key ``rng``: split(rng, 3)[2]
    -> split(., K)[k] -> fold_in(fold) -> fold_in(leaf 0) -> uniform over
    the padded chunk grid (repro/core/algorithms.py:1209-1210, :873;
    repro/comm/codecs.py:80; repro/kernels/quant/ops.py:88)."""
    cl_rng = jax.random.split(rng, 3)[2]
    keys = jax.random.split(cl_rng, K)
    nc = -(-n // chunk)
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(keys[k], fold), 0), (nc, chunk),
        jnp.float32)) for k in range(K)])


class TestCompressedRound:
    """One round through a lossy wire from a common state (comm buffers
    converted), in f64 with the ``ref_f64`` fixture. The int8 round is fed
    the reference's own draws."""

    @pytest.mark.parametrize("channel", ["int8", "bf16", "fp32"])
    @pytest.mark.parametrize("algo", ["fedosaa_svrg", "fedsvrg"])
    def test_round_matches_reference(self, ref_f64, monkeypatch, algo, channel):
        import repro.comm.codecs as jax_codecs
        import repro_torch.comm.codecs as port_codecs
        from repro_torch.comm import DELTA_UPLINK, GRAD_UPLINK, Int8SRCodec

        K, d = 4, 54
        jp, pp = both_problems(200, K)
        jhp = JaxHParams(eta=1.0, local_epochs=3, aa_impl="tree",
                         local_impl="tree")
        state = jax_init_state(jp, jax.random.PRNGKey(0), None, channel, algo)
        round_fn = jax.jit(jax_make_round_fn(algo, jp, jhp, channel))
        for _ in range(2):
            state, _ = round_fn(state)
        # record every client's int8 codec input and output in the round
        seen_ref, seen_port = [], []
        jax_rt = jax_codecs.int8_sr_roundtrip

        def rec_ref(flat, rng, chunk=256):
            out = jax_rt(flat, rng, chunk=chunk)
            jax.debug.callback(
                lambda *a: seen_ref.append([np.asarray(v) for v in a]),
                flat, rng, out)
            return out

        port_up = port_codecs.int8_sr_uplink

        def rec_port(x, u, anchor=None, ref=None, ef=None, post=None):
            # the int8 uplink's entry point: record the v it rounds (formed
            # from its arguments in the uplink's order) and the dec it returns
            out = port_up(x, u, anchor, ref, ef, post)
            v = x - anchor if anchor is not None else x
            if ref is not None:
                v = v - ref
            if ef is not None:
                v = v + ef
            seen_port.append((v.clone(), out[0].clone()))
            return out

        monkeypatch.setattr(jax_codecs, "int8_sr_roundtrip", rec_ref)
        monkeypatch.setattr(port_codecs, "int8_sr_uplink", rec_port)
        ref_state, ref_m = jax.jit(jax_make_round_fn(algo, jp, jhp, channel))(
            state)

        specs = (GRAD_UPLINK, DELTA_UPLINK)
        uniforms = None
        if channel == "int8":
            uniforms = {s.tag: torch.from_numpy(
                reference_uniforms(state.rng, K, s.fold, d)) for s in specs}
        ours = make_round_fn(algo, pp, AlgoHParams(eta=1.0, local_epochs=3),
                             channel=channel, device="cpu")
        start = convert.server_state(state.params, state.t, state.comm,
                                     device="cpu")
        new, m = ours(start, uniforms)

        ref_w = np.asarray(ref_state.params)
        w_norm = np.linalg.norm(ref_w)
        dw = np.linalg.norm(new.params.numpy() - ref_w) / w_norm
        assert dw <= 1e-7, dw
        np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-12)
        assert float(m.comm_bytes) == float(ref_m.comm_bytes)
        # the carried buffers: same tags and names; values within 1e-7 of
        # ‖w‖, the scale their error follows (they are differences of the
        # clients' iterates, which agree to that)
        ref_comm = ref_state.comm
        assert sorted(new.comm) == sorted(ref_comm)
        for tag, bufs in ref_comm.items():
            assert sorted(new.comm[tag]) == sorted(bufs)
            for name, a in bufs.items():
                err = np.abs(new.comm[tag][name].numpy() - np.asarray(a)).max()
                assert err <= 1e-7 * w_norm, (tag, name, err)
        if channel != "int8":
            return

        # the codec on its own: fed the reference's pre-codec values and
        # draws, the port's int8 codec gives the reference codec's output
        # bit for bit (the reference op by op: see tests/test_torch_quant.py
        # on XLA's rewrite of amax / 127)
        assert len(seen_ref) == 2 * K and len(seen_port) == 2
        for i, spec in enumerate(specs):
            u = uniforms[spec.tag]
            keys = [jax.random.fold_in(jax.random.fold_in(
                jax.random.split(jax.random.split(state.rng, 3)[2], K)[k],
                spec.fold), 0) for k in range(K)]
            by_client = {}
            for flat, rng, out in seen_ref:
                for k in range(K):
                    if np.array_equal(rng, np.asarray(keys[k])):
                        by_client[k] = (flat, out)
            assert sorted(by_client) == list(range(K)), spec.tag
            ref_in = np.stack([by_client[k][0] for k in range(K)])
            # the pre-codec input, computed by each package on its own
            port_in = seen_port[i][0].to(torch.float32).numpy()
            assert np.abs(port_in - ref_in).max() <= 1e-7 * w_norm, spec.tag
            fed = Int8SRCodec().roundtrip(torch.from_numpy(ref_in), u)
            with jax.disable_jit():
                want = np.stack([np.asarray(jax_rt(jnp.asarray(ref_in[k]),
                                                   keys[k]))
                                 for k in range(K)])
            np.testing.assert_array_equal(fed.numpy(), want)
