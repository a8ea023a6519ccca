"""The port's three kernels, through their plain PyTorch versions, against
the JAX package's oracles and its Pallas kernels in interpret mode (the
CUDA kernels themselves are held against their plain versions on the card,
in tests/test_torch_cuda.py and chip_smoke.py).

Inputs come from numpy with a seed and go to both packages. Every
tolerance is normwise, max |port - ref| <= tol * max |ref|, because the two
sides differ only in the order of their sums: 1e-12 in float64 and 1e-5
(trajectory, 11 chained steps) or 1e-6 (one Gram or update pass) in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.anderson.anderson import gram_pallas, update_pallas
from repro.kernels.anderson.ref import gram_ref as jax_gram_ref
from repro.kernels.anderson.ref import update_ref as jax_update_ref
from repro.kernels.local_update.local_update import trajectory_pallas
from repro.kernels.local_update.ops import fused_trajectory as jax_fused
from repro.kernels.local_update.ref import trajectory_ref as jax_traj_ref
from repro_torch.kernels import _build
from repro_torch.kernels.anderson import flat_gram, flat_update
from repro_torch.kernels.anderson.ref import gram_ref, update_ref
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.kernels.local_update.ops import (MAX_CLUSTER, inverse_count,
                                                  plan_trajectory,
                                                  resident_smem_bytes)
from repro_torch.kernels.local_update.ref import trajectory_ref

from test_torch_cuda import TOL, _aa_case, _traj_case, assert_close
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def x64():
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


class TestTrajectory:
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    @pytest.mark.parametrize("link", ["logistic", "linear"])
    @pytest.mark.parametrize("anchor", [0.0, 1.0])
    @pytest.mark.parametrize("per_step", [False, True])
    def test_plain_matches_jax_oracle_and_interpret_kernel(
            self, x64, dtype, link, anchor, per_step):
        steps, n, d = 4, 48, 12
        S = steps if per_step else 1
        rng = np.random.default_rng(7)
        x, y, mask, w0, u = _traj_case(rng, 2, S, n, d, link, dtype)
        kw = dict(link=link, reg=1e-3, eta=0.5, anchor_scale=anchor,
                  steps=steps)
        t = lambda a: torch.from_numpy(a)
        invn = inverse_count(t(mask), t(w0).dtype)
        w_p, r_p = trajectory_ref(t(x), t(y), t(mask), t(w0), t(u), invn, **kw)
        # the wrapper on CPU tensors is the plain version
        w_f, r_f = fused_trajectory(t(x), t(y), t(mask), t(w0), t(u), **kw)
        assert torch.equal(w_f, w_p) and torch.equal(r_f, r_p)
        assert w_p.dtype == t(w0).dtype and w_p.shape == (2, steps, d)
        for k in range(2):
            inv_k = np.asarray(invn[k:k + 1].numpy()).reshape(1, 1)
            args = (jnp.asarray(x[k]), jnp.asarray(y[k]), jnp.asarray(mask[k]),
                    jnp.asarray(w0[k:k + 1]), jnp.asarray(u[k:k + 1]),
                    jnp.asarray(inv_k))
            refs = [jax_traj_ref(*args, **kw)]
            if k == 1:   # the ragged client, through the interpret-mode
                #          kernel (slow) and the reference's wrapper too
                xk = args[0].reshape(S * n, d)
                refs.append(trajectory_pallas(xk, *args[1:], row_tile=n,
                                              interpret=True, **kw))
                refs.append(jax_fused(*args[:3], args[3][0], args[4][0],
                                      impl="ref", **kw))
            for ref_w, ref_r in refs:
                assert_close(w_p[k], ref_w, TOL[dtype])
                assert_close(r_p[k], ref_r, TOL[dtype])

    def test_shared_anchor_broadcasts(self):
        """w0 and u given once as [d] serve every client."""
        rng = np.random.default_rng(1)
        x, y, mask, w0, u = (torch.from_numpy(a) for a in _traj_case(
            rng, 3, 1, 20, 5, "logistic", np.float64))
        kw = dict(link="logistic", reg=1e-3, eta=1.0, anchor_scale=1.0,
                  steps=3)
        a = fused_trajectory(x, y, mask, w0[0], u[0], **kw)
        b = fused_trajectory(x, y, mask, w0[:1].expand(3, -1),
                             u[:1].expand(3, -1), **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_rejects_bad_knobs(self):
        x = torch.zeros(1, 2, 4, 3)
        y = mask = torch.zeros(1, 2, 4)
        w = torch.zeros(3)
        with pytest.raises(ValueError, match="S=2"):
            fused_trajectory(x, y, mask, w, w, link="linear", reg=0.0, eta=1.0,
                             anchor_scale=1.0, steps=3)
        with pytest.raises(ValueError, match="unknown link"):
            fused_trajectory(x, y, mask, w, w, link="probit", reg=0.0,
                             eta=1.0, anchor_scale=1.0, steps=2)
        with pytest.raises(ValueError, match="anchor_scale"):
            fused_trajectory(x, y, mask, w, w, link="linear", reg=0.0,
                             eta=1.0, anchor_scale=0.5, steps=2)


class TestTrajectoryPlan:
    """ops.plan_trajectory, a pure function of (K, S, n, d, dtype): which
    design csrc/trajectory.cu runs and, for the resident one, how many
    blocks a client's cluster has and how many rows each holds."""
    SMEM = 232_448     # shared memory an H100 block may use

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_per_step_rows_stream(self, dtype):
        for n in (10, 581, 5810):
            plan = plan_trajectory(100, 11, n, 54, dtype)
            assert (plan.design, plan.cluster, plan.rows_per_block) == (
                "streaming", 1, 0)

    @pytest.mark.parametrize("dtype,n", [(torch.float64, 7_600),
                                         (torch.float32, 15_500),
                                         (torch.float64, 581_012)])
    def test_clients_past_sixteen_blocks_stream(self, dtype, n):
        assert plan_trajectory(100, 1, n, 54, dtype).design == "streaming"

    @pytest.mark.parametrize("dtype,cluster,rows", [(torch.float64, 16, 364),
                                                    (torch.float32, 8, 727)])
    def test_paper_scale(self, dtype, cluster, rows):
        """K=100 clients of 5810 rows, d=54 (covtype's): 16 blocks of 364
        rows in f64, 8 of 727 in f32, each within one block's shared
        memory."""
        plan = plan_trajectory(100, 1, 5810, 54, dtype)
        assert (plan.design, plan.cluster, plan.rows_per_block) == (
            "resident", cluster, rows)
        assert plan.smem_bytes <= self.SMEM

    def test_few_clients_take_larger_clusters(self):
        """The acceptance configuration (K=10, n_k=1000): 4 blocks would hold
        a client, 8 keep more of the 132 SMs busy; 16 would need 160."""
        plan = plan_trajectory(10, 1, 1000, 54, torch.float64)
        assert plan.cluster == 8 and plan.rows_per_block == 125
        assert resident_smem_bytes(250, 54, 8) <= self.SMEM
        assert plan_trajectory(1, 1, 100, 54, torch.float64).cluster == MAX_CLUSTER

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    @pytest.mark.parametrize("d", [1, 12, 37, 54, 128])
    def test_rows_per_block_fit_and_cover(self, dtype, d):
        """Over a sweep of n at K=100 (no growth): the blocks cover the
        client's rows, each fits 232,448 B, and half as many blocks would
        not (the smallest power of two)."""
        size = 8 if dtype == torch.float64 else 4
        for n in (1, 100, 333, 1000, 2049, 5810, 9000, 20_000):
            plan = plan_trajectory(100, 1, n, d, dtype)
            if plan.design == "streaming":
                assert resident_smem_bytes(-(-n // MAX_CLUSTER), d, size) > self.SMEM
                continue
            assert plan.cluster * plan.rows_per_block >= n
            assert plan.rows_per_block == -(-n // plan.cluster)
            assert plan.smem_bytes == resident_smem_bytes(plan.rows_per_block, d, size)
            assert plan.smem_bytes <= self.SMEM
            if plan.cluster > 1:
                half = -(-n // (plan.cluster // 2))
                assert resident_smem_bytes(half, d, size) > self.SMEM


class TestAndersonPasses:
    def test_float32_matches_jax_oracles_and_interpret_kernels(self):
        """f32 inputs accumulate in f32, as the TPU kernels do."""
        K, m, d = 3, 5, 256
        y, s, g, w, gamma = _aa_case(np.random.default_rng(3), K, m, d,
                                     np.float32)
        t = torch.from_numpy
        gram, yg = gram_ref(t(y), t(g))
        new_w = update_ref(t(w), t(g), t(s), t(y), t(gamma), 0.7, 0.9)
        assert gram.dtype == torch.float32 and new_w.dtype == torch.float32
        for k in range(K):
            jg, jyg = jax_gram_ref(jnp.asarray(y[k]), jnp.asarray(g))
            pg, pyg = gram_pallas(jnp.asarray(y[k]), jnp.asarray(g), tile=128,
                                  interpret=True)
            for ref_g, ref_yg in ((jg, jyg), (pg, pyg)):
                assert_close(gram[k], ref_g, 1e-6)
                assert_close(yg[k], ref_yg, 1e-6)
            args = (jnp.asarray(w), jnp.asarray(g), jnp.asarray(s[k]),
                    jnp.asarray(y[k]), jnp.asarray(gamma[k]), 0.7, 0.9)
            assert_close(new_w[k], jax_update_ref(*args), 1e-6)
            assert_close(new_w[k], update_pallas(*args, tile=128,
                                                 interpret=True), 1e-6)

    def test_float64_accumulates_in_float64(self):
        """f64 inputs accumulate in f64 (the TPU kernels downcast to f32):
        held against numpy's f64 products at 1e-12."""
        K, m, d = 3, 6, 54
        y, s, g, w, gamma = _aa_case(np.random.default_rng(4), K, m, d,
                                     np.float64)
        t = torch.from_numpy
        gram, yg = gram_ref(t(y), t(g))
        new_w = update_ref(t(w), t(g), t(s), t(y), t(gamma), 1.0, 1.0)
        assert gram.dtype == torch.float64 and new_w.dtype == torch.float64
        for k in range(K):
            assert_close(gram[k], y[k] @ y[k].T, 1e-12)
            assert_close(yg[k], y[k] @ g, 1e-12)
            assert_close(new_w[k], w - g - (gamma[k] @ s[k] - gamma[k] @ y[k]),
                         1e-12)

    def test_wrappers_on_cpu_are_the_plain_versions(self):
        """[d] vectors shared by every client equal their [K, d] copies."""
        K, m, d = 4, 3, 10
        y, s, g, w, gamma = (torch.from_numpy(a) for a in _aa_case(
            np.random.default_rng(5), K, m, d, np.float64))
        before = dict(_build.LAUNCHES)
        gk = g.expand(K, d)
        for a, b in zip(flat_gram(y, g), gram_ref(y, gk)):
            assert torch.equal(a, b)
        assert torch.equal(flat_update(w, g, s, y, gamma, 1.0, 0.5),
                           update_ref(w.expand(K, d), gk, s, y, gamma, 1.0, 0.5))
        assert _build.LAUNCHES == before   # no kernel ran on the CPU
