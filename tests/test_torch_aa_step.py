"""The fused AA step's plain version (kernels/anderson/ref.py: aa_step_ref
and its Jacobi eigen-solve jacobi_eigh_ref), the one the CPU runs where the
card launches csrc/update.cu's repro_aa_step, against numpy's eigh, the
port's tree path (torch.linalg.eigh) and the JAX reference's tree path.

Tolerances. Jacobi's eigenvalues lie within 4·m·eps·λ_max of numpy's, its
eigenvectors are orthonormal within 8·m·eps, and its solve Γ = V Λ⁻¹ Vᵀ r
lies within 4·m·cond·eps·max|Γ| of numpy's (eps the dtype's machine
epsilon; a perturbation of the matrix by eps moves Γ by up to cond·eps).
Against the tree paths, on well-conditioned histories, 1e-10 in float64
(the reference with f64 accumulation patched in, as
tests/test_torch_anderson.py does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anderson as jax_aa
from repro_torch.core import anderson as aa
from repro_torch.core.anderson import AAConfig
from repro_torch.kernels.anderson import aa_step, aa_step_ref, gram_ref
from repro_torch.kernels.anderson.ref import (MAX_SWEEPS, clip_keep_ref,
                                              jacobi_eigh_ref, round_robin_pairs)

from test_torch_anderson import (assert_close, f32_case, random_histories,  # noqa: F401
                                 ref_f64, x64)

from torch_threads import one_torch_thread  # noqa: F401


def spd_batch(rng, K, m, cond, dtype):
    """K random symmetric positive definite [m, m] matrices with eigenvalues
    spread geometrically from 1 down to 1/cond."""
    out = []
    for _ in range(K):
        Q = np.linalg.qr(rng.standard_normal((m, m)))[0]
        out.append((Q * np.geomspace(1.0, 1.0 / cond, m)) @ Q.T)
    a = np.stack(out)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(dtype)


def knobs(cfg: AAConfig) -> dict:
    return dict(damping=cfg.damping, tikhonov=cfg.tikhonov,
                filter_rtol=cfg.filter_rtol, clip_rtol=cfg.clip_rtol)


def fused(w, g, s, y, eta, cfg):
    """The fused plain path from histories: the Gram pass, then aa_step_ref."""
    gram, yg = gram_ref(y, g)
    return aa_step_ref(w, g, s, y, gram, yg, eta, **knobs(cfg))


@pytest.mark.parametrize("n", [2, 4, 10, 64])
def test_round_robin_rounds_are_disjoint_and_meet_every_pair_once(n):
    rounds = round_robin_pairs(n)
    assert len(rounds) == n - 1
    met = []
    for ps, qs in rounds:
        assert len(ps) == n // 2 and all(p < q for p, q in zip(ps, qs))
        assert sorted(ps + qs) == list(range(n))
        met += list(zip(ps, qs))
    assert sorted(met) == [(p, q) for p in range(n) for q in range(p + 1, n)]


#: the Jacobi grid: dtypes, sizes and condition numbers. Its cases at m=64
#: take ~15–70 s each on the CPU alone and 2–5× that in a loaded run (the
#: plain version is a loop of rotation rounds), so this file runs
#: condition number 1 and each higher condition number and dtype has a
#: file of its own, test_torch_aa_step_jacobi_<cond>_<dtype>.py.
JACOBI_DTYPES = [np.float64, np.float32]
JACOBI_SIZES = [1, 2, 5, 10, 64]


def check_jacobi(dtype, m, cond):
    """jacobi_eigh_ref on K=3 SPD matrices against numpy's eigh."""
    rng = np.random.default_rng(m)
    K = 3
    a = spd_batch(rng, K, m, cond, dtype)
    evals, evecs, sweeps = jacobi_eigh_ref(torch.from_numpy(a))
    assert evals.dtype == evecs.dtype == torch.from_numpy(a).dtype
    assert bool((sweeps <= MAX_SWEEPS).all())
    eps = np.finfo(dtype).eps
    a64 = a.astype(np.float64)
    ev_np, V_np = np.linalg.eigh(a64)
    ev, V = evals.numpy().astype(np.float64), evecs.numpy().astype(np.float64)
    lmax = np.abs(ev_np).max(-1, keepdims=True)
    assert (np.abs(np.sort(ev, -1) - ev_np) <= 4 * m * eps * lmax).all()
    orth = np.abs(V.transpose(0, 2, 1) @ V - np.eye(m)).max()
    assert orth <= 8 * m * eps, orth
    if cond * eps <= 1e-3:   # below that the matrix is singular in its dtype
        r = rng.standard_normal((K, m))
        gamma = np.einsum("kij,kj,klj,kl->ki", V, 1 / ev, V, r)
        gamma_np = np.einsum("kij,kj,klj,kl->ki", V_np, 1 / ev_np, V_np, r)
        err = np.abs(gamma - gamma_np).max(-1)
        assert (err <= 4 * m * cond * eps * np.abs(gamma_np).max(-1)).all()


@pytest.mark.parametrize("dtype", JACOBI_DTYPES)
@pytest.mark.parametrize("m", JACOBI_SIZES)
@pytest.mark.parametrize("cond", [1e0])
def test_jacobi_matches_numpy_eigh(dtype, m, cond):
    check_jacobi(dtype, m, cond)


def test_jacobi_is_diagonal_already_and_pads_odd_m():
    """A diagonal matrix takes no sweep; an odd m runs on a zero-padded even
    matrix and returns m eigenpairs."""
    a = torch.diag(torch.tensor([3.0, 1.0, 2.0], dtype=torch.float64))[None]
    evals, evecs, sweeps = jacobi_eigh_ref(a)
    assert int(sweeps) == 0 and evals.shape == (1, 3)
    assert torch.equal(evals[0], torch.tensor([3.0, 1.0, 2.0], dtype=torch.float64))
    assert torch.equal(evecs[0], torch.eye(3, dtype=torch.float64))


class TestAgainstTreePaths:
    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("cfg", [AAConfig(), AAConfig(filter_rtol=1e-12),
                                     AAConfig(clip_rtol=1e-3, damping=0.7)])
    def test_f64_matches_port_and_reference_tree_paths(self, ref_f64, shared,
                                                       cfg):
        K, m, d = 3, 5, 12
        w, g, s, y = random_histories(K, m, d, seed=4)
        t = torch.from_numpy
        wt, gt = t(w), t(g)
        if not shared:
            wt, gt = wt + torch.arange(K, dtype=wt.dtype)[:, None], gt.expand(K, d)
        new_w, gamma, theta, gnorm, cond, used, clipped = fused(
            wt, gt, t(s), t(y), 0.3, cfg)
        tree_w, tree_st = aa.multisecant_update(wt, gt, t(s), t(y), 0.3, cfg,
                                                impl="tree")
        assert_close(new_w, tree_w, 1e-10)
        for got, want in ((theta, tree_st.theta), (gnorm, tree_st.gamma_norm),
                          (cond, tree_st.gram_cond)):
            assert_close(got, want, 1e-10)
        assert torch.equal(used, tree_st.used_columns)
        assert torch.equal(clipped, tree_st.clipped_columns)
        wk, gk = wt.expand(K, d).numpy(), gt.expand(K, d).numpy()
        for k in range(K):
            ref_w, ref_st = jax_aa.multisecant_update(
                jnp.asarray(wk[k]), jnp.asarray(gk[k]), jnp.asarray(s[k]),
                jnp.asarray(y[k]), 0.3, cfg, impl="tree")
            assert_close(new_w[k], ref_w, 1e-10)
            assert_close(theta[k], ref_st.theta, 1e-10)
            assert int(used[k]) == int(ref_st.used_columns)
            assert int(clipped[k]) == int(ref_st.clipped_columns)

    def test_kernel_path_on_cpu_is_the_fused_plain_path(self):
        """multisecant_update(impl="kernel") on CPU tensors is flat_gram then
        aa_step_ref, bit for bit, and the wrapper is the plain version."""
        w, g, s, y = (torch.from_numpy(a) for a in random_histories(2, 4, 9, 5))
        cfg = AAConfig(tikhonov=1e-8, clip_rtol=0.5)
        new_w, st = aa.multisecant_update(w, g, s, y, 0.4, cfg, impl="kernel")
        gram, yg = gram_ref(y, g)
        got = aa_step(w, g, s, y, gram, yg, 0.4, **knobs(cfg))
        want = aa_step_ref(w, g, s, y, gram, yg, 0.4, **knobs(cfg))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(new_w, want[0])
        assert torch.equal(st.theta, want[2]) and torch.equal(st.gram_cond, want[4])

    def test_wrapper_raises_on_what_the_kernel_does_not_take(self):
        w, g, s, y = (torch.from_numpy(a) for a in random_histories(2, 4, 9, 5))
        gram, yg = gram_ref(y, g)
        kw = knobs(AAConfig())
        with pytest.raises(TypeError, match="one dtype"):
            aa_step(w.float(), g, s, y, gram, yg, 0.4, **kw)
        with pytest.raises(TypeError, match="one dtype"):
            aa_step(*(t.half() for t in (w, g, s, y, gram, yg)), 0.4, **kw)
        with pytest.raises(ValueError, match="shapes"):
            aa_step(w, g, s, y, gram[:, :3], yg, 0.4, **kw)
        with pytest.raises(ValueError, match="expected shape"):
            aa_step(w[:-1], g, s, y, gram, yg, 0.4, **kw)


class TestDegenerate:
    """Through the fused plain path: degenerate systems give the reference's
    answers."""

    def test_rank0_gives_the_gradient_step(self):
        w, g, s, y = f32_case()
        new_w, gamma, theta, _, cond, used, clipped = fused(
            w, g, s, torch.zeros_like(y), 0.05, AAConfig())
        assert torch.equal(new_w[0], w - 0.05 * g)
        assert float(gamma.abs().max()) == 0.0
        assert int(used) == 0 and float(cond) == 1.0 and int(clipped) == 0
        assert float(theta) == 1.0

    def test_all_clipped_gives_the_gradient_step(self):
        w, g, s, y = f32_case()
        new_w, gamma, _, _, cond, used, clipped = fused(
            w, g, torch.full_like(s, torch.inf), torch.full_like(y, torch.inf),
            0.05, AAConfig(clip_rtol=1e-3))
        assert torch.equal(new_w[0], w - 0.05 * g)
        assert int(clipped) == 5 and int(used) == 0 and float(cond) == 1.0

    def test_inf_column_is_dropped_by_selection(self):
        """An infinite column (S and Y) is screened; the step equals the one
        without that column and is finite."""
        w, g, s, y = f32_case()
        cfg = AAConfig(clip_rtol=1e-3)
        sp, yp = s.clone(), y.clone()
        sp[0, 2], yp[0, 2] = torch.inf, -torch.inf
        got = fused(w, g, sp, yp, 0.05, cfg)
        keep = [0, 1, 3, 4]
        want = fused(w, g, s[:, keep], y[:, keep], 0.05, cfg)
        assert int(got[6]) == 1 and torch.isfinite(got[0]).all()
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        assert int(got[5]) == int(want[5])

    def test_undefended_overflow_goes_nonfinite(self):
        """Without the screen, an overflowing column makes the system
        non-finite: Γ = NaN, used 0, cond 1, as the tree path's solve."""
        w, g, s, y = f32_case()
        ypois = y.clone()
        ypois[0, -1] = y[0, -1] * 1e24
        new_w, gamma, theta, gnorm, cond, used, _ = fused(
            w, g, s, ypois, 0.05, AAConfig())
        assert not torch.isfinite(new_w).all()
        assert bool(torch.isnan(gamma).all()) and bool(torch.isnan(theta).all())
        assert int(used) == 0 and float(cond) == 1.0
        _, tree_st = aa.multisecant_update(w, g, s, ypois, 0.05, AAConfig(),
                                           impl="tree")
        assert int(tree_st.used_columns) == 0 and float(tree_st.gram_cond) == 1.0

    @pytest.mark.parametrize("norms", [[1.0, 2.0, 3.0, 100.0],
                                       [1.0, 2.0, 3.0, 3.5, np.inf],
                                       [np.inf, np.nan], [4.0]])
    def test_screen_median_matches_reference(self, x64, norms):
        """The even-count median averages the middle pair (clip_rtol=0.8
        keeps the column of norm 3: 2.4 <= 2.5); non-finite columns always
        go; with none finite, none stays."""
        gram = np.diag(np.square(norms))
        cfg = AAConfig(clip_rtol=0.8)
        keep = clip_keep_ref(torch.from_numpy(gram)[None], cfg.clip_rtol)[0]
        ref = jax_aa._residual_clip_mask(jnp.asarray(gram), cfg)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
        tree = aa._residual_clip_mask(torch.from_numpy(gram)[None], cfg)[0]
        assert torch.equal(keep, tree)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_clip_on_with_clean_history_is_bit_identical_to_clip_off(dtype):
    w, g, s, y = (torch.from_numpy(a) for a in random_histories(3, 6, 10, 7,
                                                                 dtype))
    off = fused(w, g, s, y, 0.5, AAConfig())
    on = fused(w, g, s, y, 0.5, AAConfig(clip_rtol=1e-3))
    assert int(on[6].sum()) == 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)
