"""The port's Anderson step (repro_torch/core/anderson.py) against the JAX
package's core/anderson.py, on both of the port's paths ("tree": plain
tensor ops; "kernel": the Gram and update kernels, whose plain versions run
on the CPU).

Accumulation. The reference's tree_math helpers cast every leaf to float32
before a product (repro/utils/tree_math.py: tree_dot, tree_gram,
tree_vdot_stacked, tree_combine_stacked), so its AA step accumulates in f32
even in an f64 run. The port accumulates f64 inputs in f64. To hold the two
to 1e-10 in f64, the ``ref_f64`` fixture swaps f64-accumulating versions of
those helpers into the reference for one test (nothing in the JAX package
changes); one test pins the size of the difference against the unpatched
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree_math as jax_tm
from repro.core import anderson as jax_aa
from repro_torch.core import anderson as aa
from repro_torch.core.anderson import AAConfig, multisecant_update

from torch_threads import one_torch_thread  # noqa: F401

IMPLS = ["tree", "kernel"]


@pytest.fixture
def x64():
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


@pytest.fixture
def ref_f64(x64, monkeypatch):
    """The reference's AA contractions, accumulating in the leaves' dtype
    (flat [d] leaves, as the logistic model has)."""
    monkeypatch.setattr(jax_tm, "tree_dot", lambda a, b: jnp.sum(a * b))
    monkeypatch.setattr(jax_tm, "tree_vdot_stacked", lambda s, v: s @ v)
    monkeypatch.setattr(jax_tm, "tree_gram", lambda a, b: a @ b.T)
    monkeypatch.setattr(jax_tm, "tree_combine_stacked", lambda s, c: c @ s)


def assert_close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def random_histories(K, m, d, seed, dtype=np.float64):
    """Well-conditioned S/Y (random walks on a quadratic), one per client."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    A = (Q * np.geomspace(1.0, 50.0, d)) @ Q.T
    b = rng.standard_normal(d)
    ws = np.cumsum(rng.standard_normal((K, m + 1, d)), axis=1) * 0.1
    rs = ws @ A.T - b
    s, y = ws[:, 1:] - ws[:, :-1], rs[:, 1:] - rs[:, :-1]
    w = ws[0, 0]
    g = rs[0, 0]
    return (a.astype(dtype) for a in (w, g, s, y))


class TestAgainstReference:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_f64_matches_reference_tree_path(self, ref_f64, impl):
        K, m, d = 3, 5, 12
        w, g, s, y = random_histories(K, m, d, seed=3)
        cfg = AAConfig()
        t = torch.from_numpy
        new_w, st = multisecant_update(t(w), t(g), t(s), t(y), 0.3, cfg,
                                       impl=impl)
        assert new_w.shape == (K, d) and new_w.dtype == torch.float64
        for k in range(K):
            ref_w, ref_st = jax_aa.multisecant_update(
                jnp.asarray(w), jnp.asarray(g), jnp.asarray(s[k]),
                jnp.asarray(y[k]), 0.3, cfg, impl="tree")
            assert_close(new_w[k], ref_w, 1e-10)
            for field in ("theta", "gamma_norm", "gram_cond"):
                assert_close(getattr(st, field)[k], getattr(ref_st, field),
                             1e-10)
            assert int(st.used_columns[k]) == int(ref_st.used_columns)
            # the dense multisecant formula (paper Eq. 7), Tikhonov aside
            S, Y = s[k].T, y[k].T
            Hinv = 0.3 * np.eye(d) + (S - 0.3 * Y) @ np.linalg.pinv(Y.T @ Y) @ Y.T
            assert_close(new_w[k], w - Hinv @ g, 1e-8)

    def test_reference_accumulates_in_f32(self, x64):
        """Unpatched, the reference's f64 step carries f32 rounding: on these
        well-conditioned histories it sits ~1e-7 from the port, far above
        f64 round-off."""
        w, g, s, y = random_histories(1, 5, 12, seed=3)
        port, _ = multisecant_update(*(torch.from_numpy(a) for a in
                                       (w, g, s, y)), 0.3)
        ref, _ = jax_aa.multisecant_update(
            *(jnp.asarray(a) for a in (w, g, s[0], y[0])), 0.3, impl="tree")
        err = np.abs(port[0].numpy() - np.asarray(ref)).max() / np.abs(ref).max()
        assert 1e-12 < err < 1e-5

    def test_solve_gram_batched(self, x64):
        rng = np.random.default_rng(0)
        m = 5
        grams = []
        for rank in (5, 3, 0):
            a = rng.standard_normal((m, rank))
            grams.append(a @ a.T)
        gram = np.stack(grams)
        rhs = rng.standard_normal((3, m))
        mask = np.array([[True] * 5, [True, False, True, True, False],
                         [True] * 5])
        # filtering on: a rank-deficient system is otherwise solved on
        # eigenvalues at round-off, where two LAPACKs legitimately disagree
        for cfg in (AAConfig(filter_rtol=1e-8),
                    AAConfig(filter_rtol=1e-6, tikhonov=0.0)):
            for col_mask in (None, mask):
                got = aa._solve_gram(torch.from_numpy(gram),
                                     torch.from_numpy(rhs), cfg,
                                     None if col_mask is None
                                     else torch.from_numpy(col_mask))
                for k in range(3):
                    ref = jax_aa._solve_gram(
                        jnp.asarray(gram[k]), jnp.asarray(rhs[k]), cfg,
                        None if col_mask is None else jnp.asarray(col_mask[k]))
                    if float(np.abs(ref[0]).max()) == 0.0:
                        assert float(got[0][k].abs().max()) == 0.0
                    else:
                        assert_close(got[0][k], ref[0], 1e-9)
                    assert float(got[1][k]) == pytest.approx(float(ref[1]),
                                                             rel=1e-6)
                    assert int(got[2][k]) == int(ref[2])

    @pytest.mark.parametrize("ema", [0.0, 0.3])
    def test_trajectory_to_sy(self, x64, ema):
        rng = np.random.default_rng(2)
        wt, rt = rng.standard_normal((2, 3, 6, 7))
        s, y = aa.trajectory_to_sy(torch.from_numpy(wt), torch.from_numpy(rt),
                                   ema)
        for k in range(3):
            rs, ry = jax_aa.trajectory_to_sy(jnp.asarray(wt[k]),
                                             jnp.asarray(rt[k]), ema)
            assert_close(s[k], rs, 1e-14)
            assert_close(y[k], ry, 1e-14)


def f32_case():
    """A well-conditioned f32 history of one client ([1, m, d] stacks), as
    tests/test_anderson.py uses."""
    w, g, s, y = random_histories(1, 5, 8, seed=0, dtype=np.float32)
    return (torch.from_numpy(a) for a in (w, g, s, y))


class TestDegenerateGram:
    """Degenerate systems give Γ=0 and the plain damped-gradient step
    bit-exactly, never NaN, on both paths."""

    @pytest.mark.parametrize("impl", IMPLS)
    def test_rank0_identical_columns_degrades_to_gradient_step(self, impl):
        w, g, s, y = f32_case()
        new_w, st = multisecant_update(w, g, s, torch.zeros_like(y), 0.05,
                                       AAConfig(), impl=impl)
        assert torch.equal(new_w[0], w - 0.05 * g)
        assert int(st.used_columns) == 0
        assert float(st.gram_cond) == 1.0
        assert np.isfinite(float(st.theta))

    @pytest.mark.parametrize("impl", IMPLS)
    def test_all_clipped_degrades_to_gradient_step(self, impl):
        w, g, s, y = f32_case()
        new_w, st = multisecant_update(w, g, s, torch.full_like(y, torch.inf),
                                       0.05, AAConfig(clip_rtol=1e-3), impl=impl)
        assert torch.equal(new_w[0], w - 0.05 * g)
        assert int(st.clipped_columns) == 5
        assert int(st.used_columns) == 0


class TestClipScreen:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_clean_history_is_bit_identical(self, impl):
        w, g, s, y = f32_case()
        a, _ = multisecant_update(w, g, s, y, 0.05, AAConfig(), impl=impl)
        b, st = multisecant_update(w, g, s, y, 0.05, AAConfig(clip_rtol=1e-3),
                                   impl=impl)
        assert torch.equal(a, b)
        assert int(st.clipped_columns) == 0

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("scale", [1e6, 1e24, np.inf])
    def test_poisoned_column_dropped_and_step_finite(self, impl, scale):
        w, g, s, y = f32_case()
        cfg = AAConfig(clip_rtol=1e-3)
        ypois = y.clone()
        ypois[0, -1] = y[0, -1] * scale
        w_def, st = multisecant_update(w, g, s, ypois, 0.05, cfg, impl=impl)
        assert int(st.clipped_columns) == 1
        assert torch.isfinite(w_def).all() and np.isfinite(float(st.theta))
        yref, sref = ypois.clone(), s.clone()
        yref[0, -1] = 0.0
        sref[0, -1] = 0.0
        w_ref, _ = multisecant_update(w, g, sref, yref, 0.05, cfg, impl=impl)
        torch.testing.assert_close(w_def, w_ref, rtol=1e-6, atol=1e-6)
        # and the reference screens the same column to the same step
        j_w, j_st = jax_aa.multisecant_update(
            *(jnp.asarray(a.numpy()) for a in (w, g, s[0], ypois[0])), 0.05,
            cfg)
        assert int(j_st.clipped_columns) == 1
        torch.testing.assert_close(w_def[0], torch.from_numpy(np.array(j_w)),
                                   rtol=1e-5, atol=1e-5)

    def test_undefended_overflow_goes_nonfinite(self):
        w, g, s, y = f32_case()
        ypois = y.clone()
        ypois[0, -1] = y[0, -1] * 1e24
        w_und, _ = multisecant_update(w, g, s, ypois, 0.05, AAConfig())
        assert not torch.isfinite(w_und).all()

    def test_tiny_columns_are_kept(self):
        w, g, s, y = f32_case()
        ysmall = y.clone()
        ysmall[0, -1] = y[0, -1] * 1e-8
        _, st = multisecant_update(w, g, s, ysmall, 0.05,
                                   AAConfig(clip_rtol=1e-3))
        assert int(st.clipped_columns) == 0

    @pytest.mark.parametrize("norms", [[1.0, 2.0, 3.0, 100.0],
                                       [1.0, 2.0, 3.0, 3.5, np.inf]])
    def test_even_count_median_averages_the_middle_pair(self, x64, norms):
        """Over an even count of finite columns the median is the mean of the
        middle two (jnp.nanmedian), not the lower one (torch.nanmedian): at
        clip_rtol=0.8 the column of norm 3 stays (2.4 <= 2.5), where the lower
        median (2) would drop it."""
        gram = np.diag(np.square(norms))
        cfg = AAConfig(clip_rtol=0.8)
        keep = aa._residual_clip_mask(torch.from_numpy(gram)[None], cfg)[0]
        ref = jax_aa._residual_clip_mask(jnp.asarray(gram), cfg)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
        assert keep.tolist()[:3] == [True, True, True]
        assert not keep.tolist()[-1]
