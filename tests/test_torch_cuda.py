"""The port's CUDA kernels against their plain PyTorch versions, on an
H100. Marked ``cuda``: they skip where there is no card of compute
capability 9.x. This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The two sides differ only in summation order: max |kernel - plain| <=
tol * max |plain| (or, where the result may cancel, tol times the largest
sum of its terms' magnitudes) with tol 1e-12 in float64 and 1e-5 in float32
(chained trajectory steps; Gram sums 1000 terms long).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.anderson import flat_gram, flat_update
from repro_torch.kernels.anderson.ref import gram_ref, update_ref
from repro_torch.kernels.local_update import fused_trajectory
from repro_torch.kernels.local_update.ops import inverse_count
from repro_torch.kernels.local_update.ref import trajectory_ref

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def card():
    """An H100-class card (compute capability 9.x), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def assert_close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _traj_case(rng, K, S, n, d, link, dtype):
    x = rng.standard_normal((K, S, n, d)).astype(dtype)
    if link == "logistic":
        y = rng.choice([-1.0, 1.0], (K, S, n)).astype(dtype)
    else:
        y = rng.standard_normal((K, S, n)).astype(dtype)
    mask = np.ones((K, S, n), dtype)
    mask[1, :, n - 5:] = 0.0            # a ragged client
    w0 = (0.1 * rng.standard_normal((K, d))).astype(dtype)
    u = (0.01 * rng.standard_normal((K, d))).astype(dtype)
    return x, y, mask, w0, u


def _aa_case(rng, K, m, d, dtype):
    y = rng.standard_normal((K, m, d)).astype(dtype)
    s = rng.standard_normal((K, m, d)).astype(dtype)
    g = rng.standard_normal(d).astype(dtype)
    w = rng.standard_normal(d).astype(dtype)
    gamma = rng.standard_normal((K, m)).astype(dtype)
    return y, s, g, w, gamma


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("link", ["logistic", "linear"])
@pytest.mark.parametrize("anchor", [0.0, 1.0])
@pytest.mark.parametrize("per_step", [False, True])
def test_trajectory_kernel_on_card(card, dtype, link, anchor, per_step):
    steps = 5
    S = steps if per_step else 1
    rng = np.random.default_rng(11)
    npd = np.float64 if dtype == torch.float64 else np.float32
    x, y, mask, w0, u = (torch.from_numpy(a).to(card) for a in _traj_case(
        rng, 7, S, 333, 54, link, npd))
    kw = dict(link=link, reg=1e-3, eta=0.5, anchor_scale=anchor, steps=steps)
    n0 = _build.LAUNCHES["trajectory"]
    w_k, r_k = fused_trajectory(x, y, mask, w0, u, **kw)
    torch.cuda.synchronize(card)
    assert _build.LAUNCHES["trajectory"] == n0 + 1
    w_p, r_p = trajectory_ref(x, y, mask, w0, u, inverse_count(mask, dtype),
                              **kw)
    tol = TOL[npd]
    assert_close(w_k.cpu(), w_p.cpu(), tol)
    assert_close(r_k.cpu(), r_p.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shared", [True, False])
def test_anderson_kernels_on_card(card, dtype, shared):
    npd = np.float64 if dtype == torch.float64 else np.float32
    K, m, d = 9, 10, 1000
    y, s, g, w, gamma = (torch.from_numpy(a).to(card) for a in _aa_case(
        np.random.default_rng(12), K, m, d, npd))
    if not shared:
        g, w = g.expand(K, d).contiguous(), w.expand(K, d) + 1.0
    # float32 sums of d=1000 terms carry ~sqrt(1000) ulps
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    gram_k, yg_k = flat_gram(y, g)
    gram_p, yg_p = gram_ref(y, g)
    assert_close(gram_k.cpu(), gram_p.cpu(), tol)
    # Y g and the update may cancel: their error scales with |terms|
    ya, ga = y.abs(), gamma.abs().unsqueeze(-2)
    err = (yg_k - yg_p).abs().max()
    assert err <= tol * (ya @ g.abs().expand(K, d).unsqueeze(-1)).max()
    new_k = flat_update(w, g, s, y, gamma, 0.7, 0.9)
    new_p = update_ref(w, g, s, y, gamma, 0.7, 0.9)
    scale = w.abs() + 0.7 * g.abs() + 0.9 * (ga @ s.abs() + 0.7 * (ga @ ya)
                                             ).squeeze(-2)
    assert (new_k - new_p).abs().max() <= tol * scale.max()
    with pytest.raises(ValueError, match="expected shape"):
        flat_gram(y, g[..., :-1])
