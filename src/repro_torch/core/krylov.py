"""GMRES for K systems at once: the counterpart of the one call the
reference's Newton-GMRES makes, ``jax.scipy.sparse.linalg.gmres(matvec, b,
maxiter=1, restart=L, tol=0.0, solve_method="incremental")``
(repro/core/algorithms.py::_client_newton_gmres), batched over the client
axis. The helpers keep the names of JAX's
``jax/_src/scipy/sparse/linalg.py``, which this follows step for step:

  * one restart of at most ``min(restart, d)`` Arnoldi steps from x0 = 0,
    whose residual b − A·0 is b exactly (that product is skipped);
  * each step orthogonalises by one classical Gram-Schmidt pass: JAX's
    ``_iterative_classical_gram_schmidt(..., max_iterations=2)`` stops after
    its first projection;
  * a breakdown (the new vector's norm at most eps times its norm before
    the projection) stores a zero vector, and the step's rotation then
    zeroes the residual estimate;
  * the QR factorisation grows by Givens rotations, R starts as
    ``eye(restart, restart + 1)``;
  * with tol = atol = 0 the loop runs while |β[k+1]| > ptol, where ptol is
    0, or nan for b = 0 (no step runs, x = 0).

JAX stops each system's loop on its own (under vmap). Here every system
runs ``restart`` steps and a step is kept per system with ``torch.where``
only while that system's loop would still run: the same values, no host
read and no branch on data, so a CUDA graph can capture it.
"""
from __future__ import annotations

from typing import Callable

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """(x / ‖x‖, ‖x‖) over the last axis, both zero where ‖x‖ <= thresh
    (the dtype's eps by default, or one threshold per leading index)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    unit = torch.where(use[..., None], x / norm[..., None], 0.0)
    return unit, torch.where(use, norm, 0.0)


def _kth_arnoldi_iteration(k: int, A: Callable, V: torch.Tensor):
    """Step k of the Arnoldi process: w = A(V_k) orthogonalised against the
    Krylov vectors V [K, r+1, d] (its rows) by one classical Gram-Schmidt
    pass. Returns (the new unit vector [K, d], zero on a breakdown; the
    row of H, [K, r+1]: the overlaps, with the new vector's norm at k+1)."""
    eps = torch.finfo(V.dtype).eps
    v = A(V[:, k])
    _, v_norm_0 = _safe_normalize(v)
    h = (V @ v[..., None]).squeeze(-1)
    v = v - (h[:, None, :] @ V).squeeze(1)
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    h[:, k + 1] = v_norm_1
    return unit_v, h


def _rotate_vectors(H: torch.Tensor, i: int, cs: torch.Tensor,
                    sn: torch.Tensor) -> None:
    """Rotate entries i and i+1 of every row of H [K, n] in place by the
    rotations (cs, sn) [K]."""
    x1, y1 = H[:, i].clone(), H[:, i + 1].clone()
    H[:, i] = cs * x1 - sn * y1
    H[:, i + 1] = sn * x1 + cs * y1


def _givens_rotation(a: torch.Tensor, b: torch.Tensor):
    """(cs, sn) [K] of the rotations that zero b against a."""
    b_zero = b.abs() == 0
    a_lt_b = a.abs() < b.abs()
    t = -torch.where(a_lt_b, a, b) / torch.where(a_lt_b, b, a)
    r = torch.rsqrt(1 + t.abs() ** 2)
    cs = torch.where(b_zero, 1.0, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, 0.0, torch.where(a_lt_b, r, r * t))
    return cs, sn


def _apply_givens_rotations(H_row: torch.Tensor, givens: torch.Tensor, k: int):
    """Apply the stored rotations givens[:, :k] [K, k, 2] to H_row [K, r+1],
    then the new one that zeroes its entry k+1. Returns (the rotated row,
    the new rotation's (cs, sn))."""
    R_row = H_row.clone()
    for i in range(k):
        _rotate_vectors(R_row, i, givens[:, i, 0], givens[:, i, 1])
    cs, sn = _givens_rotation(R_row[:, k], R_row[:, k + 1])
    _rotate_vectors(R_row, k, cs, sn)
    return R_row, cs, sn


def _gmres_incremental(A: Callable, b: torch.Tensor, restart: int) -> torch.Tensor:
    """One restart of incremental GMRES from x0 = 0 for each row of b [K, d]
    with ``A`` mapping [K, d] to [K, d] (system k's operator on row k)."""
    K, _ = b.shape
    dtype, dev = b.dtype, b.device
    b_norm = _norm(b)
    # tol = atol = 0: ptol = ‖b‖·min(1, 0/‖b‖), 0 or nan
    ptol = b_norm * torch.minimum(torch.ones_like(b_norm), 0.0 / b_norm)
    unit_residual, residual_norm = _safe_normalize(b)
    V = torch.zeros((K, restart + 1, b.shape[1]), dtype=dtype, device=dev)
    V[:, 0] = unit_residual
    R = torch.eye(restart, restart + 1, dtype=dtype, device=dev).repeat(K, 1, 1)
    givens = torch.zeros((K, restart, 2), dtype=dtype, device=dev)
    beta = torch.zeros((K, restart + 1), dtype=dtype, device=dev)
    beta[:, 0] = residual_norm
    err = residual_norm
    for k in range(restart):
        run = err > ptol
        unit_v, h = _kth_arnoldi_iteration(k, A, V)
        R_row, cs, sn = _apply_givens_rotations(h, givens, k)
        beta_k = beta.clone()
        _rotate_vectors(beta_k, k, cs, sn)
        V[:, k + 1] = torch.where(run[:, None], unit_v, V[:, k + 1])
        R[:, k] = torch.where(run[:, None], R_row, R[:, k])
        givens[:, k] = torch.where(run[:, None], torch.stack([cs, sn], -1),
                                   givens[:, k])
        beta = torch.where(run[:, None], beta_k, beta)
        err = torch.where(run, beta_k[:, k + 1].abs(), err)
    # y = solve_triangular(R[:, :-1].T, β[:-1]) (upper triangular), by back
    # substitution
    U = R[:, :, :-1].transpose(1, 2)
    y = torch.zeros((K, restart), dtype=dtype, device=dev)
    for i in reversed(range(restart)):
        acc = (U[:, i, i + 1:] * y[:, i + 1:]).sum(-1)
        y[:, i] = (beta[:, i] - acc) / U[:, i, i]
    return (y[:, None, :] @ V[:, :-1]).squeeze(1)


def gmres(A: Callable, b: torch.Tensor, restart: int) -> torch.Tensor:
    """x [K, d] with A(x) ≈ b from a Krylov space of min(restart, d)
    dimensions: ``jax.scipy.sparse.linalg.gmres(A, b, maxiter=1,
    restart=restart, tol=0.0, solve_method="incremental")`` for each row of
    b [K, d]; ``A`` maps [K, d] to [K, d], row k by system k's operator."""
    return _gmres_incremental(A, b, min(restart, b.shape[-1]))
