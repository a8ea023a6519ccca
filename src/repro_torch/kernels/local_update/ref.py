"""Plain PyTorch version of the fused local-trajectory kernel.

Counterpart of repro/kernels/local_update/ref.py::trajectory_ref, op for
op (same link coefficients, same row-vector contractions, same emit
expression), with an explicit leading client axis K in place of the
reference's vmap. For a resident design (S == 1) the anchor coefficients
are step-invariant and are hoisted out of the step loop; the CUDA kernel
(csrc/trajectory.cu) recomputes them per step from the same rows.

The CPU tests use it against the JAX oracle, and chip_smoke.py holds the
CUDA kernel against it on the card; nothing on the main path calls it when
a card is present.
"""
from __future__ import annotations

import torch

#: links the kernel family knows how to differentiate
LINKS = ("logistic", "linear")


def link_coeff(link: str, z: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Per-sample gradient coefficient c(z) with d loss_j/dw = c_j · x_j.

    logistic: loss_j = softplus(−y_j z_j)   → c_j = −y_j σ(−y_j z_j)
    linear:   loss_j = ½ (z_j − y_j)²       → c_j = z_j − y_j
    """
    if link == "logistic":
        return (-y) * torch.sigmoid(-(z * y)) * mask
    if link == "linear":
        return (z - y) * mask
    raise ValueError(f"unknown link {link!r}; choose from {LINKS}")


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def trajectory_ref(x, y, mask, w0, u, invn, *, link: str, eta: float,
                   reg: float, anchor_scale: float, steps: int):
    """x: [K, S, n, d]; y, mask: [K, S, n]; w0, u: [K, d]; invn: [K]
    (S ∈ {1, steps}). Returns (w_traj, r_traj), each [K, steps, d] in
    w0.dtype.

    Step ℓ emits (w_ℓ, r_ℓ) with r = Xᵀ(c(Xw) − a·c(Xw0))/n + reg·w + u,
    then w ← w − η·r.
    """
    S = x.shape[1]
    if S not in (1, steps):
        raise ValueError(f"S={S} must be 1 or steps={steps}")
    out_dtype = w0.dtype
    cd = compute_dtype(out_dtype)
    xc, yc, mc = x.to(cd), y.to(cd), mask.to(cd)
    w0c, uc = w0.to(cd), u.to(cd)
    inv = invn.to(cd)[:, None]
    anchor = anchor_scale == 1.0

    def row_dot(w, xs):
        """[K, d] · [K, n, d]ᵀ → [K, n] (the kernel's forward contraction)."""
        return torch.bmm(xs, w.unsqueeze(-1)).squeeze(-1)

    def col_dot(c, xs):
        """[K, n] · [K, n, d] → [K, d] (the kernel's backward accumulation)."""
        return torch.bmm(c.unsqueeze(1), xs).squeeze(1)

    def anchor_coeff(blk):
        xs, ys, ms = xc[:, blk], yc[:, blk], mc[:, blk]
        return link_coeff(link, row_dot(w0c, xs), ys, ms)

    c_anc = anchor_coeff(0) if (anchor and S == 1) else None
    w = w0c
    w_traj, r_traj = [], []
    for step in range(steps):
        blk = 0 if S == 1 else step
        xs, ys, ms = xc[:, blk], yc[:, blk], mc[:, blk]
        c = link_coeff(link, row_dot(w, xs), ys, ms)
        if anchor:
            c = c - (c_anc if S == 1 else anchor_coeff(blk))
        r = col_dot(c, xs) * inv + reg * w + uc
        w_traj.append(w.to(out_dtype))
        r_traj.append(r.to(out_dtype))
        w = w - eta * r
    return torch.stack(w_traj, 1), torch.stack(r_traj, 1)
