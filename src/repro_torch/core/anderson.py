"""Anderson acceleration core (paper §2.2, Eq. 4–7; counterpart of
repro/core/anderson.py).

FedOSAA's multisecant step, batched over a leading client axis K:

    w⁺ = w − η g − β (S − ηY) Γ,   Γ = (YᵀY)⁻¹ Yᵀ g

with the stability options of paper Appendix A (Tikhonov regularization,
spectral filtering, damping) and the clip_rtol byzantine-column screen.
Two implementations share the [m, m] solve (``_solve_gram``):

* ``impl="tree"``   — plain tensor ops (utils/tree_math.py);
* ``impl="kernel"`` — the single-pass Gram and update kernels
  (kernels/anderson: csrc/gram.cu, csrc/update.cu on the card, their plain
  versions on the CPU).

Both accumulate in the inputs' dtype (f64 for f64). The reference
accumulates in f32 on both of its paths, even in f64 runs; see PERF.md.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.anderson import ops as aa_ops
from repro_torch.utils import tree_math as tm


@dataclasses.dataclass(frozen=True)
class AAConfig:
    """Knobs for one Anderson-acceleration step (see the reference's
    AAConfig for the full rationale).

    tikhonov: relative Tikhonov term; the system solved is
      (YᵀY + λ·tr(YᵀY)/m·I). 0 disables.
    filter_rtol: drop eigen-directions of the Gram matrix below
      filter_rtol × λ_max. 0 disables.
    damping: β, the scale on the quasi-Newton correction. 1.0 = paper.
    residual_ema: EMA over the residuals before building Y (App. A option 3).
    clip_rtol: drop history columns with clip_rtol·‖y_i‖ > median(‖y‖)
      before the solve. 0 disables (and is an exact no-op).
    """

    tikhonov: float = 1e-10
    filter_rtol: float = 0.0
    damping: float = 1.0
    residual_ema: float = 0.0
    clip_rtol: float = 0.0


class AAStats(NamedTuple):
    """Diagnostics of one AA step, one entry per client."""

    theta: torch.Tensor          # optimization gain ‖(I−Proj_Y)g‖/‖g‖ (Eq. 9)
    gamma_norm: torch.Tensor     # ‖Γ‖ of the LS solution
    gram_cond: torch.Tensor      # condition estimate of the Gram matrix
    used_columns: torch.Tensor   # eigen-directions surviving filtering
    clipped_columns: torch.Tensor  # columns dropped by the clip_rtol screen


def _solve_gram(gram: torch.Tensor, rhs: torch.Tensor, cfg: AAConfig,
                col_mask: torch.Tensor | None = None):
    """Solve (YᵀY) Γ = Yᵀg robustly for a batch: gram [K, m, m], rhs [K, m].

    Returns (Γ [K, m], cond [K], used [K]). A symmetric eigendecomposition
    (batched ``torch.linalg.eigh``) gives filtering and conditioning for
    free. ``col_mask`` (bool [K, m]) removes masked columns from the system
    entirely (rows/cols, rhs and Tikhonov diagonal, by selection — a
    byzantine column may carry inf). A system that loses every direction
    gives Γ = 0 and cond 1.0. A system with non-finite entries gives Γ = NaN,
    as the reference's eigh does (torch's eigh would raise on it instead).
    """
    m = gram.shape[-1]
    tik_diag = torch.eye(m, dtype=gram.dtype, device=gram.device).expand_as(gram)
    if col_mask is not None:
        cm2 = col_mask[..., :, None] & col_mask[..., None, :]
        gram = torch.where(cm2, gram, 0.0)
        rhs = torch.where(col_mask, rhs, 0.0)
        tik_diag = torch.where(col_mask[..., :, None], tik_diag, 0.0)
    trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    lam = cfg.tikhonov * trace / m
    system = gram + lam[..., None, None] * tik_diag
    bad = ~torch.isfinite(system).all(-1).all(-1)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, system))
    evals = torch.clamp(evals, min=0.0)
    emax = evals.max(-1).values
    keep = evals > cfg.filter_rtol * emax[..., None]
    # never invert a (near-)zero eigenvalue even when filtering is off
    safe = evals > 1e-30 * torch.clamp(emax, min=1e-30)[..., None]
    keep = keep & safe
    inv = torch.where(keep, 1.0 / torch.where(keep, evals, 1.0), 0.0)
    proj = (evecs.transpose(-1, -2) @ rhs.unsqueeze(-1)).squeeze(-1)
    gamma = (evecs @ (inv * proj).unsqueeze(-1)).squeeze(-1)
    gamma = torch.where(bad[..., None], torch.nan, gamma)
    used = keep.sum(-1)
    emin_kept = torch.where(keep, evals, emax[..., None]).min(-1).values
    cond = torch.where(used > 0, emax / torch.clamp(emin_kept, min=1e-30),
                       torch.ones_like(emax))
    return gamma, cond, used


def _residual_clip_mask(gram: torch.Tensor, cfg: AAConfig) -> torch.Tensor:
    """Bool [K, m] keep-mask of the clip_rtol screen: the column norms ‖y_i‖
    come off the Gram diagonal and are compared with their median over the
    finite columns; non-finite columns are always dropped.

    ``jnp.nanmedian`` averages the two middle values of an even count;
    ``torch.nanmedian`` returns the lower one, so the median is taken as
    ``nanquantile(·, 0.5)``, which interpolates like the reference."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(gram, dim1=-2, dim2=-1), min=0.0))
    finite = torch.isfinite(norms)
    med = torch.nanquantile(torch.where(finite, norms, torch.nan), 0.5, dim=-1,
                            keepdim=True)
    return finite & (cfg.clip_rtol * norms <= med)


def _screened_solve(gram: torch.Tensor, rhs: torch.Tensor, cfg: AAConfig):
    """clip_rtol screen (python-gated: off → no screen ops at all) + solve.

    Returns (Γ, cond, used, clipped, keep); keep is None when the screen is
    off. When it is a mask, callers also zero the screened columns out of
    their own contractions (an infinite column times Γ_i = 0 is NaN)."""
    if cfg.clip_rtol > 0.0:
        keep = _residual_clip_mask(gram, cfg)
        clipped = gram.shape[-1] - keep.sum(-1)
        gamma, cond, used = _solve_gram(gram, rhs, cfg, keep)
        return gamma, cond, used, clipped, keep
    gamma, cond, used = _solve_gram(gram, rhs, cfg)
    return gamma, cond, used, torch.zeros_like(used), None


def _mask_stack_columns(stack: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the non-kept history columns of a [K, m, d] stack."""
    return torch.where(keep[..., None], stack, 0.0)


#: legal values of the AA-step implementation knob (AlgoHParams.aa_impl)
AA_IMPLS = ("auto", "tree", "kernel")


def resolve_aa_impl(impl: str) -> str:
    """"auto" resolves to the kernels. On the CPU their wrappers run the plain
    versions, so "auto" needs no knowledge of the device."""
    if impl not in AA_IMPLS:
        raise ValueError(f"unknown aa_impl {impl!r}; choose from {AA_IMPLS}")
    return "kernel" if impl == "auto" else impl


def multisecant_update(
    w: torch.Tensor,
    g: torch.Tensor,
    s_stack: torch.Tensor,
    y_stack: torch.Tensor,
    eta: float,
    cfg: AAConfig = AAConfig(),
    impl: str = "tree",
) -> tuple[torch.Tensor, AAStats]:
    """FedOSAA's one-step AA update (Algorithm 1, lines 15–18), per client.

    w, g: [d] (shared by every client: the anchor w^t and ∇f(w^t)) or
      [K, d]; s_stack, y_stack: [K, m, d] histories,
      s_ℓ = w_{ℓ+1} − w_ℓ, y_ℓ = r_{ℓ+1} − r_ℓ.
    Returns (w⁺ [K, d], stats with [K] entries).
    """
    if resolve_aa_impl(impl) == "kernel":
        return _multisecant_update_kernel(w, g, s_stack, y_stack, eta, cfg)
    gram = tm.tree_gram(y_stack, y_stack)              # [K, m, m] YᵀY
    yg = tm.tree_vdot_stacked(y_stack, g)              # [K, m]    Yᵀg
    gamma, cond, used, clipped, keep = _screened_solve(gram, yg, cfg)
    if keep is not None:
        y_stack = _mask_stack_columns(y_stack, keep)
        s_stack = _mask_stack_columns(s_stack, keep)
        yg = torch.where(keep, yg, 0.0)
    theta = _theta(yg, gamma, tm.tree_dot(g, g))
    s_gamma = tm.tree_combine_stacked(s_stack, gamma)  # S Γ
    y_gamma = tm.tree_combine_stacked(y_stack, gamma)  # Y Γ
    beta = cfg.damping
    new_w = w - eta * g - beta * (s_gamma - eta * y_gamma)
    return new_w, AAStats(theta, torch.linalg.vector_norm(gamma, dim=-1), cond,
                          used, clipped)


def _theta(yg, gamma, g_norm2):
    """Optimization gain θ = sqrt(1 − (Yᵀg·Γ)/‖g‖²) (Eq. 9, via Pythagoras)."""
    proj2 = (yg * gamma).sum(-1)
    return torch.sqrt(torch.clamp(
        1.0 - proj2 / torch.clamp(g_norm2, min=1e-30), 0.0, 1.0))


def _multisecant_update_kernel(w, g, s_stack, y_stack, eta: float,
                               cfg: AAConfig):
    """Same math and stats as the tree path, through the single-pass Gram
    and update kernels: S and Y are each read once per pass."""
    gram, yg = aa_ops.flat_gram(y_stack, g)
    gamma, cond, used, clipped, keep = _screened_solve(gram, yg, cfg)
    if keep is not None:
        yg = torch.where(keep, yg, 0.0)
        # a screened column must not reach the update kernel (0·inf = nan)
        s_stack = _mask_stack_columns(s_stack, keep)
        y_stack = _mask_stack_columns(y_stack, keep)
    ga = g.to(gram.dtype)
    theta = _theta(yg, gamma, tm.tree_dot(ga, ga))
    new_w = aa_ops.flat_update(w, g, s_stack, y_stack, gamma, eta, cfg.damping)
    return new_w, AAStats(theta, torch.linalg.vector_norm(gamma, dim=-1), cond,
                          used, clipped)


def trajectory_to_sy(w_traj: torch.Tensor, r_traj: torch.Tensor,
                     residual_ema: float = 0.0):
    """Build S, Y stacks from a local trajectory.

    w_traj, r_traj: [..., L+1, d] iterates w_0..L and corrected gradients
    r_0..L. Returns S, Y: [..., L, d]. residual_ema > 0 smooths the residual
    sequence with an exponential moving average before differencing.
    """
    if residual_ema > 0.0:
        rho = residual_ema
        rows = [r_traj[..., 0, :]]
        for i in range(1, r_traj.shape[-2]):
            rows.append(rho * rows[-1] + (1 - rho) * r_traj[..., i, :])
        r_traj = torch.stack(rows, dim=-2)
    s = w_traj[..., 1:, :] - w_traj[..., :-1, :]
    y = r_traj[..., 1:, :] - r_traj[..., :-1, :]
    return s, y
