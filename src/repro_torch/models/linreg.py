"""ℓ2-regularized linear (ridge) regression (counterpart of
repro/models/linreg.py).

The second member of the linear-design family: a strongly-convex quadratic
whose local trajectories exercise the fused kernel's "linear" link, and
whose global optimum has a closed form (``linreg_exact_solution``).
"""
from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.problem import (ClientBatch, FLProblem, LinearDesign,
                                      StackedClients)


def make_linreg_problem(
    clients: StackedClients, gamma: float = 1e-3, init_scale: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> FLProblem:
    """f_k(w) = mean_j ½ (wᵀx_j − y_j)² + γ/2 ‖w‖²  over client k's data."""
    clients = clients.to(resolve_device(device), dtype)
    d = clients.x.shape[-1]

    def loss(w: torch.Tensor, batch: ClientBatch) -> torch.Tensor:
        z = batch.x @ w
        per = 0.5 * (z - batch.y) ** 2
        n = torch.clamp(batch.mask.sum(), min=1.0)
        return (per * batch.mask).sum() / n + 0.5 * gamma * torch.dot(w, w)

    def init(generator: "torch.Generator | None" = None) -> torch.Tensor:
        if init_scale == 0.0:
            return torch.zeros(d, dtype=dtype, device=clients.device)
        return init_scale * torch.randn(d, generator=generator, dtype=dtype,
                                        device=clients.device)

    def linear_design(batch: ClientBatch) -> LinearDesign:
        return LinearDesign(batch.x, batch.y, "linear", gamma)

    return FLProblem(loss=loss, init=init, clients=clients,
                     linear_design=linear_design)


def linreg_exact_solution(clients: StackedClients, gamma: float) -> torch.Tensor:
    """The global ridge optimum of Σ_k (N_k/N)·f_k, in f64: the weighted
    normal equations (Σ_k w_k XᵀMX/n_k + (Σ_k w_k)·γI) w = Σ_k w_k XᵀMy/n_k.

    Each f_k carries the regularizer, so it enters with Σ_k w_k, which the
    f32-rounded weights leave ~1e-8 off 1; the reference takes γI, whose
    optimum is then ~1e-9 away from the one its rounds converge to."""
    x = clients.x.double()
    y = clients.y.double()
    m = clients.mask.double()
    nk = torch.clamp(m.sum(-1), min=1.0)                   # [K]
    wk = clients.weight.double() / nk                      # [K]
    xm = x * (m * wk[:, None])[..., None]                  # [K, n, d]
    d = x.shape[-1]
    A = torch.einsum("knd,kne->de", xm, x) + gamma * clients.weight.double(
    ).sum() * torch.eye(d, dtype=torch.float64, device=x.device)
    b = torch.einsum("knd,kn->d", xm, y)
    return torch.linalg.solve(A, b)
