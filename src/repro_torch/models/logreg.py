"""ℓ2-regularized logistic regression (paper Eq. 11; counterpart of
repro/models/logreg.py)."""
from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.problem import (ClientBatch, FLProblem, LinearDesign,
                                      StackedClients)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp(x, 0)).

    Not ``torch.nn.functional.softplus``: its default threshold=20 returns x
    itself above 20, about 2e-9 away from the exact value, which breaks f64
    loss parity with the reference. logaddexp's derivative at 0 is 1/2, as
    the reference's, which the |z| form does not give at w = 0.
    """
    return torch.logaddexp(x, torch.zeros_like(x))


def make_logreg_problem(
    clients: StackedClients, gamma: float = 1e-3, init_scale: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> FLProblem:
    """f_k(w) = mean_j log(1+exp(−y_j wᵀx_j)) + γ/2 ‖w‖²  over client k's data.

    y ∈ {−1, +1}. Initial point w⁰ = 0 (paper §4) unless init_scale > 0, in
    which case it is drawn from the generator ``init`` is given (torch's
    numbers, not the reference's). The design is cast to ``dtype`` once
    here; the reference casts it inside every loss call, with the same
    values. Declares the linear-design protocol (link "logistic").
    """
    clients = clients.to(resolve_device(device), dtype)
    d = clients.x.shape[-1]

    def loss(w: torch.Tensor, batch: ClientBatch) -> torch.Tensor:
        logits = batch.x @ w * batch.y
        per = softplus(-logits)
        n = torch.clamp(batch.mask.sum(), min=1.0)
        return (per * batch.mask).sum() / n + 0.5 * gamma * torch.dot(w, w)

    def init(generator: "torch.Generator | None" = None) -> torch.Tensor:
        if init_scale == 0.0:
            return torch.zeros(d, dtype=dtype, device=clients.device)
        return init_scale * torch.randn(d, generator=generator, dtype=dtype,
                                        device=clients.device)

    def linear_design(batch: ClientBatch) -> LinearDesign:
        return LinearDesign(batch.x, batch.y, "logistic", gamma)

    return FLProblem(loss=loss, init=init, clients=clients,
                     linear_design=linear_design)
