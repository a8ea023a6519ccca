"""ℓ2-regularized logistic regression (paper Eq. 11; counterpart of
repro/models/logreg.py)."""
from __future__ import annotations

import math

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

    x is first clamped to at least log(tiny) of its dtype (−708.4 in f64,
    −87.3 in f32): below it torch's second derivative of logaddexp is
    inf/inf = NaN (exp(−x) overflows), which made a Hessian-vector product
    NaN at a saturated logit where the reference's is finite. The value
    moves by less than the dtype's tiny, the derivatives there are 0.
    """
    lo = math.log(torch.finfo(x.dtype).tiny)
    return torch.logaddexp(torch.clamp(x, min=lo), torch.zeros_like(x))


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


def logreg_accuracy(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> float:
    """The share of rows whose sign(xᵀw) equals their label y ∈ {−1, +1}.

    Reckoned as the reference's ``jnp.mean`` of booleans comes out of XLA,
    in f32 and in either of its precision modes: the count times the f32
    reciprocal of the rows (XLA multiplies by the reciprocal of a constant
    divisor), which can sit one f32 step from count / n."""
    hits = (torch.sign(x.to(w.dtype) @ w) == y.to(w.dtype)).sum()
    one, n = (torch.tensor(v, dtype=torch.float32) for v in (1.0, float(y.numel())))
    return float(hits.cpu().to(torch.float32) * (one / n))


def logreg_condition_number(clients: StackedClients, w: torch.Tensor,
                            gamma: float) -> float:
    """Condition number of the global Hessian at w (the paper's §3.2 κ),
    from its dense [d, d] form and ``torch.linalg.eigvalsh``: for small d
    only, as the reference's. Computed in w's dtype."""
    d = clients.x.shape[-1]
    X = clients.x.reshape(-1, d).to(w.dtype)
    Y = clients.y.reshape(-1).to(w.dtype)
    M = clients.mask.reshape(-1).to(w.dtype)
    s = torch.sigmoid(-(X @ w * Y))
    weights = s * (1 - s) * M
    H = (X.T * weights) @ X / torch.clamp(M.sum(), min=1.0) + gamma * torch.eye(
        d, dtype=w.dtype, device=w.device)
    evals = torch.linalg.eigvalsh(H)
    return float(evals[-1] / evals[0])
