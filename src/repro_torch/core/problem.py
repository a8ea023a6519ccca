"""Federated problem abstraction (counterpart of repro/core/problem.py).

A federated problem = a differentiable loss + K clients' data. Client
datasets are kept *stacked*: every array has leading axis K (padded to the
largest client, with a per-sample mask), so per-client gradients are one
``torch.func.vmap`` instead of a python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from repro_torch import DEFAULT_DEVICE, resolve_device


class ClientBatch(NamedTuple):
    """One (possibly padded) batch of client data.

    x: [n, d] features; y: [n] targets; mask: [n] 0/1 sample validity.
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor


class LinearDesign(NamedTuple):
    """A batch's loss declared in canonical linear-design form.

    The model asserts that its per-sample loss is ``link_loss(x_jᵀw, y_j)``
    plus ``reg/2·‖w‖²``, mask-mean-reduced — which is what makes the fused
    local-trajectory kernel (kernels/local_update) applicable: both the live
    and the anchor gradient of a variance-reduced local step are then
    ``Xᵀ c(Xw) / n + reg·w`` for a cheap per-sample coefficient c.
    """

    x: torch.Tensor
    y: torch.Tensor
    link: str
    reg: float


def link_curvature(link: str, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """c′_j, the derivative in z_j = x_jᵀw of a linear-design loss's
    per-sample coefficient (kernels/local_update/ref.py::link_coeff), the
    weight of row j in the Hessian Xᵀ diag(c′) X:

    logistic: c_j = −y_j σ(−y_j z_j)  → c′_j = y_j² σ(y_j z_j) σ(−y_j z_j)
    linear:   c_j = z_j − y_j         → c′_j = 1

    The logistic form multiplies the two sigmoids, so it keeps its relative
    precision where one of them is near 1."""
    if link == "logistic":
        t = y * z
        return y * y * torch.sigmoid(t) * torch.sigmoid(-t)
    if link == "linear":
        return torch.ones_like(z)
    raise ValueError(f"unknown link {link!r}")


@dataclasses.dataclass(frozen=True)
class StackedClients:
    """All K clients, padded & stacked on axis 0.

    x: [K, n_max, d], y: [K, n_max], mask: [K, n_max],
    weight: [K] = N_k / N (f32, normalised in f64 before the cast).
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    weight: torch.Tensor

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device: "str | torch.device",
           dtype: torch.dtype | None = None) -> "StackedClients":
        """Move to ``device``; cast y and mask to ``dtype`` when given, and
        x too unless it holds integers (an LM's token ids stay ids).

        The weights keep their f32 values (an f64 run promotes them where it
        uses them, as the reference does)."""
        cast = {} if dtype is None else {"dtype": dtype}
        x_cast = cast if self.x.is_floating_point() else {}
        return StackedClients(self.x.to(device, **x_cast),
                              self.y.to(device, **cast),
                              self.mask.to(device, **cast),
                              self.weight.to(device))


@dataclasses.dataclass(frozen=True)
class FLProblem:
    """loss(params, batch) returns the *mean* loss over the valid samples of
    the batch (mask-weighted), including any regularizer — i.e. it IS f_k
    when evaluated on client k's full data. params is one flat [d] tensor.
    """

    loss: Callable[[torch.Tensor, ClientBatch], torch.Tensor]
    init: Callable[["torch.Generator | None"], torch.Tensor]
    clients: StackedClients
    #: optional protocol: declare a batch's loss in canonical linear-design
    #: form (see LinearDesign); models that implement it (logreg, linreg)
    #: are eligible for the fused local-trajectory kernel
    linear_design: "Callable[[ClientBatch], LinearDesign] | None" = None

    @property
    def device(self) -> torch.device:
        return self.clients.device

    # ---- single-client oracles -------------------------------------------
    def grad(self, params: torch.Tensor, batch: ClientBatch) -> torch.Tensor:
        return grad(self.loss)(params, batch)

    def hvp(self, params: torch.Tensor, batch: ClientBatch,
            v: torch.Tensor) -> torch.Tensor:
        """Hessian-vector product via forward-over-reverse (as the reference)."""
        return jvp(lambda p: grad(self.loss)(p, batch), (params,), (v,))[1]

    # ---- all-clients (batched over K) oracles ----------------------------
    def _batch(self) -> ClientBatch:
        c = self.clients
        return ClientBatch(c.x, c.y, c.mask)

    def client_grads(self, params: torch.Tensor) -> torch.Tensor:
        """[K, d] stacked full-batch gradients ∇f_k(params) for all k."""
        return vmap(self.grad, in_dims=(None, 0))(params, self._batch())

    def client_hvps(self, params: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """[K, d] stacked Hessian-vector products ∇²f_k(params)·v
        (``stacked_hvps``: in closed form for a linear-design model)."""
        batch = self._batch()
        return self.stacked_hvps(params, batch, v.expand(batch.x.shape[0], -1))

    def stacked_hvps(self, params: torch.Tensor, batch: ClientBatch,
                     v: torch.Tensor) -> torch.Tensor:
        """[K, d] products ∇²f_k(params_k)·v_k over a stacked batch (x [K,
        n, d]): params [d] (shared) or [K, d] (one point per client, as
        DANE's local iterates), v [K, d].

        A model with the linear-design protocol gets the product in closed
        form, Xᵀ(mask · c′(Xw) · Xv)/n + γv (``link_curvature``): three
        batched products, where the jvp of the gradient dispatches ~100
        kernels. Other models keep the jvp (``hvp``)."""
        if self.linear_design is None:
            return vmap(self.hvp, in_dims=(None if params.dim() == 1 else 0, 0, 0))(
                params, batch, v)
        design = self.linear_design(batch)
        x = design.x
        z = (x @ params.unsqueeze(-1)).squeeze(-1)             # [K, n]
        n = torch.clamp(batch.mask.sum(-1, keepdim=True), min=1.0)
        coef = batch.mask * link_curvature(design.link, z, design.y) / n
        xv = x @ v.unsqueeze(-1)                               # [K, n, 1]
        return (x.transpose(-1, -2) @ (coef.unsqueeze(-1) * xv)).squeeze(-1) \
            + design.reg * v

    def global_grad(self, params: torch.Tensor) -> torch.Tensor:
        """∇f(params) = Σ_k (N_k/N) ∇f_k(params)."""
        g = self.client_grads(params)
        return self.clients.weight.to(g.dtype) @ g

    def global_loss(self, params: torch.Tensor) -> torch.Tensor:
        losses = vmap(self.loss, in_dims=(None, 0))(params, self._batch())
        return self.clients.weight.to(losses.dtype) @ losses


def sample_minibatch_indices(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The row indices ``sample_minibatch`` gathers: for every uniform of
    ``u`` [..., b] (in [0, 1)), one of the valid rows of ``mask`` [..., n]
    (0/1 validity; the leading axes match), each with probability
    mask/Σmask — drawn with replacement, as the reference's
    ``jax.random.choice(n, (b,), p=mask/Σmask)``. The draw u·count is
    floored to the j-th valid row (inverse CDF, no host read). torch
    cannot reproduce the reference's key stream, so the uniforms come in
    (core/algorithms.py draws them from its own seed) and a parity test
    passes the reference's indices instead of calling this."""
    lead = mask.shape[:-1]
    cdf = torch.cumsum(mask.to(torch.float64), -1)
    count = cdf[..., -1:]
    flat = u.to(torch.float64).reshape(*lead, -1)
    j = torch.minimum(torch.floor(flat * count), count - 1.0)
    return torch.searchsorted(cdf, j, right=True).reshape(u.shape)


def sample_minibatch(batch: ClientBatch, idx: torch.Tensor) -> ClientBatch:
    """The rows ``idx`` [K, ..., b] of each client of a stacked batch (x [K,
    n, d], y and mask [K, n]): x [K, ..., b, d], y [K, ..., b] and a mask of
    ones (every drawn row is valid)."""
    K, d = batch.x.shape[0], batch.x.shape[-1]
    flat = idx.reshape(K, -1)
    x = batch.x.gather(1, flat[..., None].expand(-1, -1, d))
    y = batch.y.gather(1, flat)
    return ClientBatch(x.reshape(*idx.shape, d), y.reshape(idx.shape),
                       torch.ones(idx.shape, dtype=batch.mask.dtype,
                                  device=idx.device))


def stack_client_arrays(
    xs: list, ys: list, device: "str | torch.device" = DEFAULT_DEVICE,
) -> StackedClients:
    """Pad a ragged python list of per-client (x, y) arrays into StackedClients."""
    device = resolve_device(device)
    K = len(xs)
    n_max = max(x.shape[0] for x in xs)
    x0, y0 = np.asarray(xs[0]), np.asarray(ys[0])
    X = np.zeros((K, n_max) + x0.shape[1:], dtype=x0.dtype)
    Y = np.zeros((K, n_max) + y0.shape[1:], dtype=y0.dtype)
    M = np.zeros((K, n_max), dtype=np.float32)
    for k, (x, y) in enumerate(zip(xs, ys)):
        n = x.shape[0]
        X[k, :n] = x
        Y[k, :n] = y
        M[k, :n] = 1.0
    # Aggregation weights in float64, normalized BEFORE the f32 cast: per-
    # element f32 rounding of n_k/N would leave Σ W off 1 by O(K·eps). f64
    # runs promote these f32 values; they do not recompute them in f64 —
    # the reference does the same, and its committed losses carry that
    # rounding (e.g. round 0's 0.6931471908886433 rather than log 2).
    counts = np.array([x.shape[0] for x in xs], dtype=np.float64)
    W = (counts / counts.sum()).astype(np.float32)
    return StackedClients(*(torch.from_numpy(a).to(device) for a in (X, Y, M, W)))
