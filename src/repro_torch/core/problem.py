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
        """Move to ``device``; cast x, y and mask to ``dtype`` when given.

        The weights keep their f32 values (an f64 run promotes them where it
        uses them, as the reference does)."""
        cast = {} if dtype is None else {"dtype": dtype}
        return StackedClients(self.x.to(device, **cast),
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
        """[K, d] stacked Hessian-vector products ∇²f_k(params)·v."""
        return vmap(self.hvp, in_dims=(None, 0, None))(params, self._batch(), v)

    def global_grad(self, params: torch.Tensor) -> torch.Tensor:
        """∇f(params) = Σ_k (N_k/N) ∇f_k(params)."""
        g = self.client_grads(params)
        return self.clients.weight.to(g.dtype) @ g

    def global_loss(self, params: torch.Tensor) -> torch.Tensor:
        losses = vmap(self.loss, in_dims=(None, 0))(params, self._batch())
        return self.clients.weight.to(losses.dtype) @ losses


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
