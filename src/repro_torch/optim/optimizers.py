"""Optimizers for the centralized LM trainer (counterpart of
repro/optim/optimizers.py; no torch.optim): plain functions over dicts of
tensors (name → tensor), ``update(grads, state, params) -> (new_params,
new_state)``, nothing updated in place.

The FL local update in the paper is plain (corrected) GD; AdamW and the
schedules serve the centralized LM baselines (launch/train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.optim.schedules import constant


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32: updates taken
    mu: "dict | None"           # first moment (sgd: the momentum; None without)
    nu: "dict | None"           # second moment (adamw only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[[dict, OptState, dict], "tuple[dict, OptState]"]
    # update(grads, state, params) -> (new_params, new_state)


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else constant(lr)


def _step0(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)


def sgd(lr: "float | Callable", momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        mu = ({k: torch.zeros_like(p) for k, p in params.items()}
              if momentum else None)
        return OptState(_step0(params), mu, None)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = {k: momentum * state.mu[k] + g for k, g in grads.items()}
            d = ({k: momentum * mu[k] + g for k, g in grads.items()}
                 if nesterov else mu)
        else:
            mu, d = None, grads
        new = {k: (w - lr_t * d[k].float()).to(w.dtype) for k, w in params.items()}
        return new, OptState(step, mu, None)

    return Optimizer(init, update)


def adamw(lr: "float | Callable", b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments and bias correction; decoupled weight decay
    added to the step direction (as the reference)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        z = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
        return OptState(_step0(params), z, {k: torch.zeros_like(v) for k, v in z.items()})

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        g32 = {k: g.float() for k, g in grads.items()}
        mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in g32.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g * g for k, g in g32.items()}
        s = step.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, s), 1 - torch.pow(b2, s)

        def upd(w, m, v):
            d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                d = d + weight_decay * w.float()
            return (w.float() - lr_t * d).to(w.dtype)

        new = {k: upd(w, mu[k], nu[k]) for k, w in params.items()}
        return new, OptState(step, mu, nu)

    return Optimizer(init, update)


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """Scale every gradient by min(1, max_norm / ‖grads‖), the norm over all
    of them together."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}
