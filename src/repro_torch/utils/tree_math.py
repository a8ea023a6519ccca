"""Vector math on flat parameter tensors (counterpart of repro/utils/tree_math.py).

The port's parameters are one flat ``[d]`` tensor, so the reference's
pytree helpers collapse to tensor ops on the last axis. Every function
broadcasts over leading axes: a ``[K, d]`` argument is K clients, a
``[K, m, d]`` stack is K clients' m-column histories.

Accumulation follows the inputs' dtype (f64 for f64, f32 for f32). The
reference's helpers accumulate in f32 even on f64 leaves
(repro/utils/tree_math.py::tree_dot, tree_gram, tree_vdot_stacked,
tree_combine_stacked); the port keeps f64 for f64 on purpose (PERF.md,
"Accumulation type").
"""
from __future__ import annotations

import torch


def tree_axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y."""
    return alpha * x + y


def tree_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the last axis."""
    return (a * b).sum(-1)


def tree_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_vdot_stacked(stack: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """stack [..., m, d] · v [..., d] → [..., m]."""
    return (stack @ v.unsqueeze(-1)).squeeze(-1)


def tree_gram(stack_a: torch.Tensor, stack_b: torch.Tensor) -> torch.Tensor:
    """[..., m, m] Gram matrix A Bᵀ of two [..., m, d] stacks."""
    return stack_a @ stack_b.transpose(-1, -2)


def tree_combine_stacked(stack: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Σ_i coeff[..., i] · stack[..., i, :] → [..., d]."""
    return (coeff.unsqueeze(-2) @ stack).squeeze(-2)
