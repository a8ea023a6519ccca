"""Plain PyTorch versions of the two Anderson-step kernels.

Counterparts of repro/kernels/anderson/ref.py::gram_ref/update_ref, batched
over a leading client axis K. Accumulation type (the port's rule, stated
in PERF.md): f32 for f32 inputs — exactly the TPU kernel — and f64 for f64
inputs, where the TPU kernel downcasts to f32. The CUDA kernels
(csrc/gram.cu, csrc/update.cu) follow the same rule.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of the Anderson kernels for ``dtype`` inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gram_ref(y: torch.Tensor, g: torch.Tensor):
    """y: [K, m, d]; g: [K, d] or [d] → (Y Yᵀ [K, m, m], Y g [K, m])."""
    a = acc_dtype(y.dtype)
    ya, ga = y.to(a), g.to(a).expand(y.shape[0], y.shape[2])
    return ya @ ya.transpose(-1, -2), (ya @ ga.unsqueeze(-1)).squeeze(-1)


def update_ref(w, g, s, y, gamma, eta: float, beta: float):
    """w⁺ = w − ηg − β(Sᵀγ − ηYᵀγ) per client.

    w, g: [K, d] or [d]; s, y: [K, m, d]; gamma: [K, m]. Returns [K, d] in
    w.dtype.
    """
    a = acc_dtype(s.dtype)
    wa, ga = w.to(a), g.to(a)
    gm = gamma.to(a).unsqueeze(-2)                     # [K, 1, m]
    s_g = (gm @ s.to(a)).squeeze(-2)                   # [K, d]
    y_g = (gm @ y.to(a)).squeeze(-2)
    out = wa - eta * ga - beta * (s_g - eta * y_g)
    return out.to(w.dtype)
