"""Plain PyTorch version of the int8 stochastic-rounding quant kernels
(counterpart of repro/kernels/quant/ref.py), batched over any leading axes.

Op for op the reference's arithmetic: amax / 127 and x / scale are IEEE
divisions, never a multiply by a reciprocal, so the same uniforms give the
same int8 codes and scales bit for bit, on the CPU and on the card. It is the wrapper's path for CPU tensors, and
what csrc/quant.cu is held against on the card.
"""
from __future__ import annotations

import torch


def quantize_ref(x: torch.Tensor, u: torch.Tensor):
    """x, u: [..., nc, C] -> (q [..., nc, C] int8, scales [..., nc, 1] f32).

    Per-row symmetric scale max|x|/127 (1 for an all-zero row); stochastic
    rounding floor(x/scale + u) with u ~ U[0, 1), so E[q·scale] = x and
    |q·scale − x| < scale."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    # divide by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, one ulp off in some chunks
    scale = torch.where(amax > 0.0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax))
    q = torch.floor(x32 / scale + u.to(torch.float32))
    q = torch.clamp(q, -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: [..., nc, C] int8; scales: [..., nc, 1] f32 -> f32 [..., nc, C]."""
    return q.to(torch.float32) * scales
