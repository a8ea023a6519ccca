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
    # a NaN's code is 0, as XLA's conversion gives it (and csrc/quant.cu):
    # casting a float NaN to int8 is undefined
    q = torch.where(torch.isnan(q), 0.0, torch.clamp(q, -127.0, 127.0))
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: [..., nc, C] int8; scales: [..., nc, 1] f32 -> f32 [..., nc, C]."""
    return q.to(torch.float32) * scales


def int8_sr_uplink_ref(x: torch.Tensor, u: torch.Tensor,
                       anchor: torch.Tensor | None = None,
                       ref: torch.Tensor | None = None,
                       ef: torch.Tensor | None = None,
                       post: torch.Tensor | None = None):
    """The int8 uplink of every client's upload x [K, n] (f32 or f64), with
    the uniforms u [K, nc, C] and the optional anchor [n], reference,
    error-feedback residual and post-codec addend [K, n]; every step in x's
    dtype: v = x − anchor − ref + ef, dec = the f32 roundtrip of v widened
    back, dec = dec + post, new_e = v − dec, new_h = dec + ref,
    dec = new_h + anchor.
    Returns (dec, new_e or None without ef, new_h or None without ref)."""
    v = x - anchor if anchor is not None else x
    if ref is not None:
        v = v - ref
    if ef is not None:
        v = v + ef
    K, n = v.shape
    nc, C = u.shape[-2:]
    v32 = torch.nn.functional.pad(v.to(torch.float32), (0, nc * C - n))
    q, scales = quantize_ref(v32.reshape(K, nc, C), u)
    dec = dequantize_ref(q, scales).reshape(K, -1)[:, :n].to(v.dtype)
    if post is not None:
        dec = dec + post
    new_e = v - dec if ef is not None else None
    if ref is not None:
        dec = dec + ref
    new_h = dec if ref is not None else None
    if anchor is not None:
        dec = dec + anchor
    return dec, new_e, new_h
