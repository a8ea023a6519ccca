"""Public entry points of the int8 stochastic-rounding wire codec, batched
over clients (counterpart of repro/kernels/quant/ops.py).

``int8_sr_encode`` / ``int8_dequantize`` are what comm/codecs.py's
Int8SRCodec calls, once per uplink for all K clients: encode and decode are
separate launches. The uniforms are an input ([K, nc, C] f32, drawn by the
caller over the whole padded chunk grid, as the reference draws them), so
the kernel and its plain version give the same codes from the same draws.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(ref.py, after the reference's zero padding to whole chunks); CUDA tensors
launch csrc/quant.cu or raise. The kernel reads each client's row at its
true length and masks the ragged chunk itself, so nothing is padded there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref

#: lanes per quantization chunk (the reference's kernel tile width)
DEFAULT_CHUNK = 256
#: the largest chunk csrc/quant.cu takes (32 lanes x 32 values)
MAX_CHUNK = 1024


def chunk_rows(n: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Number of quantization chunks covering a length-n vector."""
    return max(1, -(-n // chunk))


def quantize(x: torch.Tensor, u: torch.Tensor):
    """x: [..., nc, C] f32/f64, u: [..., nc, C] f32 -> (q [..., nc, C] int8,
    scales [..., nc, 1] f32)."""
    if x.shape != u.shape:
        raise ValueError(f"quantize: x {tuple(x.shape)} and u "
                         f"{tuple(u.shape)} differ")
    if x.device.type == "cpu":
        return quantize_ref(x, u)
    *lead, nc, C = x.shape
    q, s = _quantize_cuda(x.reshape(-1, nc * C), u, nc * C)
    return q.reshape(x.shape), s.reshape(*lead, nc, 1)


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: [..., nc, C] int8; scales: [..., nc, 1] f32 -> f32 [..., nc, C]."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scales)
    *_, nc, C = q.shape
    return _dequantize_cuda(q, scales, nc * C, torch.float32).reshape(q.shape)


def int8_sr_encode(x: torch.Tensor, u: torch.Tensor):
    """Every client's flat upload x [K, n] (f32, or f64 rounded to f32) ->
    (q [K, nc, C] int8, scales [K, nc, 1] f32); C = u.shape[-1]."""
    K, n = x.shape
    C = u.shape[-1]
    if u.shape != (K, chunk_rows(n, C), C):
        raise ValueError(f"int8_sr_encode: u {tuple(u.shape)} does not cover "
                         f"x {tuple(x.shape)} in chunks of {C}")
    if x.device.type == "cpu":
        pad = u.shape[1] * C - n
        x2d = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
        return quantize_ref(x2d.reshape(u.shape), u)
    return _quantize_cuda(x, u, n)


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of int8_sr_encode: back to [K, n], in ``dtype`` (the f32
    products, widened exactly for f64)."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scales).reshape(q.shape[0], -1)[:, :n].to(dtype)
    return _dequantize_cuda(q, scales, n, dtype)


def int8_sr_roundtrip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """encode + decode (two launches): what the server sees of x [K, n],
    in x's dtype."""
    q, scales = int8_sr_encode(x, u)
    return int8_dequantize(q, scales, x.shape[-1], x.dtype)


def _quantize_cuda(x, u, n: int):
    """Launch repro_quantize: x [B, n], u [B, nc, C] -> (q, scales [B, nc, 1])."""
    B, nc, C = u.shape
    if x.shape != (B, n) or not 0 < C <= MAX_CHUNK:
        raise ValueError(f"quantize kernel: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)} (chunk <= {MAX_CHUNK})")
    dev = _build.check_cuda("quantize", x)
    _build.check_cuda("quantize", u, dtypes=(torch.float32,))
    if u.device != dev:
        raise ValueError(f"quantize: x on {dev}, u on {u.device}")
    q = torch.empty((B, nc, C), dtype=torch.int8, device=dev)
    scales = torch.empty((B, nc, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch("quantize", "repro_quantize", _build.DTYPE_CODE[x.dtype],
                      x.data_ptr(), n, u.data_ptr(), q.data_ptr(),
                      scales.data_ptr(), B, nc, C)
    return q, scales


def _dequantize_cuda(q, scales, n: int, dtype):
    """Launch repro_dequantize: q [..., nc, C] -> [B, n] in ``dtype``."""
    *lead, nc, C = q.shape
    B = q.numel() // (nc * C)
    if scales.shape != (*lead, nc, 1) or dtype not in (torch.float32,
                                                       torch.float64):
        raise ValueError(f"dequantize kernel: q {tuple(q.shape)}, scales "
                         f"{tuple(scales.shape)}, out {dtype}")
    dev = _build.check_cuda("dequantize", q, dtypes=(torch.int8,))
    _build.check_cuda("dequantize", scales, dtypes=(torch.float32,))
    if scales.device != dev:
        raise ValueError(f"dequantize: q on {dev}, scales on {scales.device}")
    out = torch.empty((B, n), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        _build.launch("dequantize", "repro_dequantize", _build.DTYPE_CODE[dtype],
                      q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, B, nc, C)
    return out
