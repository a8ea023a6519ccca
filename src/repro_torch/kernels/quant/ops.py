"""Public entry points of the int8 stochastic-rounding wire codec, batched
over clients (counterpart of repro/kernels/quant/ops.py).

``int8_sr_uplink`` is what comm/codecs.py's Int8SRCodec.uplink calls,
once per uplink for all K clients: one launch that forms each client's
upload from its anchor and carried buffers, rounds it through the codec and
returns what the server sees and the buffers' next values.
``int8_sr_encode`` / ``int8_dequantize`` are the two ends of a wire on
their own (``int8_sr_roundtrip``: encode, then decode, two launches). The
uniforms are an input ([K, nc, C] f32, drawn by the caller over the whole
padded chunk grid, as the reference draws them), so the kernels and their
plain versions give the same codes from the same draws.

Dispatch is by the tensors' device only: CPU tensors, and meta tensors
(shapes only: launch/dryrun.py), run the plain version (ref.py, after the
reference's zero padding to whole chunks); CUDA tensors launch
csrc/quant.cu or raise. The kernel reads each client's row at its true
length and masks the ragged chunk itself, so nothing is padded there."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant.ref import (dequantize_ref, int8_sr_uplink_ref,
                                          quantize_ref)

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
    if x.device.type in ("cpu", "meta"):
        return quantize_ref(x, u)
    *lead, nc, C = x.shape
    q, s = _quantize_cuda(x.reshape(-1, nc * C), u, nc * C)
    return q.reshape(x.shape), s.reshape(*lead, nc, 1)


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: [..., nc, C] int8; scales: [..., nc, 1] f32 -> f32 [..., nc, C]."""
    if q.device.type in ("cpu", "meta"):
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
    if x.device.type in ("cpu", "meta"):
        pad = u.shape[1] * C - n
        x2d = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
        return quantize_ref(x2d.reshape(u.shape), u)
    return _quantize_cuda(x, u, n)


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of int8_sr_encode: back to [K, n], in ``dtype`` (the f32
    products, widened exactly for f64)."""
    if q.device.type in ("cpu", "meta"):
        return dequantize_ref(q, scales).reshape(q.shape[0], -1)[:, :n].to(dtype)
    return _dequantize_cuda(q, scales, n, dtype)


def int8_sr_roundtrip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """encode + decode (two launches): what the server sees of x [K, n],
    in x's dtype."""
    q, scales = int8_sr_encode(x, u)
    return int8_dequantize(q, scales, x.shape[-1], x.dtype)


def int8_sr_uplink(x: torch.Tensor, u: torch.Tensor,
                   anchor: torch.Tensor | None = None,
                   ref: torch.Tensor | None = None,
                   ef: torch.Tensor | None = None,
                   post: torch.Tensor | None = None):
    """The int8 uplink of every client's upload x [K, n] (f32 or f64) with
    the uniforms u [K, nc, C]: v = x − anchor − ref + ef (each where given;
    anchor [n], ref and ef [K, n], in x's dtype) goes through the codec,
    and ``post`` [K, n] (the DP noise) is added to the decoded value;
    returns (dec, new_e, new_h): what the server sees (plus ref and anchor),
    the next error-feedback residual v − dec (None without ef) and the next
    reference dec + ref (None without ref). One launch on the card
    (ref.py::int8_sr_uplink_ref spells out the steps)."""
    K, n = x.shape
    C = u.shape[-1]
    if u.shape != (K, chunk_rows(n, C), C):
        raise ValueError(f"int8_sr_uplink: u {tuple(u.shape)} does not cover "
                         f"x {tuple(x.shape)} in chunks of {C}")
    for name, buf, shape in (("anchor", anchor, (n,)), ("ref", ref, x.shape),
                             ("ef", ef, x.shape), ("post", post, x.shape)):
        if buf is None:
            continue
        if buf.shape != shape:
            raise ValueError(f"int8_sr_uplink: {name} {tuple(buf.shape)}, "
                             f"expected {tuple(shape)}")
        if buf.dtype != x.dtype:
            raise TypeError(f"int8_sr_uplink: {name} is {buf.dtype}, x "
                            f"{x.dtype}")
    if x.device.type in ("cpu", "meta"):
        return int8_sr_uplink_ref(x, u, anchor, ref, ef, post)
    return _uplink_cuda(x, u, anchor, ref, ef, post)


def _uplink_cuda(x, u, anchor, ref, ef, post=None):
    """Launch repro_int8_uplink: x [K, n], u [K, nc, C] -> (dec, new_e,
    new_h), each [K, n] in x's dtype; new_h is dec itself without anchor."""
    K, nc, C = u.shape
    n = x.shape[1]
    if not 0 < C <= MAX_CHUNK:
        raise ValueError(f"int8 uplink kernel: u {tuple(u.shape)} (chunk <= "
                         f"{MAX_CHUNK})")
    bufs = [b for b in (anchor, ref, ef, post) if b is not None]
    dev = _build.check_cuda("int8_uplink", x, *bufs)
    _build.check_cuda("int8_uplink", u, dtypes=(torch.float32,))
    if u.device != dev:
        raise ValueError(f"int8_uplink: x on {dev}, u on {u.device}")
    dec = torch.empty_like(x)
    new_e = torch.empty_like(x) if ef is not None else None
    split_h = ref is not None and anchor is not None
    new_h = torch.empty_like(x) if split_h else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        _build.launch("int8_uplink", "repro_int8_uplink",
                      _build.DTYPE_CODE[x.dtype], x.data_ptr(), ptr(anchor),
                      ptr(ref), ptr(ef), ptr(post), u.data_ptr(), dec.data_ptr(),
                      ptr(new_e), ptr(new_h), n, K, nc, C)
    if ref is not None and not split_h:
        new_h = dec
    return dec, new_e, new_h


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
