"""Wire codecs of the FL channel (counterpart of repro/comm/codecs.py).

A codec models what one client<->server exchange of the flat [d]
parameters costs (``wire_bytes``) and loses (``roundtrip``). ``roundtrip``
works on every client's upload at once, a [K, d] stack (a broadcast is one
[d] vector), so an uplink is one call per round, never a loop over clients.
``uplink`` wraps ``roundtrip`` in the uplink's arithmetic: the anchor, the
difference-coding reference and the error-feedback residual (the int8
codec does all of it in one kernel launch).

  identity — lossless; charged at the compute dtype's itemsize
  fp32     — rounded to float32 on the wire, 4 bytes/value
  bf16     — rounded to nearest-even bfloat16, 2 bytes/value
  int8     — per-chunk-scaled stochastic-rounding int8 (kernels/quant/):
             unbiased, 1 byte/value + one f32 scale per ``chunk`` values
  topk     — magnitude top-k per client, k = ceil(ratio·n);
             (f32 value, int32 index) pairs on the wire

``wire_bytes`` depends on shapes only, so the per-round byte count is exact.
Stochastic codecs take their uniforms as an input (``draw_shape`` says the
shape per client); the channel draws them, one tensor per uplink.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.quant import (DEFAULT_CHUNK, chunk_rows,
                                       int8_sr_roundtrip, int8_sr_uplink)


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base: the identity wire format."""

    name = "identity"
    #: deterministic codecs draw no uniforms and may sit on the broadcast
    #: (server->client) leg of a channel; stochastic ones are uplink-only
    deterministic = True
    #: lossy codecs default to error feedback (see channel.make_channel)
    lossy = False
    #: delta-only codecs carry uploads that vanish at the optimum (model
    #: deltas) but not absolute state (gradients): the channel sends those
    #: through the identity codec instead (repro/comm/codecs.py explains why)
    delta_only = False

    def roundtrip(self, x: torch.Tensor, u: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """encode + decode of x [K, n] (or one [n] vector): what the other
        end of the wire sees."""
        return x

    def uplink(self, x: torch.Tensor, u: torch.Tensor | None = None,
               anchor: torch.Tensor | None = None,
               ref: torch.Tensor | None = None,
               ef: torch.Tensor | None = None,
               post: torch.Tensor | None = None):
        """Every client's upload x [K, d] through this codec, as an uplink
        carries it (repro/core/algorithms.py:837-911): v = x − anchor (the
        anchor [d] broadcast over clients), less the carried reference ref
        (difference coding), plus the error-feedback residual ef, is
        roundtripped with the uniforms u, and the addend ``post`` [K, d]
        (the DP noise of robust/faults.py) joins the decoded value before
        the residual is taken. With dec = roundtrip(v) + post, returns (the
        server's view dec + ref + anchor, the next residual v − dec or None
        without ef, the next reference dec + ref or None without ref)."""
        v = x - anchor if anchor is not None else x
        if ref is not None:
            v = v - ref
        if ef is not None:
            v = v + ef
        dec = self.roundtrip(v, u)
        if post is not None:
            dec = dec + post
        new_e = v - dec if ef is not None else None
        if ref is not None:
            # the reference tracks the decoded stream on both ends
            dec = dec + ref
        new_h = dec if ref is not None else None
        if anchor is not None:
            dec = dec + anchor
        return dec, new_e, new_h

    def draw_shape(self, n: int) -> tuple[int, int] | None:
        """Per-client shape of the uniforms ``roundtrip`` takes for a
        length-n upload; None for a deterministic codec."""
        return None

    def wire_bytes(self, shape, dtype: torch.dtype = torch.float32) -> int:
        """Exact bytes on the wire for one vector of this shape."""
        return _numel(shape) * _itemsize(dtype)

    def tree_bytes(self, params: torch.Tensor) -> int:
        """Exact bytes for one upload or broadcast of the parameters."""
        return self.wire_bytes(params.shape, params.dtype)

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    pass


@dataclasses.dataclass(frozen=True)
class Fp32Codec(Codec):
    """Round to float32 on the wire: the full-precision wire of an f64 run."""

    name = "fp32"
    lossy = True

    def roundtrip(self, x, u=None):
        return x.to(torch.float32).to(x.dtype)

    def wire_bytes(self, shape, dtype=torch.float32):
        return _numel(shape) * 4


@dataclasses.dataclass(frozen=True)
class Bf16Codec(Codec):
    """Round to nearest-even bfloat16, as XLA's convert does."""

    name = "bf16"
    lossy = True

    def roundtrip(self, x, u=None):
        return x.to(torch.bfloat16).to(x.dtype)

    def wire_bytes(self, shape, dtype=torch.float32):
        return _numel(shape) * 2


@dataclasses.dataclass(frozen=True)
class Int8SRCodec(Codec):
    """Per-chunk-scaled stochastic-rounding int8: unbiased, |error| <
    max|x_chunk|/127. An f64 upload is rounded to f32 before the codec and
    the decoded f32 values are widened back (repro/comm/codecs.py:143-146);
    here the kernel does both on load and store. ``uplink`` is one launch
    (kernels/quant/ops.py::int8_sr_uplink), the same arithmetic as the base
    class's around ``roundtrip``."""

    name = "int8"
    deterministic = False
    lossy = True
    chunk: int = DEFAULT_CHUNK

    def roundtrip(self, x, u=None):
        if u is None:
            raise ValueError("int8 codec: the uniforms u are an input")
        flat = x.reshape(-1, x.shape[-1])
        return int8_sr_roundtrip(flat, u.reshape(flat.shape[0], *u.shape[-2:])
                                 ).reshape(x.shape)

    def uplink(self, x, u=None, anchor=None, ref=None, ef=None, post=None):
        if u is None:
            raise ValueError("int8 codec: the uniforms u are an input")
        return int8_sr_uplink(x, u, anchor, ref, ef, post)

    def draw_shape(self, n):
        return (chunk_rows(n, self.chunk), self.chunk)

    def wire_bytes(self, shape, dtype=torch.float32):
        n = _numel(shape)
        return n + 4 * chunk_rows(n, self.chunk)


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Keep the k = ceil(ratio·n) largest-magnitude entries per client.
    Biased, so it needs the channel's error feedback to converge. Between
    entries of equal magnitude torch.topk may keep other indices than
    jax.lax.top_k."""

    name = "topk"
    lossy = True
    delta_only = True
    ratio: float = 0.01

    def __post_init__(self):
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {self.ratio}")

    def k_for(self, n: int) -> int:
        return min(n, max(1, math.ceil(self.ratio * n)))

    def roundtrip(self, x, u=None):
        k = self.k_for(x.shape[-1])
        idx = torch.topk(x.abs(), k, dim=-1).indices
        # the kept values ship as f32 (what wire_bytes charges)
        kept = x.gather(-1, idx).to(torch.float32).to(x.dtype)
        return torch.zeros_like(x).scatter(-1, idx, kept)

    def wire_bytes(self, shape, dtype=torch.float32):
        # one (f32 value, int32 index) pair per kept entry
        return self.k_for(_numel(shape)) * 8

    def __str__(self) -> str:
        return f"topk:{self.ratio:g}"


#: the codec names a ``--comm-codec`` spec may start with (see parse_codec)
CODECS = ("identity", "fp32", "bf16", "int8", "topk")


def parse_codec(spec: str) -> Codec:
    """'identity' | 'fp32' | 'bf16' | 'int8[:chunk]' | 'topk[:ratio]' -> Codec."""
    name, _, param = spec.partition(":")
    if name == "identity":
        return IdentityCodec()
    if name == "fp32":
        return Fp32Codec()
    if name == "bf16":
        return Bf16Codec()
    if name == "int8":
        return Int8SRCodec(chunk=int(param)) if param else Int8SRCodec()
    if name == "topk":
        return TopKCodec(ratio=float(param)) if param else TopKCodec()
    raise ValueError(f"unknown codec {name!r}; choose from {CODECS}")
