"""CommChannel: the client<->server wire of a federated round (counterpart of
repro/comm/channel.py).

A channel pairs an uplink codec (client->server: gradients, model deltas)
with a broadcast codec (server->client: w^t, ∇f) and an error-feedback
policy. The round cores (core/algorithms.py) pass every uplink through
``CrossClientReduce.uplink`` and every broadcast through
``CrossClientReduce.broadcast``.

Error feedback: the compression residual e_k <- v_k − decode(encode(v_k))
stays with the client (``ServerState.comm``, [K, d] per buffer) and is added
to its next upload, so a biased codec (topk) still reaches the exact
optimum and an unbiased one (int8) accumulates no quantization noise.
Absolute-state uploads also carry a difference-coding reference there.

Bytes: a round costs the sum of ``uplink_bytes(params, kind)`` over the
algorithm's uplink schema (comm/schema.py). Broadcasts and per-client
scalars are not charged, as the paper's Table 1 does not charge them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.codecs import CODECS, Codec, IdentityCodec, parse_codec


@dataclasses.dataclass(frozen=True)
class CommChannel:
    """up — uplink codec; down — broadcast codec (deterministic, not
    delta-only); error_feedback — carry per-client residuals across rounds."""

    up: Codec = IdentityCodec()
    down: Codec = IdentityCodec()
    error_feedback: bool = False

    def __post_init__(self):
        if not self.down.deterministic:
            raise ValueError(
                f"broadcast codec {self.down} is stochastic; clients cannot "
                "reproduce the server's draws — use identity/fp32/bf16 downlink")
        if self.down.delta_only:
            raise ValueError(
                f"broadcast codec {self.down} is delta-only, but the downlink "
                "carries absolute state (w^t, ∇f) — sparsifying it floors "
                "convergence; use identity/fp32/bf16 downlink")

    @property
    def name(self) -> str:
        tag = f"{self.up}"
        if self.error_feedback:
            tag += "+ef"
        if not isinstance(self.down, IdentityCodec):
            tag += f"/{self.down}"
        return tag

    @property
    def is_identity(self) -> bool:
        return (isinstance(self.up, IdentityCodec)
                and isinstance(self.down, IdentityCodec))

    def up_codec(self, kind: str = "delta") -> Codec:
        """The codec an uplink of ``kind`` travels through: the uplink codec,
        except the identity for an "aux" upload under a delta-only codec."""
        if kind == "aux" and self.up.delta_only:
            return IdentityCodec()
        return self.up

    def state_buffers(self, spec) -> "tuple[str, ...]":
        """The per-client buffers the uplink ``spec`` carries across rounds:
        "ef" (error-feedback residual) when error feedback is on, "ref"
        (difference-coding reference) for an "aux" upload; none on an
        identity wire or for a spec that is not stateful."""
        codec = self.up_codec(spec.kind)
        if isinstance(codec, IdentityCodec) or not spec.stateful:
            return ()
        buffers = []
        if self.error_feedback:
            buffers.append("ef")
        if spec.kind == "aux":
            buffers.append("ref")
        return tuple(buffers)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """A server broadcast as every client decodes it (deterministic).
        Uplinks go through CrossClientReduce.uplink, which owns their
        carried state: there is no bare uplink roundtrip here."""
        return self.down.roundtrip(x)

    def uplink_bytes(self, params: torch.Tensor, kind: str = "delta") -> int:
        return self.up_codec(kind).tree_bytes(params)

    def downlink_bytes(self, params: torch.Tensor) -> int:
        return self.down.tree_bytes(params)


IDENTITY_CHANNEL = CommChannel()


def make_channel(spec: "str | CommChannel | None") -> CommChannel:
    """A ``--comm-codec`` spec as a channel.

    Grammar: ``up[+ef|+noef][/down]`` with up and down from
    ``codecs.parse_codec`` (``int8``, ``topk:0.05``, ``int8+noef``,
    ``bf16/bf16``). Error feedback defaults on for int8 and topk, and off
    for fp32 and bf16, whose roundtrip error is a deterministic rounding.
    """
    if spec is None:
        return IDENTITY_CHANNEL
    if isinstance(spec, CommChannel):
        return spec
    up_spec, _, down_spec = spec.partition("/")
    ef = None
    if up_spec.endswith("+ef"):
        up_spec, ef = up_spec[:-3], True
    elif up_spec.endswith("+noef"):
        up_spec, ef = up_spec[:-5], False
    up = parse_codec(up_spec)
    down = parse_codec(down_spec) if down_spec else IdentityCodec()
    if ef is None:
        ef = up.lossy and up.name not in ("bf16", "fp32")
    return CommChannel(up=up, down=down, error_feedback=ef)


__all__ = ["CODECS", "CommChannel", "IDENTITY_CHANNEL", "make_channel"]
