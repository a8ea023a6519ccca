"""Declarative uplink schemas: what a round puts on the wire, as data
(counterpart of repro/comm/schema.py).

Every round core declares its client->server uploads as a tuple of
:class:`UplinkSpec` records, one per wire crossing, in round order. Three
consumers read them:

  * ``init_schema_state`` allocates exactly the per-client buffers the
    channel needs for them (error-feedback residuals, difference-coding
    references), keyed by ``tag`` in ``ServerState.comm``;
  * ``CrossClientReduce.uplink`` (core/algorithms.py) resolves those
    buffers from the carried state;
  * ``comm_bytes_per_round`` charges each record its codec-exact bytes.

Fields:

  tag      — the upload's name within its round; the key of its buffers.
  kind     — "delta": vanishes at the optimum (model deltas), always sent
             through the uplink codec; "aux": absolute state (gradients):
             a delta-only codec sends it through the identity codec, and a
             lossy codec difference-codes it against a carried reference.
  anchored — the wire carries ``value − anchor`` for an anchor both ends
             know (the broadcast w^t); the channel adds it back after
             decoding.
  stateful — may carry buffers across rounds.
  fold     — distinct per tag; the reference folds it into each client's
             key, the port into the seed of the uplink's uniforms, so one
             round's uploads never share draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: valid ``UplinkSpec.kind`` values (see CommChannel.up_codec)
UPLINK_KINDS = ("delta", "aux")


class UplinkSpec(NamedTuple):
    tag: str
    kind: str
    anchored: bool
    stateful: bool
    fold: int


#: canonical uplinks of the round cores (core/algorithms.py)
GRAD_UPLINK = UplinkSpec("grad", "aux", anchored=False, stateful=True, fold=101)
DELTA_UPLINK = UplinkSpec("delta", "delta", anchored=True, stateful=True, fold=102)
CTRL_UPLINK = UplinkSpec("ctrl", "aux", anchored=False, stateful=True, fold=103)
DIR_UPLINK = UplinkSpec("dir", "delta", anchored=False, stateful=True, fold=104)


def validate_schema(schema: "tuple[UplinkSpec, ...]") -> "tuple[UplinkSpec, ...]":
    """Reject duplicate tags or folds and unknown kinds."""
    tags = [s.tag for s in schema]
    folds = [s.fold for s in schema]
    if len(set(tags)) != len(tags):
        raise ValueError(f"duplicate uplink tags in schema: {tags}")
    if len(set(folds)) != len(folds):
        raise ValueError(f"duplicate rng folds in schema: {folds}")
    for s in schema:
        if s.kind not in UPLINK_KINDS:
            raise ValueError(
                f"uplink {s.tag!r}: unknown kind {s.kind!r}; "
                f"choose from {UPLINK_KINDS}")
    return schema


def uplink_byte_breakdown(channel, schema: "tuple[UplinkSpec, ...]",
                          params: torch.Tensor) -> "dict[str, float]":
    """``{tag: bytes}`` of one client's uploads in one round of ``schema``
    under ``channel``, in round order, each at its kind's codec-exact rate."""
    validate_schema(schema)
    return {spec.tag: float(channel.uplink_bytes(params, kind=spec.kind))
            for spec in schema}


def init_schema_state(channel, schema: "tuple[UplinkSpec, ...]",
                      params: torch.Tensor, K: int) -> "dict | None":
    """``{tag: {"ef": [K, d] zeros, "ref": [K, d] zeros}}`` on the params'
    device, with only the buffers :meth:`CommChannel.state_buffers` gives
    each uplink; tags with none are left out, and the state is None when no
    uplink carries any (a lossless channel carries nothing)."""
    validate_schema(schema)
    state = {}
    for spec in schema:
        buffers = channel.state_buffers(spec)
        if buffers:
            state[spec.tag] = {
                b: torch.zeros((K,) + tuple(params.shape), dtype=params.dtype,
                               device=params.device) for b in buffers}
    return state or None
