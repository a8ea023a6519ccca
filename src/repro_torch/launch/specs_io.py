"""Shape-only stand-ins for every dry-run input (counterpart of
repro/launch/specs_io.py): tensors on the ``meta`` device, which hold a
shape and a dtype and no memory.

The step each (architecture × input shape) pair runs (launch/dryrun.py):

  train_4k    -> train_step(params, batch{tokens[,embeds]}, correction)
  prefill_32k -> prefill_step(tokens[, embeds])       (the model holds params)
  decode_*    -> serve_step(caches, tokens[B,1], pos[B,1])

Decode caches: full-attention archs get a KV cache of seq_len; for
``long_500k`` the sliding-window variant is switched on for attention archs
(a ring buffer of LONG_CONTEXT_WINDOW); SSM and hybrid archs keep O(1)
state. Shapes are global: the step of a plan computes its rank's rows of a
batch (models/decoder.py), and ``params_shape`` / ``caches_shape`` give a
rank's parameters and caches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import InputShape

LONG_CONTEXT_WINDOW = 8192


def effective_cfg(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """The arch variant run for this input shape: attention archs switch to
    the sliding-window variant for long_500k (sub-quadratic requirement);
    everything else is unchanged."""
    if shape.name == "long_500k" and cfg.num_heads and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len_for(cfg: ArchConfig, shape: InputShape) -> int:
    if cfg.sliding_window:
        return cfg.sliding_window
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_for(cfg: ArchConfig, shape: InputShape) -> dict:
    """The step's data inputs as meta tensors of the global shapes: for
    train {"batch": {"tokens"[, "embeds"]}}, for prefill {"tokens"[,
    "embeds"]}, for decode {"tokens", "pos"} [B, 1]."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((B, S), torch.int32)}
        if cfg.frontend_tokens:
            out["embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model), dt)
        return {"batch": out} if shape.kind == "train" else out
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((B, 1), torch.int32)}


def params_shape(model) -> dict:
    """A model's parameters (a rank's shards, for a model built under a
    plan) by state-dict name; for a model built with ``device="meta"``
    (models/decoder.py::build_model: nothing drawn, no memory), meta
    tensors."""
    return {name: p.detach() for name, p in model.named_parameters()}


def caches_shape(model, batch: int, cache_len: int):
    """The model's empty decode caches for a batch of ``batch`` (under a
    plan, the rank's rows and heads), on the model's device."""
    return model.init_caches(batch, cache_len, device=model.device)


def correction_shape(params: dict) -> dict:
    """The FL gradient-correction term: the parameters' structure (the
    SVRG term)."""
    return params


__all__ = ["LONG_CONTEXT_WINDOW", "batch_specs_for", "cache_len_for",
           "caches_shape", "correction_shape", "effective_cfg", "params_shape"]
