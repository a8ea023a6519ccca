"""Sharding plans and the spec of every parameter and cache tensor
(counterpart of repro/sharding/specs.py).

A spec is a plain tuple with one entry per dimension: a mesh axis name
("model", "data"), a tuple of them (("pod", "data")), or None
(replicated); dimensions past the tuple's end are replicated. The rules
are the reference's, read from the same leaf names, so
``make_plan(cfg, mesh)`` and each spec equal the reference's for the same
mesh shape (tests/test_torch_sharding_specs.py holds them).

Paths. A parameter's path is its name in the port's state dict
(``model.state_dict()``): the reference's path with "." for "/", and a
stacked group's layer index after the group's name ("blocks.3.attn.wq"
for the reference's "blocks/attn/wq"). The port holds one tensor a layer,
so a stacked leaf's spec has no leading layer axis. A cache's path is its
place in ``LMCaches.tree`` ("k", "shared_kv/k", "mamba/ssm"); caches stay
stacked [n, ...] as the reference's.

Two regimes, as in the reference: ``replica`` (parameters split over
"model", replicated over "data") and ``fsdp`` (also the non-tensor-parallel
dimension of each weight over "data", or ("pod", "data") on a mesh with
pods). In the fsdp regime a rank keeps the fsdp cut of each weight and a
layer gathers it whole before use (models/layers.py::Sharder.fetch), the
reference's "gathered per-layer inside the scan".

The AA step of a plan (launch/steps.py::make_aa_step) sums its Gram pass
over the world: each element of the parameters is counted on exactly one
rank (``counted``), the replica of index 0 along every mesh axis its spec
does not name.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import mesh_coords
from repro_torch.models.layers import Sharder, default_axes

# archs whose training working set exceeds one chip's share under pure
# tensor parallelism (the reference's list)
FSDP_ARCHS = ("internvl2-76b", "llama4-scout-17b-a16e")
#: the stacked [n, ...] parameter groups of the reference (one module a
#: layer in the port)
STACKED = ("blocks", "mamba_groups", "mamba_tail")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    cfg: ArchConfig
    mesh: Any
    multi_pod: bool
    regime: str                  # "replica" | "fsdp"
    axes: dict

    @property
    def model_shards(self) -> int:
        return self.mesh.shape["model"]

    def sharder(self) -> Sharder:
        return Sharder(mesh=self.mesh, axes=self.axes, regime=self.regime,
                       multi_pod=self.multi_pod)


def _fsdp_axis(plan):
    if plan.regime != "fsdp":
        return None
    return ("pod", "data") if plan.multi_pod else "data"


def make_plan(cfg: ArchConfig, mesh, multi_pod: bool = False,
              regime: str | None = None) -> ShardingPlan:
    """The reference's plan: ``cfg.padded(model shards)``, the default axes
    and their divisibility overrides (MQA KV heads replicated, experts or
    their FFN dim on "model", ``ssm_inner`` replicated where it does not
    divide), and the regime. ``mesh`` needs only a ``shape`` dict."""
    shards = mesh.shape["model"]
    cfg = cfg.padded(shards)
    axes = default_axes(multi_pod)
    if cfg.num_heads and cfg.eff_kv_heads % shards != 0:
        axes["kv_heads"] = None                       # MQA: replicate kv
    if cfg.num_experts:
        if cfg.eff_experts % shards == 0:
            axes["experts"], axes["expert_ff"] = "model", None
        else:
            axes["experts"], axes["expert_ff"] = None, "model"
    if cfg.family in ("ssm", "hybrid") and cfg.d_inner % shards != 0:
        axes["ssm_inner"] = None
    regime = regime or ("fsdp" if cfg.name in FSDP_ARCHS else "replica")
    return ShardingPlan(cfg=cfg, mesh=mesh, multi_pod=multi_pod,
                        regime=regime, axes=axes)


# ---------------------------------------------------------------------------
# parameter specs by state-dict path
# ---------------------------------------------------------------------------

def reference_path(path: str) -> tuple[str, bool]:
    """A port state-dict path as the reference's '/'-joined path, and
    whether the reference stacks it over layers ("blocks.3.attn.wq" ->
    ("blocks/attn/wq", True))."""
    parts = path.split(".")
    stacked = parts[0] in STACKED
    if stacked:
        if len(parts) < 3 or not parts[1].isdigit():
            raise ValueError(f"{path!r}: a stacked group's path names its layer")
        parts = [parts[0]] + parts[2:]
    return "/".join(parts), stacked


def param_spec_for_path(path: str, ndim: int, plan) -> tuple:
    """The spec of the port's parameter ``path`` (its state-dict name) of
    ``ndim`` dims: the reference's rule for its path, without the layer
    axis of a stacked group. ``plan`` needs ``axes``, ``regime`` and
    ``multi_pod`` (a ShardingPlan or its Sharder)."""
    ref, _ = reference_path(path)
    ax = plan.axes
    fa = _fsdp_axis(plan)
    name = ref.split("/")[-1]

    def spec(*dims):
        return tuple(dims)

    # --- embeddings / head ---
    if name == "embed":
        return spec(ax["vocab"], fa)
    if name == "lm_head":
        return spec(fa, ax["vocab"])
    # --- norms & small vectors: replicated ---
    if name in ("final_norm", "attn_norm", "mlp_norm", "norm", "q_norm",
                "k_norm", "A_log", "D", "dt_bias", "conv_x_b", "conv_bc_b",
                "conv_bc_w"):
        return spec(*([None] * ndim))
    # --- attention ---
    if name == "wq":
        return spec(fa, ax["heads"])
    if name in ("wk", "wv"):
        return spec(fa, ax["kv_heads"])
    if name == "wo" and "attn" in ref:
        return spec(ax["heads"], fa)
    # --- dense mlp ---
    if name in ("wi_gate", "wi_up") and "moe" not in ref:
        return spec(fa, ax["d_ff"])
    if name == "wo" and "mlp" in ref:
        return spec(ax["d_ff"], fa)
    # --- moe ---
    if name == "router":
        return spec(fa, None)
    if name in ("wi_gate", "wi_up") and "moe" in ref:
        return spec(ax["experts"], fa, ax["expert_ff"])
    if name == "wo" and "moe" in ref:
        return spec(ax["experts"], ax["expert_ff"], fa)
    # --- mamba ---
    if name in ("wx", "wz"):
        return spec(fa, ax["ssm_inner"])
    if name in ("wB", "wC", "wdt"):
        return spec(fa, None)
    if name == "conv_x_w":
        return spec(None, ax["ssm_inner"])
    if name == "out_proj":
        return spec(ax["ssm_inner"], fa)
    raise ValueError(f"no sharding rule for param path {path!r} (ndim={ndim})")


def param_specs(state: "dict | torch.nn.Module", plan) -> dict:
    """{state-dict name: spec} over a model's parameters (or any dict of
    tensors, or of anything with a ``shape``, keyed by such names)."""
    if isinstance(state, torch.nn.Module):
        state = dict(state.named_parameters())
    return {name: param_spec_for_path(name, len(t.shape), plan)
            for name, t in state.items()}


def shard_slices(spec: tuple, shape, mesh_shape: dict, coords: dict) -> tuple:
    """The rank at ``coords`` on a mesh of ``mesh_shape``: its slice of each
    dim of a tensor of ``shape`` under ``spec`` (a dim split over several
    axes is split row-major over them, the slowest first)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        parts, idx = 1, 0
        for a in axes:
            size = mesh_shape.get(a, 1)
            parts, idx = parts * size, idx * size + coords.get(a, 0)
        if n % parts:
            raise ValueError(f"dim {i} of size {n} does not split over {entry} "
                             f"({parts} shards)")
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def shard_param(path: str, full: torch.Tensor, plan, coords: dict) -> torch.Tensor:
    """The rank at ``coords``: its part of the full parameter ``path``, a
    copy of its own (a slice is a view that would keep the full tensor's
    memory alive), or ``full`` itself where the spec splits nothing."""
    spec = param_spec_for_path(path, full.ndim, plan)
    part = full[shard_slices(spec, full.shape, plan.mesh.shape, coords)]
    return full if part.shape == full.shape else part.clone(
        memory_format=torch.contiguous_format)


def rank_coords(plan, rank: int) -> dict:
    """Rank ``rank``'s index along each axis of the plan's mesh."""
    return mesh_coords(plan.mesh.shape, rank)


def counted(spec: tuple, coords: dict) -> bool:
    """Whether the rank at ``coords`` counts its shard of a tensor of
    ``spec`` in a sum over the world: it is the replica of index 0 along
    every mesh axis the spec does not name, so that each element is counted
    on exactly one rank."""
    named = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    return all(i == 0 for a, i in coords.items() if a not in named)


# ---------------------------------------------------------------------------
# data / cache specs
# ---------------------------------------------------------------------------

def batch_axis(plan, batch_size: int):
    """Shard the batch over as many of (pod, data) as divide it; a batch
    that does not divide is replicated."""
    pod = plan.mesh.shape.get("pod", 1) if plan.multi_pod else 1
    data = plan.mesh.shape["data"]
    if plan.multi_pod and batch_size % (pod * data) == 0:
        return ("pod", "data")
    if batch_size % data == 0:
        return "data"
    return None


def cache_spec_for_path(path: str, ndim: int, plan, batch_size: int) -> tuple:
    """The spec of the cache tensor at ``path`` ("/"-joined keys of
    ``LMCaches.tree``), stacked [n, ...] as the reference's."""
    ax, ba = plan.axes, batch_axis(plan, batch_size)
    name = path.split("/")[-1]
    if name in ("k", "v", "k_scale", "v_scale"):   # [L, B, C, KV, hd|1]
        return (None, ba, None, ax["kv_heads"], None)
    if name == "pos":             # [L, B, C]
        return (None, ba, None)
    if name == "idx":             # [L]
        return (None,)
    if name == "conv":            # [L, B, W-1, conv_dim]
        return (None, ba, None, None)
    if name == "ssm":             # [L, B, nh, hd, st]
        heads = (ax["ssm_inner"]
                 if plan.cfg.ssm_heads % plan.model_shards == 0 else None)
        return (None, ba, heads, None, None)
    raise ValueError(f"no cache rule for {path!r}")


def cache_specs(tree: dict, plan, batch_size: int, prefix: str = "") -> dict:
    """The spec of every tensor of a cache tree (``LMCaches.tree``, or the
    reference's caches as numpy), in the same nesting."""
    out = {}
    for name, v in tree.items():
        path = prefix + name
        out[name] = (cache_specs(v, plan, batch_size, path + "/")
                     if isinstance(v, dict)
                     else cache_spec_for_path(path, len(v.shape), plan, batch_size))
    return out


__all__ = [
    "FSDP_ARCHS",
    "STACKED",
    "ShardingPlan",
    "batch_axis",
    "cache_spec_for_path",
    "cache_specs",
    "counted",
    "make_plan",
    "param_spec_for_path",
    "param_specs",
    "rank_coords",
    "reference_path",
    "shard_param",
    "shard_slices",
]
