"""The ("data", "model") mesh over a ``torch.distributed`` world
(counterpart of repro/launch/mesh.py).

A ``Mesh`` lays the world's ranks out row-major on a (data, model) grid:
rank r sits at data index r // model and model index r % model, so the
ranks of one "model" group are consecutive. ``make_mesh`` builds one
process group per row ("model": the tensor-parallel ranks that hold one
replica of the parameters) and per column ("data": the ranks that hold the
same shard of it), with ``dist.new_group``, which every backend takes (a
gloo world on the CPU or on the card, NCCL on the card). Building a mesh
is a collective call: every rank of the world makes it, in the same order.

``make_host_mesh`` is the reference's (1, 1) mesh: a world of one, started
on an in-memory store when no group exists yet. The TPU pod shapes of the
reference's ``make_production_mesh`` belong to the plan tooling (ROADMAP
item 9b).
"""
from __future__ import annotations

import datetime

import torch.distributed as dist

#: the mesh axes, slowest first
AXES = ("data", "model")


def mesh_coords(shape: dict, rank: int) -> dict:
    """Rank ``rank``'s index along each axis of a mesh of ``shape`` (axis
    name -> size, slowest first), laid out row-major."""
    out = {}
    for axis in reversed(list(shape)):
        out[axis] = rank % shape[axis]
        rank //= shape[axis]
    return {axis: out[axis] for axis in shape}


class Mesh:
    """The (data, model) grid over the world's ranks and this rank's place
    on it. ``shape`` is {"data": D, "model": M}, as the reference's
    ``mesh.shape``; ``group(axis)`` is this rank's process group along an
    axis, ``index(axis)`` its position in it."""

    def __init__(self, data: int, model: int, groups: dict, rank: int):
        self.shape = {"data": data, "model": model}
        self.axis_names = AXES
        self.rank = rank
        self.coords = mesh_coords(self.shape, rank)
        self._groups = groups

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(data: int, model: int) -> Mesh:
    """The (data, model) mesh over the current world, which must hold
    data · model ranks. Every rank of the world calls it, in the same
    order as its other ``new_group`` calls."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs an initialised process group: call "
                         "torch.distributed.init_process_group (or "
                         "core/sharded.py::init_file_world) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; "
                         f"the world has {world}")
    groups = {}
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        g = dist.new_group(ranks=ranks)
        if rank in ranks:
            groups["model"] = g
    for m in range(model):
        ranks = list(range(m, world, model))
        g = dist.new_group(ranks=ranks)
        if rank in ranks:
            groups["data"] = g
    return Mesh(data, model, groups, rank)


def make_host_mesh(backend: str = "gloo") -> Mesh:
    """The (1, 1) mesh of a world of one: the current world if it has one
    rank, else a new world of one on an in-memory store, with ``backend``
    ("gloo" for CPU tensors, "nccl" for CUDA ones)."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=60))
    return make_mesh(1, 1)


__all__ = ["AXES", "Mesh", "make_host_mesh", "make_mesh", "mesh_coords"]
