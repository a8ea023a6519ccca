"""The ("pod", "data", "model") mesh over a ``torch.distributed`` world
(counterpart of repro/launch/mesh.py).

A ``Mesh`` lays the world's ranks out row-major on its grid, the slowest
axis first: on a (data, model) mesh rank r sits at data index r // model
and model index r % model, so the ranks of one "model" group are
consecutive; a "pod" axis, where there is one, is slower still.
``make_mesh`` builds one process group per line of the grid along
"model" (the tensor-parallel ranks that hold one replica of the
parameters), along "data" (the ranks that hold the same shard of it) and,
on a mesh with pods, along the client axes ("pod", "data") together, with
``dist.new_group``, which every backend takes (a gloo world on the CPU or
on the card, NCCL on the card, the fake backend of launch/dryrun.py).
Building a mesh is a collective call: every rank of the world makes it, in
the same order.

``make_host_mesh`` is the reference's (1, 1) mesh: a world of one, started
on an in-memory store when no group exists yet. ``make_production_mesh``
is the reference's pod mesh: 16 × 16 ("data", "model") on 256 ranks, or 2 ×
16 × 16 ("pod", "data", "model") on 512 (the clients live on ("pod",
"data"), tensor parallelism on "model").
"""
from __future__ import annotations

import datetime
import math

import torch.distributed as dist

#: the axes of a (data, model) mesh, slowest first
AXES = ("data", "model")
#: the client axes of a mesh with pods (its FL clients and fsdp shards)
CLIENT_AXES = ("pod", "data")


def mesh_coords(shape: dict, rank: int) -> dict:
    """Rank ``rank``'s index along each axis of a mesh of ``shape`` (axis
    name -> size, slowest first), laid out row-major."""
    out = {}
    for axis in reversed(list(shape)):
        out[axis] = rank % shape[axis]
        rank //= shape[axis]
    return {axis: out[axis] for axis in shape}


def axis_key(axis) -> "str | tuple":
    """A mesh axis or a tuple of them as ``Mesh.group`` keys it: a tuple of
    one axis is that axis."""
    if isinstance(axis, str):
        return axis
    axis = tuple(axis)
    return axis[0] if len(axis) == 1 else axis


class Mesh:
    """The grid over the world's ranks and this rank's place on it.
    ``shape`` is {"data": D, "model": M} (or {"pod": P, "data": D, "model":
    M}), as the reference's ``mesh.shape``; ``group(axis)`` is this rank's
    process group along an axis (or along the client axes ("pod", "data")
    together), ``index(axis)`` its position in it."""

    def __init__(self, shape: dict, groups: dict, rank: int):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.coords = mesh_coords(self.shape, rank)
        self._groups = groups

    def group(self, axis):
        return self._groups[axis_key(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis) -> int:
        """The ranks along a mesh axis or a tuple of them."""
        axis = axis_key(axis)
        axes = (axis,) if isinstance(axis, str) else axis
        return math.prod(self.shape.get(a, 1) for a in axes)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords})"


def _lines(shape: dict, axes: tuple) -> list[list[int]]:
    """The ranks of each line of the grid along ``axes`` (the other axes
    fixed), in row-major order, each line's ranks ascending."""
    others = [a for a in shape if a not in axes]
    lines: dict = {}
    for r in range(math.prod(shape.values())):
        c = mesh_coords(shape, r)
        lines.setdefault(tuple(c[a] for a in others), []).append(r)
    return [lines[k] for k in sorted(lines)]


def _build(shape: dict) -> Mesh:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh needs an initialised process group: call "
                         "torch.distributed.init_process_group (or "
                         "core/sharded.py::init_file_world) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = math.prod(shape.values())
    if min(shape.values()) < 1 or size != world:
        dims = " x ".join(f"{n} {a}" for a, n in shape.items())
        raise ValueError(f"a mesh of {dims} needs {size} ranks; the world has "
                         f"{world}")
    axes = [("model",), ("data",)]
    if "pod" in shape:
        axes.append(CLIENT_AXES)
    groups = {}
    for ax in axes:
        for ranks in _lines(shape, ax):
            g = dist.new_group(ranks=ranks)
            if rank in ranks:
                groups[axis_key(ax)] = g
    return Mesh(shape, groups, rank)


def make_mesh(data: int, model: int, pod: int | None = None) -> Mesh:
    """The (data, model) mesh over the current world, which must hold
    data · model ranks; with ``pod``, the (pod, data, model) mesh of pod ·
    data · model ranks. Every rank of the world calls it, in the same
    order as its other ``new_group`` calls."""
    shape = {"data": data, "model": model}
    if pod is not None:
        shape = {"pod": pod, **shape}
    return _build(shape)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The reference's pod mesh over the current world: 16 × 16 ("data",
    "model") on a world of 256 ranks, or with ``multi_pod`` 2 × 16 × 16
    ("pod", "data", "model") on 512. Raises for any other world size."""
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise ValueError(f"the {'2x16x16' if multi_pod else '16x16'} production "
                         f"mesh needs a world of {need} ranks; this one has "
                         f"{world}")
    return make_mesh(16, 16, pod=2 if multi_pod else None)


def make_host_mesh(backend: str = "gloo") -> Mesh:
    """The (1, 1) mesh of a world of one: the current world if it has one
    rank, else a new world of one on an in-memory store, with ``backend``
    ("gloo" for CPU tensors, "nccl" for CUDA ones)."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=60))
    return make_mesh(1, 1)


__all__ = ["AXES", "CLIENT_AXES", "Mesh", "axis_key",
           "make_host_mesh", "make_mesh", "make_production_mesh", "mesh_coords"]
