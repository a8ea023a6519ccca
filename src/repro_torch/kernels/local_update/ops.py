"""Public entry point of the fused local-trajectory kernel family.

Counterpart of repro/kernels/local_update/ops.py::fused_trajectory, batched
over clients: one call runs every client's ``steps`` corrected-GD steps, so
the CUDA kernel is ONE launch per round (grid = K), not one per client.

Dispatch is by the tensors' device only: CPU tensors, and meta tensors
(shapes only: launch/dryrun.py), run the plain version (ref.py); CUDA
tensors launch csrc/trajectory.cu or raise. There is no row or feature
padding: the kernel masks its own edges.

The kernel has two designs, and ``plan_trajectory`` picks one from the
shape alone: *resident* (full batch, S = 1), one thread-block cluster per
client holding the client's rows in shared memory for all the steps; and
*streaming* (per-step rows, S = steps, or a client too large for 16
blocks), one block per client reading X from device memory each step.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.local_update.ref import (LINKS, compute_dtype,
                                                  trajectory_ref)

#: shared memory the kernel may use per block (H100: 227 KB)
_MAX_SMEM = 232_448
#: the H100's SMs: the resident design's clusters grow while K of them,
#: twice as large, still fit one wave
_SMS = 132
#: warps per block of csrc/trajectory.cu's streaming design (kTrajWarps);
#: sizes its smem
_TRAJ_WARPS = 16
#: warps per block of the resident design (kResWarps), and its largest
#: cluster (kMaxCluster: 16 blocks, the H100's non-portable maximum)
_RES_WARPS = 16
MAX_CLUSTER = 16


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """How csrc/trajectory.cu runs a shape: ``design`` "resident" (one
    cluster of ``cluster`` blocks per client, each holding
    ``rows_per_block`` rows) or "streaming" (one block per client:
    cluster 1, no rows held); ``smem_bytes`` of shared memory a block."""
    design: str
    cluster: int
    rows_per_block: int
    smem_bytes: int


def resident_smem_bytes(rows: int, d: int, itemsize: int) -> int:
    """Shared bytes of a resident block holding ``rows`` rows of d columns
    (csrc/trajectory.cu::resident_smem): X at the odd row pitch d | 1; y,
    mask, c and the anchor's c per row; w, w0, the cluster partial (two
    step parities) and _RES_WARPS warp partials per column."""
    return (rows * ((d | 1) + 4) + d * (4 + _RES_WARPS)) * itemsize


def plan_trajectory(K: int, S: int, n: int, d: int,
                    dtype: torch.dtype) -> TrajectoryPlan:
    """The design for K clients of S blocks of n rows, d columns.

    Per-step rows (S > 1) stream: each step reads other rows, so holding
    them buys nothing. Full batch (S = 1) is resident in the smallest
    power-of-two cluster (<= 16 blocks) whose blocks' shared memory holds
    the client's rows, doubled while K clusters twice as large still fit
    the card's SMs at one block each (few clients would leave most SMs
    idle); a client too large for 16 blocks streams."""
    itemsize = torch.empty((), dtype=compute_dtype(dtype)).element_size()
    streaming = TrajectoryPlan("streaming", 1, 0,
                               (2 + _TRAJ_WARPS) * d * itemsize)
    if S != 1:
        return streaming
    cluster = 1
    while resident_smem_bytes(-(-n // cluster), d, itemsize) > _MAX_SMEM:
        cluster *= 2
        if cluster > MAX_CLUSTER:
            return streaming
    while cluster < MAX_CLUSTER and 2 * cluster * K <= _SMS:
        cluster *= 2
    rows = -(-n // cluster)
    return TrajectoryPlan("resident", cluster, rows,
                          resident_smem_bytes(rows, d, itemsize))


@functools.lru_cache(maxsize=None)
def resident_occupancy(dtype: torch.dtype, link: str, anchor: bool, n: int,
                       d: int, cluster: int) -> dict:
    """What the card makes of a resident plan, without launching it:
    active_clusters (at once), shared_bytes, threads, registers. Raises
    where the card cannot hold one such cluster."""
    occ = _build.occupancy("repro_trajectory_clusters", _build.DTYPE_CODE[dtype],
                           LINKS.index(link), int(anchor), n, d, cluster)
    if occ["active_clusters"] < 1:
        raise RuntimeError(f"trajectory kernel: the card holds no cluster of "
                           f"{cluster} blocks of {occ['shared_bytes']} B")
    return occ


def inverse_count(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[K] reciprocal of each client's valid-row count: the loss's
    masked-mean denominator (every step's block has the same count).

    Divided in the compute dtype of ``dtype``: an f32 reciprocal is 1e-8 off,
    which the AA Gram solve amplifies in f64 runs."""
    return 1.0 / torch.clamp(mask[:, 0].to(compute_dtype(dtype)).sum(-1), min=1.0)


def fused_trajectory(x, y, mask, w0, u, *, link: str, reg: float, eta: float,
                     anchor_scale: float, steps: int):
    """Run ``steps`` fused corrected-GD steps for every client.

    x: [K, S, n, d] with S ∈ {1, steps}; y, mask: [K, S, n]; w0, u: [K, d]
    (or [d], shared by every client). Returns (w_traj, r_traj), each
    [K, steps, d] in w0.dtype.
    """
    if link not in LINKS:
        raise ValueError(f"unknown link {link!r}; choose from {LINKS}")
    if anchor_scale not in (0.0, 1.0):
        raise ValueError(f"anchor_scale must be 0.0 or 1.0, got {anchor_scale}")
    K, S, n, d = x.shape
    if S not in (1, steps):
        raise ValueError(f"S={S} must be 1 or steps={steps}")
    w0 = w0.expand(K, d)
    u = u.expand(K, d)
    invn = inverse_count(mask, w0.dtype)

    if x.device.type in ("cpu", "meta"):
        return trajectory_ref(x, y, mask, w0, u, invn, link=link, eta=eta,
                              reg=reg, anchor_scale=anchor_scale, steps=steps)
    return _trajectory_cuda(x, y, mask, w0, u, invn, link=link, eta=eta,
                            reg=reg, anchor=anchor_scale == 1.0, steps=steps)


def _trajectory_cuda(x, y, mask, w0, u, invn, *, link, eta, reg, anchor,
                     steps):
    """Launch csrc/trajectory.cu in the design plan_trajectory picks, the
    step loop inside."""
    cd = invn.dtype
    K, S, n, d = x.shape
    if w0.dtype != cd:
        raise TypeError(f"trajectory kernel: w0 must be float32 or float64, "
                        f"got {w0.dtype}")
    x, y, mask, w0, u = (t.to(cd).contiguous() for t in (x, y, mask, w0, u))
    dev = _build.check_cuda("trajectory", x, y, mask, w0, u, invn)
    plan = plan_trajectory(K, S, n, d, cd)
    if plan.smem_bytes > _MAX_SMEM:
        raise ValueError(f"trajectory kernel: d={d} needs {plan.smem_bytes} B "
                         f"of shared memory (max {_MAX_SMEM})")
    resident = plan.design == "resident"
    w_traj = torch.empty((K, steps, d), dtype=cd, device=dev)
    r_traj = torch.empty_like(w_traj)
    with torch.cuda.device(dev):
        if resident:
            resident_occupancy(cd, link, anchor, n, d, plan.cluster)
        _build.launch(
            "trajectory", "repro_trajectory", _build.DTYPE_CODE[cd],
            LINKS.index(link), int(anchor), x.data_ptr(), y.data_ptr(),
            mask.data_ptr(), w0.data_ptr(), u.data_ptr(), invn.data_ptr(),
            w_traj.data_ptr(), r_traj.data_ptr(), K, S, n, d, steps,
            plan.cluster if resident else 0, float(eta), float(reg),
            design=plan.design)
    return w_traj, r_traj
