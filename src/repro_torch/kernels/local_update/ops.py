"""Public entry point of the fused local-trajectory kernel family.

Counterpart of repro/kernels/local_update/ops.py::fused_trajectory, batched
over clients: one call runs every client's ``steps`` corrected-GD steps, so
the CUDA kernel is ONE launch per round (grid = K), not one per client.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(ref.py); CUDA tensors launch csrc/trajectory.cu or raise. There is no row
or feature padding: the kernel masks its own edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.local_update.ref import (LINKS, compute_dtype,
                                                  trajectory_ref)

#: shared memory the kernel may use per block (H100: 227 KB)
_MAX_SMEM = 232_448
#: warps per block of csrc/trajectory.cu (kTrajWarps); sizes its smem
_TRAJ_WARPS = 16


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

    if x.device.type == "cpu":
        return trajectory_ref(x, y, mask, w0, u, invn, link=link, eta=eta,
                              reg=reg, anchor_scale=anchor_scale, steps=steps)
    return _trajectory_cuda(x, y, mask, w0, u, invn, link=link, eta=eta,
                            reg=reg, anchor=anchor_scale == 1.0, steps=steps)


def _trajectory_cuda(x, y, mask, w0, u, invn, *, link, eta, reg, anchor,
                     steps):
    """Launch csrc/trajectory.cu: one block per client, the step loop inside."""
    cd = invn.dtype
    K, S, n, d = x.shape
    if w0.dtype != cd:
        raise TypeError(f"trajectory kernel: w0 must be float32 or float64, "
                        f"got {w0.dtype}")
    x, y, mask, w0, u = (t.to(cd).contiguous() for t in (x, y, mask, w0, u))
    dev = _build.check_cuda("trajectory", x, y, mask, w0, u, invn)
    smem = (2 + _TRAJ_WARPS) * d * x.element_size()
    if smem > _MAX_SMEM:
        raise ValueError(f"trajectory kernel: d={d} needs {smem} B of shared "
                         f"memory (max {_MAX_SMEM})")
    w_traj = torch.empty((K, steps, d), dtype=cd, device=dev)
    r_traj = torch.empty_like(w_traj)
    with torch.cuda.device(dev):
        _build.launch(
            "trajectory", "repro_trajectory", _build.DTYPE_CODE[cd],
            LINKS.index(link), int(anchor), x.data_ptr(), y.data_ptr(),
            mask.data_ptr(), w0.data_ptr(), u.data_ptr(), invn.data_ptr(),
            w_traj.data_ptr(), r_traj.data_ptr(), K, S, n, d, steps,
            float(eta), float(reg))
    return w_traj, r_traj
