"""Public entry points of the two Anderson-step kernels, batched over clients.

Counterpart of repro/kernels/anderson/ops.py::flat_gram/flat_update: one
call serves all K clients, so each pass is ONE launch per round. A vector
shared by every client (the server's w^t and ∇f(w^t)) is passed as [d]
and read with a client stride of 0 — it is never copied K times.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(ref.py); CUDA tensors launch csrc/gram.cu / csrc/update.cu or raise. No
padding: the kernels mask their own edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.anderson.ref import acc_dtype, gram_ref, update_ref

#: history length the Gram kernel's shared-memory tile holds (csrc/gram.cu)
MAX_HISTORY = 64


def _client_stride(v: torch.Tensor, K: int, d: int) -> int:
    """Element stride between clients of a [d] (shared: 0) or [K, d] vector."""
    if v.shape == (d,):
        return 0
    if v.shape == (K, d):
        return d
    raise ValueError(f"expected shape ({d},) or ({K}, {d}), got {tuple(v.shape)}")


def flat_gram(y: torch.Tensor, g: torch.Tensor):
    """One pass over Y: y [K, m, d], g [K, d] or [d] → (Y Yᵀ [K, m, m],
    Y g [K, m]) in the accumulation type (f64 for f64, else f32)."""
    if y.device.type == "cpu":
        return gram_ref(y, g)
    return _gram_cuda(y, g)


def _gram_cuda(y, g):
    """Launch csrc/gram.cu: one block per client."""
    K, m, d = y.shape
    a = acc_dtype(y.dtype)
    y, g = y.to(a).contiguous(), g.to(a).contiguous()
    if m > MAX_HISTORY:
        raise ValueError(f"gram kernel: m={m} > {MAX_HISTORY} history columns")
    g_stride = _client_stride(g, K, d)
    dev = _build.check_cuda("gram", y, g)
    gram = torch.empty((K, m, m), dtype=a, device=dev)
    yg = torch.empty((K, m), dtype=a, device=dev)
    with torch.cuda.device(dev):
        _build.launch("gram", "repro_gram", _build.DTYPE_CODE[a], y.data_ptr(),
                      g.data_ptr(), g_stride, gram.data_ptr(), yg.data_ptr(),
                      K, m, d)
    return gram, yg


def flat_update(w, g, s, y, gamma, eta: float, beta: float):
    """One pass over S and Y: w⁺ = w − ηg − β(Sᵀγ − ηYᵀγ) per client.

    w, g: [K, d] or [d]; s, y: [K, m, d]; gamma: [K, m]. Returns [K, d] in
    w.dtype."""
    if s.device.type == "cpu":
        return update_ref(w, g, s, y, gamma, eta, beta)
    return _update_cuda(w, g, s, y, gamma, eta, beta)


def _update_cuda(w, g, s, y, gamma, eta, beta):
    """Launch csrc/update.cu: a block per 256 columns of each client."""
    K, m, d = s.shape
    a = acc_dtype(s.dtype)
    if w.dtype != a:
        raise TypeError(f"update kernel: w is {w.dtype}, S/Y are {s.dtype}")
    w, g, s, y, gamma = (t.to(a).contiguous() for t in (w, g, s, y, gamma))
    if y.shape != (K, m, d) or gamma.shape != (K, m):
        raise ValueError(f"update kernel: shapes s {tuple(s.shape)}, "
                         f"y {tuple(y.shape)}, gamma {tuple(gamma.shape)}")
    w_stride, g_stride = _client_stride(w, K, d), _client_stride(g, K, d)
    dev = _build.check_cuda("update", w, g, s, y, gamma)
    out = torch.empty((K, d), dtype=a, device=dev)
    with torch.cuda.device(dev):
        _build.launch("update", "repro_update", _build.DTYPE_CODE[a],
                      w.data_ptr(), w_stride, g.data_ptr(), g_stride,
                      s.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                      out.data_ptr(), K, m, d, float(eta), float(beta))
    return out
