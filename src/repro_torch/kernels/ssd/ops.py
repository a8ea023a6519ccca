"""The SSD intra-chunk step in the model's layout (counterpart of
repro/kernels/ssd/ops.py::ssd_chunk, the ``ssd_fn`` hook).

Dispatch is by the tensors' device only: CPU tensors run the plain
version (ref.py); CUDA tensors launch csrc/ssd.cu or raise. The kernel
reads and writes the model's [B, nc, Q, nh, hd] layout itself, so nothing
is transposed around the launch; it computes C B^T once per chunk into a
[B*nc, Qp, Qp] f32 scratch allocated here (Qp: Q rounded up to the
kernel's 64-row tile). Its products run on the tensor cores in split TF32
(three TF32 passes per product keep f32's 1e-5 contract).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

#: the largest chunk and head / state width csrc/ssd.cu takes
MAX_CHUNK, MAX_DIM = 256, 128
#: csrc/ssd.cu's C B^T tile: the scratch's rows and columns are Q rounded up
#: to it
CB_TILE = 64


def ssd_chunk(xc, dtc, dA_cumsum, Bc, Cc):
    """xc: [B,nc,Q,nh,hd]; dtc/dA_cumsum: [B,nc,Q,nh]; Bc/Cc: [B,nc,Q,st],
    all f32. Returns (y_diag [B,nc,Q,nh,hd], chunk_state [B,nc,nh,hd,st])."""
    B, nc, Q, nh, hd = xc.shape
    st = Bc.shape[-1]
    want = {"dtc": (B, nc, Q, nh), "dA_cumsum": (B, nc, Q, nh),
            "Bc": (B, nc, Q, st), "Cc": (B, nc, Q, st)}
    for name, t in zip(want, (dtc, dA_cumsum, Bc, Cc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected shape {want[name]}")
    if xc.device.type == "cpu":
        return ssd_chunk_ref(xc, dtc, dA_cumsum, Bc, Cc)
    if not (Q <= MAX_CHUNK and hd <= MAX_DIM and st <= MAX_DIM):
        raise ValueError(f"ssd kernel: chunk {Q} (<= {MAX_CHUNK}), head dim "
                         f"{hd} and state {st} (<= {MAX_DIM})")
    dev = _build.check_cuda("ssd", xc, dtc, dA_cumsum, Bc, Cc,
                            dtypes=(torch.float32,))
    G = B * nc
    Qp = -(-Q // CB_TILE) * CB_TILE
    cb = torch.empty((G, Qp, Qp), dtype=torch.float32, device=dev)
    y = torch.empty_like(xc)
    state = torch.empty((B, nc, nh, hd, st), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch("ssd", "repro_ssd", xc.data_ptr(), dtc.data_ptr(),
                      dA_cumsum.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                      cb.data_ptr(), y.data_ptr(), state.data_ptr(),
                      G, Q, nh, hd, st)
    return y, state
