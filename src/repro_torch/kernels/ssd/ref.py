"""Plain PyTorch version of the SSD intra-chunk step (counterpart of
repro/kernels/ssd/ref.py, itself the default branch of the reference's
models/layers.py::_ssd_chunked_scan)."""
from __future__ import annotations

import torch


def ssd_chunk_ref(xc, dtc, dA_cumsum, Bc, Cc):
    """xc: [B,nc,Q,nh,hd]; dtc/dA_cumsum: [B,nc,Q,nh]; Bc/Cc: [B,nc,Q,st].
    Returns (y_diag [B,nc,Q,nh,hd], chunk_state [B,nc,nh,hd,st])."""
    Q = xc.shape[2]
    seg = dA_cumsum[:, :, :, None, :] - dA_cumsum[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xc.device).tril()
    # mask BEFORE the exp: above the diagonal seg > 0 and would overflow
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -1e30))
    cb = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)
    att = cb[..., None] * decay
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bcqkh,bckhd->bcqhd", att, xdt)
    decay_last = torch.exp(dA_cumsum[:, :, -1:, :] - dA_cumsum)
    chunk_state = torch.einsum("bcqs,bcqh,bcqhd->bchds", Bc, dtc * decay_last, xc)
    return y_diag, chunk_state
