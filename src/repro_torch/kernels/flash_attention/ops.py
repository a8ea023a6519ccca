"""Flash attention in the model's layout, with GQA (counterpart of
repro/kernels/flash_attention/ops.py::flash_attention).

Dispatch is by the tensors' device only: CPU tensors, and meta tensors
(shapes only: launch/dryrun.py), run the plain version (ref.py); CUDA
tensors launch csrc/flash_attention.cu (f32, on the CUDA cores) or
csrc/flash_attention_tc.cu (bf16, on the tensor cores, head dims a multiple
of 16) or raise. The kernel reads q [B, S, H, hd] and k, v [B, S, KV, hd]
as they are: it maps query head h to kv head h // (H // KV) itself (the
reference repeats the kv heads) and masks the ragged end of S itself (the
reference pads S to the block), so nothing is copied around the launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the widest head the kernels take
MAX_HEAD_DIM = 128
#: the tensor-core kernel's head dims are whole k-steps of its bf16 mma
BF16_HEAD_DIM_MULTIPLE = 16


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, S, H, hd]; k, v: [B, S, KV, hd] with H % KV == 0; f32 or
    bf16. Returns [B, S, H, hd] in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected shape "
                         "[B, S, KV, hd] for k and v with H % KV == 0")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel: head dim {hd} > {MAX_HEAD_DIM}")
    dev = _build.check_cuda("flash_attention", q, k, v,
                            dtypes=(torch.float32, torch.bfloat16))
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v in {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dtype == torch.bfloat16 and hd % BF16_HEAD_DIM_MULTIPLE:
        raise ValueError(f"flash kernel: bf16 head dim {hd} is not a multiple "
                         f"of {BF16_HEAD_DIM_MULTIPLE}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _build.launch("flash_attention", "repro_flash_attention",
                      _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, S, H, KV, hd,
                      int(causal), window)
    return out
