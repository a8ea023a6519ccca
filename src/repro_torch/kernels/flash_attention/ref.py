"""Plain PyTorch version of flash attention (counterpart of
repro/kernels/flash_attention/ref.py): materializes the full score matrix,
f32 throughout, output in q's dtype."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: [BH, S, d]. Returns [BH, S, d]."""
    S = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s / (q.shape[-1] ** 0.5)
    i = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (i[None, :] <= i[:, None])
    if window > 0:
        mask = mask & (i[None, :] > i[:, None] - window)
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """The model layout around attention_ref: q [B, S, H, hd], k, v
    [B, S, KV, hd]; query head h reads kv head h // (H // KV)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, S, hd)

    out = attention_ref(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                        window=window)
    return out.reshape(B, H, S, hd).transpose(1, 2)
