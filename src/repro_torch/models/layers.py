"""Transformer and Mamba-2 building blocks of the LM serving path
(counterpart of repro/models/layers.py, its serving subset).

Conventions, as in the reference:
* parameters are named as in the reference's nested dict (``wq``, ``wx``,
  ``A_log``, ...), held by a ``Params`` module so that a state dict path
  is the reference's path with the layer index inserted
  (core/convert.py::lm_params);
* dtype policy: parameters and activations in ``cfg.dtype`` (bf16 at full
  width), softmax, normalisation and SSM state math in f32. Each function
  rounds where the reference rounds (comments name the place).

Serving: no-cache attention (forward and prefill) goes to the
flash-attention kernel, whatever S is: the reference's materialized
softmax (S < 1024) and its blocked XLA path (``_attention_blocked``)
compute the same function, which the reference's Pallas kernel computes on
the TPU. The SSD intra-chunk step goes to the SSD kernel (the reference's
``ssd_fn`` hook). On CPU tensors both wrappers run their plain versions.

Training (``train=True``, the decoder's ``loss``): the reference trains
through its jnp paths, and so does the port, in plain torch: the
materialized softmax for S < 1024, ``_attention_blocked`` (an online
softmax over key blocks of 512) for S >= 1024 with S % 512 == 0, and the
jnp intra-chunk SSD step (``ssd_fn=None``). Neither calls a kernel
wrapper: a hand-written launch has no backward, and ``torch.func.grad``
and ``vmap`` (one point per client) cannot trace it. Both are
out-of-place and read nothing back to the host, so the engine captures
them.

MoE (``moe``): the reference's capacity dispatch in plain torch, for
serving and training alike; its expert products are plain products in the
reference too (no Pallas call). The dispatch builds an [E, C] buffer of
token ids and gathers rows, with no float atomics and no host read, so the
engine captures it and its backward (a sorted ``index_put_``) is
deterministic on the card.

GQA: in the ``grouped`` mode query head i reads KV slot i // G; in the
``gather`` mode (``padded()`` configs whose padded head map is not
uniform) the KV heads are gathered to one per query head (``kv_map``, from
the true head counts) and attention runs as MHA, on the flash kernel, the
training paths and decode alike, as the reference's gather path does.

The int8 KV cache (``kv_quant``): ``init_kv_cache(quant=True)`` holds int8
codes and an f32 scale per (slot, head) (``quantize_kv``); decode branches
on the cache's contents (``"k_scale" in cache``), as the reference, so a
prefill's model-dtype cache decodes unquantized.

Left for a later slice: the expert-parallel ``moe_sharded``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_chunk


class Params(nn.Module):
    """A flat group of parameters named as in the reference's dict. The
    serving path takes no gradients: every parameter is frozen."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype (as the reference)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)          # f32, as the reference


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int). Rotates interleaved
    (even, odd) pairs; angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., None].float() * freqs                # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    """normal x 1/sqrt(fan_in), drawn in f32 on the generator's device from
    ``gen``, then cast to ``dtype`` on ``device``."""
    scale = 1.0 / math.sqrt(in_axis_size)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm, full-causal or sliding-window, KV cache)
# ---------------------------------------------------------------------------

def gqa_mode(cfg) -> str:
    """'grouped' when query head i reads kv slot i // G (G = H // KV_eff)
    and that reproduces the true mapping i -> i * KV // H; else 'gather'."""
    H, KVe = cfg.eff_heads, cfg.eff_kv_heads
    KV, Ht = cfg.num_kv_heads, cfg.num_heads
    if not H or H % KVe != 0 or KVe % KV != 0:
        return "gather"
    G, r = H // KVe, KVe // KV
    for i in range(Ht):
        if (i // G) // r != (i * KV) // Ht:
            return "gather"
    return "grouped"


def kv_map(cfg, device) -> torch.Tensor:
    """The ``gather`` mode's [H] KV head of each query head, from the true
    counts (layers.py:294-297): (i·KVt)//Ht for a true head i < Ht, i % KV
    for a padded one (its output dies on its zero ``wo`` rows). Computed on
    the device, so that no step copies a host list there."""
    i = torch.arange(cfg.eff_heads, device=device)
    Ht, KVt = cfg.num_heads, cfg.num_kv_heads
    return torch.where(i < Ht, (i * KVt) // Ht, i % cfg.eff_kv_heads)


def _gather_kv(cfg, k: torch.Tensor) -> torch.Tensor:
    """k [B, S, KV, hd] as [B, S, H, hd] in the ``gather`` mode; as it is in
    the ``grouped`` one."""
    if gqa_mode(cfg) == "grouped":
        return k
    return k.index_select(2, kv_map(cfg, k.device))


def attn_init(gen, cfg, dtype, device) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    KV_true = cfg.num_kv_heads

    def kv_proj():
        if gqa_mode(cfg) == "grouped" and KV != KV_true and KV % KV_true == 0:
            # replicated-kv layout: padded slots repeat the true kv heads
            w = dense_init(gen, (d, KV_true, hd), d, dtype, device)
            return w.repeat_interleave(KV // KV_true, dim=1).reshape(d, KV * hd)
        return dense_init(gen, (d, KV * hd), d, dtype, device)

    p = {"wq": dense_init(gen, (d, H * hd), d, dtype, device),
         "wk": kv_proj(), "wv": kv_proj(),
         "wo": dense_init(gen, (H * hd, d), H * hd, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    if cfg.eff_heads != cfg.num_heads:
        # zero the padded heads' output rows: padded heads are no-ops
        mask = (torch.arange(H * hd, device=device) < cfg.num_heads * hd).to(dtype)
        p["wo"] = p["wo"] * mask[:, None]
    return Params(p)


def _attn_scores_mask(q_pos, k_pos, window: int):
    """[.., Sq, Sk] boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _attn_scale(hd: int) -> float:
    """1/sqrt(hd) in f32, as the reference (a Python float holding that
    value)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def _attention_blocked(q5, k, v, positions, window: int, block: int = 512):
    """The reference's flash-style blocked attention in plain torch
    (layers.py:165-210): an online softmax over key blocks of ``block``, in
    f32, so the [Sq, Sk] scores are never held whole. q5: [B, Sq, KV, G,
    hd] (grouped layout); k, v: [B, Sk, KV, hd]. Returns [B, Sq, KV, G, hd]
    in q5's dtype."""
    B, Sq, KV, G, hd = q5.shape
    Sk = k.shape[1]
    block = min(block, Sk)            # the caller's S % 512 == 0: whole blocks
    scale = _attn_scale(hd)
    q32 = q5.float()
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q5.device)
    m = torch.full((B, KV, G, Sq), -1e30, dtype=torch.float32, device=q5.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q5.device)
    for b0 in range(0, Sk, block):
        k_b, v_b = k[:, b0:b0 + block].float(), v[:, b0:b0 + block].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", q32, k_b) * scale
        mask = _attn_scores_mask(positions, positions[:, b0:b0 + block], window)
        s = torch.where(mask[:, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", pr, v_b)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)       # [B, KV, G, Sq, hd]
    return out.permute(0, 3, 1, 2, 4).to(q5.dtype)


def _attention_train(q, k, v, positions, window: int, dtype):
    """The reference's no-cache grouped attention (layers.py:278-289,
    :294-301): q [B, S, H, hd], k and v [B, S, KV, hd] → [B, S, H·hd]. The
    materialized softmax (scores rounded to ``dtype``, then an f32
    softmax, probabilities back in ``dtype``) for S < 1024; the blocked
    path for S >= 1024 with S % 512 == 0."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q5 = q.reshape(B, S, KV, H // KV, hd)
    if S >= 1024 and S % 512 == 0:
        return _attention_blocked(q5, k, v, positions, window).reshape(B, S, H * hd)
    mask = _attn_scores_mask(positions, positions, window)          # [B, S, S]
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float()
    logits = torch.where(mask[:, None, None], logits * _attn_scale(hd), -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(B, S, H * hd)


def attention(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
              cache: dict | None = None, window: int = 0, train: bool = False):
    """x: [B, S, d]. Returns (out [B, S, d], k, v): this call's k (after
    rope) and v, [B, S, KV, hd], which prefill writes into its caches.

    Without ``cache`` (forward, prefill; positions are 0..S-1): the flash
    kernel, or with ``train`` the reference's training attention in plain
    torch (``_attention_train``). With ``cache`` (decode, S == 1): one
    layer's view of the KV ring buffer {"k", "v": [B, C, KV, hd], "pos":
    [B, C], "idx": 0-d}, updated in place: this step's k/v and positions
    go to slot idx % C, then idx += 1 (the reference returns a new cache;
    the port writes into the one it was given). A cache that holds
    "k_scale" and "v_scale" [B, C, KV, 1] is the int8 one: the step is
    written as codes and scales, and read back dequantized to x's dtype.
    In the ``gather`` mode the KV heads are gathered to H (``_gather_kv``)
    after the cache, which keeps KV heads."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.eff_heads, cfg.eff_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        k_use, v_use = _gather_kv(cfg, k), _gather_kv(cfg, v)
        if train:
            out = _attention_train(q, k_use, v_use, positions, window, x.dtype)
            return out @ p["wo"], k, v
        out = flash_attention(q, k_use, v_use, causal=True, window=window)
        return out.reshape(B, S, H * hd) @ p["wo"], k, v

    if S != 1:
        raise ValueError(f"attention with a cache decodes one token; got S={S}")
    C = cache["k"].shape[1]
    slot = (cache["idx"] % C).long().reshape(1)
    cache["pos"].index_copy_(1, slot, positions.to(cache["pos"].dtype))
    cache["idx"].add_(1)
    if "k_scale" in cache:
        # int8: write codes and scales; read k_all·k_sc and v_all·v_sc in
        # f32, each rounded to x's dtype (layers.py:241-254)
        for name, t in (("k", k), ("v", v)):
            codes, scale = quantize_kv(t)
            cache[name].index_copy_(1, slot, codes)
            cache[name + "_scale"].index_copy_(1, slot, scale)
        k_all = (cache["k"].float() * cache["k_scale"]).to(x.dtype)
        v_all = (cache["v"].float() * cache["v_scale"]).to(x.dtype)
    else:
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        k_all, v_all = cache["k"], cache["v"]
    k_all, v_all, k_pos = _gather_kv(cfg, k_all), _gather_kv(cfg, v_all), cache["pos"]

    scale = _attn_scale(hd)
    mask = _attn_scores_mask(positions, k_pos, window)             # [B, Sq, Sk]
    mask = mask & (k_pos >= 0)[:, None]       # never-written slots: pos = -1
    KVa = k_all.shape[2]
    q5 = q.reshape(B, S, KVa, H // KVa, hd)
    # scores rounded to the model dtype, then the f32 softmax; the
    # probabilities go back to the model dtype for p v (layers.py:283-289)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k_all).float()
    logits = torch.where(mask[:, None, None], logits * scale, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_all).reshape(B, S, H * hd)
    return out @ p["wo"], k, v


#: the int8 KV cache's scale is max|x| · fl(1/127): the jitted reference
#: compiles its division by the constant 127 so (XLA turns a division by a
#: constant into a product by its reciprocal), one ulp off the quotient in
#: some rows; the product is a plain IEEE operation the port can match
_INV_127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def quantize_kv(x: torch.Tensor):
    """One decode step's k or v, [B, 1, KV, hd], as int8 codes and f32
    scales [B, 1, KV, 1] (the reference's ``_quantize_kv``, layers.py:339-344):
    scale = max|x| over hd, in f32, times fl(1/127), at least 1e-8; codes =
    round(x / scale) (half to even, as ``jnp.round``) clipped to ±127."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1, keepdim=True) * _INV_127, min=1e-8)
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def init_kv_cache(cfg, layers: int, batch: int, cache_len: int, dtype,
                  device, quant: bool = False) -> dict:
    """KV ring buffers of ``layers`` layers, stacked on a leading axis;
    with ``quant`` the int8 cache: int8 "k", "v" and f32 "k_scale",
    "v_scale" [layers, B, C, KV, 1] (layers.py:320-330)."""
    KV, hd = cfg.eff_kv_heads, cfg.resolved_head_dim
    kv_dtype = torch.int8 if quant else dtype
    out = {
        "k": torch.zeros((layers, batch, cache_len, KV, hd), dtype=kv_dtype, device=device),
        "v": torch.zeros((layers, batch, cache_len, KV, hd), dtype=kv_dtype, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            out[name] = torch.zeros((layers, batch, cache_len, KV, 1),
                                    dtype=torch.float32, device=device)
    out["pos"] = torch.full((layers, batch, cache_len), -1, dtype=torch.int32, device=device)
    out["idx"] = torch.zeros((layers,), dtype=torch.int32, device=device)
    return out


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    return Params({"wi_gate": dense_init(gen, (d, f), d, dtype, device),
                   "wi_up": dense_init(gen, (d, f), d, dtype, device),
                   "wo": dense_init(gen, (f, d), f, dtype, device)})


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch; the reference's ``moe``)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg, dtype, device) -> Params:
    """The router [d, E] in f32 whatever ``dtype``; the experts' SwiGLU
    weights [E, d, f], [E, d, f], [E, f, d] in ``dtype`` (layers.py:460)."""
    d, E, f = cfg.d_model, cfg.eff_experts, cfg.moe_d_ff
    return Params({"router": dense_init(gen, (d, E), d, torch.float32, device),
                   "wi_gate": dense_init(gen, (E, d, f), d, dtype, device),
                   "wi_up": dense_init(gen, (E, d, f), d, dtype, device),
                   "wo": dense_init(gen, (E, f, d), f, dtype, device)})


def moe_top_k(probs: torch.Tensor, k: int):
    """(gate_w, gate_i) [T, k]: the k most probable experts of each token,
    by a stable descending sort, so that equal probabilities take the lower
    expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order among ties); their probabilities renormalised to sum to 1."""
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :k], gate_i[:, :k]
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), gate_i


def moe_route(p: Params, xt: torch.Tensor, cfg, dropless: bool = False):
    """The router of ``moe`` on tokens xt [T, d]: (gate_w [T, k] f32,
    gate_i [T, k], aux, flat_e [T·k], pos [T·k], keep [T·k], capacity).

    Assignment j = t·k + i (token-major) sits at position pos[j] of expert
    flat_e[j]: the number of earlier assignments to that expert (the cumsum
    of the one-hot); it is kept if pos < capacity."""
    T = xt.shape[0]
    E, k = cfg.eff_experts, cfg.experts_per_token
    experts = torch.arange(E, device=xt.device)
    logits = xt.float() @ p["router"]                               # [T, E]
    if E != cfg.num_experts:
        # padded (dummy) experts are masked out of routing entirely
        logits = torch.where(experts >= cfg.num_experts, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = moe_top_k(probs, k)

    # load-balance aux loss (Switch): E · Σ_e fraction_e · prob_e
    frac = (gate_i[:, :1] == experts).float().mean(0)
    aux = E * torch.sum(frac * probs.mean(0))

    capacity = T * k if dropless else max(int(cfg.capacity_factor * T * k / E), 1)
    flat_e = gate_i.reshape(-1)                                     # [T·k]
    # the one-hot laid out [E, T·k], so that the cumsum runs along the
    # contiguous dim: along dim 0 of [T·k, E], CUDA scans each of the E
    # columns with one thread (a granite-moe-3b-a800m prefill of 4 x 2048
    # took 692 ms of device time so, 136 ms this way: chip_smoke.py phase
    # 6c on an H100 80GB HBM3 at 700 W)
    onehot = (experts[:, None] == flat_e).to(torch.int32)           # [E, T·k]
    pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None])[0] - 1
    return gate_w, gate_i, aux, flat_e, pos, pos < capacity, capacity


def moe(p: Params, x: torch.Tensor, cfg, dropless: bool = False):
    """x [B, S, d] -> (out [B, S, d], aux: the Switch load-balance loss, f32).

    ``dropless`` (decode) takes capacity T·k, so no token drops; forward,
    prefill and training keep the capacity factor (layers.py:471-526).
    Each expert's [C] slots hold the ids of its kept tokens, scattered into
    an [E, C + 1] buffer whose last column takes every dropped assignment
    (so none lands on a kept one) and is cut off; the [E, C, d] inputs are
    rows of xt gathered by id, id T being a zero row. The outputs come back
    by indexing, weighted in the model dtype and summed over the k slots."""
    B, S, d = x.shape
    E, k = cfg.eff_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    gate_w, _, aux, flat_e, pos, keep, C = moe_route(p, xt, cfg, dropless)

    tok_id = torch.arange(T * k, device=x.device) // k
    ids = torch.full((E, C + 1), T, dtype=torch.int64, device=x.device).index_put(
        (flat_e, torch.where(keep, pos, C)), tok_id)[:, :C]
    xt_pad = torch.cat([xt, xt.new_zeros(1, d)])
    buf = xt_pad[ids]                                               # [E, C, d]

    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    yb = torch.bmm(h, p["wo"])                                      # [E, C, d]

    y_tok = torch.where(keep[:, None], yb[flat_e, torch.where(keep, pos, C - 1)], 0)
    w_flat = gate_w.reshape(-1, 1).to(x.dtype)
    y = (y_tok * w_flat).reshape(T, k, d).sum(1)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg, dtype, device) -> Params:
    """Projections kept separate, as in the reference (wx, wz, wB, wC, wdt;
    the conv split into its x and B/C channels)."""
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, W = cfg.ssm_heads, cfg.ssm_conv_width
    f32 = torch.float32
    return Params({
        "wx": dense_init(gen, (d, di), d, dtype, device),
        "wz": dense_init(gen, (d, di), d, dtype, device),
        "wB": dense_init(gen, (d, st), d, dtype, device),
        "wC": dense_init(gen, (d, st), d, dtype, device),
        "wdt": dense_init(gen, (d, nh), d, dtype, device),
        "conv_x_w": dense_init(gen, (W, di), W, dtype, device),
        "conv_x_b": torch.zeros(di, dtype=dtype, device=device),
        "conv_bc_w": dense_init(gen, (W, 2 * st), W, dtype, device),
        "conv_bc_b": torch.zeros(2 * st, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)),
        "D": torch.ones(nh, dtype=f32, device=device),
        "dt_bias": torch.zeros(nh, dtype=f32, device=device),
        "norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), di, dtype, device),
    })


def _ssd_intra_chunk(xc, dtc, dA_cumsum, Bc, Cc):
    """The reference's jnp intra-chunk step (layers.py:582-600, ``ssd_fn``
    None), which it trains through: the diagonal block's output y_diag [B,
    nc, Q, nh, hd] and each chunk's final state [B, nc, nh, hd, st]."""
    Q = xc.shape[2]
    # L[i, j] = exp(dA_cum[i] - dA_cum[j]) for i >= j; the mask comes before
    # the exp, so the non-causal entries (seg > 0) cannot overflow into NaN
    # gradients
    seg = dA_cumsum[:, :, :, None, :] - dA_cumsum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -1e30))
    cb = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)             # [B, nc, Q, Q]
    att = cb[..., None] * decay                              # [B, nc, Q, Q, nh]
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bcqkh,bckhd->bcqhd", att, xdt)
    decay_last = torch.exp(dA_cumsum[:, :, -1:, :] - dA_cumsum)
    chunk_state = torch.einsum("bcqs,bcqh,bcqhd->bchds", Bc, dtc * decay_last, xc)
    return y_diag, chunk_state


def _ssd_chunked_scan(xh, dt, A, Bm, Cm, chunk: int, train: bool = False):
    """SSD forward (Mamba2, arXiv:2405.21060 §6), chunked dual form.

    xh: [B, S, nh, hd]; dt: [B, S, nh] (softplus'd); A: [nh] (negative);
    Bm/Cm: [B, S, st]; all f32. Returns y [B, S, nh, hd] and the final
    state [B, nh, hd, st]. The intra-chunk step is the SSD kernel, or with
    ``train`` the reference's jnp step (``_ssd_intra_chunk``); the
    recurrence over chunks is a loop of out-of-place torch ops (the
    reference's associative scan, taken in order).
    """
    B, S, nh, hd = xh.shape
    st = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"the chunked SSD scan needs S ({S}) to be a multiple "
                         f"of its chunk ({chunk})")
    nc, Q = S // chunk, chunk
    xc = xh.reshape(B, nc, Q, nh, hd).contiguous()
    dtc = dt.reshape(B, nc, Q, nh).contiguous()
    Bc = Bm.reshape(B, nc, Q, st).contiguous()
    Cc = Cm.reshape(B, nc, Q, st).contiguous()

    dA_cumsum = torch.cumsum(dtc * A, dim=2)            # within-chunk cumsum
    intra = _ssd_intra_chunk if train else ssd_chunk
    y_diag, chunk_state = intra(xc, dtc, dA_cumsum, Bc, Cc)

    # inter-chunk recurrence: state after chunk c = state(c-1) * decay_c + s_c
    chunk_decay = torch.exp(dA_cumsum[:, :, -1, :])     # [B, nc, nh]
    run = chunk_state[:, 0]
    states = [run]
    for c in range(1, nc):
        run = run * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
        states.append(run)
    # state entering chunk c = states[c-1]; zero for the first
    prev_states = torch.stack([torch.zeros_like(run)] + states[:-1], dim=1)

    # contribution of the carried-in state to each position of the chunk
    state_decay = torch.exp(dA_cumsum)                  # [B, nc, Q, nh]
    y_off = torch.einsum("bcqs,bchds,bcqh->bcqhd", Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(B, S, nh, hd)
    return y, run


def mamba_forward(p: Params, x: torch.Tensor, cfg, state: dict | None = None,
                  train: bool = False):
    """Mamba2 block. Prefill/forward when ``state`` is None (chunked SSD;
    with ``train`` its intra-chunk step in plain torch, ``_ssd_intra_chunk``);
    a single-token recurrent step when it is one layer's view
    {"conv": [B, W-1, conv_dim], "ssm": [B, nh, hd, st]}, which is updated
    in place. Returns (out [B, S, d], new state {"conv", "ssm"})."""
    B, S, d = x.shape
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype
    xz = x @ p["wx"]
    z = x @ p["wz"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt_raw = x @ p["wdt"]

    conv_in = torch.cat([xz, Bm, Cm], dim=-1)             # [B, S, di + 2st]
    W = cfg.ssm_conv_width
    if state is None:
        pad = torch.zeros((B, W - 1, conv_in.shape[-1]), dtype=dtype, device=x.device)
        cseq = torch.cat([pad, conv_in], dim=1)
    else:
        cseq = torch.cat([state["conv"], conv_in], dim=1)
    new_conv_state = cseq[:, S:]                          # the last W-1 rows
    # depthwise causal conv: the reference's einsum over the W taps
    # ("bswc,wc->bsc") accumulates in f32 and rounds once to the model
    # dtype, then adds the bias in the model dtype
    wfull = torch.cat([p["conv_x_w"], p["conv_bc_w"]], dim=-1).float()
    bfull = torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=-1)
    acc = cseq[:, 0:S].float() * wfull[0]
    for w in range(1, W):
        acc = acc + cseq[:, w:w + S].float() * wfull[w]
    conv_out = F.silu(acc.to(dtype) + bfull)
    xc, Bc, Cc = torch.split(conv_out, [di, st, st], dim=-1)

    # dt in f32; x, B and C cast to f32 before the scan (layers.py:662-665)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])        # [B, S, nh]
    A = -torch.exp(p["A_log"])                            # [nh], < 0
    xh = xc.reshape(B, S, nh, hd).float()
    Bc32, Cc32 = Bc.float(), Cc.float()

    if state is None:
        y, final_state = _ssd_chunked_scan(xh, dt, A, Bc32, Cc32,
                                           min(cfg.ssm_chunk, S), train)
    else:
        # recurrent step: h <- exp(dt A) h + dt B (x) x ;  y = C . h
        dA = torch.exp(dt[:, 0] * A[None])                # [B, nh]
        h = state["ssm"] * dA[..., None, None]
        h = h + (dt[:, 0, :, None] * xh[:, 0])[..., None] * Bc32[:, 0, None, None, :]
        y = torch.einsum("bs,bhds->bhd", Cc32[:, 0], h)[:, None]   # [B, 1, nh, hd]
        final_state = h
        state["conv"].copy_(new_conv_state)
        state["ssm"].copy_(final_state)

    # y + D x in f32, then the model dtype before the gate (layers.py:684-686)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"])
    return y @ p["out_proj"], {"conv": new_conv_state, "ssm": final_state}


def init_ssm_state(cfg, layers: int, batch: int, dtype, device) -> dict:
    """Conv and SSM states of ``layers`` layers, stacked on a leading axis."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32, device=device),
    }
