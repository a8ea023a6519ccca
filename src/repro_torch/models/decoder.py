"""The decoder LM for the ``dense``, ``moe``, ``ssm`` and ``hybrid``
families (counterpart of repro/models/decoder.py, its serving and training
paths).

``build_model(cfg, device=..., generator=...)`` returns a ``Decoder``
module that holds its parameters. Its methods mirror the reference's pure
functions, without the ``params`` argument:

  forward(tokens, embeds=None)          -> (logits [B, S, V], aux)
  forward_hidden(tokens, embeds=None)   -> (h [B, S, d], aux)   (training)
  loss(tokens, loss_mask=None, embeds=None) -> scalar next-token xent (training)
  prefill(tokens, embeds=None, cache_len=None) -> (logits_last [B, V], caches)
  decode_step(caches, tokens, pos)      -> (logits [B, V], caches)
  init_caches(batch, cache_len)         -> caches

``functional_loss(model)`` is ``loss`` as a function of a dict of
parameter tensors (``torch.func.functional_call``), which the trainers and
the federated problem (core/lm.py) differentiate. Serving (``forward``,
``prefill``) runs the flash-attention and SSD kernels; training
(``forward_hidden``, ``loss``) runs the reference's jnp paths in plain
torch (models/layers.py), which ``torch.func.grad`` and ``vmap`` trace.
Remat is not needed at the sizes the port trains (smollm-135m at 4 × 128
tokens a client keeps a few GiB of activations); the reference's
``remat`` switch has no counterpart.

The reference scans stacked [L, ...] layer parameters; here each stack is
an ``nn.ModuleList`` walked by a Python loop. The hybrid (Zamba2) family
keeps its one weight-tied ``shared`` attention+MLP block, applied after
each group of ``shared_attn_period - 1`` Mamba-2 layers, then its trailing
Mamba-2 layers (``mamba_tail``).

Caches (``LMCaches``) are explicit tensors in the reference's nesting,
stacked per layer: a KV group {"k", "v": [n, B, C, KV, hd], "pos":
[n, B, C] int32 (-1: never written), "idx": [n] int32 (the shared ring
index)}, an SSM group {"conv": [n, B, W-1, conv_dim], "ssm":
[n, B, nh, hd, st] f32}. ``decode_step`` updates them in place and
returns the same object. With ``cfg.kv_quant``, ``init_caches`` builds
int8 KV groups ("k", "v" int8 and "k_scale", "v_scale" [n, B, C, KV, 1]
f32); ``prefill`` builds model-dtype ones whatever ``kv_quant`` says, as
the reference's does, and the decode steps after it run unquantized.

The ``vlm`` and ``audio`` families are the dense decoder with a frontend
stub: ``embeds`` [B, P, d] (precomputed patch or audio-frame embeddings,
cast to the model dtype) replace the first P positions of the token
embeddings in ``forward``, ``forward_hidden``, ``loss`` (whose targets at
those positions carry no loss) and ``prefill``. Decode takes tokens only.

The ``moe`` family's blocks (``MoEBlock``) route with the capacity factor
in ``forward``, ``forward_hidden``, ``loss`` and ``prefill``, and dropless
in ``decode_step``, as the reference; ``forward`` and ``forward_hidden``
return the blocks' load-balance aux loss summed in f32, and ``loss`` adds
0.01 of it. Its caches are the dense family's.

Left for a later slice: the ``Sharder`` (tensor parallelism).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as Lyr

SERVED_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
#: sequence positions a chunk of the loss's unembed + cross entropy takes
#: (the reference's XENT_CHUNK): [B, c, V] logits at a time, never [B, S, V]
XENT_CHUNK = 512


class DenseBlock(nn.Module):
    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                      requires_grad=False)
        self.attn = Lyr.attn_init(gen, cfg, dtype, device)
        self.mlp_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                     requires_grad=False)
        self.mlp = Lyr.mlp_init(gen, d, cfg.d_ff, dtype, device)

    def forward(self, h, cfg, positions, window, cache=None, train=False):
        """Returns (h, (k, v)): this block's k/v for prefill's caches."""
        a, k, v = Lyr.attention(self.attn, Lyr.rms_norm(h, self.attn_norm), cfg,
                                positions, cache=cache, window=window, train=train)
        h = h + a
        h = h + Lyr.mlp(self.mlp, Lyr.rms_norm(h, self.mlp_norm))
        return h, (k, v)


class MoEBlock(nn.Module):
    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                      requires_grad=False)
        self.attn = Lyr.attn_init(gen, cfg, dtype, device)
        self.mlp_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                     requires_grad=False)
        self.moe = Lyr.moe_init(gen, cfg, dtype, device)

    def forward(self, h, cfg, positions, window, cache=None, train=False):
        """Returns (h, (k, v), aux). Decode (``cache`` given) routes
        dropless: capacity dispatch is non-causal across the batch, so drops
        would make decode part from teacher forcing (decoder.py:56-68)."""
        a, k, v = Lyr.attention(self.attn, Lyr.rms_norm(h, self.attn_norm), cfg,
                                positions, cache=cache, window=window, train=train)
        h = h + a
        y, aux = Lyr.moe(self.moe, Lyr.rms_norm(h, self.mlp_norm), cfg,
                         dropless=cache is not None)
        return h + y, (k, v), aux


class SSMBlock(nn.Module):
    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        self.norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device),
                                 requires_grad=False)
        self.mixer = Lyr.mamba_init(gen, cfg, dtype, device)

    def forward(self, h, cfg, positions=None, window=0, cache=None, train=False):
        """Returns (h, {"conv", "ssm"}); ``cache`` is this layer's state
        (decode), updated in place. Positions and window are not read."""
        y, new_state = Lyr.mamba_forward(self.mixer, Lyr.rms_norm(h, self.norm), cfg,
                                         state=cache, train=train)
        return h + y, new_state


def _layer(group: dict, l: int) -> dict:
    """Layer l's view of a stacked cache group (writes go to the stack)."""
    return {name: t[l] for name, t in group.items()}


class LMCaches:
    """Decode caches in the reference's nesting (module docstring):
    ``tree`` is a KV group (dense), an SSM group (ssm), or for the hybrid
    {"mamba": SSM group, "shared_kv": KV group[, "tail": SSM group]}."""

    def __init__(self, tree: dict):
        self.tree = tree

    def group(self, key: str | None) -> dict:
        """The stacked group ``key`` ("mamba", "shared_kv", "tail"), or the
        whole tree for None (the dense and ssm families' one group)."""
        return self.tree if key is None else self.tree[key]

    def groups(self) -> list[dict]:
        if "k" in self.tree or "ssm" in self.tree:
            return [self.tree]
        return list(self.tree.values())

    def reset_slot(self, s: int) -> None:
        """Empty batch slot s of every layer: k, v (and an int8 cache's
        k_scale and v_scale), conv and ssm to 0, pos to -1 (the reference's
        SlotServer._reset_slot). The ring index is
        shared by all slots and stays."""
        for g in self.groups():
            for name, t in g.items():
                if name == "pos":
                    t[:, s] = -1
                elif name != "idx":
                    t[:, s] = 0


class Decoder(nn.Module):
    def __init__(self, cfg: ArchConfig, device, gen: torch.Generator):
        super().__init__()
        cfg.validate()
        if cfg.family not in SERVED_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} belongs to a later "
                                      f"slice; the port serves {SERVED_FAMILIES}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        #: sqrt(d) in f32, rounded to the model dtype (decoder.py:175); a
        #: Python float, so embedding a step copies nothing to the card
        self.embed_scale = float(torch.tensor(math.sqrt(cfg.d_model)).to(self.dtype))
        dtype, V, d, L = self.dtype, cfg.eff_vocab, cfg.d_model, cfg.num_layers
        self.embed = nn.Parameter(Lyr.dense_init(gen, (V, d), d, dtype, device),
                                  requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(Lyr.dense_init(gen, (d, V), d, dtype, device),
                                        requires_grad=False)
        fam = cfg.family
        if fam == "ssm":
            self.blocks = nn.ModuleList(SSMBlock(gen, cfg, dtype, device)
                                        for _ in range(L))
        elif fam == "hybrid":
            n_groups, group, trailing = cfg.hybrid_counts
            self.mamba_groups = nn.ModuleList(SSMBlock(gen, cfg, dtype, device)
                                              for _ in range(n_groups * group))
            if trailing:
                self.mamba_tail = nn.ModuleList(SSMBlock(gen, cfg, dtype, device)
                                                for _ in range(trailing))
            self.shared = DenseBlock(gen, cfg, dtype, device)   # weight-tied
        else:
            block = MoEBlock if fam == "moe" else DenseBlock
            self.blocks = nn.ModuleList(block(gen, cfg, dtype, device)
                                        for _ in range(L))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --------------------------- embedding ---------------------------
    def embed_tokens(self, tokens, embeds=None):
        """The tokens' scaled embeddings [B, S, d]; ``embeds`` [B, P, d]
        (P <= S), cast to the model dtype, replace positions [0, P)
        (decoder.py:174-181)."""
        h = self.embed[tokens.long()] * self.embed_scale
        if embeds is None:
            return h
        P = embeds.shape[1]
        if P > tokens.shape[1]:
            raise ValueError(f"{P} frontend embeddings for {tokens.shape[1]} "
                             "positions")
        return torch.cat([embeds.to(h.dtype), h[:, P:]], dim=1)

    def unembed(self, h):
        h = Lyr.rms_norm(h, self.final_norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h @ head

    def unembed_last(self, h):
        """Logits of the last position only: prefill never builds [B, S, V]."""
        return self.unembed(h[:, -1:])[:, -1]

    def _positions(self, B, S):
        return torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)

    def schedule(self) -> list[tuple[nn.Module, str | None, int]]:
        """(block, cache group, layer index in the group) in the order the
        layers run (the group as ``LMCaches.group`` takes it)."""
        if self.cfg.family != "hybrid":
            return [(b, None, l) for l, b in enumerate(self.blocks)]
        n_groups, group, _ = self.cfg.hybrid_counts
        out = []
        for g in range(n_groups):
            out += [(self.mamba_groups[l], "mamba", l)
                    for l in range(g * group, (g + 1) * group)]
            out.append((self.shared, "shared_kv", g))
        return out + [(b, "tail", l) for l, b in enumerate(getattr(self, "mamba_tail", []))]

    # --------------------------- forward ------------------------------
    def forward(self, tokens, embeds=None):
        """tokens [B, S] -> (logits [B, S, V], aux: the MoE blocks'
        load-balance loss, f32; 0 for the other families)."""
        h, aux = self._run(tokens, embeds, None)
        return self.unembed(h), aux

    def forward_hidden(self, tokens, embeds=None):
        """The training forward: tokens [B, S] -> (h [B, S, d] before the
        final norm, aux as ``forward``'s), through the reference's jnp
        attention and SSD paths (no kernel launch). For the hybrid family:
        each group of Mamba-2 layers, then the shared block, then the
        trailing layers."""
        return self._run(tokens, embeds, None, train=True)

    def _run(self, tokens, embeds, caches: LMCaches | None, train: bool = False):
        """The no-cache pass over every layer (``train``: the training
        paths); when ``caches`` is given, writes each layer's k/v
        (positions 0..S-1) or final SSM state into it (prefill). Returns
        (h, aux): aux the MoE blocks' aux losses summed in f32."""
        cfg, window = self.cfg, self.cfg.sliding_window
        B, S = tokens.shape
        positions = self._positions(B, S)
        h = self.embed_tokens(tokens, embeds)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for block, key, l in self.schedule():
            h, new, *block_aux = block(h, cfg, positions, window, train=train)
            if block_aux:
                aux = aux + block_aux[0]
            if caches is None:
                continue
            g = caches.group(key)
            if isinstance(block, SSMBlock):
                g["conv"][l] = new["conv"]
                g["ssm"][l] = new["ssm"]
            else:
                g["k"][l, :, :S], g["v"][l, :, :S] = new
                g["pos"][l, :, :S] = positions
                g["idx"][l] = S
        return h, aux

    # ----------------------------- loss -------------------------------
    def loss(self, tokens, loss_mask=None, embeds=None):
        """Next-token cross entropy (decoder.py:303-323): tokens [B, S] int,
        loss_mask [B, S] (optional; position s weighs the prediction of
        token s), embeds [B, P, d] (vlm/audio; their P positions carry no
        loss). The mean over the mask's weight, at least 1; plus 0.01 of the
        MoE blocks' aux loss when the config has experts."""
        h, aux = self.forward_hidden(tokens, embeds)
        h = Lyr.rms_norm(h, self.final_norm)[:, :-1]
        tgt = tokens[:, 1:]
        mask = (torch.ones(tgt.shape, dtype=torch.float32, device=h.device)
                if loss_mask is None else loss_mask[:, 1:].float())
        if self.cfg.frontend_tokens and embeds is not None:
            pos_ok = torch.arange(tgt.shape[1], device=h.device) >= embeds.shape[1]
            mask = mask * pos_ok[None, :]
        total = self._chunked_xent(h, tgt, mask)
        loss = total / torch.clamp(mask.sum(), min=1.0)
        if self.cfg.num_experts:
            loss = loss + 0.01 * aux
        return loss

    def _chunked_xent(self, h, tgt, mask):
        """Σ mask · nll over chunks of XENT_CHUNK positions, in order: each
        chunk's logits in f32 (the padded vocabulary's columns at -1e30),
        its log-softmax and the targets' entries. h [B, S-1, d], tgt and
        mask [B, S-1]; S-1 is padded up to a whole chunk."""
        cfg = self.cfg
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        n = h.shape[1]
        c = min(XENT_CHUNK, n)
        pad = -n % c
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            tgt = F.pad(tgt, (0, pad))
            mask = F.pad(mask, (0, pad))
        pad_cols = None
        if cfg.eff_vocab != cfg.vocab_size:
            pad_cols = torch.arange(cfg.eff_vocab, device=h.device) >= cfg.vocab_size
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, n + pad, c):
            lg = (h[:, c0:c0 + c] @ head).float()
            if pad_cols is not None:
                lg = torch.where(pad_cols, -1e30, lg)
            logp = torch.log_softmax(lg, dim=-1)
            nll = -logp.gather(-1, tgt[:, c0:c0 + c, None].long())[..., 0]
            total = total + (nll * mask[:, c0:c0 + c]).sum()
        return total

    # --------------------------- caches -------------------------------
    def init_caches(self, batch: int, cache_len: int,
                    device: "str | torch.device" = DEFAULT_DEVICE) -> LMCaches:
        """Empty decode caches; their KV groups int8 with ``cfg.kv_quant``."""
        if resolve_device(device).type != self.device.type:
            raise ValueError(f"the model lies on {self.device}: build it with "
                             f"device={device!r} to keep caches there")
        return self._caches(batch, cache_len, self.cfg.kv_quant)

    def _caches(self, batch: int, cache_len: int, quant: bool) -> LMCaches:
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        if cfg.family == "ssm":
            return LMCaches(Lyr.init_ssm_state(cfg, cfg.num_layers, batch, dtype, dev))
        if cfg.family == "hybrid":
            n_groups, group, trailing = cfg.hybrid_counts
            tree = {"mamba": Lyr.init_ssm_state(cfg, n_groups * group, batch, dtype, dev),
                    "shared_kv": Lyr.init_kv_cache(cfg, n_groups, batch, cache_len,
                                                   dtype, dev, quant)}
            if trailing:
                tree["tail"] = Lyr.init_ssm_state(cfg, trailing, batch, dtype, dev)
            return LMCaches(tree)
        return LMCaches(Lyr.init_kv_cache(cfg, cfg.num_layers, batch, cache_len,
                                          dtype, dev, quant))

    # --------------------------- prefill ------------------------------
    def prefill(self, tokens, embeds=None, cache_len: int | None = None):
        """Full forward that also builds the decode caches. ``cache_len``
        reserves room for the decode steps that follow (default S). The
        caches hold k/v in the model dtype even with ``cfg.kv_quant`` (the
        reference's ``pad_kv``, decoder.py:431-445)."""
        B, S = tokens.shape
        C = cache_len or S
        if C < S:
            raise ValueError(f"cache_len {C} is shorter than the prompt ({S})")
        caches = self._caches(B, C, quant=False)
        h, _ = self._run(tokens, embeds, caches)
        return self.unembed_last(h), caches

    # --------------------------- decode -------------------------------
    def decode_step(self, caches: LMCaches, tokens, pos):
        """tokens: [B, 1] int; pos: [B, 1] int absolute positions. Updates
        ``caches`` in place; returns (logits [B, V], caches)."""
        cfg, window = self.cfg, self.cfg.sliding_window
        h = self.embed_tokens(tokens)
        for block, key, l in self.schedule():
            h = block(h, cfg, pos, window, cache=_layer(caches.group(key), l))[0]
        return self.unembed(h)[:, -1], caches


class _Loss(nn.Module):
    """``Decoder.loss`` as a module's forward, so that
    ``torch.func.functional_call`` can run it on substituted parameters."""

    def __init__(self, model: Decoder):
        super().__init__()
        self.model = model

    def forward(self, tokens, loss_mask=None, embeds=None):
        return self.model.loss(tokens, loss_mask, embeds)


def functional_loss(model: Decoder) -> Callable[[dict, dict], torch.Tensor]:
    """``loss(params, batch)``: the model's loss with its parameters
    replaced by ``params`` (name → tensor, the names of
    ``model.named_parameters()``), on ``batch`` {"tokens", "loss_mask"
    (optional), "embeds" (optional)}. The model's own tensors are not
    read; ``torch.func.grad`` differentiates it in ``params``."""
    wrapper = _Loss(model)

    def loss(params: dict, batch: dict) -> torch.Tensor:
        return functional_call(
            wrapper, {f"model.{name}": t for name, t in params.items()}, (),
            dict(batch))

    return loss


def build_model(cfg: ArchConfig, device: "str | torch.device" = DEFAULT_DEVICE,
                generator: torch.Generator | None = None, seed: int = 0) -> Decoder:
    """The decoder for ``cfg`` with parameters drawn from ``generator`` (by
    default a generator on ``device`` seeded with ``seed``). Raises without
    a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        return Decoder(cfg, dev, gen)
