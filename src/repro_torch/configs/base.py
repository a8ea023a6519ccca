"""Architecture config system.

One ``ArchConfig`` per assigned architecture (see configs/<id>.py, each citing
its source), selectable via ``--arch``. ``reduced()`` produces the smoke-test
variant (≤2 layers, d_model ≤ 512, ≤4 experts) used by per-arch CPU tests;
``padded(model_shards)`` returns the tensor-parallel-ready variant (heads and
vocab rounded up for clean sharding — padded head outputs are exact no-ops at
init because their o_proj rows are zero; padded vocab logits are masked in the
loss).
"""
from __future__ import annotations

import dataclasses
import math

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int            # query heads; 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int                 # dense FFN dim (0 for pure ssm)
    vocab_size: int
    head_dim: int = 0         # 0 => d_model // num_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0         # per-expert FFN dim
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (zamba2-style shared attention block) ---
    shared_attn_period: int = 0   # apply the weight-tied attn block every Nth layer
    # --- attention variant ---
    sliding_window: int = 0       # 0 = full causal; >0 = window size
    rope_theta: float = 10_000.0
    # --- modality frontend stub (vlm/audio): embeddings arrive precomputed ---
    frontend_tokens: int = 0      # patches / audio frames per sample
    # --- serving options ---
    kv_quant: bool = False        # int8 KV cache (PerfH2 iter 2; default off = paper-faithful numerics)
    # --- bookkeeping ---
    dtype: str = "bfloat16"
    source: str = ""
    # --- padding applied? (set by .padded()) ---
    padded_vocab: int = 0
    padded_heads: int = 0
    padded_kv_heads: int = 0
    padded_experts: int = 0

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def eff_vocab(self) -> int:
        return self.padded_vocab or self.vocab_size

    @property
    def eff_heads(self) -> int:
        return self.padded_heads or self.num_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.padded_kv_heads or self.num_kv_heads

    @property
    def eff_experts(self) -> int:
        return self.padded_experts or self.num_experts

    @property
    def d_inner(self) -> int:
        """SSM inner dim."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def hybrid_counts(self) -> tuple[int, int, int]:
        """Zamba2 pattern: every ``shared_attn_period``-th block is the
        shared attention block. (groups, Mamba-2 layers per group, trailing
        Mamba-2 layers); the reference's ``models/decoder._hybrid_counts``."""
        p = self.shared_attn_period
        n_shared = self.num_layers // p
        group = p - 1
        trailing = self.num_layers - n_shared - n_shared * group
        assert trailing >= 0
        return n_shared, group, trailing

    @property
    def is_decoder(self) -> bool:
        return True   # every assigned arch decodes (backbones for vlm/audio)

    def param_count(self) -> int:
        """Analytic parameter count (true, unpadded dims) — used for the
        6·N·D model-FLOPs roofline term."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d                     # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size                # lm head
        if self.family in ("ssm",):
            per = self._ssm_layer_params()
            n += L * per
        elif self.family == "hybrid":
            n_shared = self.num_layers // max(self.shared_attn_period, 1)
            n_mamba = L - n_shared
            n += n_mamba * self._ssm_layer_params()
            n += self._attn_layer_params() + 2 * d * self.d_ff + d * self.d_ff  # one shared block
        else:
            attn = self._attn_layer_params()
            if self.family == "moe" or self.num_experts:
                mlp = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            else:
                mlp = 3 * d * self.d_ff
            n += L * (attn + mlp)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for MODEL_FLOPS = 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        attn = self._attn_layer_params()
        mlp = self.experts_per_token * 3 * d * self.moe_d_ff + d * self.num_experts
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n + L * (attn + mlp)

    def _attn_layer_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def _ssm_layer_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        in_proj = d * (2 * di + 2 * st + nh)   # x, z, B, C, dt
        out_proj = di * d
        conv = (di + 2 * st) * self.ssm_conv_width
        return in_proj + out_proj + conv + 2 * nh  # + A_log, D

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/block structure, toy size."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, heads // 2)) if self.num_kv_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv or heads,
            head_dim=64 if self.num_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=64 if self.ssm_state else 256,
            shared_attn_period=2 if self.shared_attn_period else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            dtype="float32",
            padded_vocab=0, padded_heads=0, padded_kv_heads=0,
        )

    def padded(self, model_shards: int) -> "ArchConfig":
        """Tensor-parallel-ready variant for an m-way 'model' axis."""
        if model_shards <= 1:
            return self
        pv = _round_up(self.vocab_size, model_shards * 128)
        ph, pkv = self.num_heads, self.num_kv_heads
        if self.num_heads:
            ph = _round_up(self.num_heads, model_shards)
            if self.num_kv_heads > 1 and self.num_kv_heads % model_shards != 0:
                # pad kv heads so the KV cache can shard over 'model' — at
                # 76B/32k-decode scale a replicated KV cache cannot fit HBM.
                # MQA (kv=1) stays replicated (standard TP-MQA; padding would
                # multiply kv params 16×). The GQA q->kv mapping uses TRUE
                # head counts (gather), so padded kv heads are never read.
                pkv = _round_up(self.num_kv_heads, model_shards)
        pe = self.num_experts
        if self.num_experts and self.num_experts % model_shards != 0:
            # §Perf H1: pad experts up to the model axis so the MoE runs
            # expert-parallel (all-to-all dispatch) instead of sharding the
            # tiny per-expert FFN dim (which costs an all-reduce of the full
            # [E,C,d] buffer per layer). Dummy experts are masked out of the
            # router softmax and are never routed to.
            pe = _round_up(self.num_experts, model_shards)
        return dataclasses.replace(
            self, padded_vocab=pv, padded_heads=ph, padded_kv_heads=pkv,
            padded_experts=pe,
        )

    def validate(self) -> None:
        assert self.family in FAMILIES, self.family
        if self.family in ("dense", "vlm", "audio"):
            assert self.num_heads > 0 and self.d_ff > 0
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0 and self.moe_d_ff > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.shared_attn_period > 0 and self.num_heads > 0
        if self.num_heads:
            pass  # head_dim may differ from d_model//heads (qwen3)
