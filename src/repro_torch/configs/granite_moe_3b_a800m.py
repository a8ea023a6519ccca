"""Granite-3.0 MoE 3B (800M active) — 40 experts top-8, small per-expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=40, experts_per_token=8, moe_d_ff=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
