"""Llama-4 Scout 17B-active / 16 experts — MoE with top-1 routing, early
fusion. Backbone dims per model card. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=16, experts_per_token=1, moe_d_ff=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
