"""Zamba2-7B — Mamba2 backbone with a weight-TIED shared attention+MLP block
applied every 6th layer. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    shared_attn_period=6,
    source="arXiv:2411.15242",
)
