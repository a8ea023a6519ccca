"""Qwen3-4B — dense with QK-RMSNorm and GQA. head_dim=128 (decoupled from
d_model/num_heads as in the Qwen3 family). [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
