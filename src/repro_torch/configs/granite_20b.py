"""Granite-20B (code) — llama-architecture dense with MQA (kv=1).
[arXiv:2405.04324]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    source="arXiv:2405.04324",
)
