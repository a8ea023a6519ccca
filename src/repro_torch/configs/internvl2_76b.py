"""InternVL2-76B — InternViT vision encoder + InternLM2 LLM. We implement the
LANGUAGE BACKBONE (80L/8192/64H GQA-8); the ViT frontend is stubbed per spec:
input_specs() supplies precomputed patch embeddings. [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    frontend_tokens=1024,     # ViT patch embeddings per image
    source="arXiv:2404.16821",
)
