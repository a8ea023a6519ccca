"""MusicGen-medium — decoder-only transformer over EnCodec tokens. The
EnCodec conv codec is stubbed per spec: input_specs() supplies precomputed
frame embeddings; the decoder predicts codebook tokens (vocab 2048).
[arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    frontend_tokens=512,     # EnCodec frames per conditioning segment
    source="arXiv:2306.05284",
)
