"""Qwen2-VL-2B [arXiv:2409.12191]: M-RoPE, dynamic-resolution ViT frontend
(stubbed: input_specs supplies patch embeddings). 28L d=1536 12H kv=2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="embed_stub",
)
