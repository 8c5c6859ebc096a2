"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention. 56L d=6144 48H kv=8 expert d_ff=16384 vocab=32768."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, window=4096, rope_theta=1e6,
    n_experts=8, top_k=2, tie_embeddings=False,
)
