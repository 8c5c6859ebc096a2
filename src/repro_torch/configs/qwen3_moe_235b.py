"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128-expert top-8 MoE,
QK-norm. 94L d=4096 64H kv=4 expert d_ff=1536 vocab=151936."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, rope_theta=1e6, qk_norm=True,
    n_experts=128, top_k=8, tie_embeddings=False,
)
