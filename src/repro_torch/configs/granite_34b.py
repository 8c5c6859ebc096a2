"""Granite-34B-Code [arXiv:2405.04324]: deep MQA (kv=1) code model.
88L d=6144 48H kv=1 d_ff=24576 vocab=49152."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, rope_theta=1e5, tie_embeddings=False,
    mlp_gated=False,
)
