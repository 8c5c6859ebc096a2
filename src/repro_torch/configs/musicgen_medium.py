"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens
(frontend stubbed: input_specs supplies frame embeddings).
48L d=1536 24H kv=24 d_ff=6144 vocab=2048."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, rope_theta=1e4,
    mlp_gated=False,
    frontend="embed_stub", tie_embeddings=False,
)
