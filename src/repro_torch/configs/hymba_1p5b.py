"""Hymba-1.5B [arXiv:2411.13676]: hybrid parallel attention+Mamba heads,
SWA in local layers, 128 meta tokens. 32L d=1600 25H (GQA kv=5) d_ff=5504."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024, rope_theta=1e4,
    ssm_state=16, ssm_heads=50, ssm_head_dim=64, ssm_expand=2,
    hybrid=True, meta_tokens=128,
)
