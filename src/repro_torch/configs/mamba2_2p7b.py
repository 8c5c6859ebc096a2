"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD (state-space duality).
64L d=2560 ssm_state=128 vocab=50280."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
)
