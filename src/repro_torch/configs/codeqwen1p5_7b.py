"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 dense MHA.
32L d=4096 32H kv=32 d_ff=13440 vocab=92416."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416, rope_theta=1e6, tie_embeddings=False,
)
