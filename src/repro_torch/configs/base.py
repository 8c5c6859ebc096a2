"""Architecture configuration: ``ArchConfig``, its ``reduced()`` CPU-test
variant and ``get_arch``; the shape table (``ShapeConfig``, ``SHAPES``,
``get_shape``) and the (model, shape) cells it spans (``cell_supported``,
``all_cells``).

The port's own copy of the reference's ``configs/base.py`` (which the port
must not import): the dataclass is the same field for field, so a config
means the same thing in both packages. ``get_arch`` serves every language
model of the reference's pool: the dense, MoE, SSM, hybrid, vision-language
and audio families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

__all__ = ["ArchConfig", "ARCH_IDS", "get_arch", "ShapeConfig", "SHAPES",
           "get_shape", "cell_supported", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 => attention-free)
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention flavour
    window: int = 0             # sliding-window size (0 = full causal)
    rope_theta: float = 1e6
    mrope: bool = False         # Qwen2-VL M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False
    mlp_gated: bool = True      # SwiGLU (True) vs GELU 2-matrix MLP (False)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128        # SSD intra-chunk tile length
    # hybrid (Hymba): parallel attention + SSM heads per layer
    hybrid: bool = False
    meta_tokens: int = 0
    # IO
    frontend: str = "text"      # text | embed_stub (vision/audio frontends)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.has_ssm or (self.window > 0)

    def param_count(self) -> int:
        """Analytic parameter count (sanity vs the published sizes)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per = 2 * d  # norms
        if self.has_attention:
            per += d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
            if self.qk_norm:
                per += 2 * self.head_dim
        if self.has_ssm:
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            per += d * (2 * di + 2 * n + h)          # in_proj (z,x,B,C,dt)
            per += self.conv_width * (di + 2 * n)    # depthwise conv
            per += 3 * h + di                        # A, D, dt_bias, norm
            per += di * d                            # out_proj
        ff_mats = 3 if self.mlp_gated else 2
        if self.is_moe:
            per += d * self.n_experts + self.n_experts * ff_mats * d * f
        elif f > 0:
            per += ff_mats * d * f
        return emb + self.n_layers * per + d + self.meta_tokens * d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ff_mats = 3 if self.mlp_gated else 2
        dense_like = (self.param_count()
                      - self.n_layers * self.n_experts * ff_mats * d * f)
        return dense_like + self.n_layers * self.top_k * ff_mats * d * f

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        heads = min(self.n_heads, 4) if self.n_heads else 0
        kv = max(1, min(self.n_kv_heads, heads)) if heads else 0
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            mrope_sections=(2, 3, 3),  # scaled to head_dim/2 = 8
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            window=min(self.window, 32) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            # keep the invariant ssm_heads * ssm_head_dim == ssm_expand * d_model
            ssm_heads=(self.ssm_expand * 64) // 16 if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else 64,
            meta_tokens=min(self.meta_tokens, 8),
            dtype="float32",
        )


# the configurations this port serves (modules of this package): the
# reference's language models (its pool's other entry, ``glin``, is the
# spatial index, not a model)
ARCH_IDS = ["granite_3_2b", "phi4_mini_3p8b", "codeqwen1p5_7b", "granite_34b",
            "mamba2_2p7b", "hymba_1p5b", "mixtral_8x22b", "qwen3_moe_235b",
            "qwen2_vl_2b", "musicgen_medium"]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; this port serves "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{arch_id}").CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def all_cells():
    """All (arch, shape, supported, why) cells: every model of
    :data:`ARCH_IDS` under every shape of :data:`SHAPES` (40 LM cells)."""
    out = []
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        for sname, shp in SHAPES.items():
            ok, why = cell_supported(cfg, shp)
            out.append((aid, sname, ok, why))
    return out
