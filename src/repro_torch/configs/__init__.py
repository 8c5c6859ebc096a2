"""Architecture configurations of the LM serving slices: the dense, MoE,
SSM, hybrid, vision-language and audio families."""
from .base import ARCH_IDS, ArchConfig, get_arch

__all__ = ["ARCH_IDS", "ArchConfig", "get_arch"]
