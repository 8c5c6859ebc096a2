"""Architecture configurations of the LM serving slice: the dense, SSM and
hybrid families."""
from .base import ARCH_IDS, ArchConfig, get_arch

__all__ = ["ARCH_IDS", "ArchConfig", "get_arch"]
