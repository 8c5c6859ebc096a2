"""Architecture configurations of the LM serving slices: the dense, MoE,
SSM, hybrid, vision-language and audio families."""
from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, all_cells,
                   cell_supported, get_arch, get_shape)

__all__ = ["ARCH_IDS", "ArchConfig", "get_arch", "ShapeConfig", "SHAPES",
           "get_shape", "cell_supported", "all_cells"]
