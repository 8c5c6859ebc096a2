"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` with
``nvcc`` at first use (``_build``), each beside its plain torch version.

refine   GLIN refine stage: candidate count, run compaction, and the fused
         probe + compaction + exact-predicate query kernel
"""
from .refine import (MAX_COMPACT_BUDGET, refine_compact, refine_count,
                     refine_fused)

__all__ = ["MAX_COMPACT_BUDGET", "refine_count", "refine_compact",
           "refine_fused"]
