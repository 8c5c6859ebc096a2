"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` with
``nvcc`` at first use (``_build``), each beside its plain torch version.

refine   GLIN refine stage: candidate count, run compaction, the fused
         probe + compaction + exact-predicate query kernel, and the
         candidate mask
knn      the kNN rank's (distance, id) top-k
morton   Z-address encoding of grid coordinates
attention  the LM's prefill (flash) and decode attention
ssd      the Mamba-2 SSD chunked scan of the SSM prefill
ops      the kernel-level entry point (one function per kernel, with a
         ``use_kernel`` switch to the plain version)
"""
from .attention import decode_attention, flash_attention
from .knn import knn_topk
from .morton import morton_encode
from .refine import (MAX_COMPACT_BUDGET, refine_compact, refine_count,
                     refine_fused, refine_mask)
from .ssd import ssd_scan

__all__ = ["MAX_COMPACT_BUDGET", "refine_count", "refine_compact",
           "refine_fused", "refine_mask", "knn_topk", "morton_encode",
           "flash_attention", "decode_attention", "ssd_scan"]
