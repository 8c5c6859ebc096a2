"""The kernel-level entry point: one function per GLIN kernel.

The port's counterpart of the reference's ``repro.kernels.ops``. Each
function takes ``use_kernel`` (the reference's ``use_pallas``): with it, a
CUDA tensor launches the hand-written kernel and a CPU tensor takes the
kernel's plain version, as the wrappers do; without it, the plain version
runs on any device. Every function accepts any Q, N and B, and the
attention and SSD functions any S and W.
"""
from __future__ import annotations

from . import attention, knn, morton, refine, ssd

__all__ = ["morton_encode", "refine_mask", "refine_count", "refine_compact",
           "knn_topk", "flash_attention", "decode_attention", "ssd_scan"]


def morton_encode(qx, qy, use_kernel: bool = True):
    """(N,) int32 30-bit coordinates -> (hi, lo) int32 limbs."""
    if not use_kernel:
        return morton.morton_encode_plain(qx, qy)
    return morton.morton_encode(qx, qy)


def refine_mask(windows, bounds, mbrs, use_kernel: bool = True):
    """(Q,4) f32, (Q,2) i32, (N,4) f32 -> (Q,N) int8 candidate mask."""
    if not use_kernel:
        return refine.refine_mask_plain(windows, bounds, mbrs)
    return refine.refine_mask(windows, bounds, mbrs)


def refine_count(windows, bounds, mbrs, use_kernel: bool = True):
    """(Q,4) f32, (Q,2) i32, (N,4) f32 -> (Q,) int32 candidate counts. The
    reference's signature has no leaf tables, so the kernel walks in
    slot-as-leaf mode (each slot its own leaf, group rows built per
    call)."""
    if not use_kernel:
        return refine.refine_count_plain(windows, bounds, mbrs)
    return refine.refine_count(windows, bounds, mbrs)


def refine_compact(windows, bounds, leaf_mbrs, rec_mbrs, *, budget: int,
                   prefilter: str = "intersects", use_kernel: bool = True):
    """Mask + compaction: (Q,4) probe windows, (Q,2) i32 slot runs,
    slot-aligned (N,4) leaf/record MBR tables -> (slots (Q, budget) i32
    [-1 padded], counts (Q,) i32 total survivors; ``counts > budget``
    signals truncation). The reference's signature has only slot-aligned
    tables, so the kernel walks in slot-as-leaf mode (each slot its own
    leaf, group rows built per call)."""
    if not use_kernel:
        return refine.refine_compact_plain(windows, bounds, leaf_mbrs,
                                           rec_mbrs, budget, prefilter)
    return refine.refine_compact(windows, bounds, leaf_mbrs, rec_mbrs,
                                 budget=budget, prefilter=prefilter)


def knn_topk(d, ids, *, k: int, use_kernel: bool = True):
    """Top-k by ascending (distance, id): d (Q, B) f32 [+inf = dead lane],
    ids (Q, B) i32 -> ((Q, k) f32, (Q, k) i32); columns past B are
    ``(+inf, INT32_MAX)``."""
    if not use_kernel:
        return knn.knn_topk_plain(d, ids, k)
    return knn.knn_topk(d, ids, k)


def flash_attention(q, k, v, *, window: int = 0, use_kernel: bool = True):
    """Causal (optionally sliding-window) GQA attention.
    q (B,Hq,S,D); k,v (B,Hkv,S,D) -> (B,Hq,S,D) in q's dtype."""
    if not use_kernel:
        return attention.flash_attention_plain(q, k, v, window)
    return attention.flash_attention(q, k, v, window)


def decode_attention(q, k, v, abs_pos, pos, *, window: int = 0,
                     use_kernel: bool = True):
    """One-token decode attention over a ring KV cache.
    q (B,Hq,D); k/v (B,Hkv,W,D); abs_pos (B,W) int32; pos (B,) int32."""
    if not use_kernel:
        return attention.decode_attention_plain(q, k, v, abs_pos, pos, window)
    return attention.decode_attention(q, k, v, abs_pos, pos, window)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, use_kernel: bool = True):
    """Mamba-2 SSD scan. x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N) ->
    y (B,S,H,P). The reference's chunk rule: ``min(chunk, S)``, or S where
    that does not divide S."""
    s = x.shape[1]
    ch = min(chunk, s) if s and s % min(chunk, s) == 0 else s
    if not use_kernel:
        return ssd.ssd_scan_plain(x, dt, a, b, c, max(ch, 1))
    return ssd.ssd_scan(x, dt, a, b, c, max(ch, 1))
