"""The kernel-level entry point: one function per GLIN kernel.

The port's counterpart of the reference's ``repro.kernels.ops``. Each
function takes ``use_kernel`` (the reference's ``use_pallas``): with it, a
CUDA tensor launches the hand-written kernel and a CPU tensor takes the
kernel's plain version, as the wrappers do; without it, the plain version
runs on any device. Every function accepts any Q, N and B, and the
attention and SSD functions any S and W.
"""
from __future__ import annotations

import torch

from . import attention, knn, morton, refine, ssd

__all__ = ["morton_encode", "refine_mask", "refine_count", "refine_compact",
           "refine_fused", "knn_topk", "flash_attention", "decode_attention",
           "ssd_scan"]


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


def fused_leaf_walk(leaf_i, leaf_mbrs) -> refine.LeafWalk:
    """The fused kernel's walk tables from its own operands: each leaf's
    slot run is ``leaf_i[:, 0]`` (``leaf_start``), a slot's leaf the last
    leaf starting at or before it, and a leaf's MBR the slot-aligned
    ``leaf_mbrs`` row of its first slot (empty leaves, which no walk
    enters, get a far-away row). On a snapshot's operands this is
    ``GLINSnapshot.leaf_walk`` wherever a walk reads it."""
    from ..core.device import leaf_group_mbrs

    starts = leaf_i[:, 0].contiguous()
    n, nl = leaf_mbrs.shape[0], starts.shape[0] - 1
    slot = torch.arange(n, dtype=torch.int32, device=leaf_mbrs.device)
    rec_leaf = torch.searchsorted(starts, slot, right=True) - 1
    rec_leaf = rec_leaf.clamp(0, max(nl - 1, 0)).to(torch.int32)
    first = starts[:nl].clamp(max=max(n - 1, 0)).long()
    empty = (starts[1:] <= starts[:nl])[:, None]
    leaf_mbr = torch.where(empty, 2e30, leaf_mbrs[first]).contiguous()
    return refine.LeafWalk(rec_leaf, starts, leaf_mbr,
                           leaf_group_mbrs(leaf_mbr, starts))


def refine_fused(windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f, node_i,
                 node_f, codes, pw, pod_i, pool, leaf_mbrs, rec_mbrs, *,
                 budget: int, prefilter: str, code: int, dist: float = 0.0,
                 augment: bool, search_steps: int, depth: int,
                 leaves: refine.LeafWalk | None = None,
                 use_kernel: bool = True):
    """One-dispatch probe + compact + exact refine over the packed operands
    of ``core.device.GLINSnapshot.fused_operands`` (the layout
    ``kernels.refine.refine_fused`` documents) -> (hits (Q, budget) i32
    [-1 padded], counts (Q,) i32, ``-(survivors) - 1`` past the budget).

    The operands are the reference's ``ops.refine_fused``'s, column for
    column, except how the exact predicate is named: the reference takes a
    traced ``predicate`` callable and the pods' ``num_buckets``; here the
    relation's predicate ``code`` (``geometry.PRED_*``, its
    ``Relation.code``) and ``dist`` (the ``dwithin`` distance) name it, and
    the pod headers carry each record's bucket. The kernel walks each run
    group -> leaf -> slot over ``leaves`` (a snapshot's cached
    ``GLINSnapshot.leaf_walk``); without them, over tables derived here
    from ``leaf_i`` and ``leaf_mbrs`` (:func:`fused_leaf_walk`), as the
    reference's kernel derives its leaf tiles from the same operands."""
    if not use_kernel:
        return refine.refine_fused_plain(
            windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f, node_i,
            node_f, codes, pw, pod_i, pool, leaf_mbrs, rec_mbrs,
            budget=budget, prefilter=prefilter, code=code, dist=dist,
            augment=augment, search_steps=search_steps, depth=depth)
    return refine.refine_fused(
        windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f, node_i, node_f,
        codes, pw, pod_i, pool, leaf_mbrs, rec_mbrs, budget=budget,
        prefilter=prefilter, code=code, dist=dist, augment=augment,
        search_steps=search_steps, depth=depth,
        leaves=fused_leaf_walk(leaf_i, leaf_mbrs) if leaves is None
        else leaves)


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
