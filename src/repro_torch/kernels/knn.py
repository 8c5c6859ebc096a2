"""The kNN rank's top-k for Hopper: ``knn_topk`` over ``csrc/knn.cu``
(sm_90a), with its plain torch version beside it.

Per row of ``(Q, B)`` squared distances and record ids, the k smallest pairs
in ascending ``(distance, id)`` order — the two-key sort of the pair
truncated to k columns, duplicates kept. A CUDA tensor takes the kernel, a
CPU tensor the plain version; ``knn_topk.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .refine import _F32, _I32, _check, _count, _launch, _route

__all__ = ["ID_PAD", "WARP_MAX_PER_LANE", "knn_plan", "knn_topk",
           "knn_topk_plain"]

ID_PAD = 2**31 - 1       # id padding: sorts after every real record id
WARP_MAX_PER_LANE = 32   # a warp's widest row: 32 lanes x 32 columns


def knn_plan(b: int) -> dict:
    """The launch for rows of ``b`` columns: a warp a row (``per_lane``
    columns in each lane's registers, a power of two) up to
    ``32 * WARP_MAX_PER_LANE`` columns, else a block a row."""
    per_lane = 1
    while 32 * per_lane < b:
        per_lane *= 2
    if per_lane <= WARP_MAX_PER_LANE:
        return {"route": "warp", "per_lane": per_lane}
    return {"route": "block", "per_lane": 0}


def knn_topk_plain(d, ids, k: int):
    """Two stable sorts (by id, then by distance) = the two-key sort of
    ``[d, ids]``; the first k columns, padded with ``(+inf, ID_PAD)`` where
    k exceeds the row width. ``torch.sort`` orders -0 with +0 and every NaN
    last, as the reference's sort does."""
    q, b = d.shape
    by_id = torch.sort(ids, dim=1, stable=True).indices
    d1 = torch.gather(d, 1, by_id)
    by_d = torch.sort(d1, dim=1, stable=True).indices[:, :k]
    dk = torch.gather(d1, 1, by_d)
    ik = torch.gather(torch.gather(ids, 1, by_id), 1, by_d)
    if k > b:
        dk = torch.cat([dk, torch.full((q, k - b), float("inf"), dtype=_F32,
                                       device=d.device)], dim=1)
        ik = torch.cat([ik, torch.full((q, k - b), ID_PAD, dtype=_I32,
                                       device=d.device)], dim=1)
    return dk, ik


def knn_topk(d, ids, k: int):
    """d (Q, B) f32 squared distances (+inf on dead lanes), ids (Q, B) i32
    (``ID_PAD`` padding) -> ((Q, k) f32, (Q, k) i32) in ascending
    ``(distance, id)`` order.

    Replaces ``knn_topk_pallas`` (repro/kernels/refine.py), and returns what
    its reference, the two-key sort, returns (the Pallas body drops
    duplicate pairs). Bound on this card: bytes — the (Q, B) pairs read
    once, the (Q, k) pairs written. Rows up to ``32 * WARP_MAX_PER_LANE``
    columns take a warp each, whose lanes hold their columns sorted in
    registers and pop the least head k times; a wider row takes a block, k
    rounds of a block-wide argmin over (distance, id, column)
    (:func:`knn_plan`).
    """
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if not _route(d, ids):
        return knn_topk_plain(d, ids, k)
    q, b = d.shape
    _check("d", d, _F32, (q, None))
    _check("ids", ids, _I32, (q, b))
    out_d = torch.empty((q, k), dtype=_F32, device=d.device)
    out_i = torch.empty((q, k), dtype=_I32, device=d.device)
    if q:
        _launch("glin_knn_topk", d.device, d, ids, out_d, out_i, q, b, k,
                knn_plan(b)["per_lane"])
        _count(knn_topk)
    return out_d, out_i


knn_topk.launches = 0
