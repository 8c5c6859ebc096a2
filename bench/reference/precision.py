"""bfloat16, the control's precision: the reference computed over a store
and queries rounded to it (round to nearest even), as a program that kept
its coordinates in bfloat16 would see them."""
from __future__ import annotations

import numpy as np


def to_bf16(x: np.ndarray) -> np.ndarray:
    """Float64 values rounded to bfloat16, returned as float64."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def store_bf16(store):
    """A copy of ``store`` with every vertex in bfloat16 and the MBRs
    recomputed from the rounded rings."""
    import dataclasses

    pool = to_bf16(store.pool)
    mbr = np.concatenate([np.minimum.reduceat(pool, store.off, axis=0),
                          np.maximum.reduceat(pool, store.off, axis=0)], 1)
    return dataclasses.replace(store, pool=pool, mbr=mbr)
