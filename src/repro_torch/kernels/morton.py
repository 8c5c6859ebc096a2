"""Morton (Z-address) encoding for Hopper: ``morton_encode`` over
``csrc/morton.cu`` (sm_90a), with its plain torch version beside it.

30-bit int32 grid coordinates -> ``(hi, lo)`` int32 limbs, each an
independent 15x15-bit interleave. A CUDA tensor takes the kernel, a CPU
tensor the plain version (``core.zorder.morton_encode_hilo``, which the
port's core uses); ``morton_encode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..core.zorder import morton_encode_hilo
from .refine import _I32, _check, _count, _launch, _route

__all__ = ["morton_encode", "morton_encode_plain"]


def morton_encode_plain(qx, qy):
    """(N,) int32 coordinates -> (hi, lo) int32 limbs in tensor code."""
    return morton_encode_hilo(qx, qy)


def morton_encode(qx, qy):
    """qx, qy (N,) int32 30-bit grid coordinates -> (hi (N,) i32, lo (N,)
    i32) Z-address limbs.

    Replaces ``morton_encode_pallas`` (repro/kernels/morton.py). Bound on
    this card: bytes — 8 read and 8 written per element. One thread per
    element, in place of the reference's (8, 128) tiles.
    """
    if not _route(qx, qy):
        return morton_encode_plain(qx, qy)
    n = qx.shape[0]
    _check("qx", qx, _I32, (n,))
    _check("qy", qy, _I32, (n,))
    hi = torch.empty(n, dtype=_I32, device=qx.device)
    lo = torch.empty(n, dtype=_I32, device=qx.device)
    if n:
        _launch("glin_morton_encode", qx.device, qx, qy, hi, lo, n)
        _count(morton_encode)
    return hi, lo


morton_encode.launches = 0
