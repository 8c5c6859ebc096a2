"""Int8 gradient compression for the data-parallel all-reduce, with error
feedback: the port's counterpart of the reference's ``train/compress.py``.

Each position quantizes its local gradient to int8 against one scale
shared over the axis (a ``pmax``), the int8 payload is summed in int32 (no
overflow: 127 · positions < 2^31 for any realistic mesh), and the mean is
dequantized. An error-feedback accumulator carries the quantization
residual into the next step (Karimireddy et al.).

The collectives run over a named mesh axis of a placed value
(``sharding.placement.Sharded``: the reference's ``shard_map`` with
``P(axis)``). The arithmetic is the reference's in its order (``g32 /
scale``, round half to even, clip, cast), so the card and the CPU agree
bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..sharding.placement import Sharded, pmax, psum, smap

__all__ = ["quantize", "dequantize", "compressed_psum_mean",
           "apply_error_feedback"]


def _q8(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def _residual(c: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """``c - q * s`` rounded once, as the reference's compiled program
    computes it (XLA contracts it into a fused multiply-add): in fp64 both
    the product (8 bits by 24) and the difference (of two numbers within
    ``s / 2``) are exact, so the one cast to fp32 is the only rounding."""
    return (c.double() - q.double() * s.double()).float()


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q int8, fp32 scale)."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)) / 127.0, min=1e-30)
    return _q8(g32, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _shared_scale(g32: Sharded, axis: str) -> Sharded:
    """One scale for every position of the axis (``pmax``: a scalar
    collective), so the int8 sum dequantizes exactly: |error| <=
    shared_scale / 2 per element."""
    local = smap(lambda g: torch.max(torch.abs(g)) / 127.0, g32)
    return smap(lambda s: torch.clamp(s, min=1e-30), pmax(local, axis))


def _mean(q: Sharded, scale: Sharded, axis: str, dtype) -> Sharded:
    n = q.mesh.shape[axis]
    acc = psum(smap(lambda t: t.to(torch.int32), q), axis)  # int32 wire sum
    return smap(lambda a, s: (a.float() * s / n).to(dtype), acc, scale,
                out=q.spec)


def compressed_psum_mean(g: Sharded, axis: str) -> Sharded:
    """Mean all-reduce of ``g`` over ``axis`` with an int8 payload."""
    g32 = smap(lambda t: t.float(), g, out=g.spec)
    scale = _shared_scale(g32, axis)
    q = smap(_q8, g32, scale, out=g.spec)
    return _mean(q, scale, axis, g.dtype)


def apply_error_feedback(g: Sharded, err: Sharded, axis: str
                         ) -> Tuple[Sharded, Sharded]:
    """Error feedback: compress (g + carried error); return the averaged
    gradient and the new local residual."""
    corrected = smap(lambda t, e: t.float() + e, g, err, out=g.spec)
    scale = _shared_scale(corrected, axis)
    q = smap(_q8, corrected, scale, out=g.spec)
    new_err = smap(_residual, corrected, q, scale, out=err.spec)
    return _mean(q, scale, axis, g.dtype), new_err
