"""Shared transformer layers in PyTorch: the parameter leaf, RMSNorm, rotary
embedding and the dense projection, with the reference's rounding points.

Weights keep the reference's ``(in, out)`` layout, so :func:`dense` is
``x @ w`` and carried weights need no transpose.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["Leaf", "he_init", "rms_norm", "rope_tables", "apply_rot", "dense"]


class Leaf(NamedTuple):
    """One parameter of the tree: He-normal over ``fan_in`` inputs, or the
    constant ``fill`` where ``fan_in`` is None; in ``dtype``, or the model's
    dtype where that is None."""
    shape: Tuple[int, ...]
    fan_in: Optional[int] = None
    fill: float = 1.0
    dtype: Optional[torch.dtype] = None


def he_init(shape, in_axis_size: int, dtype, generator) -> torch.Tensor:
    """He-normal weights drawn on the generator's device (fp32, then cast)."""
    scale = (2.0 / max(1, in_axis_size)) ** 0.5
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """fp32 mean of squares, eps 1e-6, times the fp32 scale, cast back."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim/2), fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(theta, exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Half-split rotation (not interleaved): x (B, S, H, D); cos/sin
    broadcastable to (B, S, 1, D/2); fp32 math, cast back to x's dtype."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """The reference's ``rope`` in two halves: the angles of positions (B,S)
    or (S,) as (cos, sin), each (B, S, 1, head_dim/2) fp32 — computed once
    per forward or decode step and shared by q, k and every layer — and
    :func:`apply_rot`."""
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _rope_angles(positions, head_dim, theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., in) @ (in, out) in the activation dtype (fp32 accumulation)."""
    return x @ w
