"""Shared transformer layers in PyTorch: the parameter leaf, RMSNorm, rotary
embedding (RoPE and Qwen2-VL's multimodal M-RoPE) and the dense projection,
with the reference's rounding points.

Weights keep the reference's ``(in, out)`` layout, so :func:`dense` is
``x @ w`` and carried weights need no transpose.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["Leaf", "he_init", "rms_norm", "rope_tables", "mrope_tables",
           "apply_rot", "dense"]


class Leaf(NamedTuple):
    """One parameter of the tree: He-normal over ``fan_in`` inputs, or the
    constant ``fill`` where ``fan_in`` is None; in ``dtype``, or the model's
    dtype where that is None."""
    shape: Tuple[int, ...]
    fan_in: Optional[int] = None
    fill: float = 1.0
    dtype: Optional[torch.dtype] = None


def he_init(shape, in_axis_size: int, dtype, generator) -> torch.Tensor:
    """He-normal weights drawn on the generator's device (fp32, scaled, then
    cast). A stacked leaf (three axes or more, the layer first) is drawn a
    layer at a time, so the fp32 draw holds one layer, never the whole leaf
    (a full-width MoE layer's experts are GBs in fp32)."""
    scale = (2.0 / max(1, in_axis_size)) ** 0.5

    def draw(sh):
        w = torch.randn(sh, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    if len(shape) < 3:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


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


def mrope_tables(positions: torch.Tensor, head_dim: int,
                 sections: Tuple[int, int, int], theta: float):
    """The reference's ``mrope`` angles, as :func:`rope_tables` gives
    ``rope``'s: positions (B, 3, S) are the (t, h, w) streams, and stream i
    turns its own section of the half dim (the sections sum to head_dim/2)
    at RoPE's frequencies there -> (cos, sin), each (B, S, 1, head_dim/2)
    fp32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    j = torch.arange(half, device=positions.device)
    stream = ((j >= sections[0]).long()
              + (j >= sections[0] + sections[1]).long())
    freq = torch.pow(theta, -j.float() / half)
    ang = positions.float()[:, stream, :].transpose(1, 2) * freq
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., in) @ (in, out) in the activation dtype (fp32 accumulation)."""
    return x @ w
