"""Z-order (Morton) addressing for GLIN (paper §IV).

Two synchronized implementations:

* **Host path** (numpy): 60-bit Z-addresses packed into ``np.int64``. Used by
  the mutable host-side index (build / maintenance) and as the oracle.
* **Device path** (torch): a Z-address is an ``(hi, lo)`` pair of
  non-negative ``int32`` — 30 interleaved bits each. Lexicographic (hi, lo)
  comparison reproduces 64-bit ordering exactly, and the kernels work on the
  same int32 limbs.

Coordinate quantization follows the paper:
    x = floor((lon - lon0) / cell_size),  y = floor((lat - lat0) / cell_size)
with the default cell size 5e-7 (centimetre-level, §IV) and the WGS84 origin
(-180, -90). Synthetic datasets may use a unit-square domain with a matching
cell size; both are expressed through :class:`ZGrid`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# 30 bits per dimension -> 60-bit Z-address.
BITS_PER_DIM = 30
_LO_BITS = 15  # bits 0..14 of each dim interleave into z bits 0..29 ("lo")
_LO_MASK = (1 << _LO_BITS) - 1
LO_LIMB_BITS = 2 * _LO_BITS  # 30
LO_LIMB_SIZE = 1 << LO_LIMB_BITS  # 2**30

__all__ = [
    "ZGrid",
    "WGS84",
    "UNIT",
    "morton_encode_np",
    "morton_decode_np",
    "morton_encode_hilo",
    "split_hilo_np",
    "pack_hilo_np",
    "z_less_hilo",
    "z_leq_hilo",
    "hilo_to_float32",
    "mbr_to_zinterval_np",
    "mbr_to_zinterval_hilo",
]


# ---------------------------------------------------------------------------
# Quantization grid
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ZGrid:
    """Maps continuous coordinates onto the integer Morton grid."""

    x0: float
    y0: float
    cell_size: float

    def quantize_np(self, x: np.ndarray, y: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        # clip as floats BEFORE the int cast: far-out-of-domain coordinates
        # (padded dwithin probe windows) would overflow the cast and wrap to
        # a bogus cell instead of saturating at the domain boundary
        lim = (1 << BITS_PER_DIM) - 1
        qx = np.clip(np.floor((np.asarray(x, np.float64) - self.x0)
                              / self.cell_size), 0, lim).astype(np.int64)
        qy = np.clip(np.floor((np.asarray(y, np.float64) - self.y0)
                              / self.cell_size), 0, lim).astype(np.int64)
        return qx, qy

    # fp32 coordinates carry ~2^-24 relative error: tens of cells at
    # centimetre resolution. Device-side window quantization therefore takes
    # a ``guard`` margin (cells) — negative for lower corners, positive for
    # upper corners — so probe intervals are CONSERVATIVE: they may admit a
    # few extra candidates (pruned by exact refinement) but never lose one.
    FP32_GUARD_CELLS = 64

    def quantize_torch(self, x: torch.Tensor, y: torch.Tensor,
                       guard: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 tensors -> int32 grid coordinates (same two-stage scheme as
        the reference's device quantization).

        float32 has 24 bits of mantissa; a 30-bit grid index would lose
        precision, so quantize in two stages: coarse cell-of-2^15 then fine.
        The coarse cell is clipped into the domain BEFORE the fine stage
        (and the fine offset is clipped as a float, before any int cast):
        out-of-domain coordinates — which padded dwithin probe windows
        legitimately produce at the domain edge — then clamp to the boundary
        cell exactly like the host-side quantize_np.

        The arithmetic is written as the reference's compiled program
        evaluates it, so window keys agree bit for bit on any grid: division
        by a constant cell size is a multiply by its fp32 reciprocal, and
        ``x0 + cx * coarse`` rounds once (a fused multiply-add, evaluated
        exactly in fp64 and rounded to fp32). On the unit grid every one of
        these steps is exact and the distinction vanishes.
        """
        coarse = np.float32(self.cell_size * (1 << _LO_BITS))
        r_coarse = float(np.float32(1.0) / coarse)
        r_cell = float(np.float32(1.0) / np.float32(self.cell_size))
        x0, y0 = float(np.float32(self.x0)), float(np.float32(self.y0))
        lim = (1 << BITS_PER_DIM) - 1
        lim_hi = float((1 << _LO_BITS) - 1)
        cx = torch.clamp(torch.floor((x - x0) * r_coarse), 0.0, lim_hi)
        cy = torch.clamp(torch.floor((y - y0) * r_coarse), 0.0, lim_hi)
        bx = (cx.double() * float(coarse) + x0).float()
        by = (cy.double() * float(coarse) + y0).float()
        fx = torch.floor((x - bx) * r_cell)
        fy = torch.floor((y - by) * r_cell)
        qx_hi = cx.to(torch.int32)
        qy_hi = cy.to(torch.int32)
        qx_lo = torch.clamp(fx, 0.0, lim_hi).to(torch.int32)
        qy_lo = torch.clamp(fy, 0.0, lim_hi).to(torch.int32)
        qx = (qx_hi << _LO_BITS) | qx_lo
        qy = (qy_hi << _LO_BITS) | qy_lo
        if guard:
            qx = torch.clamp(qx + guard, 0, lim)
            qy = torch.clamp(qy + guard, 0, lim)
        return qx, qy


WGS84 = ZGrid(x0=-180.0, y0=-90.0, cell_size=5e-7)  # paper's default
UNIT = ZGrid(x0=0.0, y0=0.0, cell_size=1.0 / (1 << BITS_PER_DIM))  # unit square


# ---------------------------------------------------------------------------
# Host (numpy / int64) Morton codec
# ---------------------------------------------------------------------------
def _part1by1_np(v: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``v`` over even bit positions (uint64)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _compact1by1_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


def morton_encode_np(qx: np.ndarray, qy: np.ndarray) -> np.ndarray:
    """Interleave 30-bit integer coords into a 60-bit Z-address (int64).

    Bit i of x -> bit 2i;  bit i of y -> bit 2i+1 (x least significant,
    matching libmorton / the paper's Figure 2 layout).
    """
    z = _part1by1_np(np.asarray(qx)) | (_part1by1_np(np.asarray(qy)) << np.uint64(1))
    return z.astype(np.int64)


def morton_decode_np(z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    z = np.asarray(z).astype(np.uint64)
    qx = _compact1by1_np(z)
    qy = _compact1by1_np(z >> np.uint64(1))
    return qx.astype(np.int64), qy.astype(np.int64)


def split_hilo_np(z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 packed Z-address -> (hi, lo) int32 limbs (30 bits each)."""
    z = np.asarray(z).astype(np.int64)
    hi = (z >> LO_LIMB_BITS).astype(np.int32)
    lo = (z & (LO_LIMB_SIZE - 1)).astype(np.int32)
    return hi, lo


def pack_hilo_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi).astype(np.int64) << LO_LIMB_BITS)
            | np.asarray(lo).astype(np.int64))


# ---------------------------------------------------------------------------
# Device (torch / int32 hi-lo) Morton codec
# ---------------------------------------------------------------------------
def _part1by1_torch(v: torch.Tensor) -> torch.Tensor:
    """Spread a 15-bit int32 value over even positions of a 30-bit int32
    (every intermediate stays below 2^31, so int32 needs no unsigned
    type)."""
    v = v.to(torch.int32)
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_encode_hilo(qx: torch.Tensor, qy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """30-bit int32 coords -> (hi, lo) int32 Z-address limbs.

    The key identity: interleaving bits [0,15) of x/y yields z bits [0,30)
    and interleaving bits [15,30) yields z bits [30,60), so each limb is an
    independent 15x15-bit interleave — no 64-bit arithmetic anywhere.
    """
    qx = qx.to(torch.int32)
    qy = qy.to(torch.int32)
    x_lo, x_hi = qx & _LO_MASK, qx >> _LO_BITS
    y_lo, y_hi = qy & _LO_MASK, qy >> _LO_BITS
    lo = _part1by1_torch(x_lo) | (_part1by1_torch(y_lo) << 1)
    hi = _part1by1_torch(x_hi) | (_part1by1_torch(y_hi) << 1)
    return hi, lo


def z_less_hilo(a_hi, a_lo, b_hi, b_lo):
    """a < b on (hi, lo) Z-addresses (all limbs non-negative int32)."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def z_leq_hilo(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def hilo_to_float32(hi, lo, hi0=0, lo0=0):
    """Re-centred fp32 view of a Z-address: (hi-hi0)*2^30 + (lo-lo0).

    Re-centring at a node-local origin keeps the learned-CDF key
    well-conditioned in fp32. The product by 2^30 is exact, so the sum
    rounds once.
    """
    dh = (hi - hi0).to(torch.float32)
    dl = (lo - lo0).to(torch.float32)
    return dh * float(LO_LIMB_SIZE) + dl


# ---------------------------------------------------------------------------
# Geometry -> Z-address interval (paper §IV: MBR corners, NOT vertices)
# ---------------------------------------------------------------------------
def mbr_to_zinterval_np(mbrs: np.ndarray, grid: ZGrid) -> Tuple[np.ndarray, np.ndarray]:
    """(N,4) [xmin,ymin,xmax,ymax] -> (zmin, zmax) int64 arrays."""
    mbrs = np.asarray(mbrs, np.float64)
    qx0, qy0 = grid.quantize_np(mbrs[..., 0], mbrs[..., 1])
    qx1, qy1 = grid.quantize_np(mbrs[..., 2], mbrs[..., 3])
    return morton_encode_np(qx0, qy0), morton_encode_np(qx1, qy1)


def mbr_to_zinterval_hilo(mbrs: torch.Tensor, grid: ZGrid, guard: int = 0):
    """(N,4) float32 MBRs -> ((zmin_hi, zmin_lo), (zmax_hi, zmax_lo)).
    ``guard`` > 0 widens the interval by that many cells per corner (fp32
    conservatism for query windows)."""
    qx0, qy0 = grid.quantize_torch(mbrs[..., 0], mbrs[..., 1], guard=-guard)
    qx1, qy1 = grid.quantize_torch(mbrs[..., 2], mbrs[..., 3], guard=guard)
    return morton_encode_hilo(qx0, qy0), morton_encode_hilo(qx1, qy1)
