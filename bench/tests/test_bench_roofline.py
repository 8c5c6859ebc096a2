"""The fused refine's byte count against a hand count."""
import numpy as np

from bench.harness.roofline import peaks, refine_bytes
from bench.harness.stores import Store
from bench.reference import search


def _store():
    # record 0: a point at (0.5, 0.5); 1: a square of 4 vertices around
    # (0.52, 0.5); 2: a polyline of 3 vertices far away; 3: a point near
    # the second window only
    rings = [[(0.5, 0.5)],
             [(0.51, 0.49), (0.53, 0.49), (0.53, 0.51), (0.51, 0.51)],
             [(0.9, 0.9), (0.91, 0.9), (0.92, 0.91)],
             [(0.45, 0.45)]]
    nv = np.array([len(r) for r in rings], np.int32)
    pool = np.array([v for r in rings for v in r], np.float64)
    off = np.concatenate([[0], np.cumsum(nv[:-1])]).astype(np.int64)
    mbr = np.array([[min(x for x, _ in r), min(y for _, y in r),
                     max(x for x, _ in r), max(y for _, y in r)]
                    for r in rings])
    return Store(pool, off, nv, np.array([0, 0, 1, 0], np.int8), mbr)


def test_refine_bytes_hand_count():
    grid = search.Grid(_store(), per_cell=1)
    wins = np.array([[0.49, 0.49, 0.515, 0.51],   # meets records 0 and 1
                     [0.44, 0.44, 0.505, 0.505]])  # meets 0 and 3
    # distinct records 0, 1, 3: 20 B each; vertices 1 + 4 + 1 at 8 B;
    # 2 windows at 16 B; 3 hits at 4 B
    assert refine_bytes(grid, wins, "intersects", 3) == (
        3 * 20 + 6 * 8 + 2 * 16 + 3 * 4)
    # dwithin pads the probe: 0.4 reaches record 2 too (3 more vertices)
    assert refine_bytes(grid, wins, "dwithin:0.4", 0) == (
        4 * 20 + 9 * 8 + 2 * 16)


def test_peaks_table():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert peaks("no such card") is None
