"""GLIN query augmentation — the piecewise function of paper §VIII.

Each piece summarizes ``piece_limitation`` geometries sorted by Zmax with four
aggregates (Fig 4): ``Zmax_end`` (inclusive upper bound of the piece's Zmax
subdomain), ``Min_Zmin``, ``Sum_Zmin`` and ``Count``.

Augmentation (Alg 2): given ``Zmin_Q``, find the first piece whose
``Zmax_end >= Zmin_Q`` and lower ``Zmin_Q`` to the minimum ``Min_Zmin`` of that
piece and all pieces after it, so that every geometry with
``Zmax_GM >= Zmin_Q`` is covered (Lemma 2 OR-conditions 2 and 3).

Two implementations are provided:

* ``augment_scan``  — the paper's Algorithm 2 verbatim (binary search + linear
  scan over the remaining pieces), kept as the faithful baseline;
* ``augment``       — beyond-paper: a **suffix-min** array turns the scan into
  one O(log P) binary search + one gather. Identical output, asymptotically
  faster; benchmarked against each other in ``bench_pl_tuning``.

Maintenance follows §VIII-C: in-bound insertion updates aggregates in place,
out-of-bound insertion extends the first/last piece or appends a new one,
deletion decrements ``Sum``/``Count`` but never ``Min`` (min is a
non-invertible aggregate), and ``avg_diff`` signals when to rebuild.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["PiecewiseFunction"]


class PiecewiseFunction:
    def __init__(self, piece_limitation: int = 10000):
        self.piece_limitation = int(piece_limitation)
        self.zmax_end = np.empty(0, np.int64)
        self.min_zmin = np.empty(0, np.int64)
        self.sum_zmin = np.empty(0, np.float64)  # 60-bit keys overflow int64 sums
        self.count = np.empty(0, np.int64)
        self.domain_lo = 0  # smallest Zmax in the dataset (Fig 4's "[2, ...]")
        self._suffix_min: Optional[np.ndarray] = None  # lazy cache

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, zmin: np.ndarray, zmax: np.ndarray,
              piece_limitation: int = 10000) -> "PiecewiseFunction":
        """Sort by Zmax, group every ``piece_limitation`` records (§VIII-B).
        The Zmax-sorted order is used transiently and then dropped, exactly as
        the paper describes."""
        pw = cls(piece_limitation)
        n = zmin.shape[0]
        if n == 0:
            return pw
        order = np.argsort(zmax, kind="stable")
        zmin_s = zmin[order]
        zmax_s = zmax[order]
        k = pw.piece_limitation
        n_pieces = (n + k - 1) // k
        pad = n_pieces * k - n
        if pad:
            # pad with +inf-like sentinels that do not affect min/sum
            zmin_s = np.concatenate([zmin_s, np.full(pad, np.iinfo(np.int64).max)])
            zmax_s = np.concatenate([zmax_s, np.full(pad, zmax_s[-1])])
        zmin_g = zmin_s.reshape(n_pieces, k)
        zmax_g = zmax_s.reshape(n_pieces, k)
        pw.zmax_end = zmax_g.max(axis=1).astype(np.int64)
        pw.min_zmin = zmin_g.min(axis=1).astype(np.int64)
        real = np.where(zmin_g == np.iinfo(np.int64).max, 0, zmin_g)
        pw.sum_zmin = real.astype(np.float64).sum(axis=1)
        pw.count = np.minimum(
            k, np.maximum(0, n - np.arange(n_pieces) * k)).astype(np.int64)
        pw.domain_lo = int(zmax_s[0])
        pw._suffix_min = None
        return pw

    @property
    def num_pieces(self) -> int:
        return int(self.zmax_end.shape[0])

    def nbytes(self) -> int:
        return (self.zmax_end.nbytes + self.min_zmin.nbytes
                + self.sum_zmin.nbytes + self.count.nbytes)

    # -------------------------------------------------------------- suffix min
    def _suffix(self) -> np.ndarray:
        if self._suffix_min is None or self._suffix_min.shape[0] != self.num_pieces:
            if self.num_pieces == 0:
                self._suffix_min = np.empty(0, np.int64)
            else:
                self._suffix_min = np.minimum.accumulate(
                    self.min_zmin[::-1])[::-1].copy()
        return self._suffix_min

    def suffix_min(self) -> np.ndarray:
        """Suffix-min of ``Min_Zmin`` (read-only view used by the augmentation
        fast path and by the device snapshot flattening)."""
        return self._suffix()

    # ------------------------------------------------------------ augmentation
    def augment_scan(self, zmin_q: int) -> int:
        """Paper Algorithm 2: binary search, then scan pieces to the end."""
        if self.num_pieces == 0:
            return zmin_q
        i = int(np.searchsorted(self.zmax_end, zmin_q, side="left"))
        m = zmin_q
        while i < self.num_pieces:  # the paper's while-loop
            m = min(m, int(self.min_zmin[i]))
            i += 1
        return m

    def augment(self, zmin_q: int) -> int:
        """Suffix-min fast path (identical result to ``augment_scan``)."""
        if self.num_pieces == 0:
            return zmin_q
        i = int(np.searchsorted(self.zmax_end, zmin_q, side="left"))
        if i >= self.num_pieces:
            return zmin_q
        return min(zmin_q, int(self._suffix()[i]))

    def augment_batch(self, zmin_q: np.ndarray) -> np.ndarray:
        """Vectorized suffix-min augmentation for query batches."""
        if self.num_pieces == 0:
            return np.asarray(zmin_q, np.int64)
        zmin_q = np.asarray(zmin_q, np.int64)
        idx = np.searchsorted(self.zmax_end, zmin_q, side="left")
        suf = np.concatenate([self._suffix(), [np.iinfo(np.int64).max]])
        return np.minimum(zmin_q, suf[idx])

    # ------------------------------------------------------------- maintenance
    def insert(self, zmin: int, zmax: int) -> None:
        """§VIII-C in-bound / out-of-bound insertion."""
        n = self.num_pieces
        if n == 0:
            self._append_piece(zmax, zmin)
            self.domain_lo = zmax
            return
        if zmax < self.domain_lo:
            # Out-of-bound, lower side: extend or prepend the first piece.
            if int(self.count[0]) < self.piece_limitation:
                self._absorb(0, zmin)
            else:
                self._prepend_piece(zmax, zmin)
            self.domain_lo = zmax
        elif zmax > int(self.zmax_end[-1]):
            # Out-of-bound, upper side: extend or append the last piece.
            if int(self.count[-1]) < self.piece_limitation:
                self._absorb(n - 1, zmin)
                self.zmax_end[-1] = zmax
            else:
                self._append_piece(zmax, zmin)
        else:
            # In-bound: first piece whose Zmax_end >= zmax absorbs the record.
            i = int(np.searchsorted(self.zmax_end, zmax, side="left"))
            self._absorb(min(i, n - 1), zmin)
        self._suffix_min = None

    def _absorb(self, i: int, zmin: int) -> None:
        self.min_zmin[i] = min(int(self.min_zmin[i]), zmin)
        self.sum_zmin[i] += float(zmin)
        self.count[i] += 1
        self._suffix_min = None

    def _append_piece(self, zmax_end: int, zmin: int) -> None:
        self.zmax_end = np.append(self.zmax_end, np.int64(zmax_end))
        self.min_zmin = np.append(self.min_zmin, np.int64(zmin))
        self.sum_zmin = np.append(self.sum_zmin, float(zmin))
        self.count = np.append(self.count, np.int64(1))
        self._suffix_min = None

    def _prepend_piece(self, zmax_end: int, zmin: int) -> None:
        self.zmax_end = np.concatenate([[np.int64(zmax_end)], self.zmax_end])
        self.min_zmin = np.concatenate([[np.int64(zmin)], self.min_zmin])
        self.sum_zmin = np.concatenate([[float(zmin)], self.sum_zmin])
        self.count = np.concatenate([[np.int64(1)], self.count])
        self._suffix_min = None

    def delete(self, zmin: int, zmax: int) -> None:
        n = self.num_pieces
        if n == 0:
            return
        i = int(np.searchsorted(self.zmax_end, zmax, side="left"))
        i = min(i, n - 1)
        self.sum_zmin[i] -= float(zmin)
        self.count[i] -= 1
        # Min_Zmin is NOT updated: min is a non-invertible aggregate (§VIII-C).
        if self.count[i] <= 0:
            keep = np.ones(n, bool)
            keep[i] = False
            self.zmax_end = self.zmax_end[keep]
            self.min_zmin = self.min_zmin[keep]
            self.sum_zmin = self.sum_zmin[keep]
            self.count = self.count[keep]
        self._suffix_min = None

    # --------------------------------------------------------------- avg_diff
    def avg_diff(self) -> float:
        """Rebuild heuristic (§VIII-C): mean relative gap between Min_Zmin and
        Avg_Zmin across pieces. Larger values mean staler pieces."""
        if self.num_pieces == 0:
            return 0.0
        cnt = np.maximum(self.count, 1).astype(np.float64)
        avg = self.sum_zmin / cnt
        avg = np.where(avg == 0.0, 1.0, avg)
        return float(np.mean(np.abs(self.min_zmin.astype(np.float64) - avg) / avg))
