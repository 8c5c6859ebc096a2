"""Candidates and answers of the plain reference.

:class:`Grid` files each record under the grid cell of its MBR centre and
knows the largest half-width and half-height of any record, so a box's
candidates are the records filed in the cells within that reach of it,
kept where their MBR meets the box: no record whose MBR meets the box is
missed. Window answers are the candidates that the exact predicate keeps,
in ascending id. A kNN answer grows a radius from a density guess,
doubling it until at least k records lie within it (every record within
the radius is a candidate of the radius's box), and takes the k nearest in
ascending (distance, id).
"""
from __future__ import annotations

import math

import numpy as np

from . import geometry as geo


class Grid:
    def __init__(self, store, per_cell: int = 64):
        n = len(store)
        self.store = store
        m = store.mbr
        self.cx = (m[:, 0] + m[:, 2]) * 0.5
        self.cy = (m[:, 1] + m[:, 3]) * 0.5
        self.hx = float(np.max(m[:, 2] - m[:, 0])) * 0.5 if n else 0.0
        self.hy = float(np.max(m[:, 3] - m[:, 1])) * 0.5 if n else 0.0
        self.g = g = max(1, int(math.sqrt(n / per_cell)))
        self.x0, self.y0 = float(self.cx.min()), float(self.cy.min())
        span = max(float(self.cx.max()) - self.x0,
                   float(self.cy.max()) - self.y0, 1e-12)
        self.cell = span / g * (1 + 1e-9)
        ix, iy = self._cell(self.cx, self.cy)
        key = iy * g + ix
        self.order = np.argsort(key, kind="stable")
        self.start = np.searchsorted(key[self.order], np.arange(g * g + 1))

    def _cell(self, x, y):
        ix = np.clip(np.floor((x - self.x0) / self.cell), 0, self.g - 1)
        iy = np.clip(np.floor((y - self.y0) / self.cell), 0, self.g - 1)
        return ix.astype(np.int64), iy.astype(np.int64)

    def candidates(self, box) -> np.ndarray:
        """Ids of the records whose MBR meets the closed ``box``, ascending."""
        (ix0, ix1), (iy0, iy1) = (
            self._cell(np.array([box[0] - self.hx, box[2] + self.hx]),
                       np.array([box[1] - self.hy, box[3] + self.hy])))
        g, st = self.g, self.start
        rec = np.concatenate([self.order[st[r * g + ix0]:st[r * g + ix1 + 1]]
                              for r in range(iy0, iy1 + 1)])
        m = self.store.mbr[rec]
        keep = ((m[:, 0] <= box[2]) & (box[0] <= m[:, 2])
                & (m[:, 1] <= box[3]) & (box[1] <= m[:, 3]))
        return np.sort(rec[keep])


def _pad(box, d):
    return np.array([box[0] - d, box[1] - d, box[2] + d, box[3] + d])


def window_answers(grid: Grid, windows: np.ndarray, relations) -> list:
    """Sorted hit ids of each (window, relation) row."""
    wi, recs = [], []
    for i, (w, rel) in enumerate(zip(windows, relations)):
        c = grid.candidates(_pad(w, geo.parse(rel)[2]))
        wi.append(np.full(c.shape[0], i, np.int64))
        recs.append(c)
    wi = np.concatenate(wi) if wi else np.zeros(0, np.int64)
    recs = np.concatenate(recs) if recs else np.zeros(0, np.int64)
    keep = np.zeros(recs.shape[0], bool)
    rel_of = np.asarray(relations, dtype=object)[wi] if wi.size else wi
    for rel in sorted(set(relations)):
        s = np.nonzero(rel_of == rel)[0]
        keep[s] = geo.over_pairs(lambda r, v, n, k: geo.decide(rel, r, v, n, k),
                                 grid.store, windows[wi[s]], recs[s])
    wi, recs = wi[keep], recs[keep]
    cut = np.searchsorted(wi, np.arange(len(windows) + 1))
    return [recs[cut[i]:cut[i + 1]] for i in range(len(windows))]


def point_distances(store, points: np.ndarray, rec: np.ndarray) -> np.ndarray:
    """Distance from each point to each paired record."""
    rect = np.concatenate([points, points], axis=1)
    return np.sqrt(geo.over_pairs(geo.sqdist, store, rect, rec))


def knn_answers(grid: Grid, points: np.ndarray, k: int):
    """(ids (Q, k) int64, distances (Q, k) float64), ascending (distance,
    id); rows short of k records are padded with -1 and +inf."""
    store = grid.store
    n = len(store)
    q = points.shape[0]
    ids = np.full((q, k), -1, np.int64)
    dist = np.full((q, k), np.inf)
    area = max((grid.cx.max() - grid.x0) * (grid.cy.max() - grid.y0), 1e-12)
    radius = np.full(q, math.sqrt(k / (math.pi * max(n, 1) / area)))
    todo = np.arange(q)
    while todo.size:
        pi, recs = [], []
        for i in todo:
            p = points[i]
            c = grid.candidates(_pad(np.concatenate([p, p]), radius[i]))
            pi.append(np.full(c.shape[0], i, np.int64))
            recs.append(c)
        pi, recs = np.concatenate(pi), np.concatenate(recs)
        d = point_distances(store, points[pi], recs)
        within = d <= radius[pi]
        pi, recs, d = pi[within], recs[within], d[within]
        order = np.lexsort((recs, d, pi))
        pi, recs, d = pi[order], recs[order], d[order]
        cut = np.searchsorted(pi, np.concatenate([todo, [q]]))
        again = []
        for j, i in enumerate(todo):
            a, b = cut[j], np.searchsorted(pi, i, side="right")
            if b - a >= k or b - a >= n:
                m = min(k, b - a)
                ids[i, :m], dist[i, :m] = recs[a:a + m], d[a:a + m]
            else:
                again.append(i)
        todo = np.asarray(again, np.int64)
        radius[todo] *= 2.0
    return ids, dist
