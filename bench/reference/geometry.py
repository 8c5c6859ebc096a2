"""Exact predicates in float64, one (window, record) pair per row.

The semantics of the port's relations (``core/geometry.py``), written again
with a window per row: ``rect`` (P, 4), ``verts`` (P, V, 2) rings padded
with their last vertex, ``nv`` (P,) vertices, ``kind`` (P,) 0 polygon (a
closed simple ring; one vertex is a point) or 1 polyline (an open chain).

* ``intersects``: the closed window and the geometry share a point;
* ``contains``: every point of the geometry lies in the closed window and
  one lies in its open interior (GEOS's proper Contains);
* ``dwithin:<d>``: the Euclidean distance between them is at most d.
"""
from __future__ import annotations

import numpy as np

POLYGON = 0
_CHUNK = 1 << 20       # pair-vertex lanes per chunk


def parse(relation: str):
    """``relation`` -> (name, distance, probe pad)."""
    name, _, arg = relation.partition(":")
    if name == "dwithin":
        d = float(arg)
        if not (np.isfinite(d) and d >= 0):
            raise ValueError(f"bad distance in {relation!r}")
        return name, d, d
    if name in ("intersects", "contains") and not arg:
        return name, 0.0, 0.0
    raise ValueError(f"the reference does not know {relation!r}")


def _lanes(verts, nv, kind):
    """x, y, the kind-aware next vertex (a ring wraps; a chain's last
    segment is zero-length) and the valid-lane mask, each (P, V)."""
    v = verts.shape[1]
    idx = np.arange(v)[None, :]
    nvc = nv[:, None]
    nxt = np.where((kind == POLYGON)[:, None],
                   np.where(idx + 1 >= nvc, 0, idx + 1),
                   np.minimum(idx + 1, v - 1))
    x, y = verts[..., 0], verts[..., 1]
    return (x, y, np.take_along_axis(x, nxt, 1), np.take_along_axis(y, nxt, 1),
            idx < nvc)


def _ring(verts, nv):
    """Closed-ring edges whatever the kind (the ray cast's)."""
    v = verts.shape[1]
    idx = np.arange(v)[None, :]
    nxt = np.where(idx + 1 >= nv[:, None], 0, idx + 1)
    x, y = verts[..., 0], verts[..., 1]
    return (x, y, np.take_along_axis(x, nxt, 1), np.take_along_axis(y, nxt, 1),
            idx < nv[:, None])


def _clip(r, x, y, x2, y2):
    """Liang-Barsky: does segment (x, y)-(x2, y2) meet the closed window?
    ``r`` is (P, 1, 4) against (P, V) segments."""
    dx, dy = x2 - x, y2 - y
    t0 = np.zeros_like(dx)
    t1 = np.ones_like(dx)
    reject = np.zeros(dx.shape, bool)
    for p, q in ((-dx, x - r[..., 0]), (dx, r[..., 2] - x),
                 (-dy, y - r[..., 1]), (dy, r[..., 3] - y)):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = q / np.where(p == 0, 1e-30, p)
        t0 = np.where(p < 0, np.maximum(t0, t), t0)
        t1 = np.where(p > 0, np.minimum(t1, t), t1)
        reject |= (p == 0) & (q < 0)
    return (t0 <= t1) & ~reject


def _in_closed(r, x, y):
    return ((x >= r[..., 0]) & (x <= r[..., 2]) & (y >= r[..., 1])
            & (y <= r[..., 3]))


def _in_open(r, x, y):
    return (x > r[..., 0]) & (x < r[..., 2]) & (y > r[..., 1]) & (y < r[..., 3])


def _points_in_rings(px, py, verts, nv):
    """Closed point-in-ring (even-odd ray cast plus an on-edge test):
    px, py (P, C) -> (P, C)."""
    x1, y1, x2, y2, ok = (a[:, :, None] for a in _ring(verts, nv))
    pxb, pyb = px[:, None, :], py[:, None, :]
    straddle = (y1 > pyb) != (y2 > pyb)
    den = y2 - y1
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (pyb - y1) / np.where(den == 0, 1.0, den) * (x2 - x1)
    odd = (np.sum(straddle & (pxb < xint) & ok, axis=1) % 2) == 1
    cross = (x2 - x1) * (pyb - y1) - (y2 - y1) * (pxb - x1)
    box = ((pxb >= np.minimum(x1, x2)) & (pxb <= np.maximum(x1, x2))
           & (pyb >= np.minimum(y1, y2)) & (pyb <= np.maximum(y1, y2)))
    return odd | np.any((cross == 0) & box & ok, axis=1)


def _corners(rect):
    return (rect[:, [0, 2, 2, 0]], rect[:, [1, 1, 3, 3]])


def intersects(rect, verts, nv, kind):
    r = rect[:, None, :]
    x, y, x2, y2, ok = _lanes(verts, nv, kind)
    hit = np.any(_clip(r, x, y, x2, y2) & ok, axis=1)
    # no edge meets the window: it meets a polygon only lying inside it,
    # which needs a window corner inside the polygon's MBR (padding lanes
    # repeat a vertex, so the lanes' extremes are the MBR)
    cx, cy = _corners(rect)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    near = np.any((cx >= lo[:, :1]) & (cx <= hi[:, :1]) & (cy >= lo[:, 1:])
                  & (cy <= hi[:, 1:]), axis=1)
    s = np.nonzero(~hit & near & (kind == POLYGON))[0]
    if s.size:
        hit[s] = np.any(_points_in_rings(cx[s], cy[s], verts[s], nv[s]),
                        axis=1)
    return hit


def contains(rect, verts, nv, kind):
    r = rect[:, None, :]
    x, y, x2, y2, ok = _lanes(verts, nv, kind)
    covered = np.all(_in_closed(r, x, y) | ~ok, axis=1)
    wit = np.any(_in_open(r, x, y) & ok, axis=1)
    wit |= np.any(_in_open(r, (x + x2) * 0.5, (y + y2) * 0.5) & ok, axis=1)
    cnt = np.maximum(nv, 1)
    mx = np.sum(np.where(ok, x, 0.0), axis=1) / cnt
    my = np.sum(np.where(ok, y, 0.0), axis=1) / cnt
    wit |= _in_open(rect, mx, my) & (kind == POLYGON)
    return covered & wit


def sqdist(rect, verts, nv, kind):
    """Squared distance between the closed window and the geometry (0 where
    they meet)."""
    d2 = np.zeros(rect.shape[0])
    s = np.nonzero(~intersects(rect, verts, nv, kind))[0]
    if s.size:
        d2[s] = _apart_sqdist(rect[s], verts[s], nv[s], kind[s])
    return d2


def _apart_sqdist(rect, verts, nv, kind):
    """:func:`sqdist` of pairs that do not meet: the nearest point pair has
    a vertex on one side, so the least of the vertex-to-window and
    corner-to-segment distances."""
    r = rect[:, None, :]
    x, y, x2, y2, ok = _lanes(verts, nv, kind)
    ddx = np.maximum(np.maximum(r[..., 0] - x, x - r[..., 2]), 0.0)
    ddy = np.maximum(np.maximum(r[..., 1] - y, y - r[..., 3]), 0.0)
    vd2 = np.min(np.where(ok, ddx * ddx + ddy * ddy, np.inf), axis=1)
    cx, cy = _corners(rect)
    ex, ey = (x2 - x)[:, :, None], (y2 - y)[:, :, None]
    px = cx[:, None, :] - x[:, :, None]
    py = cy[:, None, :] - y[:, :, None]
    ll = ex * ex + ey * ey
    t = np.clip((px * ex + py * ey) / np.where(ll == 0, 1.0, ll), 0.0, 1.0)
    qx, qy = px - t * ex, py - t * ey
    sd2 = np.min(np.where(ok[:, :, None], qx * qx + qy * qy, np.inf),
                 axis=(1, 2))
    return np.minimum(vd2, sd2)


def decide(relation: str, rect, verts, nv, kind):
    name, d, _ = parse(relation)
    if name == "intersects":
        return intersects(rect, verts, nv, kind)
    if name == "contains":
        return contains(rect, verts, nv, kind)
    return sqdist(rect, verts, nv, kind) <= d * d


def over_pairs(fn, store, rect, rec):
    """``fn(rect, verts, nv, kind)`` over (window, record) pairs, grouped by
    the records' power-of-two width and cut into chunks."""
    out = None
    nv = store.nv[rec]
    width = np.left_shift(1, np.ceil(np.log2(np.maximum(nv, 1)))
                          .astype(np.int64))
    for w in np.unique(width):
        sel = np.nonzero(width == w)[0]
        step = max(1, _CHUNK // int(w))
        for a in range(0, sel.shape[0], step):
            s = sel[a:a + step]
            r = rec[s]
            v = fn(rect[s], store.padded(r, int(w)), store.nv[r],
                   store.kind[r])
            if out is None:
                out = np.empty(rec.shape[0], v.dtype)
            out[s] = v
    return np.zeros(0, bool) if out is None else out
