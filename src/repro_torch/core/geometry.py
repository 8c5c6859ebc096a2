"""Exact-geometry predicates for GLIN's refinement step (paper §VI-B).

The paper refines candidates with GEOS ``Contains``/``Intersects`` on exact
shapes. We support the shape families produced by our data generators
(rectangles, simple polygons — convex OR concave — and polylines) with fully
vectorized predicates. Point-in-polygon is an even-odd ray cast and
window/boundary interaction is decided per edge segment, so no predicate
assumes convexity anywhere.

Two synchronized halves:

* **Host** (numpy, float64): the array-namespace generic functions below
  (``xp=numpy``), used by the mutable host index and the brute-force oracle.
* **Device** (torch, float32): the ``*_torch`` functions, batched over query
  windows — ``rect`` is ``(..., 4)`` and every record array carries the same
  leading dims — with the host version's op order kept term for term, so the
  per-lane arithmetic is what the CUDA kernels (``kernels/csrc/geometry.cuh``)
  evaluate one record at a time.

Predicates take DENSE padded vertex blocks::

    verts:  (N, V, 2)  padded with the last valid vertex
    nverts: (N,)       number of valid vertices
    kind:   GeomKind   POLYGON (closed simple ring) or POLYLINE (open chain)

The store itself keeps geometry in a CSR vertex pool (``datasets.GeometrySet``
/ the device ``VertexPods``); :func:`ragged_padded` is the thin adapter that
materializes the dense per-candidate view from ``(pool, offsets, nverts)`` at
a chosen width, reproducing the pad-with-last convention exactly. Every
predicate is independent of that width (padding lanes are masked or repeat
the last vertex), which is what lets a kernel loop over exactly ``nverts``
vertices instead.

Query windows are axis-aligned rectangles (the paper's query windows are MBRs
of KNN result sets), given as (4,) [xmin, ymin, xmax, ymax].
"""
from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "GeomKind",
    "mbr_intersects",
    "mbr_contains",
    "mbrs_of_verts",
    "points_in_polygons",
    "points_strictly_in_polygons",
    "rect_contains_geoms",
    "rect_covers_geoms",
    "rect_contains_geoms_proper",
    "rect_intersects_polygons",
    "rect_intersects_polylines",
    "rect_intersects_geoms",
    "rect_disjoint_geoms",
    "rect_interior_intersects_geoms",
    "rect_touches_geoms",
    "rect_crosses_geoms",
    "rect_dwithin_geoms",
    "rect_geom_sqdist",
    "geoms_cover_rect",
    "ragged_padded",
    "PRED_INTERSECTS", "PRED_CONTAINS", "PRED_COVERS", "PRED_WITHIN",
    "PRED_TOUCHES", "PRED_CROSSES", "PRED_DWITHIN",
    "device_predicate", "map_over_pods",
]


class GeomKind(enum.IntEnum):
    POLYGON = 0   # closed simple ring (convex or concave)
    POLYLINE = 1  # open chain (roads / rivers)


# ---------------------------------------------------------------------------
# MBR algebra
# ---------------------------------------------------------------------------
def mbr_intersects(a, b, xp=np):
    """(...,4) x (...,4) -> bool. Closed-boundary intersection test."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def mbr_contains(outer, inner, xp=np):
    """outer fully contains inner (closed boundaries)."""
    return (
        (outer[..., 0] <= inner[..., 0])
        & (outer[..., 1] <= inner[..., 1])
        & (inner[..., 2] <= outer[..., 2])
        & (inner[..., 3] <= outer[..., 3])
    )


def mbrs_of_verts(verts, nverts, xp=np):
    """Padded vertex rings -> (N,4) MBRs (padding repeats a valid vertex)."""
    xmin = xp.min(verts[..., 0], axis=-1)
    ymin = xp.min(verts[..., 1], axis=-1)
    xmax = xp.max(verts[..., 0], axis=-1)
    ymax = xp.max(verts[..., 1], axis=-1)
    return xp.stack([xmin, ymin, xmax, ymax], axis=-1)


def ragged_padded(pool, offsets, nverts, width, xp=np):
    """CSR ragged view -> dense ``(..., width, 2)`` padded block.

    ``pool`` is the flat ``(P, 2)`` vertex pool; ``offsets``/``nverts`` are
    same-shaped integer arrays addressing rings inside it. Each ring is
    gathered at ``width`` lanes, repeating its last valid vertex past
    ``nverts`` — bit-identical to the legacy dense pad-with-last layout (the
    fp32 cast commutes with a gather, so device parity is preserved).
    Out-of-pool indices are clamped, so masked/inert records only need
    ``offset`` to point at ANY valid pool row.
    """
    nverts = xp.asarray(nverts)
    lane = xp.minimum(xp.arange(width), nverts[..., None] - 1)
    idx = xp.clip(xp.asarray(offsets)[..., None] + lane, 0, pool.shape[0] - 1)
    return pool[idx]


def _valid_mask(verts, nverts, xp):
    v = verts.shape[-2]
    idx = xp.arange(v)
    return idx[None, :] < xp.asarray(nverts)[:, None]  # (N, V)


# ---------------------------------------------------------------------------
# Contains (Q is a rectangle): true iff every vertex lies inside Q.
# Correct for any geometry because the rectangle is convex, so containing the
# vertex set contains the convex hull (and hence the polygon/polyline).
# ---------------------------------------------------------------------------
def rect_contains_geoms(rect, verts, nverts, xp=np):
    x, y = verts[..., 0], verts[..., 1]
    inside = (x >= rect[0]) & (x <= rect[2]) & (y >= rect[1]) & (y <= rect[3])
    valid = _valid_mask(verts, nverts, xp)
    return xp.all(inside | ~valid, axis=-1)


# DE-9IM name for the closed-boundary test: a geometry touching the window
# boundary from the inside is *covered*.
rect_covers_geoms = rect_contains_geoms


def _seg_next_idx(verts, nverts, kinds, xp):
    """Successor-vertex index per vertex: closed ring for polygons (wraps to
    0), clamped open chain for polylines. Returns (idx, nxt, valid)."""
    nv = xp.asarray(nverts)[:, None]
    vcount = verts.shape[-2]
    idx = xp.arange(vcount)[None, :]
    is_poly = (xp.asarray(kinds) == int(GeomKind.POLYGON))[:, None]
    nxt_poly = xp.where(idx + 1 >= nv, 0, idx + 1)
    nxt_line = xp.minimum(idx + 1, vcount - 1)
    return idx, xp.where(is_poly, nxt_poly, nxt_line), idx < nv


def _ring_edges(verts, nverts, xp):
    """Closed-ring edges of polygon records: (x1, y1, x2, y2, valid), each
    (N, V). Padding rows are invalid; the last valid vertex closes to v0."""
    nv = xp.asarray(nverts)[:, None]
    vcount = verts.shape[-2]
    idx = xp.arange(vcount)[None, :]
    nxt = xp.where(idx + 1 >= nv, 0, idx + 1)
    x, y = verts[..., 0], verts[..., 1]
    x2 = xp.take_along_axis(x, nxt, axis=-1)
    y2 = xp.take_along_axis(y, nxt, axis=-1)
    return x, y, x2, y2, idx < nv


def _clip_segments(rect, x, y, dx, dy, xp):
    """Liang–Barsky clip of segments P + t·D, t ∈ [0, 1], against the CLOSED
    rectangle. Returns ``(t0, t1, reject)``: the clipped parameter interval
    and the parallel-outside rejection mask. A segment meets the closed rect
    iff ``(t0 <= t1) & ~reject``; zero-length segments degenerate to a point
    test (t-span stays [0, 1], rejection decides)."""
    eps = xp.asarray(1e-30, x.dtype)
    t0 = xp.zeros_like(dx)
    t1 = xp.ones_like(dx)
    reject = xp.zeros(dx.shape, dtype=bool)
    for p, q in (
        (-dx, x - rect[0]),
        (dx, rect[2] - x),
        (-dy, y - rect[1]),
        (dy, rect[3] - y),
    ):
        # p*t <= q half-plane; parallel segments handled via sign(q).
        p_safe = xp.where(p == 0, eps, p)
        r = q / p_safe
        t0 = xp.where(p < 0, xp.maximum(t0, r), t0)
        t1 = xp.where(p > 0, xp.minimum(t1, r), t1)
        reject = reject | ((p == 0) & (q < 0))
    return t0, t1, reject


def _strict_inside(rect, px, py):
    return (px > rect[0]) & (px < rect[2]) & (py > rect[1]) & (py < rect[3])


def _segs_hit_and_open(rect, x, y, x2, y2, xp):
    """One Liang–Barsky pass per segment -> ``(hit, open_hit)``: meets the
    CLOSED rect, and meets the rect's OPEN interior. The open test uses the
    clipped span's midpoint — a chord of a convex set not contained in the
    boundary has a strictly interior midpoint, and a boundary-only span (or
    single touch point) does not."""
    t0, t1, rej = _clip_segments(rect, x, y, x2 - x, y2 - y, xp)
    hit = (t0 <= t1) & ~rej
    tm = (t0 + t1) * 0.5
    mx = x + tm * (x2 - x)
    my = y + tm * (y2 - y)
    return hit, hit & _strict_inside(rect, mx, my)


# ---------------------------------------------------------------------------
# Point-in-polygon: even-odd ray cast, exact for simple (possibly concave)
# rings. Boundary membership is decided by an explicit collinearity test, so
# both closed (boundary counts) and strict (interior only) variants are exact.
# ---------------------------------------------------------------------------
def _ray_cast(px, py, verts, nverts, xp):
    """(P,), (P,), (N,V,2), (N,) -> (odd, on_edge) each (N, P) bool."""
    x1, y1, x2, y2, valid = _ring_edges(verts, nverts, xp)
    x1, y1 = x1[:, :, None], y1[:, :, None]          # (N, V, 1)
    x2, y2 = x2[:, :, None], y2[:, :, None]
    pxb, pyb = px[None, None, :], py[None, None, :]  # (1, 1, P)
    validb = valid[:, :, None]

    # Horizontal ray to +x: count edges straddling py whose crossing lies
    # strictly right of px (half-open rule: ties on vertices count once).
    straddle = (y1 > pyb) != (y2 > pyb)
    denom = y2 - y1
    denom_safe = xp.where(denom == 0, xp.asarray(1.0, denom.dtype), denom)
    xint = x1 + (pyb - y1) / denom_safe * (x2 - x1)
    crossing = straddle & (pxb < xint) & validb
    odd = (xp.sum(crossing, axis=1) % 2) == 1        # (N, P)

    # On-boundary: collinear with an edge and inside its bounding box.
    cross = (x2 - x1) * (pyb - y1) - (y2 - y1) * (pxb - x1)
    in_box = (
        (pxb >= xp.minimum(x1, x2)) & (pxb <= xp.maximum(x1, x2))
        & (pyb >= xp.minimum(y1, y2)) & (pyb <= xp.maximum(y1, y2))
    )
    on_edge = xp.any((cross == 0) & in_box & validb, axis=1)
    return odd, on_edge


def points_in_polygons(px, py, verts, nverts, xp=np):
    """Closed point-in-polygon: (P,), (P,), (N,V,2), (N,) -> (N,P) bool.
    True when the point lies in the polygon's interior OR on its boundary.
    Exact for simple rings, convex or concave; degenerate (zero-area) rings
    contain only their boundary points."""
    odd, on_edge = _ray_cast(px, py, verts, nverts, xp)
    return odd | on_edge


def points_strictly_in_polygons(px, py, verts, nverts, xp=np):
    """Open point-in-polygon: true only for interior points (boundary
    excluded). Same shapes/guarantees as :func:`points_in_polygons`."""
    odd, on_edge = _ray_cast(px, py, verts, nverts, xp)
    return odd & ~on_edge


def _rect_corners(rect, xp, center=False):
    cx = [rect[0], rect[2], rect[2], rect[0]]
    cy = [rect[1], rect[1], rect[3], rect[3]]
    if center:
        cx.append((rect[0] + rect[2]) * 0.5)
        cy.append((rect[1] + rect[3]) * 0.5)
    return xp.stack(cx), xp.stack(cy)


def rect_contains_geoms_proper(rect, verts, nverts, kinds, xp=np):
    """Proper (GEOS-style) Contains: geometry covered by the closed window AND
    at least one point of it lies in the window's open interior.

    Exact for the supported shape families (simple polygons — convex or
    concave — and polylines): for a covered geometry the interior witness
    exists iff some vertex, edge midpoint, or (polygons) the vertex mean is
    strictly inside — a geometry lying wholly on the 1-D window boundary has
    none of the three.
    """
    covered = rect_contains_geoms(rect, verts, nverts, xp=xp)
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx(verts, nverts, kinds, xp)

    wit = xp.any(_strict_inside(rect, x, y) & valid, axis=-1)
    mx = (x + xp.take_along_axis(x, nxt, axis=-1)) * 0.5
    my = (y + xp.take_along_axis(y, nxt, axis=-1)) * 0.5
    wit = wit | xp.any(_strict_inside(rect, mx, my) & valid, axis=-1)
    cnt = xp.maximum(xp.asarray(nverts), 1)
    cx_ = xp.sum(xp.where(valid, x, 0.0), axis=-1) / cnt
    cy_ = xp.sum(xp.where(valid, y, 0.0), axis=-1) / cnt
    is_poly = xp.asarray(kinds) == int(GeomKind.POLYGON)
    wit = wit | (_strict_inside(rect, cx_, cy_) & is_poly)
    return covered & wit


def geoms_cover_rect(rect, verts, nverts, kinds, xp=np):
    """(4,), (N,V,2), (N,), (N,) -> (N,): geometry covers the whole window
    (the facade's *Within* relation: window within geometry).

    Exact for simple polygons, convex or concave: the window is covered iff
    all four corners AND the centre lie in the closed polygon (even-odd ray
    cast) and no polygon edge passes through the window's open interior (a
    clipped-midpoint test per edge). The centre test closes the measure-zero
    gap where every corner sits exactly on the boundary of a polygon that
    excludes the interior. Polylines never cover a 2-D window and return
    False.
    """
    x1, y1, x2, y2, valid = _ring_edges(verts, nverts, xp)
    _, open_hit = _segs_hit_and_open(rect, x1, y1, x2, y2, xp)
    interior_clip = xp.any(open_hit & valid, axis=-1)

    px, py = _rect_corners(rect, xp, center=True)
    inside = points_in_polygons(px, py, verts, nverts, xp=xp)  # (N, 5)
    is_poly = xp.asarray(kinds) == int(GeomKind.POLYGON)
    return xp.all(inside, axis=-1) & ~interior_clip & is_poly


# ---------------------------------------------------------------------------
# Intersects — simple polygons (convex or concave): the closed window meets
# the polygon iff some boundary edge meets the closed window (Liang–Barsky)
# or the window lies entirely inside the polygon (corner ray cast).
# ---------------------------------------------------------------------------
def rect_intersects_polygons(rect, verts, nverts, xp=np):
    """(4,), (N,V,2), (N,) -> (N,) bool. Exact simple-polygon vs rect."""
    x1, y1, x2, y2, valid = _ring_edges(verts, nverts, xp)
    hit, _ = _segs_hit_and_open(rect, x1, y1, x2, y2, xp)
    edge_hit = xp.any(hit & valid, axis=-1)

    px, py = _rect_corners(rect, xp)
    corner_in = xp.any(points_in_polygons(px, py, verts, nverts, xp=xp),
                       axis=-1)
    return edge_hit | corner_in


# ---------------------------------------------------------------------------
# Intersects — polylines: any segment clips the rectangle (Liang–Barsky) or
# any endpoint lies inside.
# ---------------------------------------------------------------------------
def rect_intersects_polylines(rect, verts, nverts, xp=np):
    x, y = verts[..., 0], verts[..., 1]
    nv = xp.asarray(nverts)[:, None]
    vcount = verts.shape[-2]
    idx = xp.arange(vcount)[None, :]
    seg_valid = (idx + 1) < nv  # (N, V): segment i..i+1 exists

    nxt = xp.minimum(idx + 1, vcount - 1)
    x1 = xp.take_along_axis(x, nxt, axis=-1)
    y1 = xp.take_along_axis(y, nxt, axis=-1)
    t0, t1, reject = _clip_segments(rect, x, y, x1 - x, y1 - y, xp)
    seg_hit = (t0 <= t1) & ~reject & seg_valid

    valid = _valid_mask(verts, nverts, xp)
    pt_in = (x >= rect[0]) & (x <= rect[2]) & (y >= rect[1]) & (y <= rect[3]) & valid
    return xp.any(seg_hit, axis=-1) | xp.any(pt_in, axis=-1)


def rect_intersects_geoms(rect, verts, nverts, kinds, xp=np):
    """Dispatch on geometry kind. ``kinds``: (N,) int array of GeomKind."""
    poly = rect_intersects_polygons(rect, verts, nverts, xp=xp)
    line = rect_intersects_polylines(rect, verts, nverts, xp=xp)
    return xp.where(xp.asarray(kinds) == int(GeomKind.POLYGON), poly, line)


def rect_disjoint_geoms(rect, verts, nverts, kinds, xp=np):
    """Complement of Intersects (closed boundaries: touching is NOT disjoint)."""
    return ~rect_intersects_geoms(rect, verts, nverts, kinds, xp=xp)


# ---------------------------------------------------------------------------
# Interior interaction — the DE-9IM int(W) ∩ int(G) test behind Touches and
# Crosses. A geometry's interior meets the open window iff some edge's
# clipped midpoint is strictly inside (the clipped span of a segment through
# the open interior has a strictly-interior midpoint; spans on the boundary
# do not), or — polygons only — the window centre is strictly inside the
# ring (window fully interior to the polygon, no boundary crossing).
# Degenerate point-like records follow the DE-9IM convention that a point's
# interior is the point itself.
# ---------------------------------------------------------------------------
def rect_interior_intersects_geoms(rect, verts, nverts, kinds, xp=np):
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx(verts, nverts, kinds, xp)
    x2 = xp.take_along_axis(x, nxt, axis=-1)
    y2 = xp.take_along_axis(y, nxt, axis=-1)
    _, open_hit = _segs_hit_and_open(rect, x, y, x2, y2, xp)
    seg_int = xp.any(open_hit & valid, axis=-1)

    ccx = xp.stack([(rect[0] + rect[2]) * 0.5])
    ccy = xp.stack([(rect[1] + rect[3]) * 0.5])
    center_in = points_strictly_in_polygons(ccx, ccy, verts, nverts,
                                            xp=xp)[:, 0]
    is_poly = xp.asarray(kinds) == int(GeomKind.POLYGON)
    return seg_int | (center_in & is_poly)


def rect_touches_geoms(rect, verts, nverts, kinds, xp=np):
    """DE-9IM Touches: W and G share at least one point but their interiors
    are disjoint (they meet only along boundaries).

    Single-pass: one Liang–Barsky clip over the kind-aware edge set decides
    both closed contact and open-interior contact (for polygons the
    kind-aware edges ARE the closed ring; for polylines the clamped trailing
    zero-length segment makes every vertex — including a single-vertex
    record — a point test, so no separate endpoint term is needed), and one
    five-point ray cast decides corners-in (closed, window inside polygon)
    plus centre-in (strict, window interior inside polygon).
    """
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx(verts, nverts, kinds, xp)
    x2 = xp.take_along_axis(x, nxt, axis=-1)
    y2 = xp.take_along_axis(y, nxt, axis=-1)
    hit, open_hit = _segs_hit_and_open(rect, x, y, x2, y2, xp)
    edge_hit = xp.any(hit & valid, axis=-1)
    edge_open = xp.any(open_hit & valid, axis=-1)

    px, py = _rect_corners(rect, xp, center=True)
    odd, on_edge = _ray_cast(px, py, verts, nverts, xp)
    corner_in = xp.any((odd | on_edge)[:, :4], axis=-1)
    center_strict = odd[:, 4] & ~on_edge[:, 4]

    is_poly = xp.asarray(kinds) == int(GeomKind.POLYGON)
    inter = edge_hit | (corner_in & is_poly)
    interior = edge_open | (center_strict & is_poly)
    return inter & ~interior


def rect_crosses_geoms(rect, verts, nverts, kinds, xp=np):
    """DE-9IM Crosses for mixed dimensions: a polyline crosses the window
    when its interior passes through the window's interior AND part of it
    lies outside the closed window. Area/area crosses is undefined in
    DE-9IM, so polygon records always return False."""
    open_hit = rect_interior_intersects_geoms(rect, verts, nverts, kinds,
                                              xp=xp)
    inside_all = rect_contains_geoms(rect, verts, nverts, xp=xp)
    is_line = xp.asarray(kinds) == int(GeomKind.POLYLINE)
    return is_line & open_hit & ~inside_all


# ---------------------------------------------------------------------------
# DWithin — Euclidean distance between the window and the geometry at most d
# (distance-buffered Intersects; the ROADMAP's knn-radius relation). For a
# disjoint segment/rect pair the minimum distance is attained either at a
# segment endpoint (point-to-rect) or at a rect corner (point-to-segment),
# so the vectorized minimum over both families is exact.
# ---------------------------------------------------------------------------
def rect_geom_sqdist(rect, verts, nverts, kinds, xp=np):
    """(4,), (N,V,2), (N,), (N,) -> (N,) squared min Euclidean distance
    between the closed window and each geometry (0 where they intersect).
    Shared by ``rect_dwithin_geoms`` and the exact-distance knn ranking."""
    inter = rect_intersects_geoms(rect, verts, nverts, kinds, xp=xp)

    x, y = verts[..., 0], verts[..., 1]
    valid = _valid_mask(verts, nverts, xp)
    big = xp.asarray(1e30, verts.dtype)
    zero = xp.asarray(0.0, verts.dtype)

    # vertex -> rect distance (covers closest-point-at-segment-endpoint)
    ddx = xp.maximum(xp.maximum(rect[0] - x, x - rect[2]), zero)
    ddy = xp.maximum(xp.maximum(rect[1] - y, y - rect[3]), zero)
    vd2 = xp.min(xp.where(valid, ddx * ddx + ddy * ddy, big), axis=-1)

    # rect corner -> edge-segment distance (covers closest-point-at-corner)
    _, nxt, _ = _seg_next_idx(verts, nverts, kinds, xp)
    bx = xp.take_along_axis(x, nxt, axis=-1)
    by = xp.take_along_axis(y, nxt, axis=-1)
    ex, ey = bx - x, by - y                              # (N, V)
    cx, cy = _rect_corners(rect, xp)                     # (4,)
    px = cx[None, None, :] - x[:, :, None]               # (N, V, 4)
    py = cy[None, None, :] - y[:, :, None]
    ll = ex * ex + ey * ey
    ll_safe = xp.where(ll == 0, xp.asarray(1.0, ll.dtype), ll)[:, :, None]
    t = (px * ex[:, :, None] + py * ey[:, :, None]) / ll_safe
    t = xp.clip(t, 0.0, 1.0)
    qx = px - t * ex[:, :, None]
    qy = py - t * ey[:, :, None]
    sd2 = qx * qx + qy * qy                              # (N, V, 4)
    sd2 = xp.min(xp.where(valid[:, :, None], sd2, big), axis=(1, 2))

    d2 = xp.minimum(vd2, sd2)
    return xp.where(inter, xp.asarray(0.0, d2.dtype), d2)


def rect_dwithin_geoms(rect, verts, nverts, kinds, dist, xp=np):
    """(4,), (N,V,2), (N,), (N,), float -> (N,) bool: min Euclidean distance
    between the closed window and the geometry is at most ``dist``."""
    d2 = rect_geom_sqdist(rect, verts, nverts, kinds, xp=xp)
    return d2 <= xp.asarray(float(dist) ** 2, d2.dtype)


# ---------------------------------------------------------------------------
# kNN ordering contract
# ---------------------------------------------------------------------------
def rank_knn(ids, dists, k: int):
    """Canonical kNN ordering: ascending ``(distance, record id)``.

    This is THE tie-break contract shared by every backend. The host ladder
    ranks with ``np.lexsort((ids, d))``; the device rank sorts the operand
    pair ``[d, ids]`` with a two-key sort; the sharded k-merge
    re-sorts the all-gathered per-shard blocks the same way. All three reduce
    to this ordering, so co-located records (equal exact distance) resolve to
    the same ids on every path and oracle parity never flakes on ties.

    Returns ``(ids[:k], dists[:k])`` in that order — shorter than ``k`` when
    fewer candidates exist (the k > live-records contract).
    """
    ids = np.asarray(ids)
    dists = np.asarray(dists)
    order = np.lexsort((ids, dists))[: max(int(k), 0)]
    return ids[order], dists[order]


# ===========================================================================
# Device half: batched torch fp32 predicates
#
# Shapes: ``rect`` (..., 4); ``verts`` (..., N, V, 2); ``nverts``/``kinds``
# (..., N); results (..., N). The leading dims of ``rect`` line up with the
# record arrays' leading dims (one window per row of candidates). Every
# arithmetic step is one torch op, so nothing is contracted into a fused
# multiply-add: each product and sum rounds on its own, as in the CUDA
# kernels (built with ``--fmad=false``). Lane indices are int64 because
# ``torch.gather`` takes no other index type.
# ===========================================================================
def _rc(rect, trailing: int):
    """The four window coordinates, each shaped (..., 1 x trailing) to
    broadcast against per-record (trailing=1) or per-lane (trailing=2)
    arrays."""
    idx = (Ellipsis,) + (None,) * trailing
    return tuple(rect[..., k][idx] for k in range(4))


def _lanes(verts) -> torch.Tensor:
    return torch.arange(verts.shape[-2], dtype=torch.int64,
                        device=verts.device)


def _gather_lanes(a, idx):
    return torch.gather(a, -1, idx.expand(a.shape))


def _lane_sum(a):
    """Left-to-right sum over the lane axis: the order a kernel's scalar
    loop adds in (padding lanes carry 0 and leave the sum unchanged)."""
    acc = a[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i]
    return acc


def _valid_mask_torch(verts, nverts):
    return _lanes(verts) < nverts[..., None]


def _seg_next_idx_torch(verts, nverts, kinds):
    nv = nverts[..., None].to(torch.int64)
    idx = _lanes(verts)
    is_poly = (kinds == int(GeomKind.POLYGON))[..., None]
    nxt_poly = torch.where(idx + 1 >= nv, 0, idx + 1)
    nxt_line = torch.clamp(idx + 1, max=verts.shape[-2] - 1)
    return idx, torch.where(is_poly, nxt_poly, nxt_line), idx < nv


def _ring_edges_torch(verts, nverts):
    nv = nverts[..., None].to(torch.int64)
    idx = _lanes(verts)
    nxt = torch.where(idx + 1 >= nv, 0, idx + 1)
    x, y = verts[..., 0], verts[..., 1]
    return x, y, _gather_lanes(x, nxt), _gather_lanes(y, nxt), idx < nv


def _clip_segments_torch(r, x, y, dx, dy):
    """Liang–Barsky clip against the closed window ``r`` (components from
    :func:`_rc`); see :func:`_clip_segments`."""
    eps = torch.tensor(1e-30, dtype=x.dtype, device=x.device)
    t0 = torch.zeros_like(dx)
    t1 = torch.ones_like(dx)
    reject = torch.zeros(dx.shape, dtype=torch.bool, device=dx.device)
    for p, q in ((-dx, x - r[0]), (dx, r[2] - x),
                 (-dy, y - r[1]), (dy, r[3] - y)):
        p_safe = torch.where(p == 0, eps, p)
        rr = q / p_safe
        t0 = torch.where(p < 0, torch.maximum(t0, rr), t0)
        t1 = torch.where(p > 0, torch.minimum(t1, rr), t1)
        reject = reject | ((p == 0) & (q < 0))
    return t0, t1, reject


def _strict_inside_torch(r, px, py):
    return (px > r[0]) & (px < r[2]) & (py > r[1]) & (py < r[3])


def _segs_hit_and_open_torch(r, x, y, x2, y2):
    t0, t1, rej = _clip_segments_torch(r, x, y, x2 - x, y2 - y)
    hit = (t0 <= t1) & ~rej
    tm = (t0 + t1) * 0.5
    mx = x + tm * (x2 - x)
    my = y + tm * (y2 - y)
    return hit, hit & _strict_inside_torch(r, mx, my)


def _ray_cast_torch(px, py, verts, nverts):
    """(..., P), (..., P), (..., N, V, 2), (..., N) -> (odd, on_edge) each
    (..., N, P) bool."""
    x1, y1, x2, y2, valid = _ring_edges_torch(verts, nverts)
    x1, y1 = x1[..., None], y1[..., None]            # (..., N, V, 1)
    x2, y2 = x2[..., None], y2[..., None]
    pxb, pyb = px[..., None, None, :], py[..., None, None, :]
    validb = valid[..., None]

    straddle = (y1 > pyb) != (y2 > pyb)
    denom = y2 - y1
    denom_safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    xint = x1 + (pyb - y1) / denom_safe * (x2 - x1)
    crossing = straddle & (pxb < xint) & validb
    odd = (crossing.sum(dim=-2, dtype=torch.int32) % 2) == 1

    cross = (x2 - x1) * (pyb - y1) - (y2 - y1) * (pxb - x1)
    in_box = (
        (pxb >= torch.minimum(x1, x2)) & (pxb <= torch.maximum(x1, x2))
        & (pyb >= torch.minimum(y1, y2)) & (pyb <= torch.maximum(y1, y2))
    )
    on_edge = ((cross == 0) & in_box & validb).any(dim=-2)
    return odd, on_edge


def points_in_polygons_torch(px, py, verts, nverts):
    odd, on_edge = _ray_cast_torch(px, py, verts, nverts)
    return odd | on_edge


def points_strictly_in_polygons_torch(px, py, verts, nverts):
    odd, on_edge = _ray_cast_torch(px, py, verts, nverts)
    return odd & ~on_edge


def _rect_corners_torch(rect, center=False):
    cx = [rect[..., 0], rect[..., 2], rect[..., 2], rect[..., 0]]
    cy = [rect[..., 1], rect[..., 1], rect[..., 3], rect[..., 3]]
    if center:
        cx.append((rect[..., 0] + rect[..., 2]) * 0.5)
        cy.append((rect[..., 1] + rect[..., 3]) * 0.5)
    return torch.stack(cx, dim=-1), torch.stack(cy, dim=-1)


def rect_contains_geoms_torch(rect, verts, nverts, kinds=None):
    r = _rc(rect, 2)
    x, y = verts[..., 0], verts[..., 1]
    inside = (x >= r[0]) & (x <= r[2]) & (y >= r[1]) & (y <= r[3])
    valid = _valid_mask_torch(verts, nverts)
    return (inside | ~valid).all(dim=-1)


rect_covers_geoms_torch = rect_contains_geoms_torch


def rect_contains_geoms_proper_torch(rect, verts, nverts, kinds):
    covered = rect_contains_geoms_torch(rect, verts, nverts)
    r2, r1 = _rc(rect, 2), _rc(rect, 1)
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx_torch(verts, nverts, kinds)

    wit = (_strict_inside_torch(r2, x, y) & valid).any(dim=-1)
    mx = (x + _gather_lanes(x, nxt)) * 0.5
    my = (y + _gather_lanes(y, nxt)) * 0.5
    wit = wit | (_strict_inside_torch(r2, mx, my) & valid).any(dim=-1)
    cnt = torch.clamp(nverts, min=1)
    cx_ = _lane_sum(torch.where(valid, x, 0.0)) / cnt
    cy_ = _lane_sum(torch.where(valid, y, 0.0)) / cnt
    is_poly = kinds == int(GeomKind.POLYGON)
    wit = wit | (_strict_inside_torch(r1, cx_, cy_) & is_poly)
    return covered & wit


def geoms_cover_rect_torch(rect, verts, nverts, kinds):
    x1, y1, x2, y2, valid = _ring_edges_torch(verts, nverts)
    _, open_hit = _segs_hit_and_open_torch(_rc(rect, 2), x1, y1, x2, y2)
    interior_clip = (open_hit & valid).any(dim=-1)

    px, py = _rect_corners_torch(rect, center=True)
    inside = points_in_polygons_torch(px, py, verts, nverts)  # (..., N, 5)
    is_poly = kinds == int(GeomKind.POLYGON)
    return inside.all(dim=-1) & ~interior_clip & is_poly


def rect_intersects_polygons_torch(rect, verts, nverts):
    x1, y1, x2, y2, valid = _ring_edges_torch(verts, nverts)
    hit, _ = _segs_hit_and_open_torch(_rc(rect, 2), x1, y1, x2, y2)
    edge_hit = (hit & valid).any(dim=-1)

    px, py = _rect_corners_torch(rect)
    corner_in = points_in_polygons_torch(px, py, verts, nverts).any(dim=-1)
    return edge_hit | corner_in


def rect_intersects_polylines_torch(rect, verts, nverts):
    r = _rc(rect, 2)
    x, y = verts[..., 0], verts[..., 1]
    nv = nverts[..., None].to(torch.int64)
    idx = _lanes(verts)
    seg_valid = (idx + 1) < nv

    nxt = torch.clamp(idx + 1, max=verts.shape[-2] - 1)
    x1 = _gather_lanes(x, nxt)
    y1 = _gather_lanes(y, nxt)
    t0, t1, reject = _clip_segments_torch(r, x, y, x1 - x, y1 - y)
    seg_hit = (t0 <= t1) & ~reject & seg_valid

    valid = idx < nv
    pt_in = ((x >= r[0]) & (x <= r[2]) & (y >= r[1]) & (y <= r[3])
             & valid)
    return seg_hit.any(dim=-1) | pt_in.any(dim=-1)


def rect_intersects_geoms_torch(rect, verts, nverts, kinds):
    poly = rect_intersects_polygons_torch(rect, verts, nverts)
    line = rect_intersects_polylines_torch(rect, verts, nverts)
    return torch.where(kinds == int(GeomKind.POLYGON), poly, line)


def rect_disjoint_geoms_torch(rect, verts, nverts, kinds):
    return ~rect_intersects_geoms_torch(rect, verts, nverts, kinds)


def rect_interior_intersects_geoms_torch(rect, verts, nverts, kinds):
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx_torch(verts, nverts, kinds)
    x2 = _gather_lanes(x, nxt)
    y2 = _gather_lanes(y, nxt)
    _, open_hit = _segs_hit_and_open_torch(_rc(rect, 2), x, y, x2, y2)
    seg_int = (open_hit & valid).any(dim=-1)

    ccx = ((rect[..., 0] + rect[..., 2]) * 0.5)[..., None]
    ccy = ((rect[..., 1] + rect[..., 3]) * 0.5)[..., None]
    center_in = points_strictly_in_polygons_torch(ccx, ccy, verts,
                                                  nverts)[..., 0]
    is_poly = kinds == int(GeomKind.POLYGON)
    return seg_int | (center_in & is_poly)


def rect_touches_geoms_torch(rect, verts, nverts, kinds):
    x, y = verts[..., 0], verts[..., 1]
    _, nxt, valid = _seg_next_idx_torch(verts, nverts, kinds)
    x2 = _gather_lanes(x, nxt)
    y2 = _gather_lanes(y, nxt)
    hit, open_hit = _segs_hit_and_open_torch(_rc(rect, 2), x, y, x2, y2)
    edge_hit = (hit & valid).any(dim=-1)
    edge_open = (open_hit & valid).any(dim=-1)

    px, py = _rect_corners_torch(rect, center=True)
    odd, on_edge = _ray_cast_torch(px, py, verts, nverts)
    corner_in = (odd | on_edge)[..., :4].any(dim=-1)
    center_strict = odd[..., 4] & ~on_edge[..., 4]

    is_poly = kinds == int(GeomKind.POLYGON)
    inter = edge_hit | (corner_in & is_poly)
    interior = edge_open | (center_strict & is_poly)
    return inter & ~interior


def rect_crosses_geoms_torch(rect, verts, nverts, kinds):
    open_hit = rect_interior_intersects_geoms_torch(rect, verts, nverts,
                                                    kinds)
    inside_all = rect_contains_geoms_torch(rect, verts, nverts)
    is_line = kinds == int(GeomKind.POLYLINE)
    return is_line & open_hit & ~inside_all


def rect_geom_sqdist_torch(rect, verts, nverts, kinds):
    inter = rect_intersects_geoms_torch(rect, verts, nverts, kinds)

    r = _rc(rect, 2)
    x, y = verts[..., 0], verts[..., 1]
    valid = _valid_mask_torch(verts, nverts)
    big = torch.tensor(1e30, dtype=verts.dtype, device=verts.device)
    zero = torch.tensor(0.0, dtype=verts.dtype, device=verts.device)

    ddx = torch.maximum(torch.maximum(r[0] - x, x - r[2]), zero)
    ddy = torch.maximum(torch.maximum(r[1] - y, y - r[3]), zero)
    vd2 = torch.where(valid, ddx * ddx + ddy * ddy, big).amin(dim=-1)

    _, nxt, _ = _seg_next_idx_torch(verts, nverts, kinds)
    bx = _gather_lanes(x, nxt)
    by = _gather_lanes(y, nxt)
    ex, ey = bx - x, by - y                              # (..., N, V)
    cx, cy = _rect_corners_torch(rect)                   # (..., 4)
    px = cx[..., None, None, :] - x[..., None]           # (..., N, V, 4)
    py = cy[..., None, None, :] - y[..., None]
    ll = ex * ex + ey * ey
    ll_safe = torch.where(ll == 0, torch.ones_like(ll), ll)[..., None]
    t = (px * ex[..., None] + py * ey[..., None]) / ll_safe
    t = torch.clamp(t, 0.0, 1.0)
    qx = px - t * ex[..., None]
    qy = py - t * ey[..., None]
    sd2 = qx * qx + qy * qy
    sd2 = torch.where(valid[..., None], sd2, big).amin(dim=(-2, -1))

    d2 = torch.minimum(vd2, sd2)
    return torch.where(inter, zero, d2)


def rect_dwithin_geoms_torch(rect, verts, nverts, kinds, dist):
    d2 = rect_geom_sqdist_torch(rect, verts, nverts, kinds)
    return d2 <= torch.tensor(float(dist) ** 2, dtype=d2.dtype,
                              device=d2.device)


def ragged_padded_torch(pool, offsets, nverts, width):
    """Torch :func:`ragged_padded`: ``(..., width, 2)`` gather of CSR rings
    from ``pool`` (P, 2), repeating each ring's last vertex."""
    lane = torch.minimum(
        torch.arange(width, dtype=torch.int64, device=pool.device),
        nverts[..., None].to(torch.int64) - 1)
    idx = torch.clamp(offsets[..., None].to(torch.int64) + lane, 0,
                      pool.shape[0] - 1)
    return pool[idx]


# ---------------------------------------------------------------------------
# Device predicate codes: one integer per device-native relation predicate,
# shared by the torch path and the CUDA kernels (geometry.cuh switches on the
# same values)
# ---------------------------------------------------------------------------
PRED_INTERSECTS = 0
PRED_CONTAINS = 1    # proper (GEOS-style) contains
PRED_COVERS = 2
PRED_WITHIN = 3      # the geometry covers the window
PRED_TOUCHES = 4
PRED_CROSSES = 5
PRED_DWITHIN = 6     # takes the distance as a parameter

_TORCH_PREDICATES = {
    PRED_INTERSECTS: rect_intersects_geoms_torch,
    PRED_CONTAINS: rect_contains_geoms_proper_torch,
    PRED_COVERS: rect_covers_geoms_torch,
    PRED_WITHIN: geoms_cover_rect_torch,
    PRED_TOUCHES: rect_touches_geoms_torch,
    PRED_CROSSES: rect_crosses_geoms_torch,
}


def device_predicate(code: int, dist: float = 0.0):
    """The batched torch predicate ``(rect, verts, nverts, kinds) -> bool``
    for a predicate code (``dist`` parameterizes ``PRED_DWITHIN``)."""
    if code == PRED_DWITHIN:
        return lambda rect, verts, nverts, kinds: rect_dwithin_geoms_torch(
            rect, verts, nverts, kinds, dist)
    try:
        return _TORCH_PREDICATES[code]
    except KeyError:
        raise ValueError(f"unknown predicate code {code!r}") from None


# lanes x vertices per chunk of the exact stage: bounds the (chunk, 1, W, 5)
# ray-cast intermediates to a few hundred MB whatever the batch size
_EXACT_CHUNK_ELEMS = 1 << 22


def map_over_pods(fn, windows, pool, off, nv, kd, bucket, rec, sel, fill,
                  width=None):
    """``fn(rect, verts, nverts, kinds)`` — an exact predicate or distance —
    over gathered records ``rec`` (Q, M) -> (Q, M), ``fill`` on unselected
    lanes (every caller masks them anyway).

    Evaluates the selected lanes only, gathering each record's vertex pod at
    the widest pow2 bucket among the selected lanes of the whole batch —
    the reference's width ladder picks the same branch — or at ``width``
    when given (``bucket`` is then unused), padded with the last valid
    vertex. Lanes run in chunks, so memory stays bounded even over a dense
    (Q, cap) candidate block."""
    rows, cols = sel.nonzero(as_tuple=True)
    if rows.numel() == 0:
        return torch.full(rec.shape, fill, device=rec.device)
    r = rec[rows, cols]
    o, n, k = off[r], nv[r], kd[r]
    if width is None:
        width = 1 << int(bucket[r].max())
    lane = torch.arange(width, dtype=torch.int64, device=rec.device)
    parts = []
    step = max(1, _EXACT_CHUNK_ELEMS // width)
    for i in range(0, r.shape[0], step):
        nn = n[i:i + step, None]
        idx = torch.clamp(
            o[i:i + step, None, None].to(torch.int64)
            + torch.minimum(lane, nn[..., None].to(torch.int64) - 1),
            0, pool.shape[0] - 1)
        parts.append(fn(windows[rows[i:i + step]], pool[idx], nn,
                        k[i:i + step, None])[:, 0])
    res = torch.cat(parts)
    out = torch.full(rec.shape, fill, dtype=res.dtype, device=rec.device)
    out[rows, cols] = res
    return out
