"""Baseline spatial indexes the paper compares against (§IX-A).

* :class:`RTree`     — Boost-style R-Tree: STR bulk load, min-enlargement
                       insertion with linear split (paper uses Boost R-Tree
                       defaults, max 16 entries).
* :class:`QuadTree`  — GEOS-style region quadtree: items live at the deepest
                       node whose quadrant fully contains their MBR.
* :class:`SortedArray` — non-learned ablation: the same Zmin-sorted record
                       array probed by binary search instead of the learned
                       model (isolates the learned-CDF contribution).

All three expose ``query(window, relation)`` with the same probe → exact-shape
refinement split as GLIN, so probing time / refinement checks / sizes are
directly comparable.

The port's copy of the reference's ``core/baselines.py``, over the port's
own ``geometry``, ``datasets``, ``index``, ``piecewise``, ``relations`` and
``zorder``. Like the reference's, all three are host structures: a numpy
probe and an fp64 exact refinement, with no device path. Their answers and
their ``stats()`` (the storage model the paper's comparison reads) equal the
reference's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import geometry as geom
from .datasets import GeometrySet
from .index import QueryStats
from .piecewise import PiecewiseFunction
from .relations import get_relation
from .zorder import mbr_to_zinterval_np

__all__ = ["RTree", "QuadTree", "SortedArray"]


def _refine(gs: GeometrySet, cand: np.ndarray, window: np.ndarray,
            relation: str, st: QueryStats) -> np.ndarray:
    rel = get_relation(relation)
    if rel.complement_of is not None:
        # the tree probes only surface MBR-intersecting candidates, so a
        # complement's true hits (records far from the window) are never
        # visited — refuse rather than silently return near-boundary records
        raise NotImplementedError(
            f"baseline indexes do not implement complement relation "
            f"{relation!r}; use SpatialIndex")
    st.checked += int(cand.shape[0])
    if cand.shape[0] == 0:
        return np.empty(0, np.int64)
    # gather only THIS candidate set's rings from the pool, padded to the
    # set's own widest record — never the store-wide dense block
    ok = rel.predicate(window, gs.padded(cand), gs.nverts[cand],
                       gs.kinds[cand])
    return cand[ok]


# ---------------------------------------------------------------------------
# R-Tree (STR bulk load; Guttman insert with linear split)
# ---------------------------------------------------------------------------
class _RNode:
    __slots__ = ("mbr", "children", "entries", "is_leaf")

    def __init__(self, is_leaf: bool):
        self.is_leaf = is_leaf
        self.mbr = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float64)
        self.children: List["_RNode"] = []
        self.entries: List[int] = []  # record ids (leaves only)

    def recompute_mbr(self, gs_mbrs) -> None:
        if self.is_leaf:
            if self.entries:
                m = gs_mbrs[np.asarray(self.entries)]
                self.mbr = np.array([m[:, 0].min(), m[:, 1].min(),
                                     m[:, 2].max(), m[:, 3].max()])
        else:
            ms = np.stack([c.mbr for c in self.children])
            self.mbr = np.array([ms[:, 0].min(), ms[:, 1].min(),
                                 ms[:, 2].max(), ms[:, 3].max()])


class RTree:
    MAX_ENTRIES = 16

    def __init__(self, gs: GeometrySet):
        self.gs = gs

    @classmethod
    def build(cls, gs: GeometrySet) -> "RTree":
        """Sort-Tile-Recursive bulk load."""
        self = cls(gs)
        mbrs = gs.mbrs
        n = len(gs)
        cx = (mbrs[:, 0] + mbrs[:, 2]) * 0.5
        cy = (mbrs[:, 1] + mbrs[:, 3]) * 0.5
        cap = self.MAX_ENTRIES
        idx = np.argsort(cx, kind="stable")
        s = int(np.ceil(np.sqrt(np.ceil(n / cap))))
        slice_sz = s * cap
        leaves: List[_RNode] = []
        for i in range(0, n, slice_sz):
            sl = idx[i : i + slice_sz]
            sl = sl[np.argsort(cy[sl], kind="stable")]
            for j in range(0, sl.shape[0], cap):
                node = _RNode(True)
                node.entries = sl[j : j + cap].tolist()
                node.recompute_mbr(mbrs)
                leaves.append(node)
        level = leaves
        while len(level) > 1:
            nxt: List[_RNode] = []
            order = np.argsort([0.5 * (nd.mbr[0] + nd.mbr[2]) for nd in level],
                               kind="stable")
            lv = [level[i] for i in order]
            s = int(np.ceil(np.sqrt(np.ceil(len(lv) / cap))))
            slice_sz = s * cap
            for i in range(0, len(lv), slice_sz):
                sl = lv[i : i + slice_sz]
                sl.sort(key=lambda nd: 0.5 * (nd.mbr[1] + nd.mbr[3]))
                for j in range(0, len(sl), cap):
                    node = _RNode(False)
                    node.children = sl[j : j + cap]
                    node.recompute_mbr(mbrs)
                    nxt.append(node)
            level = nxt
        self.root = level[0] if level else _RNode(True)
        return self

    # -- query ---------------------------------------------------------------
    def probe(self, window: np.ndarray, st: QueryStats) -> np.ndarray:
        out: List[int] = []
        stack = [self.root]
        gs_mbrs = self.gs.mbrs
        while stack:
            node = stack.pop()
            if not bool(geom.mbr_intersects(node.mbr, window)):
                st.leaves_skipped += 1
                continue
            if node.is_leaf:
                st.leaves_visited += 1
                if node.entries:
                    e = np.asarray(node.entries)
                    hit = geom.mbr_intersects(gs_mbrs[e], window[None, :])
                    out.extend(e[hit].tolist())
            else:
                stack.extend(node.children)
        return np.asarray(out, np.int64)

    def query(self, window: np.ndarray, relation: str = "contains",
              stats: Optional[QueryStats] = None) -> np.ndarray:
        st = stats if stats is not None else QueryStats()
        window = np.asarray(window, np.float64)
        rel = get_relation(relation)
        cand = self.probe(rel.probe_window(window), st)
        st.candidates += int(cand.shape[0])
        res = _refine(self.gs, cand, window, relation, st)
        st.results = int(res.shape[0])
        return res

    # -- maintenance -----------------------------------------------------------
    def insert(self, rec: int) -> None:
        mbr = self.gs.mbrs[rec]

        def enlarge(m, b):
            return ((max(m[2], b[2]) - min(m[0], b[0]))
                    * (max(m[3], b[3]) - min(m[1], b[1]))
                    - (m[2] - m[0]) * (m[3] - m[1]))

        node = self.root
        path = [node]
        while not node.is_leaf:
            best = min(node.children, key=lambda c: enlarge(c.mbr, mbr))
            node = best
            path.append(node)
        node.entries.append(rec)
        for nd in reversed(path):
            nd.mbr[0] = min(nd.mbr[0], mbr[0])
            nd.mbr[1] = min(nd.mbr[1], mbr[1])
            nd.mbr[2] = max(nd.mbr[2], mbr[2])
            nd.mbr[3] = max(nd.mbr[3], mbr[3])
        if len(node.entries) > self.MAX_ENTRIES:
            self._split_leaf(path)

    def _split_leaf(self, path: List[_RNode]) -> None:
        leaf = path[-1]
        mbrs = self.gs.mbrs
        e = np.asarray(leaf.entries)
        cx = (mbrs[e, 0] + mbrs[e, 2]) * 0.5
        order = np.argsort(cx)  # linear split along x
        half = e.shape[0] // 2
        a, b = _RNode(True), _RNode(True)
        a.entries = e[order[:half]].tolist()
        b.entries = e[order[half:]].tolist()
        a.recompute_mbr(mbrs)
        b.recompute_mbr(mbrs)
        if len(path) == 1:
            new_root = _RNode(False)
            new_root.children = [a, b]
            new_root.recompute_mbr(mbrs)
            self.root = new_root
            return
        parent = path[-2]
        parent.children.remove(leaf)
        parent.children.extend([a, b])
        if len(parent.children) > self.MAX_ENTRIES:
            # split internal node the same way
            ms = np.stack([c.mbr for c in parent.children])
            order = np.argsort((ms[:, 0] + ms[:, 2]) * 0.5)
            half = len(parent.children) // 2
            kids = [parent.children[i] for i in order]
            a2, b2 = _RNode(False), _RNode(False)
            a2.children = kids[:half]
            b2.children = kids[half:]
            a2.recompute_mbr(ms)
            b2.recompute_mbr(ms)
            if len(path) == 2:
                new_root = _RNode(False)
                new_root.children = [a2, b2]
                new_root.recompute_mbr(ms)
                self.root = new_root
            else:
                gp = path[-3]
                gp.children.remove(parent)
                gp.children.extend([a2, b2])

    def delete(self, rec: int) -> bool:
        mbr = self.gs.mbrs[rec]
        stack = [self.root]
        while stack:
            node = stack.pop()
            if not bool(geom.mbr_intersects(node.mbr, mbr)):
                continue
            if node.is_leaf:
                if rec in node.entries:
                    node.entries.remove(rec)
                    return True
            else:
                stack.extend(node.children)
        return False

    def stats(self) -> dict:
        n_nodes = n_leaf = size = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n_nodes += 1
            size += 32 + 8  # node MBR + header
            if node.is_leaf:
                n_leaf += 1
                size += 40 * len(node.entries)  # entry MBR + id (Boost layout)
            else:
                size += 40 * len(node.children)  # child MBR + pointer
                stack.extend(node.children)
        return {"nodes": n_nodes, "leaf_nodes": n_leaf, "index_bytes": size,
                "total_index_bytes": size}


# ---------------------------------------------------------------------------
# Quad-Tree (GEOS-style: items at deepest fully-containing quadrant)
# ---------------------------------------------------------------------------
class _QNode:
    __slots__ = ("x0", "y0", "x1", "y1", "items", "children")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.items: List[int] = []
        self.children: Optional[List["_QNode"]] = None

    def quadrant(self, mbr) -> int:
        mx = (self.x0 + self.x1) * 0.5
        my = (self.y0 + self.y1) * 0.5
        if mbr[2] <= mx and mbr[3] <= my:
            return 0
        if mbr[0] >= mx and mbr[3] <= my:
            return 1
        if mbr[2] <= mx and mbr[1] >= my:
            return 2
        if mbr[0] >= mx and mbr[1] >= my:
            return 3
        return -1  # straddles a midline: stays at this node

    def child_box(self, q: int):
        mx = (self.x0 + self.x1) * 0.5
        my = (self.y0 + self.y1) * 0.5
        return [(self.x0, self.y0, mx, my), (mx, self.y0, self.x1, my),
                (self.x0, my, mx, self.y1), (mx, my, self.x1, self.y1)][q]


class QuadTree:
    MAX_ITEMS = 8
    MAX_DEPTH = 24

    def __init__(self, gs: GeometrySet):
        self.gs = gs
        self.root = _QNode(0.0, 0.0, 1.0, 1.0)

    @classmethod
    def build(cls, gs: GeometrySet) -> "QuadTree":
        self = cls(gs)
        x0 = float(gs.mbrs[:, 0].min()) if len(gs) else 0.0
        y0 = float(gs.mbrs[:, 1].min()) if len(gs) else 0.0
        x1 = float(gs.mbrs[:, 2].max()) if len(gs) else 1.0
        y1 = float(gs.mbrs[:, 3].max()) if len(gs) else 1.0
        self.root = _QNode(x0, y0, x1, y1)
        for rec in range(len(gs)):
            self.insert(rec)
        return self

    def insert(self, rec: int) -> None:
        mbr = self.gs.mbrs[rec]
        node, depth = self.root, 0
        while True:
            if node.children is None:
                if len(node.items) < self.MAX_ITEMS or depth >= self.MAX_DEPTH:
                    node.items.append(rec)
                    return
                node.children = [_QNode(*node.child_box(q)) for q in range(4)]
                stay: List[int] = []
                for it in node.items:
                    q = node.quadrant(self.gs.mbrs[it])
                    (stay if q < 0 else node.children[q].items).append(it)
                node.items = stay
            q = node.quadrant(mbr)
            if q < 0:
                node.items.append(rec)
                return
            node = node.children[q]
            depth += 1

    def delete(self, rec: int) -> bool:
        mbr = self.gs.mbrs[rec]
        node = self.root
        while node is not None:
            if rec in node.items:
                node.items.remove(rec)
                return True
            if node.children is None:
                return False
            q = node.quadrant(mbr)
            if q < 0:
                return False
            node = node.children[q]
        return False

    def probe(self, window: np.ndarray, st: QueryStats) -> np.ndarray:
        out: List[int] = []
        gs_mbrs = self.gs.mbrs
        stack = [self.root]
        while stack:
            node = stack.pop()
            if (node.x1 < window[0] or window[2] < node.x0
                    or node.y1 < window[1] or window[3] < node.y0):
                st.leaves_skipped += 1
                continue
            st.leaves_visited += 1
            if node.items:
                e = np.asarray(node.items)
                hit = geom.mbr_intersects(gs_mbrs[e], window[None, :])
                out.extend(e[hit].tolist())
            if node.children is not None:
                stack.extend(node.children)
        return np.asarray(out, np.int64)

    def query(self, window: np.ndarray, relation: str = "contains",
              stats: Optional[QueryStats] = None) -> np.ndarray:
        st = stats if stats is not None else QueryStats()
        window = np.asarray(window, np.float64)
        rel = get_relation(relation)
        cand = self.probe(rel.probe_window(window), st)
        st.candidates += int(cand.shape[0])
        res = _refine(self.gs, cand, window, relation, st)
        st.results = int(res.shape[0])
        return res

    def stats(self) -> dict:
        n_nodes = size = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n_nodes += 1
            size += 32 + 4 * 8 + 8  # box + 4 child ptrs + header
            size += 8 * len(node.items)
            if node.children is not None:
                stack.extend(node.children)
        return {"nodes": n_nodes, "index_bytes": size, "total_index_bytes": size}


# ---------------------------------------------------------------------------
# Sorted array + binary search (GLIN-without-the-model ablation)
# ---------------------------------------------------------------------------
class SortedArray:
    def __init__(self, gs: GeometrySet, piece_limitation: int = 10000):
        self.gs = gs
        zmin, zmax = mbr_to_zinterval_np(gs.mbrs, gs.grid)
        order = np.argsort(zmin, kind="stable")
        self.keys = zmin[order]
        self.recs = order.astype(np.int64)
        self.pw = PiecewiseFunction.build(zmin, zmax, piece_limitation)

    @classmethod
    def build(cls, gs: GeometrySet, piece_limitation: int = 10000) -> "SortedArray":
        return cls(gs, piece_limitation)

    def query(self, window: np.ndarray, relation: str = "contains",
              stats: Optional[QueryStats] = None) -> np.ndarray:
        st = stats if stats is not None else QueryStats()
        window = np.asarray(window, np.float64)
        rel = get_relation(relation)
        probe_win = rel.probe_window(window)
        zmin_q, zmax_q = (int(v[0]) for v in
                          mbr_to_zinterval_np(probe_win[None, :],
                                              self.gs.grid))
        if rel.augment:
            zmin_q = self.pw.augment(zmin_q)
        lo = int(np.searchsorted(self.keys, zmin_q, side="left"))
        hi = int(np.searchsorted(self.keys, zmax_q, side="right"))
        cand = self.recs[lo:hi]
        st.candidates += int(cand.shape[0])
        res = _refine(self.gs, cand, window, relation, st)
        st.results = int(res.shape[0])
        return res

    def stats(self) -> dict:
        return {"nodes": 1, "index_bytes": self.pw.nbytes() + 16,
                "total_index_bytes": self.pw.nbytes() + 16}
