"""GLIN — the lightweight learned spatial index (paper §III–§VIII).

Host-side reference system: builds the hierarchical learned model over
Zmin addresses, answers *Contains* / *Intersects* range queries with the
two-step probe + refine algorithm (Alg 1), augments *Intersects* queries with
the piecewise function (Alg 2), and maintains the structure under insertion /
deletion (ALEX-style leaf grow / split / merge).

Device-resident batched querying lives in ``core.device`` (flattened snapshot)
and ``kernels/refine`` (CUDA); both are validated against this class.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import geometry as geom
from .datasets import GeometrySet
from .model import (GLINModelConfig, InternalNode, LeafNode, build_tree,
                    probe, tree_stats)
from .piecewise import PiecewiseFunction
from .relations import get_relation
from .zorder import mbr_to_zinterval_np

__all__ = ["GLINConfig", "GLIN", "QueryStats"]


@dataclasses.dataclass(frozen=True)
class GLINConfig:
    model: GLINModelConfig = GLINModelConfig()
    piece_limitation: int = 10000
    enable_piecewise: bool = True      # "GLIN-piecewise" vs plain "GLIN"
    record_mbr_prefilter: bool = False  # beyond-paper: record-level MBR test
                                        # before the exact-shape check


@dataclasses.dataclass
class QueryStats:
    """Instrumentation mirroring the paper's reported quantities."""

    candidates: int = 0       # records between probe start and Zmax_Q
    checked: int = 0          # records that underwent the exact-shape check
    leaves_visited: int = 0
    leaves_skipped: int = 0   # skipped via leaf-MBR pruning (§V-C)
    results: int = 0


class GLIN:
    def __init__(self, cfg: GLINConfig = GLINConfig()):
        self.cfg = cfg
        self.root = None
        self.leaves: List[LeafNode] = []
        self.pw: Optional[PiecewiseFunction] = None
        self.gs: Optional[GeometrySet] = None
        self.zmin: Optional[np.ndarray] = None  # per-record, aligned with gs
        self.zmax: Optional[np.ndarray] = None
        self.num_records = 0

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, gs: GeometrySet, cfg: GLINConfig = GLINConfig()) -> "GLIN":
        self = cls(cfg)
        self.gs = gs
        zmin, zmax = mbr_to_zinterval_np(gs.mbrs, gs.grid)
        self.zmin, self.zmax = zmin, zmax
        # Step 1 (§V-A): sort by Zmin; Zmax is dropped from the tree build.
        order = np.argsort(zmin, kind="stable")
        keys = zmin[order]
        recs = order.astype(np.int64)
        # Step 2 (§V-B): hierarchical model.
        self.root, self.leaves = build_tree(keys, recs, cfg.model)
        # Step 3 (§V-C): aggregate MBR per leaf.
        for leaf in self.leaves:
            leaf.set_mbr_from(gs.mbrs[leaf.recs[: leaf.size]])
        # §VIII-B: piecewise function from the transient Zmax-sorted order.
        if cfg.enable_piecewise:
            self.pw = PiecewiseFunction.build(zmin, zmax, cfg.piece_limitation)
        self.num_records = len(gs)
        return self

    # ------------------------------------------------------------------ sizes
    def stats(self) -> Dict:
        st = tree_stats(self.root)
        st["piecewise_bytes"] = self.pw.nbytes() if self.pw else 0
        st["piecewise_pieces"] = self.pw.num_pieces if self.pw else 0
        st["total_index_bytes"] = st["index_bytes"] + st["piecewise_bytes"]
        return st

    # ------------------------------------------------------------------ query
    def query(self, window: np.ndarray, relation: str = "contains",
              stats: Optional[QueryStats] = None) -> np.ndarray:
        """Algorithm 1 for any registered relation. ``window``: (4,)
        [xmin, ymin, xmax, ymax]. Returns record ids satisfying the relation,
        in Zmin order (complement relations: ascending record id)."""
        rel = get_relation(relation)
        window = np.asarray(window, np.float64)
        if rel.complement_of is not None:
            base = self.query(window, rel.complement_of, stats)
            live = np.nonzero(self._live_mask())[0].astype(np.int64)
            res = np.setdiff1d(live, base)
            if stats is not None:
                # candidates/checked/leaves_* honestly describe the base
                # probe's work, but the hit count must be the complement's
                stats.results = int(res.shape[0])
            return res
        # dwithin-style relations probe (and prune leaves with) the window
        # expanded by the relation's pad; the exact predicate still sees the
        # caller's window.
        probe_win = rel.probe_window(window)
        zmin_q, zmax_q = (int(v[0]) for v in
                          mbr_to_zinterval_np(probe_win[None, :],
                                              self.gs.grid))
        if rel.augment:
            if self.pw is None:
                raise ValueError(f"{relation} requires the piecewise function "
                                 "(cfg.enable_piecewise=True)")
            zmin_q = self.pw.augment(zmin_q)  # §VIII query augmentation

        leaf, slot = probe(self.root, zmin_q)
        out: List[np.ndarray] = []
        st = stats if stats is not None else QueryStats()
        gs = self.gs
        while leaf is not None:
            n = leaf.size
            if n == 0 or slot >= n:
                leaf, slot = leaf.next, 0
                continue
            if int(leaf.keys[slot]) > zmax_q:
                break
            # End of the in-range run inside this leaf.
            end = int(np.searchsorted(leaf.keys[:n], zmax_q, side="right"))
            cand = leaf.recs[slot:end]
            st.candidates += int(cand.shape[0])
            # Leaf-MBR pruning (§V-C): skip the node wholesale.
            if not bool(geom.mbr_intersects(leaf.mbr, probe_win)):
                st.leaves_skipped += 1
            else:
                st.leaves_visited += 1
                sel = cand
                if self.cfg.record_mbr_prefilter:
                    keep = rel.mbr_prefilter(gs.mbrs[sel], window[None, :])
                    sel = sel[keep]
                st.checked += int(sel.shape[0])
                if sel.shape[0]:
                    # ragged store: gather only this candidate set's widest
                    # ring, not the global max width
                    ok = rel.predicate(window, gs.padded(sel), gs.nverts[sel],
                                       gs.kinds[sel])
                    hits = sel[ok]
                    if hits.shape[0]:
                        out.append(hits)
            if end < n:
                break  # zmax_q falls inside this leaf
            leaf, slot = leaf.next, 0
        res = np.concatenate(out) if out else np.empty(0, np.int64)
        st.results = int(res.shape[0])
        return res

    def query_bruteforce(self, window: np.ndarray, relation: str = "contains"
                         ) -> np.ndarray:
        """Oracle for correctness tests: exact check on every live record."""
        gs = self.gs
        rel = get_relation(relation)
        window = np.asarray(window, np.float64)
        live = self._live_mask()
        ok = rel.predicate(window, gs.verts, gs.nverts, gs.kinds)
        return np.nonzero(ok & live)[0].astype(np.int64)

    def _live_mask(self) -> np.ndarray:
        live = np.zeros(len(self.gs), bool)
        for leaf in self.leaves:
            live[leaf.recs[: leaf.size]] = True
        return live

    # ------------------------------------------------------------ maintenance
    def insert(self, verts: np.ndarray, nverts: int, kind: int) -> int:
        """Insert one geometry; returns its record id (§VII).

        The CSR vertex pool appends exactly this record's ring — O(width)
        bytes moved (amortized), regardless of how wide the new geometry is
        relative to the rest of the store. Nothing is re-padded and nothing
        is truncated, so the MBR and exact-shape checks always see the full
        input ring."""
        gs = self.gs
        verts = np.asarray(verts, np.float64)
        nverts = int(nverts)
        if verts.ndim != 2 or verts.shape[1] != 2 or not 1 <= nverts <= verts.shape[0]:
            raise ValueError(
                f"verts must be (>=nverts, 2) with nverts >= 1; got "
                f"shape {verts.shape}, nverts={nverts}")
        keep = verts[:nverts]
        mbr = np.array([keep[:, 0].min(), keep[:, 1].min(),
                        keep[:, 0].max(), keep[:, 1].max()])
        rec = gs.append(keep, nverts, kind, mbr)
        zmin, zmax = mbr_to_zinterval_np(mbr[None, :], gs.grid)
        zmin, zmax = int(zmin[0]), int(zmax[0])
        self.zmin = np.append(self.zmin, np.int64(zmin))
        self.zmax = np.append(self.zmax, np.int64(zmax))

        leaf, slot = probe(self.root, zmin)
        leaf.insert_at(slot, zmin, rec)
        leaf.expand_mbr(mbr)  # §VII: expand, never shrink
        self._maybe_split(leaf)
        if self.pw is not None:
            self.pw.insert(zmin, zmax)
        self.num_records += 1
        return rec

    def delete(self, rec: int) -> bool:
        """Delete a record by id (paper: by geometry key; several geometries
        may share a Zmin — only the matching record is erased)."""
        zmin = int(self.zmin[rec])
        leaf, slot = probe(self.root, zmin)
        n = leaf.size
        # scan the duplicate-key run for the matching record id
        pos = -1
        j = slot
        while j < n and int(leaf.keys[j]) == zmin:
            if int(leaf.recs[j]) == rec:
                pos = j
                break
            j += 1
        if pos < 0:
            return False
        leaf.delete_at(pos)
        # MBR intentionally NOT shrunk (§VII) — stale MBRs only add false
        # positives, never true negatives. The store tombstones the ring;
        # its pool space is reclaimed by the compaction pass at the next
        # snapshot republish (published snapshots may still read it).
        self.gs.mark_dead(rec)
        self._maybe_merge(leaf)
        if self.pw is not None:
            self.pw.delete(zmin, int(self.zmax[rec]))
        self.num_records -= 1
        return True

    # -- ALEX-style node expansion / splitting / merging (§VII) -------------
    def _maybe_split(self, leaf: LeafNode) -> None:
        cfg = self.cfg.model
        if leaf.size < cfg.max_leaf * 2:
            if leaf.size >= cfg.upper_density * leaf.keys.shape[0]:
                leaf.grow()       # gapped-array expansion
                leaf.refit()
            return
        width = leaf.dhi - leaf.dlo
        if width < cfg.min_split_width:
            leaf.grow()  # unsplittable domain: keep absorbing via expansion
            leaf.refit()
            return
        # Split: replace the leaf with a fanout-2 internal node.
        node = InternalNode(leaf.dlo, leaf.dhi, 2)
        mid = leaf.dlo + width // 2
        n = leaf.size
        cut = int(np.searchsorted(leaf.keys[:n], mid, side="left"))
        gs_mbrs = self.gs.mbrs
        left = LeafNode(leaf.keys[:cut], leaf.recs[:cut], leaf.dlo, mid)
        right = LeafNode(leaf.keys[cut:n], leaf.recs[cut:n], mid, leaf.dhi)
        left.set_mbr_from(gs_mbrs[left.recs[: left.size]])
        right.set_mbr_from(gs_mbrs[right.recs[: right.size]])
        left.parent = right.parent = node
        left.cell, right.cell = 0, 1
        node.children[0], node.children[1] = left, right
        self._replace_child(leaf, node)
        # relink the leaf chain
        idx = self.leaves.index(leaf)
        prev = self.leaves[idx - 1] if idx > 0 else None
        left.next = right
        right.next = leaf.next
        if prev is not None:
            prev.next = left
        self.leaves[idx : idx + 1] = [left, right]

    def _maybe_merge(self, leaf: LeafNode) -> None:
        cfg = self.cfg.model
        parent = leaf.parent
        if (parent is None or parent.fanout != 2
                or leaf.size > cfg.lower_density * cfg.max_leaf):
            return
        sib = parent.children[1 - leaf.cell]
        if not isinstance(sib, LeafNode):
            return
        if leaf.size + sib.size > cfg.max_leaf:
            return
        lo_leaf, hi_leaf = (leaf, sib) if leaf.cell == 0 else (sib, leaf)
        keys = np.concatenate([lo_leaf.keys[: lo_leaf.size],
                               hi_leaf.keys[: hi_leaf.size]])
        recs = np.concatenate([lo_leaf.recs[: lo_leaf.size],
                               hi_leaf.recs[: hi_leaf.size]])
        merged = LeafNode(keys, recs, parent.dlo, parent.dhi)
        # fresh MBR (§VII)
        merged.set_mbr_from(self.gs.mbrs[merged.recs[: merged.size]])
        self._replace_child(parent, merged)
        idx = self.leaves.index(lo_leaf)
        prev = self.leaves[idx - 1] if idx > 0 else None
        merged.next = hi_leaf.next
        if prev is not None:
            prev.next = merged
        self.leaves[idx : idx + 2] = [merged]

    def _replace_child(self, old, new) -> None:
        parent = old.parent
        new.parent = parent
        new.cell = old.cell
        if parent is None:
            self.root = new
        else:
            parent.children[old.cell] = new

    # ---------------------------------------------------------------- helpers
    def all_leaf_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(keys, recs, leaf_start, leaf_mbr) packed over live records, used by
        the device snapshot and by rebuilds."""
        total = sum(lf.size for lf in self.leaves)
        keys = np.empty(total, np.int64)
        recs = np.empty(total, np.int64)
        starts = np.empty(len(self.leaves) + 1, np.int64)
        mbrs = np.empty((len(self.leaves), 4), np.float64)
        off = 0
        for i, lf in enumerate(self.leaves):
            starts[i] = off
            keys[off : off + lf.size] = lf.keys[: lf.size]
            recs[off : off + lf.size] = lf.recs[: lf.size]
            mbrs[i] = lf.mbr
            off += lf.size
        starts[-1] = off
        return keys, recs, starts, mbrs


def initial_knn_radius(glin: GLIN, k: int) -> float:
    """First search radius from global density: expect ~k hits inside it."""
    gs = glin.gs
    n = max(glin.num_records, 1)
    span_x = float(gs.mbrs[:, 2].max() - gs.mbrs[:, 0].min()) or 1.0
    span_y = float(gs.mbrs[:, 3].max() - gs.mbrs[:, 1].min()) or 1.0
    return max(1e-9, float(np.sqrt(span_x * span_y * k / n)))


def knn(glin: GLIN, point, k: int):
    """K-nearest-neighbour query — the paper's stated future work (§XI).

    knn through ``dwithin`` (cf. LISA): the point becomes a degenerate window
    probed with ``dwithin:<r>`` at doubling radii. The candidate set at
    radius r is exactly {geometries with Euclidean distance <= r}, so once k
    candidates lie within r no closer geometry can be missing. Candidates are
    ranked by exact point-to-geometry distance (``geometry.rect_geom_sqdist``;
    0 inside a polygon) under the shared ``geometry.rank_knn`` (distance, id)
    ordering contract. Settled candidates carry across rungs: dwithin radii
    nest, so each rung's candidate set is a superset of the last and only
    NEWLY probed records get an exact-distance evaluation (the PR-4 ladder
    re-ranked the full candidate set every rung). Indexes built without the
    piecewise function fall back to an Intersects probe over the square
    window of half-side r — a superset of the dwithin candidates, so the
    same count-within-r termination rule holds.

    Returns (ids, distances) sorted by (distance, id); fewer than k entries
    when fewer than k records are live (the ladder stops once the candidate
    set covers every record — it can never grow past that).
    """
    gs = glin.gs
    px, py = float(point[0]), float(point[1])
    rect = np.array([px, py, px, py])
    k = int(k)
    if k <= 0 or glin.num_records == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    r = initial_knn_radius(glin, k)

    ids = np.empty(0, np.int64)          # settled candidates (exact distance
    dists = np.empty(0, np.float64)      # computed exactly once per record)
    for _ in range(64):
        if glin.pw is not None:
            cand = glin.query(rect, f"dwithin:{r:.17g}")
        else:
            cand = glin.query(np.array([px - r, py - r, px + r, py + r]),
                              "intersects")
        new = np.setdiff1d(cand, ids, assume_unique=True)
        if new.shape[0]:
            nd = np.sqrt(geom.rect_geom_sqdist(
                rect, gs.padded(new), gs.nverts[new], gs.kinds[new]))
            ids = np.concatenate([ids, new])
            dists = np.concatenate([dists, nd])
        if (int((dists <= r).sum()) >= k
                or cand.shape[0] >= glin.num_records):
            return geom.rank_knn(ids, dists, k)
        r *= 2.0
    raise RuntimeError("knn did not converge")
