"""GLIN's hierarchical learned CDF model (paper §V-B, ALEX-style).

Host-side structure used for index build + maintenance:

* **Internal nodes** split their key domain into ``fanout`` equal-width cells
  (the paper: "the model prediction in each internal node has perfect accuracy
  thanks to the uniform partitioning"), holding child pointers per cell.
* **Leaf nodes** hold sorted ``(Zmin, record-id)`` arrays with slack capacity
  (the numpy analogue of ALEX gapped arrays: amortized-O(leaf) memmove
  insertion), a local linear regression model ``Zmin -> slot``, the model's
  exact max error (bounding the exponential-search window), and the
  aggregate **MBR** of the leaf's geometries (§V-C).

Routing arithmetic on 60-bit keys uses Python ints (arbitrary precision) for
scalar ops and ``np.searchsorted`` for bulk ops, so no int64 overflow is
possible. The device-resident flattened snapshot lives in ``device.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["GLINModelConfig", "LeafNode", "InternalNode", "build_tree",
           "probe", "leaves_in_order", "tree_stats"]


@dataclasses.dataclass(frozen=True)
class GLINModelConfig:
    fanout: int = 64            # children per internal node (equal-width cells)
    max_leaf: int = 512         # split a partition bigger than this
    err_bound: int = 64         # re-split leaves whose model error exceeds this
    max_depth: int = 12         # force a leaf beyond this depth
    min_split_width: int = 64   # domains narrower than this are never split
    upper_density: float = 0.8  # leaf grows/splits above this fill factor
    lower_density: float = 0.2  # leaf merges below this fill factor


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------
class LeafNode:
    __slots__ = ("keys", "recs", "size", "slope", "intercept", "key0",
                 "max_err", "mbr", "next", "dlo", "dhi", "parent", "cell")

    def __init__(self, keys: np.ndarray, recs: np.ndarray, dlo: int, dhi: int):
        n = keys.shape[0]
        cap = max(8, int(n / 0.7) + 1)
        self.keys = np.empty(cap, np.int64)
        self.recs = np.empty(cap, np.int64)
        self.keys[:n] = keys
        self.recs[:n] = recs
        self.size = n
        self.dlo = int(dlo)
        self.dhi = int(dhi)
        self.next: Optional["LeafNode"] = None
        self.parent: Optional["InternalNode"] = None
        self.cell: int = -1
        self.mbr = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float64)
        self.refit()

    # -- learned model ------------------------------------------------------
    def refit(self) -> None:
        n = self.size
        if n == 0:
            self.key0, self.slope, self.intercept, self.max_err = 0, 0.0, 0.0, 0
            return
        k = self.keys[:n]
        self.key0 = int(k[0])
        x = (k - k[0]).astype(np.float64)
        y = np.arange(n, dtype=np.float64)
        vx = float(x @ x) - float(x.sum()) ** 2 / n
        if vx <= 0.0:
            self.slope, self.intercept = 0.0, (n - 1) / 2.0
        else:
            cxy = float(x @ y) - float(x.sum()) * float(y.sum()) / n
            self.slope = cxy / vx
            self.intercept = (float(y.sum()) - self.slope * float(x.sum())) / n
        pred = np.rint(self.slope * x + self.intercept)
        self.max_err = int(np.max(np.abs(pred - y))) if n else 0

    def predict_slot(self, key: int) -> int:
        p = int(round(self.slope * float(key - self.key0) + self.intercept))
        return min(max(p, 0), max(self.size - 1, 0))

    def lower_bound(self, key: int) -> int:
        """Model-predicted position + bounded local search (paper §VI-A)."""
        n = self.size
        if n == 0:
            return 0
        p = self.predict_slot(key)
        lo = max(0, p - self.max_err - 1)
        hi = min(n, p + self.max_err + 2)
        pos = lo + int(np.searchsorted(self.keys[lo:hi], key, side="left"))
        # Window-edge validation: fall back to a full-leaf search when the
        # bounded window did not bracket the answer (possible for absent keys).
        if (pos == lo and lo > 0 and self.keys[lo - 1] >= key) or (
            pos == hi and hi < n and self.keys[hi - 1] < key
        ):
            pos = int(np.searchsorted(self.keys[:n], key, side="left"))
        return pos

    # -- MBR maintenance (§V-C / §VII) --------------------------------------
    def set_mbr_from(self, mbrs: np.ndarray) -> None:
        if mbrs.shape[0] == 0:
            self.mbr = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float64)
        else:
            self.mbr = np.array([mbrs[:, 0].min(), mbrs[:, 1].min(),
                                 mbrs[:, 2].max(), mbrs[:, 3].max()], np.float64)

    def expand_mbr(self, mbr: np.ndarray) -> None:
        self.mbr[0] = min(self.mbr[0], mbr[0])
        self.mbr[1] = min(self.mbr[1], mbr[1])
        self.mbr[2] = max(self.mbr[2], mbr[2])
        self.mbr[3] = max(self.mbr[3], mbr[3])

    # -- mutation -----------------------------------------------------------
    def grow(self) -> None:
        cap = max(16, 2 * self.keys.shape[0])
        for name in ("keys", "recs"):
            new = np.empty(cap, np.int64)
            old = getattr(self, name)
            new[: self.size] = old[: self.size]
            setattr(self, name, new)

    def insert_at(self, pos: int, key: int, rec: int) -> None:
        if self.size >= self.keys.shape[0]:
            self.grow()
        self.keys[pos + 1 : self.size + 1] = self.keys[pos : self.size]
        self.recs[pos + 1 : self.size + 1] = self.recs[pos : self.size]
        self.keys[pos] = key
        self.recs[pos] = rec
        self.size += 1

    def delete_at(self, pos: int) -> None:
        self.keys[pos : self.size - 1] = self.keys[pos + 1 : self.size]
        self.recs[pos : self.size - 1] = self.recs[pos + 1 : self.size]
        self.size -= 1

    def metadata_bytes(self) -> int:
        # model (key0, slope, intercept, max_err) + MBR + domain + pointers
        return 8 * 4 + 32 + 16 + 16


class InternalNode:
    __slots__ = ("dlo", "dhi", "children", "parent", "cell")

    def __init__(self, dlo: int, dhi: int, fanout: int):
        self.dlo = int(dlo)
        self.dhi = int(dhi)
        self.children: List[object] = [None] * fanout
        self.parent: Optional["InternalNode"] = None
        self.cell: int = -1

    @property
    def fanout(self) -> int:
        return len(self.children)

    def route(self, key: int) -> int:
        """Equal-width cell of ``key`` — exact integer arithmetic."""
        f = len(self.children)
        idx = (int(key) - self.dlo) * f // (self.dhi - self.dlo)
        return min(max(idx, 0), f - 1)

    def cell_bounds(self, i: int) -> Tuple[int, int]:
        f = len(self.children)
        w = self.dhi - self.dlo
        return self.dlo + w * i // f, self.dlo + w * (i + 1) // f

    def metadata_bytes(self) -> int:
        return 8 * 2 + 8 * len(self.children)


# ---------------------------------------------------------------------------
# Bulk build (paper §V: top-down equal-width partitioning)
# ---------------------------------------------------------------------------
def build_tree(keys: np.ndarray, recs: np.ndarray, cfg: GLINModelConfig):
    """keys must be sorted int64; recs are record ids aligned with keys."""
    assert keys.dtype == np.int64
    n = keys.shape[0]
    if n == 0:
        root = LeafNode(keys, recs, 0, 1)
        return root, [root]

    dlo = int(keys[0])
    dhi = int(keys[-1]) + 1
    leaves: List[LeafNode] = []

    def rec_build(lo: int, hi: int, s: int, e: int, depth: int):
        count = e - s
        width = hi - lo
        make_leaf = (
            count <= cfg.max_leaf
            or depth >= cfg.max_depth
            or width < cfg.min_split_width
        )
        if not make_leaf:
            node = InternalNode(lo, hi, cfg.fanout)
            bounds = [lo + width * i // cfg.fanout for i in range(cfg.fanout + 1)]
            cuts = np.searchsorted(keys[s:e], np.asarray(bounds[1:-1], np.int64),
                                   side="left") + s
            cuts = [s, *cuts.tolist(), e]
            for i in range(cfg.fanout):
                child = rec_build(bounds[i], bounds[i + 1], cuts[i], cuts[i + 1],
                                  depth + 1)
                child.parent, child.cell = node, i
                node.children[i] = child
            return node
        leaf = LeafNode(keys[s:e], recs[s:e], lo, hi)
        # Optional error-driven re-split: an inaccurate leaf becomes internal.
        if (leaf.max_err > cfg.err_bound and count > cfg.fanout
                and width >= cfg.min_split_width and depth < cfg.max_depth):
            node = InternalNode(lo, hi, cfg.fanout)
            bounds = [lo + width * i // cfg.fanout for i in range(cfg.fanout + 1)]
            cuts = np.searchsorted(keys[s:e], np.asarray(bounds[1:-1], np.int64),
                                   side="left") + s
            cuts = [s, *cuts.tolist(), e]
            for i in range(cfg.fanout):
                child = rec_build(bounds[i], bounds[i + 1], cuts[i], cuts[i + 1],
                                  cfg.max_depth)  # children become leaves
                child.parent, child.cell = node, i
                node.children[i] = child
            return node
        leaves.append(leaf)
        return leaf

    root = rec_build(dlo, dhi, 0, n, 0)

    # The recursion appends leaves in key order except when error-driven
    # re-splits interleave; rebuild the ordered list + next pointers by walk.
    ordered = leaves_in_order(root)
    for a, b in zip(ordered, ordered[1:]):
        a.next = b
    if ordered:
        ordered[-1].next = None
    return root, ordered


def leaves_in_order(root) -> List[LeafNode]:
    out: List[LeafNode] = []

    def walk(node):
        if isinstance(node, LeafNode):
            out.append(node)
        else:
            for c in node.children:
                if c is not None:
                    walk(c)

    walk(root)
    return out


def probe(root, key: int) -> Tuple[LeafNode, int]:
    """model_traversal of Algorithm 1: descend to a leaf, then model-predicted
    lower_bound inside it. Returns (leaf, slot)."""
    node = root
    while isinstance(node, InternalNode):
        node = node.children[node.route(key)]
    return node, node.lower_bound(key)


def tree_stats(root) -> dict:
    n_internal = n_leaf = meta = records = 0
    depth_max = 0
    stack = [(root, 1)]
    while stack:
        node, d = stack.pop()
        depth_max = max(depth_max, d)
        if isinstance(node, LeafNode):
            n_leaf += 1
            meta += node.metadata_bytes()
            records += node.size
        else:
            n_internal += 1
            meta += node.metadata_bytes()
            stack.extend((c, d + 1) for c in node.children if c is not None)
    return {
        "internal_nodes": n_internal,
        "leaf_nodes": n_leaf,
        "nodes": n_internal + n_leaf,
        "index_bytes": meta,
        "records": records,
        "depth": depth_max,
    }
