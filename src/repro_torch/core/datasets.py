"""Synthetic geometry datasets standing in for the paper's Table IV corpora.

Real TIGER / OSM extracts are not available offline; these generators emulate
the distributions the paper evaluates:

* ``uniform``   — SpiderWeb UNIF_S/UNIF_L: polygons uniform over the domain.
* ``diagonal``  — SpiderWeb DIAG_S/DIAG_L: polygons hugging the main diagonal.
* ``cluster``   — OSM-points / PARKS style: Gaussian metro clusters.
* ``roads``     — TIGER ROADS / LINEARWATER style: long, thin, anisotropic
                  polylines.
* ``points``    — OSM_Points: degenerate single-vertex geometries.
* ``concave``   — LAKES/BUILDINGS style simple CONCAVE rings: alternating
                  star polygons and rotated L-shaped rings. Real corpora are
                  dominated by concave geometry; this family exercises the
                  exact (ray-cast / edge-clip) refinement predicates that the
                  convex generators never stress.
* ``rings``     — dense boundary rings with exactly ``max_verts`` vertices
                  (coastline/lake-shore style wide records).
* ``mixed``     — heavy-tailed vertex-count mix: points + short polylines +
                  convex polygons + 64-vertex rings in ONE store. This is the
                  workload where dense ``(N, V, 2)`` padding is pathological
                  (every point pays for the widest ring) and the vertex pool
                  pays off.

Every generator is deterministic in its seed and returns a
:class:`GeometrySet` in CSR vertex-pool layout (see the class docstring).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from .geometry import GeomKind, mbrs_of_verts
from .zorder import ZGrid, UNIT

__all__ = ["GeometrySet", "generate", "make_query_windows", "DATASETS"]


class GeometrySet:
    """A batch of geometries in CSR vertex-pool layout.

    The source of truth is one flat ``pool`` of ``(total_verts, 2)`` float64
    vertices plus per-record ``(offset, nverts)``: record ``r``'s ring is
    ``pool[offsets[r] : offsets[r] + nverts[r]]``. A point record owns one
    pool row, a 64-vertex ring owns 64 — no record pays for the widest
    geometry in the store, and appending a record moves O(record width)
    bytes (amortized), not O(N·V).

    Invariants:

    * ``pool``/``offsets``/``nverts``/``kinds``/``mbrs`` are live views onto
      internal capacity buffers. Growth REPLACES a buffer (never resizes it
      in place) and appends only ever write past the live length, so a view
      taken at time T stays valid and immutable forever — snapshot captures
      rely on this.
    * ``mark_dead`` tombstones a record; its ring stays readable until
      :meth:`compact` (run at republish) rewrites the pool without it and
      repoints the dead record at ``(offset=0, nverts=1)`` — still finite
      and in-bounds for masked device reads.
    * ``verts`` is a backward-compatible DENSE ``(N, maxV, 2)`` view padded
      with the last valid vertex (the pre-pool layout), materialized lazily
      and cached until the next mutation. Assigning ``gs.verts = dense``
      re-imports the dense data back into the pool (same N / nverts).
    * ``bytes_moved`` counts every byte the store copied (appends, buffer
      doublings, compaction) — the maintenance bench and the O(width)
      insert regression test read it.
    """

    def __init__(self, *, nverts, kinds, mbrs, grid: ZGrid,
                 name: str = "synthetic", verts=None, pool=None,
                 offsets=None):
        self.grid = grid
        self.name = name
        nv = np.asarray(nverts, np.int32)
        n = int(nv.shape[0])
        self._n = n
        self._nv = np.array(nv, np.int32)
        self._kinds = np.array(np.asarray(kinds), np.int8)
        self._mbrs = np.array(np.asarray(mbrs), np.float64)
        self._dead = np.zeros(n, bool)
        self._dirty_dead = False
        self.pool_version = 0
        # bumped only when EXISTING pool contents are rewritten (verts
        # setter re-import, compaction) — appends extend the pool without
        # touching live data, so device payload caches key on this instead
        # of pool_version and survive insert bursts between publishes
        self.layout_version = 0
        self.bytes_moved = 0
        self._dense = None
        self._dense_version = -1
        if pool is not None:
            self._pool = np.asarray(pool, np.float64).reshape(-1, 2)
            self._off = np.asarray(offsets, np.int64).reshape(-1).copy()
            self._pool_len = int(self._pool.shape[0])
        elif verts is not None:
            self._import_dense(np.asarray(verts, np.float64))
        else:
            raise TypeError("GeometrySet needs either pool+offsets or verts")

    # -- construction ------------------------------------------------------
    def _import_dense(self, dense: np.ndarray) -> None:
        """Build the CSR pool from a dense padded ``(N, W, 2)`` block."""
        n = self._n
        nv = self._nv[:n].astype(np.int64)
        off = np.zeros(n, np.int64)
        if n:
            np.cumsum(nv[:-1], out=off[1:])
        total = int(nv.sum())
        pool = np.empty((max(total, 1), 2), np.float64)
        if total:
            rec_of = np.repeat(np.arange(n), nv)
            pos = np.arange(total) - np.repeat(off, nv)
            pool[:total] = dense[rec_of, pos]
        else:
            pool[:] = 0.0
        self._pool = pool
        self._off = off
        self._pool_len = max(total, 1) if n else total
        if n == 0:
            self._pool_len = 0

    @classmethod
    def concat(cls, parts: Iterable["GeometrySet"],
               name: str = "concat") -> "GeometrySet":
        parts = list(parts)
        pool = np.concatenate([p.pool for p in parts])
        offs, base = [], 0
        for p in parts:
            offs.append(p.offsets + base)
            base += p.pool.shape[0]
        return cls(pool=pool, offsets=np.concatenate(offs),
                   nverts=np.concatenate([p.nverts for p in parts]),
                   kinds=np.concatenate([p.kinds for p in parts]),
                   mbrs=np.concatenate([p.mbrs for p in parts]),
                   grid=parts[0].grid, name=name)

    # -- live views --------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    @property
    def pool(self) -> np.ndarray:
        return self._pool[:self._pool_len]

    @property
    def pool_len(self) -> int:
        return self._pool_len

    @property
    def offsets(self) -> np.ndarray:
        return self._off[:self._n]

    @property
    def nverts(self) -> np.ndarray:
        return self._nv[:self._n]

    @property
    def kinds(self) -> np.ndarray:
        return self._kinds[:self._n]

    @property
    def mbrs(self) -> np.ndarray:
        return self._mbrs[:self._n]

    @mbrs.setter
    def mbrs(self, m) -> None:
        m = np.array(np.asarray(m), np.float64)
        if m.shape != (self._n, 4):
            raise ValueError(f"mbrs shape {m.shape} != ({self._n}, 4)")
        self._mbrs = m

    @property
    def max_nverts(self) -> int:
        return int(self._nv[:self._n].max()) if self._n else 1

    # -- dense compatibility view -----------------------------------------
    @property
    def verts(self) -> np.ndarray:
        """Dense ``(N, maxV, 2)`` padded-with-last-vertex view (cached)."""
        if self._dense is None or self._dense_version != self.pool_version:
            self._dense = self.padded()
            self._dense_version = self.pool_version
        return self._dense

    @verts.setter
    def verts(self, dense) -> None:
        dense = np.asarray(dense, np.float64)
        if dense.shape[0] != self._n or (self._n and
                                         dense.shape[1] < self.max_nverts):
            raise ValueError(
                f"dense verts {dense.shape} cannot cover {self._n} records "
                f"of up to {self.max_nverts} vertices")
        self._import_dense(dense)
        self.layout_version += 1
        self._touch()

    def padded(self, idx=None, width: Optional[int] = None) -> np.ndarray:
        """Dense ``(len(idx), W, 2)`` gather of a record subset, padded with
        each record's last valid vertex (the device-layout convention)."""
        if idx is None:
            off, nv = self.offsets, self.nverts
        else:
            idx = np.asarray(idx)
            off, nv = self._off[idx], self._nv[idx]
        if off.shape[0] == 0:
            return np.empty((0, width or 1, 2), np.float64)
        w = int(width) if width else max(int(nv.max()), 1)
        j = np.minimum(np.arange(w)[None, :], nv[:, None].astype(np.int64) - 1)
        return self._pool[off[:, None] + j]

    def ring(self, rec: int) -> np.ndarray:
        """The ``(nverts, 2)`` ring of one record (a pool view)."""
        o = int(self._off[rec])
        return self._pool[o : o + int(self._nv[rec])]

    def take(self, idx) -> "GeometrySet":
        idx = np.asarray(idx).reshape(-1)
        counts = self._nv[idx].astype(np.int64)
        starts = self._off[idx]
        total = int(counts.sum())
        off = np.zeros(idx.shape[0], np.int64)
        if idx.shape[0]:
            np.cumsum(counts[:-1], out=off[1:])
        pool = np.empty((max(total, 1), 2), np.float64)
        if total:
            pos = np.arange(total) - np.repeat(off, counts)
            pool[:total] = self._pool[np.repeat(starts, counts) + pos]
        else:
            pool[:] = 0.0
        return GeometrySet(pool=pool[:max(total, 1)], offsets=off,
                           nverts=self._nv[idx], kinds=self._kinds[idx],
                           mbrs=self._mbrs[idx], grid=self.grid,
                           name=self.name)

    # -- sizes -------------------------------------------------------------
    def nbytes(self) -> int:
        """Live store bytes in the CSR pool layout."""
        return (self.pool.nbytes + self.offsets.nbytes + self.nverts.nbytes
                + self.kinds.nbytes + self.mbrs.nbytes)

    def dense_nbytes(self) -> int:
        """What the pre-pool dense ``(N, maxV, 2)`` layout would cost."""
        return (self._n * self.max_nverts * 16 + self.nverts.nbytes
                + self.kinds.nbytes + self.mbrs.nbytes)

    # -- mutation ----------------------------------------------------------
    def _touch(self) -> None:
        self.pool_version += 1
        self._dense = None

    def reserve(self, num_records: int, num_verts: int) -> None:
        """Pre-grow capacity buffers (does not change live contents)."""
        if num_verts > self._pool.shape[0]:
            self._grow_pool(num_verts)
        if num_records > self._off.shape[0]:
            self._grow_records(num_records)

    def _grow_pool(self, need: int) -> None:
        cap = max(need, 2 * self._pool.shape[0], 64)
        new = np.empty((cap, 2), np.float64)
        new[:self._pool_len] = self._pool[:self._pool_len]
        self.bytes_moved += self._pool_len * 16
        self._pool = new

    def _grow_records(self, need: int) -> None:
        cap = max(need, 2 * self._off.shape[0], 64)
        n = self._n

        def grow(buf, dtype, cols=None):
            shape = (cap,) if cols is None else (cap, cols)
            new = np.zeros(shape, dtype)
            new[:n] = buf[:n]
            self.bytes_moved += buf[:n].nbytes
            return new

        self._off = grow(self._off, np.int64)
        self._nv = grow(self._nv, np.int32)
        self._kinds = grow(self._kinds, np.int8)
        self._mbrs = grow(self._mbrs, np.float64, 4)
        self._dead = grow(self._dead, bool)

    def append(self, verts, nverts: int, kind: int, mbr=None) -> int:
        """Append one record; O(record width) bytes moved, amortized."""
        w = int(nverts)
        ring = np.asarray(verts, np.float64).reshape(-1, 2)[:w]
        if ring.shape[0] != w or w < 1:
            raise ValueError(f"need {nverts} vertices, got {ring.shape[0]}")
        if self._pool_len + w > self._pool.shape[0]:
            self._grow_pool(self._pool_len + w)
        if self._n + 1 > self._off.shape[0]:
            self._grow_records(self._n + 1)
        self._pool[self._pool_len : self._pool_len + w] = ring
        self.bytes_moved += w * 16
        rec = self._n
        self._off[rec] = self._pool_len
        self._nv[rec] = w
        self._kinds[rec] = np.int8(kind)
        if mbr is None:
            mbr = mbrs_of_verts(ring[None], np.asarray([w], np.int32))[0]
        self._mbrs[rec] = np.asarray(mbr, np.float64)
        self._dead[rec] = False
        self.bytes_moved += 8 + 4 + 1 + 32
        self._pool_len += w
        self._n += 1
        self._touch()
        return rec

    def mark_dead(self, rec: int) -> None:
        """Tombstone a record's storage; reclaimed at the next compact()."""
        if not self._dead[rec]:
            self._dead[rec] = True
            self._dirty_dead = True

    @property
    def dead_count(self) -> int:
        return int(self._dead[:self._n].sum())

    def compact(self) -> int:
        """Rewrite the pool without dead records' rings; returns bytes
        reclaimed. Record ids are stable: a dead record keeps its id and is
        repointed at ``(offset=0, nverts=1)`` — finite, in-bounds data for
        masked reads. Replaces (never mutates) the offset/nverts buffers so
        previously captured views stay consistent."""
        if not self._dirty_dead:
            return 0
        n = self._n
        dead = self._dead[:n]
        live_idx = np.nonzero(~dead)[0]
        counts = self._nv[live_idx].astype(np.int64)
        starts = self._off[live_idx]
        total = int(counts.sum())
        pool = np.empty((max(total, 1), 2), np.float64)
        seg = np.zeros(live_idx.shape[0], np.int64)
        if live_idx.shape[0]:
            np.cumsum(counts[:-1], out=seg[1:])
        if total:
            pos = np.arange(total) - np.repeat(seg, counts)
            pool[:total] = self._pool[np.repeat(starts, counts) + pos]
        else:
            pool[:] = 0.0
        self.bytes_moved += total * 16
        reclaimed = (self._pool_len - max(total, 1)) * 16
        off = np.zeros(n, np.int64)
        off[live_idx] = seg
        nv = np.ones(n, np.int32)
        nv[live_idx] = self._nv[live_idx]
        self._pool = pool
        self._pool_len = max(total, 1)
        self._off = off
        self._nv = nv
        self._dirty_dead = False
        self.layout_version += 1
        self._touch()
        return max(reclaimed, 0)


def _convex_polygons(rng: np.random.Generator, centers: np.ndarray, sizes: np.ndarray,
                     max_verts: int) -> Dict[str, np.ndarray]:
    """Random convex polygons: sorted random angles on a jittered radius."""
    n = centers.shape[0]
    nverts = rng.integers(3, max_verts + 1, size=n).astype(np.int32)
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, size=(n, max_verts)), axis=1)
    radii = sizes[:, None] * rng.uniform(0.5, 1.0, size=(n, max_verts))
    vx = centers[:, 0:1] + radii * np.cos(angles)
    vy = centers[:, 1:2] + radii * np.sin(angles)
    verts = np.stack([vx, vy], axis=-1)
    # Pad: repeat the (nv-1)-th vertex beyond nv.
    idx = np.minimum(np.arange(max_verts)[None, :], nverts[:, None] - 1)
    verts = np.take_along_axis(verts, idx[:, :, None], axis=1)
    return {"verts": verts, "nverts": nverts}


def _concave_polygons(rng: np.random.Generator, centers: np.ndarray,
                      sizes: np.ndarray, max_verts: int) -> Dict[str, np.ndarray]:
    """Simple concave rings: star polygons (alternating outer/inner radius —
    star-shaped about the centre, hence simple) interleaved with randomly
    rotated L-shaped rings. Requires ``max_verts >= 6``."""
    if max_verts < 6:
        raise ValueError(f"concave rings need max_verts >= 6, got {max_verts}")
    n = centers.shape[0]

    # Stars: sorted angles, radius alternating between r and frac*r.
    nverts = (2 * rng.integers(3, max_verts // 2 + 1, size=n)).astype(np.int32)
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, size=(n, max_verts)), axis=1)
    frac = rng.uniform(0.25, 0.5, size=(n, 1))
    radii = np.where(np.arange(max_verts)[None, :] % 2 == 0,
                     sizes[:, None], sizes[:, None] * frac)
    vx = centers[:, 0:1] + radii * np.cos(angles)
    vy = centers[:, 1:2] + radii * np.sin(angles)
    verts = np.stack([vx, vy], axis=-1)

    # L-shaped rings on half the records (reflex corner at (t, t)).
    ell = rng.random(n) < 0.5
    t = rng.uniform(0.25, 0.6, size=n)
    unit = np.zeros((n, 6, 2))
    unit[:, 1] = np.stack([np.ones(n), np.zeros(n)], -1)
    unit[:, 2] = np.stack([np.ones(n), t], -1)
    unit[:, 3] = np.stack([t, t], -1)
    unit[:, 4] = np.stack([t, np.ones(n)], -1)
    unit[:, 5] = np.stack([np.zeros(n), np.ones(n)], -1)
    theta = rng.uniform(0.0, 2 * np.pi, size=n)
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    shifted = (unit - 0.5) * (2.0 * sizes[:, None, None])
    lx = centers[:, 0:1] + shifted[..., 0] * c - shifted[..., 1] * s
    ly = centers[:, 1:2] + shifted[..., 0] * s + shifted[..., 1] * c
    lverts = np.zeros_like(verts)
    lverts[:, :6] = np.stack([lx, ly], axis=-1)
    verts = np.where(ell[:, None, None], lverts, verts)
    nverts = np.where(ell, np.int32(6), nverts).astype(np.int32)

    idx = np.minimum(np.arange(max_verts)[None, :], nverts[:, None] - 1)
    verts = np.take_along_axis(verts, idx[:, :, None], axis=1)
    return {"verts": verts, "nverts": nverts}


def _polylines(rng: np.random.Generator, starts: np.ndarray, steps: np.ndarray,
               max_verts: int, anisotropy: float) -> Dict[str, np.ndarray]:
    """Random-walk polylines with a persistent heading (road-like)."""
    n = starts.shape[0]
    nverts = rng.integers(2, max_verts + 1, size=n).astype(np.int32)
    heading = rng.uniform(0.0, 2 * np.pi, size=(n, 1))
    wiggle = rng.normal(0.0, 0.25, size=(n, max_verts)).cumsum(axis=1)
    theta = heading + wiggle
    dx = np.cos(theta) * steps[:, None] * anisotropy
    dy = np.sin(theta) * steps[:, None]
    vx = starts[:, 0:1] + np.concatenate(
        [np.zeros((n, 1)), dx[:, :-1].cumsum(axis=1)], axis=1)
    vy = starts[:, 1:2] + np.concatenate(
        [np.zeros((n, 1)), dy[:, :-1].cumsum(axis=1)], axis=1)
    verts = np.stack([vx, vy], axis=-1)
    idx = np.minimum(np.arange(max_verts)[None, :], nverts[:, None] - 1)
    verts = np.take_along_axis(verts, idx[:, :, None], axis=1)
    return {"verts": verts, "nverts": nverts}


def generate(name: str, n: int, seed: int = 0, max_verts: int = 12,
             grid: Optional[ZGrid] = None) -> GeometrySet:
    """Build a synthetic dataset. Domain is the unit square."""
    rng = np.random.default_rng(seed)
    grid = grid or UNIT
    kinds = np.full(n, int(GeomKind.POLYGON), np.int8)

    if name == "uniform":
        centers = rng.uniform(0.02, 0.98, size=(n, 2))
        sizes = rng.uniform(1e-5, 4e-4, size=n)
        parts = _convex_polygons(rng, centers, sizes, max_verts)
    elif name == "diagonal":
        t = rng.uniform(0.02, 0.98, size=n)
        off = rng.normal(0.0, 0.01, size=(n, 2))
        centers = np.clip(np.stack([t, t], axis=1) + off, 0.001, 0.999)
        sizes = rng.uniform(1e-5, 4e-4, size=n)
        parts = _convex_polygons(rng, centers, sizes, max_verts)
    elif name == "cluster":
        k = 32
        mus = rng.uniform(0.05, 0.95, size=(k, 2))
        sig = rng.uniform(0.004, 0.03, size=k)
        comp = rng.integers(0, k, size=n)
        centers = np.clip(
            mus[comp] + rng.normal(0, 1, (n, 2)) * sig[comp][:, None],
            0.001, 0.999)
        sizes = rng.uniform(1e-5, 3e-4, size=n)
        parts = _convex_polygons(rng, centers, sizes, max_verts)
    elif name == "roads":
        starts = rng.uniform(0.02, 0.98, size=(n, 2))
        steps = rng.uniform(2e-5, 2e-4, size=n)
        parts = _polylines(rng, starts, steps, max_verts, anisotropy=3.0)
        kinds = np.full(n, int(GeomKind.POLYLINE), np.int8)
    elif name == "concave":
        centers = rng.uniform(0.02, 0.98, size=(n, 2))
        sizes = rng.uniform(5e-5, 5e-4, size=n)
        parts = _concave_polygons(rng, centers, sizes, max_verts)
    elif name == "points":
        centers = rng.uniform(0.0, 1.0, size=(n, 2))
        parts = {"verts": centers[:, None, :],
                 "nverts": np.ones(n, np.int32)}
    elif name == "rings":
        # Dense boundary rings with exactly max_verts vertices each.
        centers = rng.uniform(0.02, 0.98, size=(n, 2))
        sizes = rng.uniform(5e-5, 5e-4, size=n)
        angles = np.sort(rng.uniform(0.0, 2 * np.pi, (n, max_verts)), axis=1)
        radii = sizes[:, None] * rng.uniform(0.7, 1.0, (n, max_verts))
        parts = {"verts": np.stack(
                     [centers[:, 0:1] + radii * np.cos(angles),
                      centers[:, 1:2] + radii * np.sin(angles)], -1),
                 "nverts": np.full(n, max_verts, np.int32)}
    elif name == "mixed":
        # Heavy-tailed vertex counts in one store: ~45% single-vertex
        # points, 25% short polylines, 20% mid-width (concave) polygons, 10%
        # 64-vertex rings. Mean width ~8, max 64 — dense padding makes every
        # point pay 64 slots.
        n_ring = max(n // 10, 1)
        n_poly = max(n // 5, 1)
        n_road = max(n // 4, 1)
        n_pts = max(n - n_ring - n_poly - n_road, 1)
        gs = GeometrySet.concat(
            [generate("points", n_pts, seed=seed + 1, grid=grid),
             generate("roads", n_road, seed=seed + 2, max_verts=8, grid=grid),
             generate("concave", n_poly, seed=seed + 3, max_verts=12,
                      grid=grid),
             generate("rings", n_ring, seed=seed + 4, max_verts=64,
                      grid=grid)],
            name="mixed")
        # shuffle so the families interleave in Zmin order too
        return gs.take(rng.permutation(len(gs)))
    else:
        raise ValueError(f"unknown dataset {name!r}")

    verts = np.clip(parts["verts"], 0.0, 1.0 - 1e-12)
    mbrs = mbrs_of_verts(verts, parts["nverts"])
    return GeometrySet(verts=verts, nverts=parts["nverts"], kinds=kinds,
                       mbrs=mbrs, grid=grid, name=name)


# Named dataset registry mirroring Table IV (cardinalities scaled to CPU).
DATASETS = {
    "UNIF_S": ("uniform", 1),
    "DIAG_S": ("diagonal", 1),
    "CLUSTER": ("cluster", 2),
    "ROADS": ("roads", 3),
    "POINTS": ("points", 4),
    "CONCAVE": ("concave", 5),
    "MIXED": ("mixed", 6),
}


def make_query_windows(gs: GeometrySet, selectivity: float, num_windows: int,
                       seed: int = 0) -> np.ndarray:
    """Selectivity-matched query windows, following the paper's §IX-A recipe:
    pick a random geometry, take the K = selectivity * N nearest geometries
    (by MBR-centre distance), and use the MBR of that result set.
    Returns (num_windows, 4).

    The K nearest are found through a grid of the centres: the searched
    square of cells around the anchor grows a ring at a time until the K-th
    distance lies inside it, so no record outside is as near. Where the
    K-th distance ties, which of the tied records are taken is decided by
    a pass over every record, so the windows equal that pass's always.
    """
    rng = np.random.default_rng(seed + 7)
    n = len(gs)
    k = max(1, int(round(selectivity * n)))
    cx = (gs.mbrs[:, 0] + gs.mbrs[:, 2]) * 0.5
    cy = (gs.mbrs[:, 1] + gs.mbrs[:, 3]) * 0.5
    windows = np.empty((num_windows, 4), np.float64)
    anchors = rng.integers(0, n, size=num_windows)
    if num_windows == 0:
        return windows
    g = max(1, int(np.sqrt(n / k)))
    x0, y0 = cx.min(), cy.min()
    cell = max(cx.max() - x0, cy.max() - y0, 1e-12) / g * (1 + 1e-9)
    ix = np.minimum(((cx - x0) / cell).astype(np.int64), g - 1)
    iy = np.minimum(((cy - y0) / cell).astype(np.int64), g - 1)
    key = iy * g + ix
    order = np.argsort(key, kind="stable")
    start = np.searchsorted(key[order], np.arange(g * g + 1))
    for i, a in enumerate(anchors):
        nearest = None
        # rounding of the cell index may put a record a hair past its
        # cell's edge: a margin far above it, far below any real gap
        tol = 1e-9 * (cell + abs(cx[a]) + abs(cy[a]))
        r = 1
        while True:
            xlo, xhi = max(ix[a] - r, 0), min(ix[a] + r, g - 1)
            ylo, yhi = max(iy[a] - r, 0), min(iy[a] + r, g - 1)
            if xlo == 0 and ylo == 0 and xhi == g - 1 and yhi == g - 1:
                break                    # the square is every record
            cand = np.concatenate([order[start[row * g + xlo]:
                                         start[row * g + xhi + 1]]
                                   for row in range(ylo, yhi + 1)])
            if cand.shape[0] >= k:
                d = np.maximum(np.abs(cx[cand] - cx[a]),
                               np.abs(cy[cand] - cy[a]))
                part = np.argpartition(d, k - 1)
                dk = d[part[k - 1]]
                # every record outside the square lies at least this far
                # (an edge at the domain's bound holds nothing beyond it)
                reach = np.inf
                if xlo > 0:
                    reach = min(reach, cx[a] - (x0 + xlo * cell))
                if xhi < g - 1:
                    reach = min(reach, x0 + (xhi + 1) * cell - cx[a])
                if ylo > 0:
                    reach = min(reach, cy[a] - (y0 + ylo * cell))
                if yhi < g - 1:
                    reach = min(reach, y0 + (yhi + 1) * cell - cy[a])
                if dk < reach - tol:
                    if np.count_nonzero(d <= dk) == k:   # no tie at the K-th
                        nearest = cand[part[:k]]
                    break
            r += 1
        if nearest is None:
            d = np.maximum(np.abs(cx - cx[a]), np.abs(cy - cy[a]))  # Chebyshev
            nearest = np.argpartition(d, k - 1)[:k]
        m = gs.mbrs[nearest]
        windows[i] = (m[:, 0].min(), m[:, 1].min(), m[:, 2].max(), m[:, 3].max())
    return windows
