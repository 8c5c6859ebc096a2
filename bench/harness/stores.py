"""Stores, made from a configuration file and a seed.

A configuration lists its parts: each names a record family, found by name
as ``bench/families/<family>.py``, with its share of the records, its seed
offset and the family's sizes; a part with ``"rest": true`` takes what the
others leave. A family draws its centres from a distribution found by name
as ``bench/centres/<dist>.py`` (the part's ``"centres"``). A ``"shuffle"``
store interleaves the parts by a permutation drawn from the seed.
Coordinates are snapped to float32 and every MBR is recomputed from its
ring, so float32 and float64 code read the same coordinates.

A family module has ``make(rng, n, part) -> (verts (n, V, 2) padded with
each ring's last vertex, nverts (n,), kind)``; a distribution module has
``draw(rng, n, params) -> (n, 2)``.

The result is a :class:`Store` of plain numpy arrays in CSR layout: record
``r``'s ring is ``pool[off[r]:off[r] + nv[r]]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import spec

POLYGON, POLYLINE = 0, 1
CLIP_HI = 1.0 - 1e-12


@dataclasses.dataclass
class Store:
    pool: np.ndarray    # (P, 2) float64, float32-representable
    off: np.ndarray     # (N,) int64 ring start
    nv: np.ndarray      # (N,) int32 vertices
    kind: np.ndarray    # (N,) int8 POLYGON or POLYLINE
    mbr: np.ndarray     # (N, 4) float64 [xmin, ymin, xmax, ymax]

    def __len__(self) -> int:
        return int(self.nv.shape[0])

    def padded(self, rec: np.ndarray, width: int) -> np.ndarray:
        """(len(rec), width, 2) rings, each padded with its last vertex."""
        lane = np.minimum(np.arange(width)[None, :],
                          self.nv[rec].astype(np.int64)[:, None] - 1)
        return self.pool[self.off[rec][:, None] + lane]


def pad_last(verts, nverts):
    """``verts`` with each ring's lanes past ``nverts`` set to its last."""
    idx = np.minimum(np.arange(verts.shape[1])[None, :], nverts[:, None] - 1)
    return np.take_along_axis(verts, idx[:, :, None], axis=1)


def centres(rng, n: int, part: dict) -> np.ndarray:
    """(n, 2) centres of a part, from its named distribution."""
    c = part["centres"]
    return spec.module("centres", c["dist"]).draw(rng, n, c)


def part_counts(parts, n: int) -> list:
    """Records of each part: ``n * share[0] // share[1]`` (at least one),
    and the rest for the part marked ``rest``."""
    counts = [0 if p.get("rest") else max(n * int(p["share"][0])
                                          // int(p["share"][1]), 1)
              for p in parts]
    rest = [i for i, p in enumerate(parts) if p.get("rest")]
    if len(rest) > 1:
        raise ValueError("at most one part takes the rest")
    if rest:
        counts[rest[0]] = max(n - sum(counts), 1)
    return counts


def make_store(store_spec: dict, n: int, seed: int) -> Store:
    """The store of configuration ``store_spec`` at ``n`` records."""
    verts_l, nv_l, kind_l = [], [], []
    for p, cnt in zip(store_spec["parts"],
                      part_counts(store_spec["parts"], n)):
        rng = np.random.default_rng(seed + int(p.get("seed_offset", 0)))
        verts, nverts, kind = spec.module("families", p["family"]).make(
            rng, cnt, p)
        verts = np.clip(verts, 0.0, CLIP_HI)
        lane = np.arange(verts.shape[1])[None, :] < nverts[:, None]
        verts_l.append(verts[lane])            # valid vertices, ring order
        nv_l.append(nverts)
        kind_l.append(np.full(cnt, kind, np.int8))
    nv = np.concatenate(nv_l)
    kind = np.concatenate(kind_l)
    pool = np.concatenate(verts_l)
    off = np.zeros(nv.shape[0], np.int64)
    np.cumsum(nv[:-1].astype(np.int64), out=off[1:])
    if store_spec.get("shuffle"):
        perm = np.random.default_rng(seed).permutation(nv.shape[0])
        cnt = nv[perm].astype(np.int64)
        noff = np.zeros_like(off)
        np.cumsum(cnt[:-1], out=noff[1:])
        pos = np.arange(int(cnt.sum())) - np.repeat(noff, cnt)
        pool = pool[np.repeat(off[perm], cnt) + pos]
        nv, kind, off = nv[perm], kind[perm], noff
    pool = pool.astype(np.float32).astype(np.float64)   # float32 snap
    mbr = np.concatenate([np.minimum.reduceat(pool, off, axis=0),
                          np.maximum.reduceat(pool, off, axis=0)], 1)
    return Store(pool=pool, off=off, nv=nv.astype(np.int32), kind=kind,
                 mbr=mbr)
