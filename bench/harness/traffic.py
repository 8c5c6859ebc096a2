"""Traffic: a mix file's parameters and a seed give a pool of queries and
the sequence of batches drawn from it.

The mix names its driver (``"kind"``), found by name as
``bench/drivers/<kind>.py``: the driver makes the pool, calls the program,
keeps the answers the check compares and judges them. This module holds
what every driver shares: the batch draws and the query recipes.

Windows follow the GLIN paper's recipe (§IX-A), as the port's
``make_query_windows`` does: pick a random record, take the K =
selectivity * N records whose MBR centres lie nearest to its centre (by the
largest coordinate difference), and use the MBR of those K. The K nearest
come from a k-d tree here; where the K-th distance ties, the tree decides
which tied records are taken, the same way for the same store. kNN points
are the centres of such windows, snapped to float32.

A closed loop of one client: batch ``i`` draws ``batch`` distinct queries
from the pool, and the relation ``relations[i % len(relations)]`` where the
mix has relations.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import spec
from .stores import Store


@dataclasses.dataclass
class Traffic:
    kind: str                  # the driver, bench/drivers/<kind>.py
    batch: int
    pool: int
    relations: List[str]       # cycled batch by batch; none for kNN
    check_rows: int            # rows of each batch the check compares
    profile_batches: int       # batches in the traced stretch
    limits: dict
    raw: dict                  # the whole file, for the driver's own keys

    @classmethod
    def from_json(cls, d: dict) -> "Traffic":
        return cls(kind=d["kind"], batch=int(d["batch"]), pool=int(d["pool"]),
                   relations=list(d.get("relations", [])),
                   check_rows=int(d["check"]["rows_per_batch"]),
                   profile_batches=int(d["profile_batches"]),
                   limits=dict(d["limits"]), raw=dict(d))

    @property
    def driver(self):
        return spec.module("drivers", self.kind)


def query_windows(store: Store, selectivity: float, num: int,
                  seed: int) -> np.ndarray:
    """(num, 4) windows by the paper's recipe (module docstring)."""
    from scipy.spatial import cKDTree

    n = len(store)
    k = min(max(1, int(round(selectivity * n))), n)
    rng = np.random.default_rng(seed + 7)
    anchors = rng.integers(0, n, size=num)
    ctr = np.stack([(store.mbr[:, 0] + store.mbr[:, 2]) * 0.5,
                    (store.mbr[:, 1] + store.mbr[:, 3]) * 0.5], 1)
    _, nearest = cKDTree(ctr).query(ctr[anchors], k=k, p=np.inf)
    nearest = np.asarray(nearest).reshape(num, k)
    m = store.mbr[nearest]                           # (num, k, 4)
    return np.stack([m[..., 0].min(1), m[..., 1].min(1),
                     m[..., 2].max(1), m[..., 3].max(1)], 1)


def knn_points(windows: np.ndarray) -> np.ndarray:
    """The windows' centres, snapped to float32."""
    c = (windows[:, :2] + windows[:, 2:]) / 2
    return c.astype(np.float32).astype(np.float64)


class Batches:
    """The batches of one run: ``next()`` -> (pool rows, relation or None).
    Draws from its own stream of the seed, so the check's sampling cannot
    change the traffic."""

    def __init__(self, traffic: Traffic, seed: int):
        self.t = traffic
        self.rng = np.random.default_rng([seed, 2])
        self.i = 0

    def next(self):
        t = self.t
        rows = self.rng.permutation(t.pool)[:t.batch]
        rel = t.relations[self.i % len(t.relations)] if t.relations else None
        self.i += 1
        return rows, rel
