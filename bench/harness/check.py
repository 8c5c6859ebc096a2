"""The comparison that decides ``correct``.

Each run keeps, for a sample of the rows of every timed batch (drawn from
the seed), what the program answered, and after the window the plain
reference (``bench/reference``, float64) answers the same queries over the
same store.

* Window rows: ``wrong_ids`` counts the ids by which an answer differs
  from the reference's, an id out of ascending order or repeated, and,
  for a batch that raised, every id the reference gives its sampled rows.
  An id that differs is excused where the reference itself decides it
  differently on the window grown and shrunk by ``band`` on every side:
  the record lies within ``band`` of the relation's boundary, where the
  program's float32 arithmetic may round either way. Its limit is 0: the
  store's coordinates are float32 values, so apart from that band the
  answers are exact.
* kNN rows: ``knn_gap`` is the largest distance, over the sampled points
  and the k ranks, between the reference's distance at a rank and either
  the program's distance at that rank or the reference's own distance of
  the record the program put there. A missing, repeated or unknown id, or
  a batch that raised, reads :data:`MISSING`.
"""
from __future__ import annotations

import numpy as np

from ..reference import geometry as geo
from ..reference import search

MISSING = 1e9     # a kNN rank with no valid answer (coordinates lie in [0, 1])


def window_readings(grid, windows, relations, got, band: float) -> dict:
    """``got``: per sampled row the program's ids, or None where its batch
    raised. -> {"wrong_ids", "excused_ids", "ids_checked",
    "rows_checked"}."""
    store = grid.store
    n = len(store)
    key = {}
    for w, rel in zip(map(tuple, windows), relations):
        key.setdefault((w, rel), len(key))
    uniq = list(key)
    want = search.window_answers(grid, np.array([u[0] for u in uniq]),
                                 [u[1] for u in uniq])
    wrong = excused = checked = 0
    odd_w, odd_rec, odd_rel = [], [], []
    for w, rel, ids in zip(map(tuple, windows), relations, got):
        ref = want[key[(w, rel)]]
        checked += ref.shape[0]
        if ids is None:
            wrong += max(ref.shape[0], 1)
            continue
        ids = np.asarray(ids, np.int64)
        wrong += int(np.count_nonzero(np.diff(ids) <= 0))
        diff = np.setxor1d(ids, ref)
        bad = (diff < 0) | (diff >= n)
        wrong += int(bad.sum())
        for r in diff[~bad]:
            odd_w.append(w)
            odd_rec.append(r)
            odd_rel.append(rel)
    if odd_rec:
        rect = np.asarray(odd_w, np.float64)
        rec = np.asarray(odd_rec, np.int64)
        grown = rect + np.array([-band, -band, band, band])
        shrunk = rect + np.array([band, band, -band, -band])
        near = np.zeros(rec.shape[0], bool)
        for rel in set(odd_rel):
            s = np.nonzero(np.asarray(odd_rel, dtype=object) == rel)[0]

            def dec(r, v, nv, kd, rel=rel):
                return geo.decide(rel, r, v, nv, kd)

            near[s] = (geo.over_pairs(dec, store, grown[s], rec[s])
                       != geo.over_pairs(dec, store, shrunk[s], rec[s]))
        excused = int(near.sum())
        wrong += int((~near).sum())
    return {"wrong_ids": wrong, "excused_ids": excused, "ids_checked": checked,
            "rows_checked": len(got)}


def knn_readings(grid, points, k: int, got) -> dict:
    """``got``: per sampled point (ids, distances) of the program, or None
    where its batch raised. -> {"knn_gap", "points_checked"}."""
    store = grid.store
    n = len(store)
    want_ids, want_d = search.knn_answers(grid, points, k)
    gap = 0.0
    pi, rec, slot = [], [], []
    true_d = np.full((len(got), k), np.inf)
    for i, g in enumerate(got):
        if g is None:
            gap = MISSING
            continue
        ids, d = np.asarray(g[0], np.int64), np.asarray(g[1], np.float64)
        m = min(k, n)
        if ids.shape[0] != m or d.shape[0] != m:
            gap = MISSING
            continue
        gap = max(gap, float(np.max(np.abs(d - want_d[i, :m]), initial=0.0)))
        ok = (ids >= 0) & (ids < n)
        if not ok.all() or np.unique(ids).shape[0] != m:
            gap = MISSING
            continue
        pi.append(np.full(m, i))
        rec.append(ids)
        slot.append(np.arange(m))
    if pi:
        pi, rec, slot = map(np.concatenate, (pi, rec, slot))
        true_d[pi, slot] = search.point_distances(store, points[pi], rec)
        fin = np.isfinite(want_d)
        gap = max(gap, float(np.max(np.abs(true_d[pi, slot]
                                           - want_d[pi, slot]),
                                    initial=0.0)
                             if fin[pi, slot].all() else MISSING))
    return {"knn_gap": min(gap, MISSING), "points_checked": len(got)}
