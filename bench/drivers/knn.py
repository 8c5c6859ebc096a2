"""kNN batches: ``SpatialIndex.query`` over a batch of points at the mix's
``k``. The pool holds the float32-snapped centres of windows by the
paper's recipe at the mix's ``selectivity`` (seed + ``pool_seed_offset``).
The check compares each sampled point's ids and distances
(``check.knn_readings``)."""
from bench.harness import check
from bench.harness.traffic import knn_points, query_windows
from bench.reference import search


def pool(store, t, seed):
    w = query_windows(store, float(t.raw["selectivity"]), t.pool,
                      seed + int(t.raw["pool_seed_offset"]))
    return {"points": knn_points(w)}


def warm_batches(t):
    return 3


def call(idx, pool, t, rows, rel):
    from repro_torch.core.engine import QueryBatch

    return idx.query(QueryBatch.knn(pool["points"][rows], int(t.raw["k"])))


def keep(res, j):
    return res.ids[j].copy(), res.distances[j].copy()


def reference(grid, pool, t, rows, rels):
    ids, d = search.knn_answers(grid, pool["points"][rows], int(t.raw["k"]))
    return list(zip(ids, d))


def judge(grid, pool, t, rows, rels, got):
    return check.knn_readings(grid, pool["points"][rows], int(t.raw["k"]),
                              got)
