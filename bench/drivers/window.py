"""Window batches: ``SpatialIndex.query`` over a batch of query windows
under one relation. The pool holds windows by the paper's recipe at the
mix's ``selectivity``, made with seed + ``pool_seed_offset``. The check
compares each sampled row's ids (``check.window_readings``, with the
mix's ``check.band``)."""
from bench.harness import check
from bench.harness.traffic import query_windows
from bench.reference import search


def pool(store, t, seed):
    return {"windows": query_windows(store, float(t.raw["selectivity"]),
                                     t.pool,
                                     seed + int(t.raw["pool_seed_offset"]))}


def warm_batches(t):
    return 2 * len(t.relations)


def call(idx, pool, t, rows, rel):
    from repro_torch.core.engine import QueryBatch

    return idx.query(QueryBatch.window(pool["windows"][rows], rel))


def keep(res, j):
    return res.ids[j].copy()


def reference(grid, pool, t, rows, rels):
    return search.window_answers(grid, pool["windows"][rows], rels)


def judge(grid, pool, t, rows, rels, got):
    return check.window_readings(grid, pool["windows"][rows], rels, got,
                                 float(t.raw["check"]["band"]))
