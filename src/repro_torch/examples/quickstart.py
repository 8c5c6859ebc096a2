"""GLIN quickstart: the ONE public API — build, query, maintain.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Everything goes through the ``SpatialIndex`` facade::

    from repro_torch.core import SpatialIndex, QueryBatch, generate

    index = SpatialIndex.build(generate("cluster", 100_000, seed=0))
    res = index.query(windows, "intersects")     # 1 or 10k windows; host or
    ids0 = res[0]                                # device picked by the planner
    nn = index.query(QueryBatch.knn([[0.5, 0.5]], k=10))
    rec = index.insert(verts, nverts=8, kind=0)  # bumps the mutation epoch
    index.delete(rec)                            # snapshot rebuilt lazily

Relations: contains, intersects, within, covers, disjoint, touches, crosses
and the parametric ``dwithin:<d>`` (``repro_torch.core.relations``
registry; exact for concave polygons) — plus knn as a query kind. The
device path runs on the card (``--device cuda``, the default) or, with
``--device cpu``, through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import (GLINConfig, QueryBatch, SpatialIndex, generate,
                    make_query_windows, relation_names)
from ..core.relations import RELATIONS


def check(ok: bool, what: str) -> None:
    """Raise on a failed check (also under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    # 1. a synthetic "parks"-like dataset (convex polygons, metro clusters)
    gs = generate("cluster", args.n, seed=0)

    # 2. build the learned index behind the facade (Zmin-sorted hierarchical
    #    model + leaf MBRs + the piecewise augmentation function)
    index = SpatialIndex.build(gs, GLINConfig(piece_limitation=10_000),
                               device=args.device)
    stats = index.stats()
    print(f"index: {stats['nodes']} nodes, "
          f"{stats['total_index_bytes']/1024:.0f} KiB "
          f"({stats['piecewise_pieces']} pieces), "
          f"data {gs.nbytes()/2**20:.0f} MiB")

    # 3. one entry point, every relation, batched: 5 windows x all relations
    #    (parametric families like dwithin are bound by name: "dwithin:<d>")
    windows = make_query_windows(gs, 0.001, 5, seed=1)
    hits = {}
    for relation in relation_names():
        if RELATIONS[relation].parametric:
            relation = f"{relation}:0.001"
        res = index.query(windows, relation, collect_stats=True)
        st = res.stats[0] if res.stats else None
        extra = (f", {st.checked} exact checks, {st.leaves_skipped} leaves "
                 f"skipped by MBR pruning" if st else "")
        print(f"{relation:10s}: {res.total_hits} hits over {len(res)} windows "
              f"[{res.plan.backend}]{extra}")
        hits[relation] = list(res.ids)

    # 4. big batches take the device path automatically
    big = np.repeat(windows, 64, axis=0)
    res = index.query(big, "intersects")
    print(f"batched   : {len(res)} windows -> {res.total_hits} hits "
          f"[{res.plan.backend}: {res.plan.reason}]")
    batched = res

    # 5. knn is a query kind, not another API
    nn = index.query(QueryBatch.knn([[0.5, 0.5]], k=10))
    print(f"knn       : {len(nn.ids[0])} neighbours, "
          f"d_max={nn.distances[0].max():.4f}")

    # 6. verify against brute force (the library's own oracle)
    check(np.array_equal(index.query(windows[1], "intersects")[0],
                         np.sort(index.glin.query_bruteforce(windows[1],
                                                             "intersects"))),
          "intersects differs from the brute-force oracle")

    # 7. maintenance: insert a new polygon, delete an old record — the
    #    device snapshot is epoch-invalidated and rebuilt lazily, never
    #    served stale
    ang = np.sort(np.random.default_rng(7).uniform(0, 2 * np.pi, 8))
    verts = np.stack([0.5 + 3e-4 * np.cos(ang), 0.5 + 3e-4 * np.sin(ang)], -1)
    rec = index.insert(verts, 8, kind=0)
    check(index.snapshot_is_stale(), "an insert left the snapshot current")
    hit = index.query(np.array([0.49, 0.49, 0.51, 0.51]), "intersects")
    check(rec in hit[0], "the inserted record is not found")
    check(index.delete(rec), "the inserted record could not be deleted")
    print(f"insert/delete ok (epoch {index.epoch}); quickstart done.")
    return {"index": index, "windows": windows, "hits": hits, "big": big,
            "batched": batched, "knn": nn}


if __name__ == "__main__":
    main(sys.argv[1:])
