"""End to end: GLIN spatial-query serving with batched requests.

Builds a 200k-geometry index behind the ``SpatialIndex`` facade and serves
batches of Intersects queries through the ``SpatialQueryServer`` front-end
while interleaved inserts/deletes stream through the same facade — every
mutation is recorded as a delta against the published device snapshot, so
the planner serves the ``device+delta`` backend (snapshot + tombstone mask +
added-set check, exact at the current epoch) instead of republishing per
write, and republishes only once the delta crosses
``EngineConfig.refresh_threshold``.

    PYTHONPATH=src python -m repro_torch.examples.serve_queries \\
        [--n 200000] [--batches 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import (EngineConfig, GLINConfig, SpatialIndex, generate,
                    make_query_windows)
from ..serve import SpatialQueryServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--selectivity", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    print(f"[serve] building index over {args.n} geometries ...")
    gs = generate("cluster", args.n, seed=0)
    t0 = time.time()
    # augmented Intersects runs are long: two-stage refinement — full-run
    # MBR masks, exact checks on <=1024 survivors; the facade's adaptive
    # cap climbs from initial_cap to the run length once
    index = SpatialIndex.build(
        gs, GLINConfig(piece_limitation=10_000),
        config=EngineConfig(initial_cap=8192, exact_budget=1024,
                            refresh_threshold=4096, delta_patch_max=4096),
        device=args.device)
    server = SpatialQueryServer(index)
    print(f"[serve] built in {time.time()-t0:.1f}s; "
          f"index {index.stats()['total_index_bytes']/1024:.0f} KiB")

    base = make_query_windows(gs, args.selectivity, 64, seed=2)
    rng = np.random.default_rng(3)
    lat = []
    total_hits = 0
    refreshes = 0
    for b in range(args.batches):
        # a fresh batch of query windows (jittered around the base set)
        idx = rng.integers(0, len(base), args.batch_size)
        jitter = rng.normal(0, 1e-4, (args.batch_size, 1))
        windows = base[idx] + jitter * [[1, 1, 1, 1]]
        t0 = time.time()
        res = server.query(windows, "intersects")
        dt = time.time() - t0
        lat.append(dt)
        refreshes += int(res.plan.rebuild_snapshot)
        total_hits += res.total_hits
        # interleaved writes (hybrid workload, paper Fig 17)
        for _ in range(32):
            if rng.random() < 0.7:
                c = rng.uniform(0.1, 0.9, 2)
                ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
                verts = np.stack([c[0] + 2e-4 * np.cos(ang),
                                  c[1] + 2e-4 * np.sin(ang)], -1)
                server.insert(verts, 8, 0)
            else:
                live = np.nonzero(index.glin._live_mask())[0]
                server.delete(int(rng.choice(live)))
        if b % 5 == 0:
            print(f"[serve] batch {b}: {dt*1e3:.1f} ms "
                  f"({args.batch_size/dt:.0f} q/s) "
                  f"[{res.plan.backend}, epoch {res.epoch}]")
    lat = np.array(lat[1:])  # drop the first (warm-up) batch
    qps = args.batch_size / lat.mean()
    st = index.stats()
    print(f"[serve] {args.batches} batches, {total_hits} total hits, "
          f"{server.write_ops} writes, {refreshes} snapshot refreshes")
    print(f"[serve] backends {server.backend_counts}; "
          f"{st['snapshot_publishes']} publishes, "
          f"delta {st['delta_size']} at exit")
    print(f"[serve] p50={np.percentile(lat,50)*1e3:.1f}ms "
          f"p95={np.percentile(lat,95)*1e3:.1f}ms throughput={qps:.0f} "
          "queries/s")
    return {"index": index, "total_hits": total_hits,
            "writes": server.write_ops, "refreshes": refreshes,
            "backends": dict(server.backend_counts),
            "p50_ms": float(np.percentile(lat, 50) * 1e3), "qps": float(qps)}


if __name__ == "__main__":
    main(sys.argv[1:])
