"""Distributed GLIN on an 8-position mesh (4 data x 2 model).

The production layout: a replicated learned model, a range-partitioned
record table, the query batch split over the model axis — the sharded
window step (``core.distributed.build_glin_query_step``). One controller
drives a grid of torch devices: on the card every position is
``cuda:(i % count)`` (all eight on one card where it has one), on the CPU
(``--device cpu``) every position is ``cpu``.

    PYTHONPATH=src python -m repro_torch.examples.distributed_glin \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core import GLINConfig, SpatialIndex, generate, make_query_windows
from ..core.distributed import (build_glin_query_step, make_mesh,
                                place_table, replicate_model,
                                shard_glin_arrays)


def mesh_devices(device: str, n: int) -> list:
    """The mesh's positions: ``cuda:(i % count)`` on the card, else
    ``device`` at every position."""
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("distributed_glin: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        return [f"cuda:{i % count}" for i in range(n)]
    return [device] * n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    mesh = make_mesh((4, 2), ("data", "model"), mesh_devices(args.device, 8))
    print(f"[dist] mesh {mesh.shape} over {len(mesh.flat)} positions "
          f"({len(mesh.distinct_devices())} device(s))")

    gs = generate("cluster", args.n, seed=0)
    index = SpatialIndex.build(gs, GLINConfig(piece_limitation=5_000),
                               device=mesh.merge_device)
    snap = index.snapshot()                  # current-epoch flattened index
    table_np = shard_glin_arrays(index.glin, 4)

    step = build_glin_query_step(mesh, "intersects", cap=32768)
    windows = make_query_windows(gs, 1e-4, 64, seed=1).astype(np.float32)

    table = place_table(table_np, mesh)
    snaps = replicate_model(snap, mesh)
    w = torch.from_numpy(windows)
    hits, counts = step(snaps, w, table)     # warm-up
    t0 = time.time()
    for _ in range(5):
        hits, counts = step(snaps, w, table)
    if mesh.merge_device.type == "cuda":
        torch.cuda.synchronize(mesh.merge_device)
    dt = (time.time() - t0) / 5

    counts = counts.cpu().numpy()
    hits = hits.cpu().numpy()
    if not (counts >= 0).all():
        raise AssertionError("cap overflow")
    per_shard = counts.sum(axis=0)
    print(f"[dist] {windows.shape[0]} queries in {dt*1e3:.1f} ms "
          f"({windows.shape[0]/dt:.0f} q/s)")
    print(f"[dist] hits per record-shard: {per_shard.tolist()} "
          f"(total {counts.sum()})")
    # cross-check one query against the host path of the facade
    q0 = np.sort(hits[0][hits[0] >= 0])
    host = index.query(windows[0].astype(np.float64), "intersects",
                       backend="host")
    print(f"[dist] query 0: {len(q0)} hits; host agrees: {len(host[0])} "
          f"(fp64 host may differ at window boundaries by design)")
    return {"index": index, "mesh": mesh, "windows": windows, "hits": hits,
            "counts": counts, "ms_per_batch": dt * 1e3}


if __name__ == "__main__":
    main(sys.argv[1:])
