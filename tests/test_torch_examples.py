"""The port's GLIN examples (``repro_torch.examples``) on the CPU at about
2,000 records: each ``main(["--device", "cpu", ...])`` runs to its end (its
own checks raise on a mismatch) and its answers equal the port's fp64 host
path on the same index.
"""
import numpy as np
import pytest
import torch

from repro_torch.examples import distributed_glin, quickstart, serve_queries
from repro_torch.serve import SpatialQueryServer

torch.set_num_threads(1)
N = 2000


def _host(index, windows, relation):
    return index.query(np.atleast_2d(windows), relation, backend="host")


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_quickstart_matches_host_path(capsys):
    out = quickstart.main(["--device", "cpu", "--n", str(N)])
    assert "quickstart done" in capsys.readouterr().out
    index, windows = out["index"], out["windows"]
    assert len(out["hits"]) == 8                  # every relation
    for rel, hits in out["hits"].items():
        _same(hits, _host(index, windows, rel).ids)
    assert out["batched"].plan.backend == "device"
    _same(out["batched"].ids, _host(index, out["big"], "intersects").ids)
    assert out["batched"].total_hits > 0
    assert len(out["knn"].ids[0]) == 10


def test_quickstart_check_raises():
    with pytest.raises(AssertionError, match="oracle"):
        quickstart.check(False, "intersects differs from the brute-force "
                                "oracle")


def test_serve_queries_matches_host_path(monkeypatch):
    """Every served batch equals the host path at the epoch it was served
    (writes interleave between batches)."""
    query = SpatialQueryServer.query
    served = []

    def checked(self, windows, relation="intersects", **kw):
        res = query(self, windows, relation, **kw)
        _same(res.ids, _host(self.index, windows, relation).ids)
        served.append(res.plan.backend)
        return res

    monkeypatch.setattr(SpatialQueryServer, "query", checked)
    out = serve_queries.main(["--device", "cpu", "--n", str(N),
                              "--batches", "5", "--batch-size", "128"])
    assert len(served) == 5 and "device+delta" in served
    assert out["writes"] == 5 * 32 and out["total_hits"] > 0


def test_distributed_glin_matches_host_path():
    out = distributed_glin.main(["--device", "cpu", "--n", str(N)])
    assert out["mesh"].shape == {"data": 4, "model": 2}
    index, windows = out["index"], out["windows"]
    host = _host(index, windows.astype(np.float64), "intersects")
    hits = out["hits"]
    assert hits.shape[:2] == (64, 4) and (out["counts"] >= 0).all()
    got = [np.sort(h[h >= 0]) for h in hits.reshape(64, -1)]
    _same(got, host.ids)
    assert sum(len(g) for g in got) == out["counts"].sum() > 0
