"""The CUDA kernels on the card: each against its plain version on the same
inputs, and the facade's kernel paths against its host path.

Every test here is marked ``gpu`` and skips without a card (decided inside
the ``cuda`` fixture). The file imports only the port, so it needs nothing
of the reference: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``. Tolerance: none — the
kernels are built with ``--fmad=false`` and must reproduce the plain
versions' bounds, slot lists, hit layouts and counts exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import device as tdev
from repro_torch.core.datasets import generate, make_query_windows
from repro_torch.core.engine import EngineConfig, QueryBatch, SpatialIndex
from repro_torch.core.geometry import mbrs_of_verts
from repro_torch.core.index import GLINConfig
from repro_torch.core.relations import get_relation
from repro_torch.kernels import refine as kr

RELATIONS = ("intersects", "contains", "covers", "within", "touches",
             "crosses", "dwithin:0.004")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store():
    gs = generate("mixed", 3000, seed=2)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = mbrs_of_verts(gs.verts, gs.nverts)
    lo = gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = gs.mbrs[:, 2:].max(axis=0) + 0.01
    wins = np.concatenate([
        make_query_windows(gs, 0.004, 61, seed=4),
        [[hi[0] + 1, hi[1] + 1, hi[0] + 2, hi[1] + 2],
         [lo[0], lo[1], hi[0], hi[1]]]]).astype(np.float32)
    return gs, wins


def _index(gs, cuda, **cfg):
    return SpatialIndex.build(gs, GLINConfig(piece_limitation=250),
                              EngineConfig(device_min_batch=1,
                                           stale_rebuild_min_batch=1, **cfg),
                              device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("prefilter", ["intersects", "contains"])
def test_count_and_compact_kernels_match_plain(store, cuda, prefilter):
    gs, wins = store
    idx = _index(gs, cuda)
    s = idx.snapshot()
    w = torch.from_numpy(wins).to(cuda)
    rel = get_relation("within" if prefilter == "contains" else "intersects")
    start, end = tdev.batch_query_bounds(s, w, rel.name)
    bounds = torch.stack([start, end], 1)
    bounds[0] = bounds[0].flip(0)          # an inverted run
    n0 = kr.refine_count.launches
    got = kr.refine_count(w, bounds, s.slot_rmbr)
    assert kr.refine_count.launches == n0 + 1
    assert torch.equal(got, kr.refine_count_plain(w, bounds, s.slot_rmbr))
    for budget in (7, 64, kr.MAX_COMPACT_BUDGET):
        a = kr.refine_compact(w, bounds, s.slot_lmbr, s.slot_rmbr,
                              budget=budget, prefilter=prefilter)
        b = kr.refine_compact_plain(w, bounds, s.slot_lmbr, s.slot_rmbr,
                                    budget, prefilter)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("relation", RELATIONS)
def test_fused_kernel_matches_plain(store, cuda, relation):
    gs, wins = store
    idx = _index(gs, cuda)
    s, pods = idx.snapshot(), idx._device_payload()
    w = torch.from_numpy(wins).to(cuda)
    for budget in (8, 256):
        n0 = kr.refine_fused.launches
        a = tdev.batch_query_fused(s, w, pods, relation=relation,
                                   exact_budget=budget, mode="kernel")
        assert kr.refine_fused.launches == n0 + 1
        b = tdev.batch_query_fused(s, w, pods, relation=relation,
                                   exact_budget=budget, mode="reference")
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("relation", RELATIONS + ("disjoint",))
def test_facade_kernel_paths_match_host(store, cuda, relation):
    """Default (fused kernel), staged kernel compaction and the plain
    reference all equal the fp64 host path on this fp32-exact store."""
    gs, wins = store
    host = None
    for cfg in ({}, {"fusion": "off"}, {"fusion": "reference"}):
        idx = _index(gs, cuda, exact_budget=16, **cfg)
        res = idx.query(QueryBatch.window(wins, relation))
        assert res.plan.backend == "device"
        if host is None:
            host = idx.query(QueryBatch.window(wins, relation,
                                               backend="host"))
        for a, b in zip(res, host):
            np.testing.assert_array_equal(a, b)
