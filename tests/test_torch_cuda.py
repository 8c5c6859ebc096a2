"""The CUDA kernels on the card: each against its plain version on the same
inputs, the facade's kernel paths (window queries and kNN) against its
host path, the LM's decode through both attention kernels (dense), the
SSD scan (mamba2_2p7b) or all three (hymba_1p5b) against its full
forward, the three LM kernels at hymba_1p5b's shapes, and the two attention
kernels at the MoE and stub-frontend families' shapes, with those models
(reduced) through the kernels against their plain path, and training: the
flash and SSD kernels' autograd Functions against autograd of their plain
versions, and a full-width granite_3_2b step (2 layers) through the kernels
against the plain path.

Every test here is marked ``gpu`` and skips without a card (decided inside
the ``cuda`` fixture). The file imports only the port, so it needs nothing
of the reference: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``. Tolerance: none for the GLIN kernels — they are
built with ``--fmad=false`` and must reproduce the plain versions' bounds,
slot lists, hit layouts and counts exactly; the attention kernels sum in
another order than the plain versions (online softmax over key tiles), so
2e-5 in fp32 and 3e-2 in bf16 (absolute), as the reference's kernel tests.
The SSD scan tiles the sequence in 64 steps where its plain version takes
the caller's chunk: 2e-4 / 1e-3 (atol / rtol) in fp32, the reference's
chunk-invariance tolerance, for y and the final state; a bf16 y is two
roundings of such values, so one bf16 step (2^-7 relative) more.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from _leafwalk import slot_walk, spliced_walk
from repro_torch.core import device as tdev
from repro_torch.core.datasets import generate, make_query_windows
from repro_torch.core.engine import EngineConfig, QueryBatch, SpatialIndex
from repro_torch.core.geometry import mbrs_of_verts
from repro_torch.core.index import GLINConfig
from repro_torch.core.relations import get_relation
from repro_torch.configs import get_arch
from repro_torch.kernels import attention as katt
from repro_torch.kernels import knn as kk
from repro_torch.kernels import morton as km
from repro_torch.kernels import refine as kr
from repro_torch.kernels import ssd as kssd
from repro_torch.models import attention as mattn
from repro_torch.models import transformer as tf

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
    # count: the snapshot's walk, spliced empty leaves, slot-as-leaf mode;
    # on the probe runs and on mid-leaf and whole-table runs
    for case, runs in {"inverted": bounds, **_walk_cases(s, w, 5)}.items():
        want = kr.refine_count_plain(w, runs, s.slot_rmbr)
        for name, leaves in (("leaves", s.leaf_walk),
                             ("spliced", spliced_walk(s)),
                             ("slot-as-leaf", None)):
            n0 = kr.refine_count.launches
            got = kr.refine_count(w, runs, s.slot_rmbr, leaves=leaves)
            assert kr.refine_count.launches == n0 + 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (case, name)
        assert (want > 0).any()
    for budget in (7, 64, kr.MAX_COMPACT_BUDGET):
        a = kr.refine_compact(w, bounds, s.slot_lmbr, s.slot_rmbr,
                              budget=budget, prefilter=prefilter,
                              leaves=s.leaf_walk)
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


@pytest.mark.gpu
def test_compact_kernel_past_the_fused_budget(store, cuda):
    """Budgets past MAX_COMPACT_BUDGET (the kNN ladder's fat rows)."""
    gs, wins = store
    s = _index(gs, cuda).snapshot()
    w = torch.from_numpy(wins).to(cuda)
    start, end = tdev.batch_query_bounds(s, w, "intersects")
    bounds = torch.stack([start, end], 1)
    for budget in (kr.MAX_COMPACT_BUDGET + 1, 4096):
        n0 = kr.refine_compact.launches
        a = kr.refine_compact(w, bounds, s.slot_lmbr, s.slot_rmbr,
                              budget=budget, leaves=s.leaf_walk)
        assert kr.refine_compact.launches == n0 + 1
        b = kr.refine_compact_plain(w, bounds, s.slot_lmbr, s.slot_rmbr,
                                    budget, "intersects")
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _walk_cases(s, w, seed):
    """Runs that start and end mid-leaf (some inverted, one empty), the
    whole table (padding slots and leaves included) and the probe runs."""
    real = int(s.leaf_start[-1])
    g = np.random.default_rng(seed)
    a = g.integers(0, real, w.shape[0])
    b = g.integers(0, real + 1, w.shape[0])
    mid = torch.from_numpy(np.stack([a, b], 1).astype(np.int32)).to(w.device)
    mid[0] = torch.tensor([7, 7])
    mid[1] = torch.tensor([0, s.num_slots])
    mid[-2] = torch.tensor([0, s.num_slots])     # the far window: no leaf
    start, end = tdev.batch_query_bounds(s, w, "intersects")
    return {"mid-leaf": mid, "probe": torch.stack([start, end], 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("prefilter", ["intersects", "contains"])
def test_compact_walk_matches_plain(store, cuda, prefilter):
    """The group -> leaf -> slot walk against the per-slot plain version:
    runs that start and end mid-leaf, the whole table, a window that meets
    no leaf, survivors past the budget; over the snapshot's leaves, over
    leaves with empty ones spliced in (NaN, inverted and all-covering rows)
    and slot-as-leaf (with and without tables)."""
    gs, wins = store
    s = _index(gs, cuda).snapshot()
    w = torch.from_numpy(wins).to(cuda)
    if prefilter == "contains":   # tiny windows that records can cover
        c = (w[:, :2] + w[:, 2:]) / 2
        w = torch.cat([c, c + 1e-5], 1).contiguous()
    walks = {"leaves": s.leaf_walk, "spliced": spliced_walk(s),
             "slot tables": slot_walk(s.slot_lmbr), "slot-as-leaf": None}
    for case, bounds in _walk_cases(s, w, 11).items():
        for budget in (7, 4096):
            want = kr.refine_compact_plain(w, bounds, s.slot_lmbr,
                                           s.slot_rmbr, budget, prefilter)
            for name, leaves in walks.items():
                n0 = kr.refine_compact.launches
                got = kr.refine_compact(w, bounds, s.slot_lmbr, s.slot_rmbr,
                                        budget=budget, prefilter=prefilter,
                                        leaves=leaves)
                assert kr.refine_compact.launches == n0 + 1
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (case, budget, name)
                assert torch.equal(got[1], want[1]), (case, budget, name)
            if prefilter == "intersects" and budget == 7:
                assert (want[1] > budget).any()
                assert int(want[1][-2]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("relation", RELATIONS)
def test_fused_walk_matches_plain(store, cuda, relation):
    """The fused kernel over the snapshot's leaves and over spliced empty
    leaves, at a budget that overflows (-(survivors) - 1) and one that does
    not."""
    gs, wins = store
    idx = _index(gs, cuda)
    s, pods = idx.snapshot(), idx._device_payload()
    w = torch.from_numpy(wins).to(cuda)
    rel = get_relation(relation)
    qk = torch.stack(tdev._raw_query_keys(s, w, rel), 1)
    ops = (w, rel.probe_window(w).contiguous(), qk, *s.fused_operands,
           pods.headers, pods.pool, s.slot_lmbr, s.slot_rmbr)
    for budget in (8, 256):
        kw = dict(budget=budget, prefilter=rel.prefilter_kind, code=rel.code,
                  dist=rel.dist,
                  augment=bool(rel.augment) and s.pw_zmax_hi.shape[0] > 0,
                  search_steps=s.search_steps, depth=s.depth)
        want = kr.refine_fused_plain(*ops, **kw)
        for leaves in (s.leaf_walk, spliced_walk(s)):
            got = kr.refine_fused(*ops, **kw, leaves=leaves)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        if budget == 8 and rel.prefilter_kind == "intersects":
            assert (want[1] < 0).any()


def _topk_inputs(q, b, seed, cuda):
    """Distance ties, duplicate (d, id) pairs, +inf tails, an all-+inf row,
    zeros of both signs."""
    g = np.random.default_rng(seed)
    d = g.choice(np.float32([0.0, -0.0, 0.25, 0.5, 1.0, 2.0, 3.5]),
                 (q, b)).astype(np.float32)
    d[g.random((q, b)) < 0.3] = np.inf
    ids = g.integers(0, 50, (q, b)).astype(np.int32)
    ids[d == np.inf] = kk.ID_PAD
    d[0], ids[0] = np.inf, kk.ID_PAD
    if b >= 4:
        d[1, :4], ids[1, :4] = 0.5, 7
    if q > 2:
        d[2] = g.random(b).astype(np.float32)
    return torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("q,b,k", [(5, 37, 5), (1024, 256, 10),
                                   (4, 130, 150), (3, 1, 4),
                                   (8, 4096, 100), (3, 1 << 20, 10),
                                   (9, 32 * kk.WARP_MAX_PER_LANE, 100),
                                   (9, 32 * kk.WARP_MAX_PER_LANE + 1, 100)])
def test_knn_topk_kernel_matches_plain(cuda, q, b, k):
    """Both routes (kernels.knn.knn_plan) on either side of the boundary: a
    warp a row up to 32 * WARP_MAX_PER_LANE columns, else a block a row."""
    d, ids = _topk_inputs(q, b, q * 7 + b, cuda)
    n0 = kk.knn_topk.launches
    a = kk.knn_topk(d, ids, k)
    assert kk.knn_topk.launches == n0 + 1
    p = kk.knn_topk_plain(d, ids, k)
    torch.cuda.synchronize()
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])


@pytest.mark.gpu
def test_morton_kernel_matches_plain(cuda):
    g = np.random.default_rng(3)
    lim = (1 << 30) - 1
    qx = torch.from_numpy(np.concatenate(
        [[0, lim, (1 << 15) - 1, 1 << 15],
         g.integers(0, lim + 1, 1_000_003)]).astype(np.int32)).to(cuda)
    qy = torch.from_numpy(np.concatenate(
        [[lim, 0, 1 << 15, (1 << 15) - 1],
         g.integers(0, lim + 1, 1_000_003)]).astype(np.int32)).to(cuda)
    n0 = km.morton_encode.launches
    a = km.morton_encode(qx, qy)
    assert km.morton_encode.launches == n0 + 1
    p = km.morton_encode_plain(qx, qy)
    torch.cuda.synchronize()
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])


@pytest.mark.gpu
def test_mask_kernel_matches_plain(store, cuda):
    """The snapshot's probe runs (one inverted); then the awkward edges: n
    of 4096 k + 5 slots (rows of every alignment, a tail thread), an odd q
    (a short last row chunk), runs that start below 0 and end past n."""
    gs, wins = store
    s = _index(gs, cuda).snapshot()
    w = torch.from_numpy(wins).to(cuda)
    start, end = tdev.batch_query_bounds(s, w, "intersects")
    bounds = torch.stack([start, end], 1)
    bounds[0] = bounds[0].flip(0)          # an inverted run
    n0 = kr.refine_mask.launches
    a = kr.refine_mask(w, bounds, s.slot_rmbr)
    assert kr.refine_mask.launches == n0 + 1
    p = kr.refine_mask_plain(w, bounds, s.slot_rmbr)
    torch.cuda.synchronize()
    assert torch.equal(a, p) and a.any()
    assert torch.equal(a.sum(1, dtype=torch.int32),
                       kr.refine_count(w, bounds, s.slot_rmbr))
    n = 4096 * (s.num_slots // 4096) + 5
    rm = s.slot_rmbr.repeat(2, 1)[:n].contiguous()
    q = w.shape[0] - (1 - w.shape[0] % 2)  # odd
    g = np.random.default_rng(6)
    lo = g.integers(-100, n, q)
    runs = np.stack([lo, lo + g.integers(0, n, q)], 1)
    runs[0], runs[1] = [-9, n + 9], [n - 3, n + 40]
    runs = torch.from_numpy(runs.astype(np.int32)).to(cuda)
    wq = w[:q].clone()
    wq[1] = w[-1]                          # the whole extent: meets the tail
    a = kr.refine_mask(wq, runs, rm)
    p = kr.refine_mask_plain(wq, runs, rm)
    torch.cuda.synchronize()
    assert a.shape == (q, n) and torch.equal(a, p) and a[:, -5:].any()
    assert torch.equal(a.sum(1, dtype=torch.int32),
                       kr.refine_count(wq, runs, rm))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 3500])
def test_knn_facade_kernel_matches_sort_and_host(store, cuda, k):
    """kNN through the facade: the top-k kernel and the compact kernel (the
    default on a card) against the plain sort and the fp64 host ladder; the
    exact budget 16 sends fat rows up the ladder, k=3500 exceeds the live
    records."""
    gs, _ = store
    pts = np.random.default_rng(9).uniform(0.15, 0.85, (40, 2))
    pts = pts.astype(np.float32).astype(np.float64)
    res = {}
    for topk in ("kernel", "sort"):
        idx = _index(gs, cuda, exact_budget=16, knn_topk=topk)
        n0 = (kk.knn_topk.launches, kr.refine_compact.launches)
        res[topk] = idx.query(QueryBatch.knn(pts, k))
        assert res[topk].plan.backend == "device"
        launched = (kk.knn_topk.launches > n0[0],
                    kr.refine_compact.launches > n0[1])
        assert launched == (topk == "kernel", True)
    host = idx.query(QueryBatch.knn(pts, k, backend="host"))
    for i in range(len(pts)):
        np.testing.assert_array_equal(res["kernel"].ids[i],
                                      res["sort"].ids[i])
        np.testing.assert_array_equal(res["kernel"].distances[i],
                                      res["sort"].distances[i])
        got = res["kernel"].ids[i]
        if k > len(gs):
            # every record, ranked: far records whose fp64 distances differ
            # by less than fp32 rounding tie on the card (and order by id)
            got, want = np.sort(got), np.sort(host.ids[i])
        else:
            want = host.ids[i]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(res["kernel"].distances[i],
                                   host.distances[i], rtol=1e-4, atol=1e-7)


ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _att_err(a, p):
    torch.cuda.synchronize()
    assert a.dtype == p.dtype and a.shape == p.shape
    return float((a.float() - p.float()).abs().max())


@pytest.fixture
def entries(monkeypatch):
    """The entry points the attention wrappers launch, in order (each launch
    still goes through)."""
    names, launch = [], katt._launch

    def spy(name, *args):
        names.append(name)
        return launch(name, *args)
    monkeypatch.setattr(katt, "_launch", spy)
    return names


# head dims 16-256 (each through both entry points), groups 1-64 (48 and 64:
# one token a block), S from 1 to 513 (ragged last tiles, one exactly 64),
# windows 1, 5, 16 and 40 (shorter than a key tile) and 64
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,group,s,d,window", [
    (1, 8, 4, 512, 64, 0), (2, 2, 1, 100, 64, 0), (2, 2, 8, 100, 64, 64),
    (1, 1, 48, 70, 128, 0), (3, 2, 3, 130, 128, 64), (1, 4, 4, 1, 64, 0),
    (2, 1, 2, 33, 16, 0), (1, 2, 2, 65, 256, 16), (1, 2, 4, 40, 32, 1),
    (1, 1, 64, 17, 64, 0), (2, 2, 4, 64, 32, 0), (1, 2, 4, 513, 64, 0),
    (1, 1, 48, 513, 128, 40), (1, 2, 1, 513, 256, 0), (1, 2, 4, 17, 16, 5)])
def test_flash_kernel_matches_plain(cuda, entries, dtype, b, hkv, group, s,
                                    d, window):
    g = torch.Generator(device=cuda).manual_seed(s * 7 + d)
    q = torch.randn(b, hkv * group, s, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    n0 = katt.flash_attention.launches
    a = katt.flash_attention(q, k, v, window)
    assert katt.flash_attention.launches == n0 + 1
    assert entries == ["glin_flash_attention_bf16" if dtype == torch.bfloat16
                       else "glin_flash_attention_fp32"]
    assert _att_err(a, katt.flash_attention_plain(q, k, v, window)) < (
        ATT_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_transposed_views(cuda, dtype):
    """The model's (B, S, H, D) activations go in as transposed views; the
    output keeps that layout."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 77, 8, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 77, 2, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 77, 2, 64, device=cuda, generator=g).to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    a = katt.flash_attention(qt, kt, vt, 0)
    assert a.transpose(1, 2).is_contiguous()
    assert _att_err(a, katt.flash_attention_plain(
        qt.contiguous(), kt.contiguous(), vt.contiguous(), 0)) < ATT_TOL[dtype]


def _decode_inputs(cuda, dtype, b, hkv, group, w, d, seed, fresh=0):
    """q and a ring cache (the model's layout, handed in transposed). With
    ``fresh`` = n every row is a new cache at position n: slots 0..n live,
    the rest empty (n below W / split puts every live slot in the first
    block of the cluster). Else positions up to 3 W (rings that wrap), row 0
    with no live slot and row 1 with scattered empty ones."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, hkv * group, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, w, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, w, hkv, d, device=cuda, generator=g).to(dtype)
    slots = torch.arange(w, device=cuda, dtype=torch.int32)[None]
    if fresh:
        pos = torch.full((b,), fresh, device=cuda, dtype=torch.int32)
        ap = torch.where(slots <= fresh, slots, -1).repeat(b, 1)
        return q, k.transpose(1, 2), v.transpose(1, 2), ap.to(torch.int32), pos
    pos = torch.randint(0, 3 * w, (b,), device=cuda, generator=g,
                        dtype=torch.int32)
    ap = slots + w * torch.div(pos[:, None] - slots, w, rounding_mode="floor")
    ap = torch.where(ap <= pos[:, None], ap, -1).to(torch.int32)
    ap[0] = -1                               # a ring with no live slot
    if b > 1:
        ap[1, ::5] = -1                      # scattered empty slots
    return q, k.transpose(1, 2), v.transpose(1, 2), ap, pos


# the granite shape; W below the split (8) and not a multiple of it; group
# 48 and 64; every live slot in the first block's run (fresh = 40 of 1024
# slots over 8 blocks); windowed rings that wrap (W = window = 128 at
# positions up to 384, as the model's windowed cache)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,group,w,d,window,fresh", [
    (8, 8, 4, 1024, 64, 0, 0), (3, 2, 1, 70, 64, 0, 0),
    (3, 2, 8, 70, 64, 64, 0), (2, 1, 48, 100, 128, 0, 0),
    (3, 8, 3, 300, 128, 128, 0), (1, 2, 4, 1, 64, 0, 0),
    (2, 2, 4, 33, 16, 0, 0), (2, 1, 2, 65, 256, 16, 0),
    (4, 4, 5, 129, 32, 7, 0), (2, 2, 4, 5, 32, 0, 0),
    (2, 1, 64, 40, 64, 0, 0), (8, 8, 4, 1024, 64, 0, 40),
    (2, 2, 4, 1000, 128, 0, 3), (8, 2, 4, 128, 64, 128, 0)])
def test_decode_kernel_matches_plain(cuda, dtype, b, hkv, group, w, d,
                                     window, fresh):
    q, k, v, ap, pos = _decode_inputs(cuda, dtype, b, hkv, group, w, d,
                                      w * 3 + d, fresh)
    n0 = katt.decode_attention.launches
    a = katt.decode_attention(q, k, v, ap, pos, window)
    assert katt.decode_attention.launches == n0 + 1
    assert _att_err(a, katt.decode_attention_plain(q, k, v, ap, pos,
                                                   window)) < ATT_TOL[dtype]


@pytest.mark.gpu
def test_decode_kernel_on_an_empty_current_ring(cuda):
    """Every slot empty (abs_pos -1) while pos is current: both versions
    average all W values, as the reference's all -1e30 softmax does."""
    q, k, v, ap, pos = _decode_inputs(cuda, torch.float32, 2, 2, 4, 96, 64,
                                      11)
    ap.fill_(-1)
    a = katt.decode_attention(q, k, v, ap, pos, 0)
    mean = v.float().mean(2).repeat_interleave(4, dim=1)
    assert _att_err(a, katt.decode_attention_plain(q, k, v, ap, pos, 0)) < (
        2e-5)
    assert float((a - mean).abs().max()) < 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,window", [("float32", 0), ("float32", 16),
                                          ("bfloat16", 0)])
def test_lm_decode_matches_forward_through_kernels(cuda, dtype, window):
    """Reduced granite_3_2b on the card: prefill + 6 decode steps through
    both kernels equal the full forward, with one flash launch per layer
    per prefill and one decode launch per layer per step. bf16 logits of
    magnitude ~5: 0.25, as the CPU tests' bf16 case."""
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              dtype=dtype, window=window)
    params = tf.init_params(cfg, 3, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 46), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    tol = (2e-4, 1e-3) if dtype == "float32" else (0.25, 0.0)
    n0 = katt.flash_attention.launches
    last, cache = tf.prefill(params, cfg, {"tokens": toks[:, :40]},
                             seq_len_cache=46)
    assert katt.flash_attention.launches == n0 + cfg.n_layers
    full, _ = tf.forward(params, cfg, {"tokens": toks[:, :40]})
    torch.testing.assert_close(last, full[:, -1], atol=tol[0], rtol=tol[1])
    for t in range(6):
        n0 = katt.decode_attention.launches
        dec, cache = tf.decode_step(params, cfg, {"tokens": toks[:, 40 + t]},
                                    cache)
        assert katt.decode_attention.launches == n0 + cfg.n_layers
        full, _ = tf.forward(params, cfg, {"tokens": toks[:, :41 + t]})
        torch.testing.assert_close(dec, full[:, -1], atol=max(tol[0], 5e-4),
                                   rtol=max(tol[1], 1e-2))


SSD_TOL = dict(atol=2e-4, rtol=1e-3)


def _ssd_inputs(cuda, dtype, b, s, h, p, n, seed, strided=False):
    """x, dt in [0.001, 0.1], a in [-1, -0.1], b, c (tests/test_kernels.py's
    ranges). ``strided``: x, b and c are views into one (B, S, H*P + 2N)
    tensor, as the model's convolution output hands them in."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, s, h * p, device=cuda, generator=g)
    dt = torch.rand(b, s, h, device=cuda, generator=g) * 0.099 + 0.001
    a = -(torch.rand(h, device=cuda, generator=g) * 0.9 + 0.1)
    bm = torch.randn(b, s, n, device=cuda, generator=g)
    cm = torch.randn(b, s, n, device=cuda, generator=g)
    if strided:
        x, bm, cm = torch.cat([x, bm, cm], -1).to(dtype).split([h * p, n, n],
                                                               -1)
    else:
        x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    return x.reshape(b, s, h, p), dt, a, bm, cm


def _ssd_close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = dict(SSD_TOL)
    if got.dtype == torch.bfloat16:
        tol["rtol"] += 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 2, 16, 8, 32), (2, 256, 3, 32, 16, 64), (2, 256, 1, 64, 32, 128),
    (2, 40, 8, 16, 16, 128), (1, 512, 80, 64, 128, 128),
    (1, 100, 3, 64, 128, 100), (3, 1, 2, 16, 8, 128),
    (1, 65, 2, 40, 256, 64), (2, 1100, 2, 72, 24, 128),
    (1, 70, 3, 20, 12, 64)])
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, h, p, n, chunk):
    """y and the final state: the reference's sweep, the reduced widths (P
    16, N 16), the serving shape, S that the 64-step tile does not divide
    (100, 1, 65), P not a multiple of 32 and the largest N; 18 chunks (the
    pass loads 8 chunks at a time) with P over two 64-column blocks and N
    not a multiple of 16; P and N that are not multiples of 8 (bf16 inputs
    staged element by element, not by 16-byte copies)."""
    args = _ssd_inputs(cuda, dtype, b, s, h, p, n, s * 7 + n)
    n0 = kssd.ssd_scan.launches
    y, state = kssd.ssd_scan(*args, chunk, return_state=True)
    assert kssd.ssd_scan.launches == n0 + 1
    want_y, want_state = kssd.ssd_scan_plain(*args, chunk, return_state=True)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    assert torch.equal(kssd.ssd_scan(*args, chunk), y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_strided_views(cuda, dtype):
    """x, b and c as views into the convolution's output (rows of H*P + 2N
    elements) give what contiguous copies give."""
    args = _ssd_inputs(cuda, dtype, 2, 130, 4, 32, 16, 3, strided=True)
    assert not args[0].is_contiguous() and not args[3].is_contiguous()
    y, state = kssd.ssd_scan(*args, return_state=True)
    dense = [t.contiguous() for t in args]
    y2, state2 = kssd.ssd_scan(*dense, return_state=True)
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want_y, want_state = kssd.ssd_scan_plain(*dense, return_state=True)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, a, bm, cm = _ssd_inputs(cuda, torch.float32, 1, 8, 2, 16, 8, 1)
    with pytest.raises(TypeError):
        kssd.ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(TypeError):
        kssd.ssd_scan(x, dt, a, bm.bfloat16(), cm)
    with pytest.raises(ValueError):
        kssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                      a, bm, cm)
    with pytest.raises(ValueError):
        kssd.ssd_scan(x, dt, a, bm.expand(1, 8, 8).transpose(1, 2), cm)
    big = torch.zeros(1, 8, kssd.MAX_STATE + 1, device=cuda)
    with pytest.raises(ValueError):
        kssd.ssd_scan(x, dt, a, big, big)
    with pytest.raises(ValueError):
        kssd.ssd_scan(x, dt, a.cpu(), bm, cm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_forward_through_kernel(cuda, dtype):
    """Reduced mamba2_2p7b on the card: prefill + 6 decode steps (the
    prefill's SSD through the kernel, one launch per layer) equal the full
    forward. bf16 logits of magnitude ~5: 0.25, as the CPU tests' bf16
    case."""
    cfg = dataclasses.replace(get_arch("mamba2_2p7b").reduced(), dtype=dtype)
    params = tf.init_params(cfg, 3, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 46), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    tol = (2e-4, 1e-3) if dtype == "float32" else (0.25, 0.0)
    n0 = kssd.ssd_scan.launches
    last, cache = tf.prefill(params, cfg, {"tokens": toks[:, :40]})
    assert kssd.ssd_scan.launches == n0 + cfg.n_layers
    full, _ = tf.forward(params, cfg, {"tokens": toks[:, :40]})
    torch.testing.assert_close(last, full[:, -1], atol=tol[0], rtol=tol[1])
    for t in range(6):
        dec, cache = tf.decode_step(params, cfg, {"tokens": toks[:, 40 + t]},
                                    cache)
        full, _ = tf.forward(params, cfg, {"tokens": toks[:, :41 + t]})
        torch.testing.assert_close(dec, full[:, -1], atol=max(tol[0], 5e-4),
                                   rtol=max(tol[1], 1e-2))


# ------------------------------------------------------ device+delta writes --
def _writes(idx, rng, n_add=70, deletes=(3, 40, 1500)):
    """The same inserts (1 to 64 vertices, polylines among them) and deletes
    of published records on any facade; returns the added ids."""
    added = []
    for i in range(n_add):
        nv = (1, 2, 5, 9, 17, 64)[i % 6]
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        c, r = rng.uniform(0.2, 0.8, 2), 10 ** rng.uniform(-4, -2)
        ring = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)
        added.append(idx.insert(ring.astype(np.float32).astype(np.float64),
                                nv, 1 if nv in (2, 9) else 0))
    for rec in deletes:
        assert idx.delete(rec)
    return added


@pytest.mark.gpu
def test_device_delta_matches_cpu_plain_path(store, cuda):
    """A stale snapshot with 70 added records (the device DeltaTable) and 3
    tombstones: every relation's device+delta batch on the card (the fused
    kernel, the table check on the card) equals the CPU facade's plain
    path, and kNN with the delta ranked in line equals it too (ids exactly,
    distances to 1e-6)."""
    _, wins = store
    idxs = {}
    for dev in (cuda, torch.device("cpu")):
        g = generate("mixed", 3000, seed=2)
        g.verts = g.verts.astype(np.float32).astype(np.float64)
        g.mbrs = mbrs_of_verts(g.verts, g.nverts)
        idxs[dev.type] = _index(g, dev)
        idxs[dev.type].snapshot()
        _writes(idxs[dev.type], np.random.default_rng(7))
    w = wins.astype(np.float64)
    n0 = kr.refine_fused.launches
    for rel in RELATIONS + ("disjoint",):
        a = idxs["cuda"].query(w, rel)
        b = idxs["cpu"].query(w, rel)
        assert a.plan.backend == b.plan.backend == "device+delta"
        for x, y in zip(a.ids, b.ids):
            np.testing.assert_array_equal(x, y)
        st = {s.stage: s for s in a.stages}["delta-patch"]
        assert (st.delta_added, st.delta_tombstoned) == (70, 3)
    assert kr.refine_fused.launches > n0
    pts = np.random.default_rng(3).uniform(0.2, 0.8, (64, 2))
    n1 = kk.knn_topk.launches
    a = idxs["cuda"].query(QueryBatch.knn(pts, 10))
    b = idxs["cpu"].query(QueryBatch.knn(pts, 10))
    assert a.plan.backend == b.plan.backend == "device+delta"
    assert kk.knn_topk.launches > n1
    for x, y, dx, dy in zip(a.ids, b.ids, a.distances, b.distances):
        np.testing.assert_array_equal(x, y)
        # torch's elementwise distance ops on the card and on the CPU:
        # each op rounds once either way, 1e-6 leaves room for a last bit
        np.testing.assert_allclose(dx, dy, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_async_swap_on_the_card_with_a_held_build(cuda, monkeypatch):
    """The double-buffered republish on the card: the build (on its own
    thread, holding the card as its current device) is held on an event;
    batches served meanwhile are exact against the host path, a mid-build
    delete stays deleted and a mid-build insert stays in the delta after
    the swap."""
    import threading

    from repro_torch.core import engine as teng

    g = generate("mixed", 3000, seed=5)
    g.verts = g.verts.astype(np.float32).astype(np.float64)
    g.mbrs = mbrs_of_verts(g.verts, g.nverts)
    idx = SpatialIndex.build(g, GLINConfig(piece_limitation=250),
                             EngineConfig(device_min_batch=1,
                                          stale_rebuild_min_batch=1,
                                          delta_patch_max=8,
                                          refresh_threshold=8,
                                          async_republish=True),
                             device=cuda)
    idx.snapshot()
    real, release = teng.snapshot_from_capture, threading.Event()
    seen = []

    def held(cap, device):
        if threading.current_thread().name == "glin-republish":
            seen.append(torch.cuda.current_device())
            assert release.wait(60.0), "never released"
        return real(cap, device)

    monkeypatch.setattr(teng, "snapshot_from_capture", held)
    wins = make_query_windows(g, 0.02, 8, seed=6).astype(
        np.float32).astype(np.float64)

    def exact():
        res = idx.query(wins, "intersects")
        for x, y in zip(res.ids,
                        idx.query(wins, "intersects", backend="host").ids):
            np.testing.assert_array_equal(x, y)
        return res

    _writes(idx, np.random.default_rng(9), n_add=9, deletes=())
    pubs = idx.stats()["snapshot_publishes"]
    res = exact()
    assert idx.republish_inflight() and res.plan.backend == "device+delta"
    victim = int(idx.query(wins, "intersects", backend="host")[0][0])
    assert idx.delete(victim)
    c = np.array([wins[0][[0, 2]].mean(), wins[0][[1, 3]].mean()])
    late = idx.insert(np.array([c, c + 1e-4, c + [1e-4, 0]]), 3, 0)
    for _ in range(3):
        exact()
    release.set()
    assert idx._inflight.done.wait(60.0)
    res = exact()
    assert idx.stats()["snapshot_publishes"] == pubs + 1
    assert seen == [cuda.index if cuda.index is not None
                    else torch.cuda.current_device()]
    assert victim not in res[0] and late in res[0]
    assert victim in idx._tombstones and late in idx._added


@pytest.fixture(scope="module")
def padded_store():
    """3,003 records: over the 4 shards of a (4, 2) mesh the last shard
    holds one padding slot."""
    gs = generate("mixed", 3003, seed=8)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = mbrs_of_verts(gs.verts, gs.nverts)
    wins = make_query_windows(gs, 0.004, 32, seed=4).astype(np.float32)
    return gs, wins


def _sharded_index(gs, cuda, **cfg):
    from repro_torch.core.distributed import make_mesh

    mesh = make_mesh((4, 2), ("data", "model"), [cuda] * 8)
    idx = _index(gs, cuda, mesh=mesh, shard_min_records=1,
                 knn_device_min_batch=1, **cfg)
    idx.snapshot()
    return idx


@pytest.mark.gpu
@pytest.mark.parametrize("relation", ["intersects", "within",
                                      "dwithin:0.004"])
@pytest.mark.parametrize("budget", [8, 256])
def test_sharded_window_step_kernel_matches_plain(padded_store, cuda,
                                                  relation, budget):
    """The sharded window step on a (4, 2) mesh of one card: compaction by
    the compact kernel over each shard's walk against the scan, hit for hit
    and code for code (the cap covers every run, so both encode the
    survivors), the padded last shard included."""
    from repro_torch.core import distributed as tdist

    gs, wins = padded_store
    idx = _sharded_index(gs, cuda)
    snaps, table, shards, maxw = idx._sharded_placement()
    last = table.at(shards - 1, idx.config.mesh.merge_device)
    assert (last.recs < 0).any() and last.walk.leaf_mbr.shape[0] >= 2
    w = torch.from_numpy(wins)
    out = {}
    for comp in ("kernel", "scan"):
        n0 = kr.refine_compact.launches
        step = tdist.build_glin_query_step(idx.config.mesh, relation,
                                           cap=4096, exact_budget=budget,
                                           compaction=comp, max_width=maxw)
        out[comp] = step(snaps, w, table)
        torch.cuda.synchronize()
        assert (kr.refine_compact.launches - n0
                == (8 if comp == "kernel" else 0))
    assert torch.equal(out["kernel"][0], out["scan"][0])
    assert torch.equal(out["kernel"][1], out["scan"][1])
    if budget == 8 and relation != "within":   # few records cover a window
        assert (out["kernel"][1] < 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("k,budget", [(10, 256), (20, 8), (10, 0)])
def test_sharded_knn_step_kernel_matches_plain(padded_store, cuda, k,
                                               budget):
    """The sharded kNN step: the compact kernel and the top-k kernel (the
    shard-local top-k and the k-merge) against the scan and the plain sort
    on the same mesh, ids and distances exactly; budget 8 < k pads the
    local columns, budget 0 is the dense path (its rows cap wide: the
    top-k's block route)."""
    from repro_torch.core import distributed as tdist

    gs, wins = padded_store
    idx = _sharded_index(gs, cuda)
    snaps, table, _, maxw = idx._sharded_placement()
    pts = (wins[:, :2] + wins[:, 2:]) / 2
    pw = torch.from_numpy(np.concatenate([pts, pts], 1))
    out = {}
    for comp, topk in (("kernel", "kernel"), ("scan", "sort")):
        n0 = kk.knn_topk.launches
        step = tdist.build_glin_knn_step(idx.config.mesh, "dwithin:0.02", k,
                                         cap=4096, exact_budget=budget,
                                         compaction=comp, max_width=maxw,
                                         topk=topk)
        out[topk] = step(snaps, pw, table)
        torch.cuda.synchronize()
        assert kk.knn_topk.launches - n0 == (9 if topk == "kernel" else 0)
    for a, b in zip(out["kernel"], out["sort"]):
        assert torch.equal(a, b)
    assert (out["kernel"][0] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("relation", RELATIONS + ("disjoint",))
def test_sharded_facade_on_the_card_matches_host(padded_store, cuda,
                                                 relation):
    gs, wins = padded_store
    idx = _sharded_index(gs, cuda, exact_budget=16)
    w = wins.astype(np.float64)
    n0 = kr.refine_compact.launches
    res = idx.query(w, relation)
    assert res.plan.backend == "sharded"
    assert kr.refine_compact.launches > n0
    for x, y in zip(res.ids, idx.query(w, relation, backend="host").ids):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_sharded_knn_facade_on_the_card_matches_host(padded_store, cuda):
    gs, wins = padded_store
    idx = _sharded_index(gs, cuda, exact_budget=16)
    pts = ((wins[:, :2] + wins[:, 2:]) / 2).astype(np.float64)
    n0 = kk.knn_topk.launches
    res = idx.query(QueryBatch.knn(pts, 10))
    assert res.plan.backend == "sharded" and kk.knn_topk.launches > n0
    host = idx.query(QueryBatch.knn(pts, 10, backend="host"))
    for i in range(len(pts)):
        np.testing.assert_array_equal(res.ids[i], host.ids[i])
        np.testing.assert_allclose(res.distances[i], host.distances[i],
                                   rtol=1e-4, atol=1e-7)
    assert res.stages[0].merge_bytes > 0


# ------------------------------------------ ops.refine_fused on the card --
@pytest.mark.gpu
@pytest.mark.parametrize("relation", ("intersects", "contains",
                                      "dwithin:0.004"))
def test_ops_refine_fused_kernel_matches_plain(store, cuda, relation):
    """``ops.refine_fused`` on the snapshot's packed operands: the kernel,
    over the snapshot's walk and over the walk it derives from ``leaf_i``
    and ``leaf_mbrs``, against ``use_kernel=False`` and the facade's fused
    path, exactly."""
    from repro_torch.kernels import ops as kops

    gs, wins = store
    idx = _index(gs, cuda)
    s, pods = idx.snapshot(), idx._device_payload()
    rel = tdev._device_relation(relation)
    w = torch.from_numpy(wins).to(cuda)
    args = (w, rel.probe_window(w), torch.stack(
        tdev._raw_query_keys(s, w, rel), dim=1), *s.fused_operands,
        pods.headers, pods.pool, s.slot_lmbr, s.slot_rmbr)
    kw = dict(budget=64, prefilter=rel.prefilter_kind, code=rel.code,
              dist=rel.dist,
              augment=bool(rel.augment) and s.pw_zmax_hi.shape[0] > 0,
              search_steps=s.search_steps, depth=s.depth)
    want = kops.refine_fused(*args, **kw, use_kernel=False)
    n0 = kr.refine_fused.launches
    got = kops.refine_fused(*args, **kw, leaves=s.leaf_walk)
    derived = kops.refine_fused(*args, **kw)
    assert kr.refine_fused.launches == n0 + 2
    facade = tdev.batch_query_fused(s, w, pods, relation=relation,
                                    exact_budget=64, mode="kernel")
    torch.cuda.synchronize()
    for a in (derived, want, facade):
        assert torch.equal(got[0], a[0]) and torch.equal(got[1], a[1])


# ------------------------------------------------ hymba_1p5b's shapes --
# 25 query heads over 5 kv heads (a group of 5: 12 tokens a flash block, 60
# of its 64 rows), head dim 64, a 1,024-token window, 128 meta tokens ahead
# of a 512-token prompt (640) and of a 1,024-token one (1,152: the window
# slides), and the SSM's 50 heads of 64 with a state of 16
HYMBA = dict(hkv=5, group=5, d=64, window=1024, meta=128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,prompt", [(1, 512), (2, 1024), (1, 3)])
def test_flash_kernel_at_hymba_shapes(cuda, dtype, b, prompt):
    s = prompt + HYMBA["meta"]
    hkv, group, d = HYMBA["hkv"], HYMBA["group"], HYMBA["d"]
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn(b, s, hkv * group, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # the model's views
    n0 = katt.flash_attention.launches
    a = katt.flash_attention(qt, kt, vt, HYMBA["window"])
    assert katt.flash_attention.launches == n0 + 1
    assert katt.flash_plan(b, hkv, group, s, d, dtype)[
        "tokens_per_block"] == 12
    assert _att_err(a, katt.flash_attention_plain(
        qt, kt, vt, HYMBA["window"])) < ATT_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,fresh", [(8, 0), (8, 640), (1, 0)])
def test_decode_kernel_at_hymba_shapes(cuda, dtype, b, fresh):
    """8 slots over a 1,024-slot windowed ring: positions up to 3 W (rings
    that wrap), and fresh rings at 640 (the meta tokens and a 512-token
    prompt)."""
    q, k, v, ap, pos = _decode_inputs(cuda, dtype, b, HYMBA["hkv"],
                                      HYMBA["group"], 1024, HYMBA["d"],
                                      b * 31 + fresh, fresh)
    n0 = katt.decode_attention.launches
    a = katt.decode_attention(q, k, v, ap, pos, HYMBA["window"])
    assert katt.decode_attention.launches == n0 + 1
    assert _att_err(a, katt.decode_attention_plain(
        q, k, v, ap, pos, HYMBA["window"])) < ATT_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 640), (2, 1152), (1, 136)])
def test_ssd_kernel_at_hymba_shapes(cuda, dtype, b, s):
    """50 heads of 64, N = 16 (one 16-wide tile of the state, under the
    pass kernel's 32-wide tile), x/B/C as views of the convolution output."""
    args = _ssd_inputs(cuda, dtype, b, s, 50, 64, 16, s + 16, strided=True)
    n0 = kssd.ssd_scan.launches
    y, state = kssd.ssd_scan(*args, 128, return_state=True)
    assert kssd.ssd_scan.launches == n0 + 1
    want_y, want_state = kssd.ssd_scan_plain(*args, 128, return_state=True)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_matches_forward_through_kernels(cuda, dtype):
    """Reduced hymba_1p5b on the card (8 meta tokens, window 32): prefill
    of 40 tokens (48 with the meta tokens: the ring rolls) + 6 decode steps
    through the three kernels equal the full forward; one flash and one
    SSD launch per layer per prefill, one decode launch per layer per
    step."""
    cfg = dataclasses.replace(get_arch("hymba_1p5b").reduced(), dtype=dtype)
    params = tf.init_params(cfg, 3, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 46), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    tol = (2e-4, 1e-3) if dtype == "float32" else (0.25, 0.0)
    n0 = (katt.flash_attention.launches, kssd.ssd_scan.launches)
    last, cache = tf.prefill(params, cfg, {"tokens": toks[:, :40]},
                             seq_len_cache=64)
    assert (katt.flash_attention.launches, kssd.ssd_scan.launches) == (
        n0[0] + cfg.n_layers, n0[1] + cfg.n_layers)
    full, _ = tf.forward(params, cfg, {"tokens": toks[:, :40]})
    torch.testing.assert_close(last, full[:, -1], atol=tol[0], rtol=tol[1])
    for t in range(6):
        n0 = katt.decode_attention.launches
        dec, cache = tf.decode_step(params, cfg, {"tokens": toks[:, 40 + t]},
                                    cache)
        assert katt.decode_attention.launches == n0 + cfg.n_layers
        full, _ = tf.forward(params, cfg, {"tokens": toks[:, :41 + t]})
        torch.testing.assert_close(dec, full[:, -1], atol=max(tol[0], 5e-4),
                                   rtol=max(tol[1], 1e-2))


# ------------------------ the MoE and stub-frontend families' shapes --
# mixtral_8x22b: 48 query heads over 8 kv heads (a group of 6: 10 tokens a
# flash block, 60 of its 64 rows), head dim 128, a 4,096-token window (a
# 4,608-token prompt binds it; the decode ring of 4,096 slots wraps);
# qwen3_moe_235b: 64 over 4 (a group of 16: 4 tokens a flash block, the
# decode kernel's heads in four passes of 4); qwen2_vl_2b: 12 over 2 (a
# group of 6); musicgen_medium: 24 over 24 at head dim 64 (a group of 1:
# the wgmma kernel at 64 tokens a block)
FAMILY_ATT = {"mixtral": dict(hkv=8, group=6, d=128, window=4096),
              "qwen3": dict(hkv=4, group=16, d=128, window=0),
              "qwen2_vl": dict(hkv=2, group=6, d=128, window=0),
              "musicgen": dict(hkv=24, group=1, d=64, window=0)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model,b,s", [
    ("mixtral", 1, 512), ("mixtral", 1, 4608), ("qwen3", 1, 512),
    ("qwen3", 2, 130), ("qwen2_vl", 2, 512), ("musicgen", 1, 512),
    ("musicgen", 2, 77)])
def test_flash_kernel_at_family_shapes(cuda, dtype, model, b, s):
    m = FAMILY_ATT[model]
    hkv, group, d = m["hkv"], m["group"], m["d"]
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, hkv * group, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # the model's views
    n0 = katt.flash_attention.launches
    a = katt.flash_attention(qt, kt, vt, m["window"])
    assert katt.flash_attention.launches == n0 + 1
    assert katt.flash_plan(b, hkv, group, s, d, dtype)[
        "tokens_per_block"] == 64 // group
    assert _att_err(a, katt.flash_attention_plain(
        qt, kt, vt, m["window"])) < ATT_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model,b,w,fresh", [
    ("mixtral", 8, 4096, 0), ("mixtral", 1, 4096, 0),
    ("mixtral", 8, 4096, 512), ("qwen3", 8, 1024, 0),
    ("qwen3", 8, 1024, 512), ("qwen2_vl", 8, 1024, 0),
    ("musicgen", 8, 1024, 0), ("musicgen", 8, 1024, 512)])
def test_decode_kernel_at_family_shapes(cuda, dtype, model, b, w, fresh):
    """Rings that wrap (positions up to 3 W) and fresh ones at 512 (a
    512-token prompt)."""
    m = FAMILY_ATT[model]
    q, k, v, ap, pos = _decode_inputs(cuda, dtype, b, m["hkv"], m["group"],
                                      w, m["d"], b * 17 + w + fresh, fresh)
    n0 = katt.decode_attention.launches
    a = katt.decode_attention(q, k, v, ap, pos, m["window"])
    assert katt.decode_attention.launches == n0 + 1
    assert _att_err(a, katt.decode_attention_plain(
        q, k, v, ap, pos, m["window"])) < ATT_TOL[dtype]


# bf16 for the stub-frontend models only: in bf16 a near-tie in a MoE
# router can send a token to another expert on one of two paths that
# differ by a rounding (chip_smoke.py reports that share at full width)
@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [
    ("mixtral_8x22b", "float32"), ("qwen3_moe_235b", "float32"),
    ("qwen2_vl_2b", "float32"), ("musicgen_medium", "float32"),
    ("qwen2_vl_2b", "bfloat16"), ("musicgen_medium", "bfloat16")])
def test_family_kernel_path_matches_plain_path(cuda, monkeypatch, arch,
                                               dtype):
    """Reduced models on the card (mixtral's window 32 binds past the
    40-token prompt; qwen2_vl's prompt on a 4 x 4 patch grid of M-RoPE
    positions first): prefill + 6 decode steps through both attention
    kernels (one flash launch a layer, one decode launch a layer a step)
    against the same model with the plain versions in their place, fp32
    at the CPU tests' tolerances, bf16 logits of magnitude ~5 within
    0.25."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    params = tf.init_params(cfg, 3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    if cfg.frontend == "embed_stub":
        emb = torch.randn(2, 46, cfg.d_model, device=cuda, generator=g)
        prompt = {"embeds": emb[:, :40]}
        steps = [{"embeds": emb[:, 40 + t]} for t in range(6)]
        if cfg.mrope:
            pos = torch.arange(40, device=cuda, dtype=torch.int32)
            pos = pos.expand(2, 3, 40).clone()
            pos[:, 0, :16] = 0
            pos[:, 1, :16] = torch.arange(16, device=cuda) // 4
            pos[:, 2, :16] = torch.arange(16, device=cuda) % 4
            prompt["positions"] = pos
    else:
        toks = torch.randint(0, cfg.vocab, (2, 46), device=cuda, generator=g)
        prompt = {"tokens": toks[:, :40]}
        steps = [{"tokens": toks[:, 40 + t]} for t in range(6)]

    def path():
        n0 = (katt.flash_attention.launches, katt.decode_attention.launches)
        last, cache = tf.prefill(params, cfg, prompt, seq_len_cache=64)
        out = [last]
        for step in steps:
            last, cache = tf.decode_step(params, cfg, step, cache)
            out.append(last)
        return out, (katt.flash_attention.launches - n0[0],
                     katt.decode_attention.launches - n0[1])

    got, launched = path()
    assert launched == (cfg.n_layers, 6 * cfg.n_layers)
    monkeypatch.setattr(mattn, "katt", types.SimpleNamespace(
        flash_attention=katt.flash_attention_plain,
        decode_attention=katt.decode_attention_plain))
    want, launched = path()
    assert launched == (0, 0)
    pre, dec = (((2e-4, 1e-3), (5e-4, 1e-2)) if dtype == "float32"
                else ((0.25, 0.0), (0.25, 0.0)))
    torch.testing.assert_close(got[0], want[0], atol=pre[0], rtol=pre[1])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=dec[0], rtol=dec[1])


# ------------------------------------------------------------- training
# The kernels' autograd Functions: the forward is the kernel, the backward
# the plain version's derivative (recomputed, the attention in query
# chunks), against autograd of the plain version. fp32 within ATT_TOL of
# max(1, the output's or gradient's largest magnitude); bf16 within ATT_TOL
# or one bf16 step of the plain value (chip_smoke's att_bound), the
# attention's gradients against the plain version's autograd on fp32
# copies of the inputs, cast (its Function sums dk and dv over the group
# in fp32 and rounds once; autograd through bf16 inputs rounds each head's
# first).
def _bf16_ok(got, want):
    d = (got.float() - want.float()).abs()
    w = want.float().abs().clamp(min=2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return bool(((d < ATT_TOL[torch.bfloat16]) | (d <= step)).all())


def _grad_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.cuda.synchronize()
    if want.dtype == torch.bfloat16:
        assert _bf16_ok(got, want)
    else:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) < ATT_TOL[want.dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_function_forward_and_backward(cuda, dtype, d, window):
    b, s, hkv, group = 2, 200, 2, 4
    g = torch.Generator(device=cuda).manual_seed(d + window)
    mk = (lambda h: torch.randn(b, s, h, d, device=cuda, generator=g)
          .to(dtype).transpose(1, 2).requires_grad_())
    q, k, v = mk(hkv * group), mk(hkv), mk(hkv)      # strided views
    dout = torch.randn(b, hkv * group, s, d, device=cuda,
                       generator=g).to(dtype)
    n0 = katt.flash_attention.launches
    out = katt.flash_attention(q, k, v, window)
    assert katt.flash_attention.launches == n0 + 1 and out.grad_fn
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert katt.flash_attention.launches == n0 + 1    # backward: plain
    want_out = katt.flash_attention_plain(q, k, v, window)
    ins32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = [t.to(dtype) for t in torch.autograd.grad(
        katt.flash_attention_plain(*ins32, window), ins32, dout.float())]
    _grad_close(out.detach(), want_out.detach())
    for a, w in zip(got, want):
        _grad_close(a, w)
    chunked = katt.flash_attention_grad(q, k, v, dout, window, rows=64)
    for a, w in zip(chunked, want):
        _grad_close(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [128, 200])
def test_ssd_function_forward_and_backward(cuda, dtype, s):
    x, dt, a, b, c = _ssd_inputs(cuda, dtype, 2, s, 4, 32, 16, s,
                                 strided=s == 200)
    ins = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
    g = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn(x.shape, device=cuda, generator=g).to(dtype)
    n0 = kssd.ssd_scan.launches
    y, state = kssd.ssd_scan(*ins, 64, return_state=True)
    assert kssd.ssd_scan.launches == n0 + 1 and y.grad_fn is not None
    assert not state.requires_grad
    got = torch.autograd.grad(y, ins, dy)
    want_y = kssd.ssd_scan_plain(*ins, 64)
    want = torch.autograd.grad(want_y, ins, dy)
    _ssd_close(y.detach(), want_y.detach())
    for u, w in zip(got, want):       # the same derivative, recomputed
        _grad_close(u, w)


@pytest.mark.gpu
def test_full_width_granite_step_kernel_path_matches_plain_path(cuda,
                                                                monkeypatch):
    """granite_3_2b at full width, its first 2 layers in fp32, one train
    step on 512 tokens: the loss and every gradient leaf through the flash
    kernel (twice a layer: the forward and its remat recompute) against
    the plain path, and the AdamW step that follows."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train.step import train_step, value_and_grad

    cfg = dataclasses.replace(get_arch("granite_3_2b"), n_layers=2,
                              dtype="float32")
    params = tf.init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, 513), device=cuda, generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n0 = katt.flash_attention.launches
    loss, grads = value_and_grad(params, cfg, batch)
    assert katt.flash_attention.launches == n0 + 2 * cfg.n_layers
    monkeypatch.setattr(mattn, "katt", types.SimpleNamespace(
        flash_attention=katt.flash_attention_plain,
        decode_attention=katt.decode_attention_plain))
    want_loss, want = value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for a, w in zip(grads, want):
        assert float((a - w).abs().max()) <= 1e-3 * float(w.abs().max())
    monkeypatch.undo()
    _, state, m = train_step(params, topt.adamw_init(params), batch, cfg)
    assert int(state["step"]) == 1 and bool(torch.isfinite(m["loss"]))


# ------------------------------------------------- the sharded trainer
def _mesh_of(device, shape=(4, 2), axes=("data", "model")):
    from repro_torch.core.distributed import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, axes, [device] * n)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_2b", "granite_34b",
                                  "qwen2_vl_2b"])
def test_sharded_step_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced model's sharded step (two microbatches) on a (4, 2)
    mesh whose positions all sit on the card, against the same step on a
    mesh of CPU positions: B7 on every position's local heads, twice a
    layer (remat); loss, grad_norm and parameters within fp32 summation
    order."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import leaves

    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    if cfg.frontend == "embed_stub":
        batch = {"embeds": torch.from_numpy(rng.normal(
            0, 1, (8, 64, cfg.d_model)).astype(np.float32))}
        if cfg.mrope:
            batch["positions"] = torch.from_numpy(rng.integers(
                0, 64, (8, 3, 64)).astype(np.int32))
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (8, 64)).astype(np.int32))}
    batch["labels"] = torch.from_numpy(rng.integers(
        0, cfg.vocab, (8, 64)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        rules = MeshRules(_mesh_of(dev))
        step, in_sh, _, _ = tstep.build_train_step(
            cfg, ShapeConfig("t", 64, 8, "train"), rules, microbatches=2)
        pd = place_tree(params, in_sh[0])
        n0 = katt.flash_attention.launches
        new, _, m = step(pd, tstep.sharded_adamw_init(pd),
                         place_tree(batch, in_sh[2]))
        launched = katt.flash_attention.launches - n0
        out[str(dev)] = ({k: float(gather(v)) for k, v in m.items()},
                         [gather(v, "cpu") for v in leaves(new)], launched)
    (m0, p0, n_cpu), (m1, p1, n_card) = out["cpu"], out[str(cuda)]
    assert n_cpu == 0 and n_card == 8 * cfg.n_layers * 2 * 2
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * abs(m0[k]), k
    for a, b in zip(p1, p0):
        assert float((a - b).abs().max()) <= 2 * m0["lr"]


@pytest.mark.gpu
def test_compression_on_the_card_equals_the_cpu(cuda):
    from repro_torch.sharding import gather, place
    from repro_torch.train.compress import (apply_error_feedback,
                                            compressed_psum_mean)

    g = torch.Generator().manual_seed(0)
    gs = torch.randn(8 * 64, 256, generator=g)
    res = {}
    for dev in ("cpu", cuda):
        mesh = _mesh_of(dev, (8,), ("data",))
        x = place(gs, mesh, ("data",))
        avg, err = apply_error_feedback(x, place(torch.zeros_like(gs) + 1e-3,
                                                 mesh, ("data",)), "data")
        res[str(dev)] = [gather(t, "cpu") for t in (
            compressed_psum_mean(x, "data"), avg, err)]
    for a, b in zip(res[str(cuda)], res["cpu"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_gpipe_on_the_card_equals_sequential_layers(cuda):
    """Four stages of two bf16 granite layers (reduced width) over a
    ("pod",) mesh of the card: the pipelined outputs equal the layers run
    in sequence, bit for bit."""
    from repro_torch.sharding import gather
    from repro_torch.sharding.pipeline import gpipe
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              n_layers=8, dtype="bfloat16")
    params = tf.init_params(cfg, 0, device=cuda)
    stages = tree_map(params["blocks"], lambda t: t.view(4, 2, *t.shape[1:]))
    rot = mattn.rot_tables(cfg, torch.arange(128, device=cuda))

    def stage(p, x):
        for pl_ in tf._layers(p):
            x = tf._block_full(x, pl_, cfg, rot)[0]
        return x

    g = torch.Generator(device=cuda).manual_seed(1)
    xs = torch.randn(6, 1, 128, cfg.d_model, device=cuda, generator=g).to(
        torch.bfloat16)
    with torch.no_grad():
        ys = gather(gpipe(stage, _mesh_of(cuda, (4,), ("pod",)))(stages, xs))
        ref = torch.stack([stage(params["blocks"], x) for x in xs])
    assert torch.equal(ys.view(torch.int16), ref.view(torch.int16))


# ------------------------------------- the sharded families and serving
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model,b,w,fresh", [
    ("mixtral", 8, 4096, 0), ("mixtral", 1, 4096, 0),
    ("mixtral", 8, 4096, 512), ("qwen3", 8, 1024, 0),
    ("qwen3", 8, 1024, 512), ("qwen2_vl", 8, 1024, 0),
    ("musicgen", 8, 1024, 0), ("musicgen", 8, 1024, 512)])
def test_decode_lse_at_family_shapes(cuda, dtype, model, b, w, fresh):
    """B8's log-sum-exp output (the sharded decode's merge weights) at
    ``test_decode_kernel_at_family_shapes``' shapes: against the plain
    version's within ATT_TOL, -inf on the row with no live slot; the
    output the same as without it."""
    m = FAMILY_ATT[model]
    q, k, v, ap, pos = _decode_inputs(cuda, dtype, b, m["hkv"], m["group"],
                                      w, m["d"], b * 17 + w + fresh, fresh)
    a, lse = katt.decode_attention(q, k, v, ap, pos, m["window"],
                                   return_lse=True)
    pa, plse = katt.decode_attention_plain(q, k, v, ap, pos, m["window"],
                                           return_lse=True)
    assert torch.equal(a, katt.decode_attention(q, k, v, ap, pos,
                                                m["window"]))
    assert _att_err(a, pa) < ATT_TOL[dtype]
    empty = torch.isneginf(plse)
    assert torch.equal(torch.isneginf(lse), empty)
    if not bool(empty.all()):           # b = 1: the one row has no live slot
        assert _att_err(lse[~empty], plse[~empty]) < ATT_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "hymba_1p5b",
                                  "mixtral_8x22b", "qwen3_moe_235b"])
def test_sharded_family_step_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced (2-layer, fp32) model's sharded step (two microbatches)
    on a (4, 2) mesh of the card against the same on CPU positions: B9 on
    every position's SSM heads and B7 on its query heads, twice a layer
    (remat); loss, grad_norm and parameters as the attention families'."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import leaves

    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)).astype(
        np.int32)) for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", cuda):
        rules = MeshRules(_mesh_of(dev))
        step, in_sh, _, _ = tstep.build_train_step(
            cfg, ShapeConfig("t", 64, 8, "train"), rules, microbatches=2)
        pd = place_tree(params, in_sh[0])
        n0 = (katt.flash_attention.launches, kssd.ssd_scan.launches)
        new, _, m = step(pd, tstep.sharded_adamw_init(pd),
                         place_tree(batch, in_sh[2]))
        launched = (katt.flash_attention.launches - n0[0],
                    kssd.ssd_scan.launches - n0[1])
        out[str(dev)] = ({k: float(gather(v)) for k, v in m.items()},
                         [gather(v, "cpu") for v in leaves(new)], launched)
    (m0, p0, n_cpu), (m1, p1, n_card) = out["cpu"], out[str(cuda)]
    each = 8 * cfg.n_layers * 2 * 2
    assert n_cpu == (0, 0)
    assert n_card == (each if cfg.has_attention else 0,
                      each if cfg.has_ssm else 0)
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * abs(m0[k]), k
    for a, b in zip(p1, p0):
        assert float((a - b).abs().max()) <= 2 * m0["lr"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_2b", "hymba_1p5b"])
def test_sharded_decode_on_the_card_matches_the_cpu(cuda, arch):
    """The sharded prefill of a 40-token prompt into a 48-slot ring (24 |
    24 over ``model``; hymba's window of 32 wraps it) and 3 decode steps
    on the card's (4, 2) mesh against the same on CPU positions: B8 on
    each position's slots, merged by its log-sum-exp; fp32 logits and
    caches within the kernel path's tolerance against the plain path
    (``test_family_kernel_path_matches_plain_path``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import paths

    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 43)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        rules = MeshRules(_mesh_of(dev))
        pf, pin, _, _ = tstep.build_prefill_step(
            cfg, ShapeConfig("p", 48, 8, "prefill"), rules)
        df, din, _, _ = tstep.build_decode_step(
            cfg, ShapeConfig("d", 48, 8, "decode"), rules)
        pd = place_tree(params, pin[0])
        n0 = katt.decode_attention.launches
        lg, cache = pf(pd, place_tree({"tokens": toks[:, :40]}, pin[1]))
        logits = [gather(lg, "cpu")]
        for t in range(3):
            lg, cache = df(pd, cache, place_tree({"tokens": toks[:, 40 + t]},
                                                 din[2]))
            logits.append(gather(lg, "cpu"))
        out[str(dev)] = (logits, {k: gather(v, "cpu") for k, v in
                                  paths(cache)},
                         katt.decode_attention.launches - n0)
    (l0, c0, n_cpu), (l1, c1, n_card) = out["cpu"], out[str(cuda)]
    assert n_cpu == 0 and n_card == 3 * cfg.n_layers * 8
    torch.testing.assert_close(l1[0], l0[0], atol=2e-4, rtol=1e-3)
    for a, b in zip(l1[1:], l0[1:]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-2)
    for k in c0:
        if c0[k].dtype == torch.int32:
            assert torch.equal(c1[k], c0[k]), k
        else:
            torch.testing.assert_close(c1[k], c0[k], atol=2e-4, rtol=1e-3)
