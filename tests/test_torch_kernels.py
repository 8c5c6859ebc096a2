"""The kernels' wrappers and plain versions, and the ``ops`` entry point.

On the CPU a wrapper takes its plain version (the kernel's arithmetic in
tensor code), which must equal the reference package's functions bit for
bit: ``kernels.ref.refine_count_ref`` / ``refine_compact_ref`` for count and
compact (both prefilters, empty and inverted runs, odd budgets, a budget
past the fused kernel's bound), ``batch_query_fused(mode="reference")`` for
the fused query over the seven relation forms, the two-key sort
(``ops.knn_topk(use_pallas=False)``) for the kNN top-k, and the Pallas
kernels in interpret mode for ``morton_encode``, ``refine_mask`` and
``ops.refine_fused``.
(``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card.)
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
# small tensors: one torch thread per xdist worker beats oversubscribing
# the cores the workers share
torch.set_num_threads(1)

from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro.core.engine import EngineConfig as REngineConfig  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLIN as RGLIN  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core import relations as trel  # noqa: E402
from repro_torch.kernels import knn as kk  # noqa: E402
from repro_torch.kernels import morton as km  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import refine as kr  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RELATIONS = ("intersects", "contains", "covers", "within", "touches",
             "crosses", "dwithin:0.004")


@pytest.fixture(scope="module")
def world():
    """Reference snapshot over an odd N=347 mixed store, carried into the
    port; 15 windows (random, empty-region, whole-domain)."""
    gs = mixed_store(347, seed=3)
    g = RGLIN.build(gs, RGLINConfig(piece_limitation=200))
    rs = RIndex(g, REngineConfig(pad_quantum=0)).snapshot()
    rpods = rdev.pods_from_store(gs)
    fields = {k: np.asarray(getattr(rs, k)) for k in tdev.SNAPSHOT_FIELDS}
    meta = {k: getattr(rs, k) for k in tdev.SNAPSHOT_META}
    ts = tdev.snapshot_from_numpy(fields, meta, device="cpu")
    tpods = tdev.pods_from_numpy(
        {k: np.asarray(getattr(rpods, k))
         for k in ("pool", "off", "nv", "kd", "bucket")}
        | {"max_width": rpods.max_width}, device="cpu")
    lo = gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = gs.mbrs[:, 2:].max(axis=0) + 0.01
    wins = np.concatenate([
        make_query_windows(gs, 0.004, 13, seed=4),
        [[hi[0] + 1, hi[1] + 1, hi[0] + 2, hi[1] + 2],
         [lo[0], lo[1], hi[0], hi[1]]]]).astype(np.float32)
    rng = np.random.default_rng(5)
    n = len(gs)
    a = rng.integers(0, n, len(wins))
    b = rng.integers(0, n + 1, len(wins))
    bounds = np.stack([a, b], 1).astype(np.int32)   # some inverted
    bounds[0] = [5, 5]                               # empty run
    bounds[1] = [0, n]                               # the whole table
    return dict(gs=gs, rs=rs, rpods=rpods, ts=ts, tpods=tpods, wins=wins,
                bounds=bounds)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ plain == ref --
def test_refine_count_plain_matches_reference(world):
    rs = world["rs"]
    want = rref.refine_count_ref(jnp.asarray(world["wins"]),
                                 jnp.asarray(world["bounds"]),
                                 rs.slot_rmbr)
    before = kr.refine_count.launches
    got = kr.refine_count(_t(world["wins"]), _t(world["bounds"]),
                          world["ts"].slot_rmbr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert kr.refine_count.launches == before   # CPU: plain version


@pytest.mark.parametrize("prefilter", ["intersects", "contains"])
@pytest.mark.parametrize("budget", [7, 64])
def test_refine_compact_plain_matches_reference(world, prefilter, budget):
    rs, ts = world["rs"], world["ts"]
    ws, wb = world["wins"], world["bounds"]
    if prefilter == "contains":   # tiny windows that records can cover
        c = (ws[:, :2] + ws[:, 2:]) / 2
        ws = np.concatenate([c, c + 1e-5], 1).astype(np.float32)
    want_s, want_c = rref.refine_compact_ref(
        jnp.asarray(ws), jnp.asarray(wb), rs.slot_lmbr, rs.slot_rmbr,
        budget, prefilter)
    before = kr.refine_compact.launches
    got_s, got_c = kr.refine_compact(_t(ws), _t(wb), ts.slot_lmbr,
                                     ts.slot_rmbr, budget=budget,
                                     prefilter=prefilter)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert kr.refine_compact.launches == before
    assert (np.asarray(want_c) > 0).any()
    if prefilter == "intersects":
        assert (np.asarray(want_c) > budget).any()   # a truncated row


@pytest.mark.parametrize("relation", RELATIONS)
def test_refine_fused_plain_matches_reference(world, relation):
    """The wrapper (plain version on the CPU) over packed operands ==
    the reference's fused reference composition: the (Q, budget) hit
    layout column for column, exact counts and overflow codes."""
    wins = world["wins"]
    rh, rc = rdev.batch_query_fused(world["rs"], jnp.asarray(wins),
                                    world["rpods"], relation=relation,
                                    exact_budget=64, mode="reference")
    before = kr.refine_fused.launches
    th, tc = tdev.batch_query_fused(world["ts"], _t(wins), world["tpods"],
                                    relation=relation, exact_budget=64,
                                    mode="kernel")
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert kr.refine_fused.launches == before


def test_fused_empty_and_inverted_probe_runs(world):
    """Doctored keys: an inverted run (zmin > ub) and one past every stored
    key both give zero survivors; an untouched row is unaffected."""
    ts, tpods = world["ts"], world["tpods"]
    rel = trel.get_relation("contains")
    w = _t(world["wins"][:3])
    qk = torch.stack(tdev._raw_query_keys(ts, w, rel), dim=1)
    qk[0] = qk[0][[2, 3, 0, 1]]
    qk[1] = torch.tensor([2**30, 0, 2**30, 0], dtype=torch.int32)
    pod_i = torch.stack([tpods.off, tpods.nv, tpods.kd, tpods.bucket], 1)
    hits, counts = kr.refine_fused(
        w, rel.probe_window(w), qk, *tdev._fused_operands(ts), pod_i,
        tpods.pool, ts.slot_lmbr, ts.slot_rmbr, budget=32,
        prefilter=rel.prefilter_kind, code=rel.code, augment=False,
        search_steps=ts.search_steps, depth=ts.depth)
    assert counts[0] == 0 and (hits[0] == -1).all()
    assert counts[1] == 0 and (hits[1] == -1).all()
    _, c_ref = tdev.batch_query_fused(ts, w, tpods, relation="contains",
                                      exact_budget=32, mode="reference")
    assert counts[2] == c_ref[2]


# ------------------------------------------------------------- the wrappers --
def test_wrapper_validation(world):
    ts = world["ts"]
    w, b = _t(world["wins"]), _t(world["bounds"])
    with pytest.raises(ValueError, match="budget"):
        kr.refine_compact(w, b, ts.slot_lmbr, ts.slot_rmbr, budget=0)
    with pytest.raises(ValueError, match="budget"):
        kr.refine_fused(*(w,) * 15, budget=kr.MAX_COMPACT_BUDGET + 1,
                        prefilter="intersects", code=0, augment=False,
                        search_steps=1, depth=1)
    with pytest.raises(ValueError, match="k must"):
        kk.knn_topk(w, b, 0)
    with pytest.raises(ValueError, match="prefilter"):
        kr.refine_compact(w, b, ts.slot_lmbr, ts.slot_rmbr, budget=8,
                          prefilter="custom")
    with pytest.raises(ValueError, match="devices"):
        kr.refine_count(w, b, ts.slot_rmbr.to("meta"))
    with pytest.raises(TypeError, match="dtype"):
        kr._check("x", w.double(), torch.float32, (None, 4))
    with pytest.raises(ValueError, match="shape"):
        kr._check("x", w, torch.float32, (None, 2))
    with pytest.raises(ValueError, match="contiguous"):
        kr._check("x", w.t(), torch.float32, (4, None))
    with pytest.raises(ValueError, match="aligned"):
        kr._check("x", torch.zeros(41)[1:], torch.float32, (None,))


def test_cuda_request_without_cuda_raises():
    """Entry points run on the card unless the caller asks for the CPU:
    asking for CUDA where there is none raises, nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from repro_torch.core import SpatialIndex
    gs = mixed_store(40, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpatialIndex.build(gs)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpatialIndex.build(gs, device="cuda")
    assert SpatialIndex.build(gs, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_and_no_reference():
    """No file of the port, nor chip_smoke.py, imports jax or repro."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/kernels/knn.py",
            "src/repro_torch/kernels/morton.py",
            "src/repro_torch/kernels/ops.py"} <= names
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)


def test_device_predicate_codes_cover_relations():
    for name in RELATIONS:
        rel = trel.get_relation(name)
        assert tgeom.device_predicate(rel.code, rel.dist) is not None
    with pytest.raises(ValueError, match="code"):
        tgeom.device_predicate(99)


# --------------------------------------------- budgets past the fused bound --
def test_refine_compact_budget_past_fused_bound(world):
    """The compact kernel takes budgets past MAX_COMPACT_BUDGET (the kNN
    ladder grows them up to max_cap); the engine routes them to it."""
    rs, ts = world["rs"], world["ts"]
    ws, wb = world["wins"], world["bounds"]
    budget = 4096
    want_s, want_c = rref.refine_compact_ref(
        jnp.asarray(ws), jnp.asarray(wb), rs.slot_lmbr, rs.slot_rmbr,
        budget, "intersects")
    got_s, got_c = kr.refine_compact(_t(ws), _t(wb), ts.slot_lmbr,
                                     ts.slot_rmbr, budget=budget)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    from repro_torch.core import SpatialIndex
    from repro_torch.core.engine import EngineConfig
    idx = SpatialIndex.build(world["gs"], config=EngineConfig(
        compaction="kernel"), device="cpu")
    assert idx._compaction("intersects") == "kernel"
    assert idx._fusion_mode("intersects", budget) is None


# ------------------------------------------------------------ knn top-k --
def _topk_inputs(q, b, seed):
    """Rows with distance ties, duplicate (d, id) pairs, +inf tails, an
    all-+inf row, zeros of both signs, and ids in random order."""
    rng = np.random.default_rng(seed)
    d = rng.choice(np.float32([0.0, -0.0, 0.25, 0.5, 1.0, 2.0, 3.5]),
                   (q, b)).astype(np.float32)
    d[rng.random((q, b)) < 0.3] = np.inf
    ids = rng.integers(0, 50, (q, b)).astype(np.int32)
    ids[d == np.inf] = kk.ID_PAD
    d[0] = np.inf
    ids[0] = kk.ID_PAD
    d[1, :4] = 0.5
    ids[1, :4] = 7                       # four identical pairs
    if q > 2:
        d[2] = rng.random(b).astype(np.float32)   # no ties at all
    return d, ids


@pytest.mark.parametrize("q,b,k", [(5, 37, 5), (9, 200, 17), (4, 130, 150),
                                   (3, 1, 4), (6, 128, 128)])
def test_knn_topk_plain_matches_two_key_sort(q, b, k):
    """The plain version == the reference's two-key sort truncated to k
    columns, the inputs padded to k columns with (+inf, INT32_MAX) where k
    exceeds B (as ``batch_knn_rank`` pads them)."""
    d, ids = _topk_inputs(q, b, seed=q * 1000 + b)
    dp, ip = d, ids
    if k > b:
        dp = np.concatenate([d, np.full((q, k - b), np.inf, np.float32)], 1)
        ip = np.concatenate([ids, np.full((q, k - b), kk.ID_PAD, np.int32)],
                            1)
    wd, wi = rops.knn_topk(jnp.asarray(dp), jnp.asarray(ip), k=k,
                           use_pallas=False)
    before = kk.knn_topk.launches
    for got in (kk.knn_topk_plain(_t(d), _t(ids), k),
                kk.knn_topk(_t(d), _t(ids), k),
                tops.knn_topk(_t(d), _t(ids), k=k),
                tops.knn_topk(_t(d), _t(ids), k=k, use_kernel=False)):
        assert got[0].shape == (q, k) and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(wi))
        # -0 and +0 are one distance: the id decides between them
        assert (np.diff(got[1].numpy()[:, :2], axis=1)[
            got[0].numpy()[:, 1] == got[0].numpy()[:, 0]] >= 0).all()
    assert kk.knn_topk.launches == before


# --------------------------------------------------------------- morton --
def test_morton_encode_matches_pallas_interpret():
    rng = np.random.default_rng(8)
    lim = (1 << 30) - 1
    qx = np.concatenate([[0, lim, (1 << 15) - 1, 1 << 15, lim, 0],
                         rng.integers(0, lim + 1, 997)]).astype(np.int32)
    qy = np.concatenate([[0, lim, 1 << 15, (1 << 15) - 1, 0, lim],
                         rng.integers(0, lim + 1, 997)]).astype(np.int32)
    want = [rops.morton_encode(jnp.asarray(qx), jnp.asarray(qy),
                               use_pallas=flag) for flag in (True, False)]
    np.testing.assert_array_equal(np.asarray(want[0][0]),
                                  np.asarray(want[1][0]))
    before = km.morton_encode.launches
    for hi, lo in (km.morton_encode_plain(_t(qx), _t(qy)),
                   km.morton_encode(_t(qx), _t(qy)),
                   tops.morton_encode(_t(qx), _t(qy)),
                   tops.morton_encode(_t(qx), _t(qy), use_kernel=False)):
        for w in want:
            np.testing.assert_array_equal(hi.numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(lo.numpy(), np.asarray(w[1]))
    assert km.morton_encode.launches == before


# ---------------------------------------------------------- refine mask --
def test_refine_mask_matches_pallas_interpret(world):
    rs, ts = world["rs"], world["ts"]
    ws, wb = world["wins"], world["bounds"]
    want = np.asarray(rops.refine_mask(jnp.asarray(ws), jnp.asarray(wb),
                                       rs.slot_rmbr, use_pallas=True))
    np.testing.assert_array_equal(want, np.asarray(rref.refine_mask_ref(
        jnp.asarray(ws), jnp.asarray(wb), rs.slot_rmbr)))
    assert want.any() and not want.all()
    before = kr.refine_mask.launches
    for got in (kr.refine_mask_plain(_t(ws), _t(wb), ts.slot_rmbr),
                kr.refine_mask(_t(ws), _t(wb), ts.slot_rmbr),
                tops.refine_mask(_t(ws), _t(wb), ts.slot_rmbr),
                tops.refine_mask(_t(ws), _t(wb), ts.slot_rmbr,
                                 use_kernel=False)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    assert kr.refine_mask.launches == before
    # count is the mask's row sum, through either entry point
    counts = tops.refine_count(_t(ws), _t(wb), ts.slot_rmbr)
    np.testing.assert_array_equal(counts.numpy(), want.sum(1))
    np.testing.assert_array_equal(
        tops.refine_count(_t(ws), _t(wb), ts.slot_rmbr,
                          use_kernel=False).numpy(), want.sum(1))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_refine_compact_both_ways(world, use_kernel):
    rs, ts = world["rs"], world["ts"]
    ws, wb = world["wins"], world["bounds"]
    want = rops.refine_compact(jnp.asarray(ws), jnp.asarray(wb),
                               rs.slot_lmbr, rs.slot_rmbr, budget=16,
                               use_pallas=False)
    got = tops.refine_compact(_t(ws), _t(wb), ts.slot_lmbr, ts.slot_rmbr,
                              budget=16, use_kernel=use_kernel)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ops_refine_fused_matches_reference_interpret(world):
    """``ops.refine_fused`` (the wrapper's plain version on the CPU, with
    and without the snapshot's walk, and ``use_kernel=False``) over the
    packed operands == the reference's
    ``ops.refine_fused`` in interpret mode, hit for hit and count for
    count; the walk it derives from ``leaf_i`` and ``leaf_mbrs`` is the
    snapshot's."""
    rs, ts, rpods, tpods = (world[k] for k in ("rs", "ts", "rpods", "tpods"))
    name = "dwithin:0.004"
    rrel, trel_ = rdev._device_relation(name), tdev._device_relation(name)
    wins = world["wins"]
    wj = jnp.asarray(wins)
    rqk = jnp.stack(rdev._raw_query_keys(rs, wj, rrel), axis=1)
    rpod_i = jnp.stack([rpods.off, rpods.nv, rpods.kd, rpods.bucket], 1)
    want = rops.refine_fused(
        wj, rrel.probe_window(wj, xp=jnp), rqk, *rdev._fused_operands(rs),
        rpod_i, rpods.pool, rs.slot_lmbr, rs.slot_rmbr, budget=16,
        prefilter=rrel.prefilter_kind,
        predicate=lambda w, vv, nn, kk_: rrel.predicate(w, vv, nn, kk_,
                                                        xp=jnp),
        augment=True, search_steps=rs.search_steps, depth=rs.depth,
        num_buckets=rpods.num_buckets, interpret=True)
    w = _t(wins)
    ops_ = tdev._fused_operands(ts)
    args = (w, trel_.probe_window(w), torch.stack(
        tdev._raw_query_keys(ts, w, trel_), dim=1), *ops_, tpods.headers,
        tpods.pool, ts.slot_lmbr, ts.slot_rmbr)
    kw = dict(budget=16, prefilter=trel_.prefilter_kind, code=trel_.code,
              dist=trel_.dist, augment=True, search_steps=ts.search_steps,
              depth=ts.depth)
    before = kr.refine_fused.launches
    for use_kernel, leaves in ((True, None), (True, ts.leaf_walk),
                               (False, None)):
        hits, counts = tops.refine_fused(*args, **kw, leaves=leaves,
                                         use_kernel=use_kernel)
        np.testing.assert_array_equal(hits.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
    assert kr.refine_fused.launches == before        # CPU: plain version
    assert (np.asarray(want[1]) < 0).any() and (np.asarray(want[1]) > 0).any()
    walk, snap_walk = tops.fused_leaf_walk(ops_[2], ts.slot_lmbr), ts.leaf_walk
    assert torch.equal(walk.rec_leaf, snap_walk.rec_leaf)
    assert torch.equal(walk.leaf_start, snap_walk.leaf_start)
    full = snap_walk.leaf_start[1:] > snap_walk.leaf_start[:-1]
    assert torch.equal(walk.leaf_mbr[full], snap_walk.leaf_mbr[full])
