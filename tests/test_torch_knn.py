"""The kNN slice: the port's device-complete kNN against the reference's.

Both packages build the same store from the same seed (``mixed``, and a
``points`` store small enough that k can exceed the live records). The
reference runs with ``EngineConfig(delta_patch_max=0, knn_topk="sort")``;
the port runs on the CPU with ``delta_patch_max=0`` too (the delta's kNN
parity is in ``tests/test_torch_delta.py``), with its defaults (scan
compaction, plain two-key sort) and through the kernel wrappers (``knn_topk="kernel"``,
``compaction="kernel"``, which take their plain versions for CPU tensors).
Ids and rung telemetry (``rungs``, ``rung_hist``, ``seed_hits``) must be
equal; device distances agree to ``rtol=1e-6`` (the tolerance of
``rect_geom_sqdist``: XLA on the CPU contracts multiply-adds into FMAs), host
distances exactly. ``knn_seed_radii`` and ``batch_knn_rank`` are held against
the reference on the same snapshot, carried across with
``snapshot_from_numpy`` / ``pods_from_numpy``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
# small tensors: one torch thread per xdist worker beats oversubscribing
# the cores the workers share
torch.set_num_threads(1)

from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core.datasets import generate as rgenerate  # noqa: E402
from repro.core.engine import EngineConfig as RConfig  # noqa: E402
from repro.core.engine import QueryBatch as RBatch  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.engine import QueryBatch  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.core.index import GLINConfig as TGLINConfig  # noqa: E402

PORT_MODES = {"plain": {}, "kernel": {"knn_topk": "kernel",
                                      "compaction": "kernel"}}


def _fp32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _port_store(family, n, seed):
    gs = tdata.generate(family, n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = tgeom.mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def _ref_store(family, n, seed):
    if family == "mixed":
        return mixed_store(n, seed=seed)
    from repro.core.geometry import mbrs_of_verts

    gs = rgenerate(family, n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = mbrs_of_verts(gs.verts, gs.nverts)
    return gs


# (family, records, exact_budget, ks): exact_budget 16 sends the k=10 rows'
# fat squares up the overflow ladder; k=400 exceeds the 300 live points.
# The reference compiles once per shape, so every test reuses these shapes
# (16 points, the same stores and budgets).
STORES = {"mixed": ("mixed", 2000, 16, (10,)),
          "points": ("points", 300, 256, (1, 400))}
N_POINTS = 16


def _pair(key):
    """The reference facade and one port facade per mode over one store."""
    family, n, budget, _ = STORES[key]
    ref = RIndex.build(_ref_store(family, n, 3),
                       RGLINConfig(piece_limitation=500),
                       RConfig(delta_patch_max=0, knn_topk="sort",
                               exact_budget=budget))
    ports = {m: TIndex.build(_port_store(family, n, 3),
                             TGLINConfig(piece_limitation=500),
                             TConfig(delta_patch_max=0, exact_budget=budget,
                                     **cfg),
                             device="cpu")
             for m, cfg in PORT_MODES.items()}
    return ref, ports


@pytest.fixture(scope="module")
def world():
    pts = _fp32(np.random.default_rng(5).uniform(0.15, 0.85, (N_POINTS, 2)))
    out = {}
    for key, (_, _, _, ks) in STORES.items():
        ref, ports = _pair(key)
        want = {k: ref.query(RBatch.knn(pts, k)) for k in ks}
        out[key] = dict(ref=ref, ports=ports, pts=pts, want=want)
    return out


def _same_rows(got, want, rtol):
    assert len(got.ids) == len(want.ids)
    for i, (a, b) in enumerate(zip(got.ids, want.ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"point {i}")
        if rtol:
            np.testing.assert_allclose(got.distances[i], want.distances[i],
                                       rtol=rtol, atol=0, err_msg=f"pt {i}")
        else:
            np.testing.assert_array_equal(got.distances[i],
                                          want.distances[i])


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
@pytest.mark.parametrize("case", [("mixed", 10), ("points", 1),
                                  ("points", 400)])
def test_device_knn_matches_reference(world, case, mode):
    key, k = case
    w = world[key]
    want = w["want"][k]
    assert want.plan.backend == "device"
    got = w["ports"][mode].query(QueryBatch.knn(w["pts"], k))
    assert got.plan.backend == "device" and got.plan.kind == "knn"
    assert got.plan.reason == want.plan.reason
    _same_rows(got, want, rtol=1e-6)
    a, b = got.stages[-1], want.stages[-1]
    assert (a.stage, a.impl, a.covers) == (b.stage, b.impl, b.covers)
    assert (a.rungs, a.rung_hist, a.seed_hits) == (b.rungs, b.rung_hist,
                                                   b.seed_hits)
    assert a.survivors == b.survivors
    np.testing.assert_allclose(a.seed_radius, b.seed_radius, rtol=1e-6)
    topk = "kernel" if mode == "kernel" else "sort"
    assert a.note == f"seed=cdf topk={topk}"
    if mode == "plain":      # scan compaction: the reference's ladder
        assert (a.escalations, a.dispatches) == (b.escalations, b.dispatches)
    if k == 400:             # k > live: every row holds every record
        assert all(len(r) == len(w["ref"].gs) for r in got.ids)


@pytest.mark.parametrize("case", [("mixed", 10), ("points", 1)])
def test_global_seed_matches_reference(world, case):
    """``knn_seed="global"``: every point starts at the global density
    radius (no model dispatch); ids, rung telemetry and the seed radius are
    the reference's under the same setting."""
    key, k = case
    w = world[key]
    budget = STORES[key][2]
    ref = RIndex(w["ref"].glin, RConfig(delta_patch_max=0, knn_topk="sort",
                                        exact_budget=budget,
                                        knn_seed="global"))
    port = TIndex(w["ports"]["plain"].glin,
                  TConfig(delta_patch_max=0, exact_budget=budget,
                          knn_seed="global"),
                  device="cpu")
    want = ref.query(RBatch.knn(w["pts"], k))
    got = port.query(QueryBatch.knn(w["pts"], k))
    _same_rows(got, want, rtol=1e-6)
    a, b = got.stages[-1], want.stages[-1]
    assert (a.rungs, a.rung_hist, a.seed_hits) == (b.rungs, b.rung_hist,
                                                   b.seed_hits)
    assert (a.escalations, a.dispatches) == (b.escalations, b.dispatches)
    assert a.seed_radius == b.seed_radius
    assert a.note == "seed=global topk=sort"


def test_fat_rows_walk_the_ladder(world):
    """exact_budget=16 at k=10: some rows overflow the pinned budget and
    re-dispatch through the ladder on both packages."""
    want = world["mixed"]["want"][10]
    rank = want.stages[-1]
    assert rank.dispatches > 4 * rank.rungs + 1


@pytest.mark.parametrize("key", sorted(STORES))
def test_host_knn_matches_reference(world, key):
    w = world[key]
    k = STORES[key][3][-1]
    want = w["ref"].query(RBatch.knn(w["pts"][:8], k, backend="host"))
    got = w["ports"]["plain"].query(QueryBatch.knn(w["pts"][:8], k,
                                                   backend="host"))
    assert got.plan.backend == want.plan.backend == "host"
    _same_rows(got, want, rtol=0)
    assert got.stages[-1].survivors == want.stages[-1].survivors


_RANK = {}


def _carried(ref):
    """The reference's published snapshot and pods, carried into the port."""
    rs = ref.snapshot()
    rpods = ref._device_payload(ref._snapshot_recs)[0]
    fields = {k: np.asarray(getattr(rs, k)) for k in tdev.SNAPSHOT_FIELDS}
    meta = {k: getattr(rs, k) for k in tdev.SNAPSHOT_META}
    ts = tdev.snapshot_from_numpy(fields, meta, device="cpu")
    tpods = tdev.pods_from_numpy(
        {k: np.asarray(getattr(rpods, k))
         for k in ("pool", "off", "nv", "kd", "bucket")}
        | {"max_width": rpods.max_width}, device="cpu")
    return rs, rpods, ts, tpods


def test_knn_seed_radii_matches_reference(world):
    w = world["mixed"]
    rs, _, ts, _ = _carried(w["ref"])
    pts = np.concatenate([w["pts"], [[-0.5, 2.0], [1.0, 1.0]]])
    wins = np.concatenate([pts, pts], 1).astype(np.float32)
    want = np.asarray(rdev.knn_seed_radii(rs, jnp.asarray(wins),
                                          jnp.float32(10)))
    got = tdev.knn_seed_radii(ts, torch.from_numpy(wins), 10)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("impl", ["sort", "kernel"])
def test_batch_knn_rank_matches_reference(world, impl):
    """A random hit matrix (-1 padding, duplicate ids, a dead row) with
    tombstones: ids, distances and within-radius counts, through the plain
    sort and through the knn_topk wrapper; k=20 exceeds the 16 columns."""
    w = world["mixed"]
    _, rpods, _, tpods = _carried(w["ref"])
    rng = np.random.default_rng(11)
    q, b, k, n = N_POINTS, 16, 20, len(w["ref"].gs)
    hits = rng.integers(0, n, (q, b)).astype(np.int32)
    hits[rng.random((q, b)) < 0.3] = -1
    hits[1, :5] = hits[1, 5]              # duplicate ids in one row
    hits[2] = -1                          # nothing survived
    tomb = np.unique(hits[hits >= 0])[::7].astype(np.int32)
    pts = w["pts"][:q].astype(np.float32)
    wins = np.concatenate([pts, pts], 1)
    radius = rng.uniform(0.01, 0.2, q).astype(np.float32)
    want = _RANK.get("want")
    if want is None:     # one reference compile for both impls
        want = _RANK["want"] = rdev.batch_knn_rank(
            jnp.asarray(wins), rpods, jnp.asarray(hits),
            jnp.asarray(radius), k, "sort", tombstones=jnp.asarray(tomb))
    got = tdev.batch_knn_rank(
        torch.from_numpy(wins), tpods, torch.from_numpy(hits),
        torch.from_numpy(radius), k, impl, tombstones=torch.from_numpy(tomb))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (np.asarray(want[0])[2] == -1).all()
    assert not np.isin(np.asarray(want[0]), tomb).any()
    # a delta of records the pods also hold ranks as those records appended
    # to every row's hits: the same ids, distances and counts (added ids are
    # never tombstones: the mask applies to the hit matrix only)
    tail = np.setdiff1d(np.unique(hits[hits >= 0]), tomb)[:5]
    dtab = tdev.delta_table_from_host(w["ref"].glin, tail, "cpu",
                                      pad_to=8)
    ext = np.concatenate([hits, np.broadcast_to(tail.astype(np.int32),
                                                (q, tail.shape[0]))], 1)
    for t in (None, torch.from_numpy(tomb)):
        a = tdev.batch_knn_rank(torch.from_numpy(wins), tpods,
                                torch.from_numpy(hits),
                                torch.from_numpy(radius), k, impl,
                                tombstones=t, delta=dtab)
        b = tdev.batch_knn_rank(torch.from_numpy(wins), tpods,
                                torch.from_numpy(ext),
                                torch.from_numpy(radius), k, impl,
                                tombstones=t)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="impl"):
        tdev.batch_knn_rank(torch.from_numpy(wins), tpods,
                            torch.from_numpy(hits), torch.from_numpy(radius),
                            k, "pallas")


def test_planner_matches_reference(world):
    """Host below knn_device_min_batch, device at or above it, forced
    backends, and republish on a stale snapshot (the reference without delta
    patching plans ``device`` too), with the same ids after the writes."""
    ref, ports = _pair("mixed")      # fresh facades: this test writes
    port = ports["plain"]
    pts = world["mixed"]["pts"]
    for idx in (ref, port):
        idx.snapshot()
    for q, backend in ((4, None), (15, None), (16, None), (16, "host"),
                       (4, "device")):
        a = port.plan(QueryBatch.knn(pts[:q], 3, backend=backend))
        b = ref.plan(RBatch.knn(pts[:q], 3, backend=backend))
        assert (a.backend, a.kind, a.reason, a.relation) == (
            b.backend, b.kind, b.reason, b.relation)
        assert port.explain(QueryBatch.knn(pts[:q], 3, backend=backend)) \
            == ref.explain(RBatch.knn(pts[:q], 3, backend=backend))
    # writes: a record at the first point, the nearest record of another
    # deleted — the snapshot is stale with a delta of two
    near = ref.query(RBatch.knn(pts, 1, backend="host")).ids[1][0]
    ring = _fp32([pts[0]])
    for idx in (ref, port):
        idx.insert(ring, 1, 0)
        assert idx.delete(int(near))
    a = port.plan(QueryBatch.knn(pts, 3))
    b = ref.plan(RBatch.knn(pts, 3))
    assert a.backend == b.backend == "device"      # delta_patch_max=0
    assert a.reason == b.reason and a.rebuild_snapshot
    for backend in ("device+delta", "device"):     # forced on a stale one
        a = port.plan(QueryBatch.knn(pts, 3, backend=backend))
        b = ref.plan(RBatch.knn(pts, 3, backend=backend))
        assert (a.backend, a.reason, a.delta_size) == (
            b.backend, b.reason, b.delta_size) == (backend,
                                                   "forced by caller", 2)
    got = port.query(QueryBatch.knn(pts, 10))
    want = ref.query(RBatch.knn(pts, 10))
    assert got.epoch == port.epoch and not port.snapshot_is_stale()
    _same_rows(got, want, rtol=1e-6)
    assert got.ids[0][0] == len(ref.gs) - 1          # the inserted record
    assert not any(int(near) in r for r in got.ids)
    st = port.stats()["stages"]["device"]["knn-rank"]
    assert st["calls"] == 1 and sum(st["rung_hist"]) == len(pts)
    with pytest.raises(ValueError, match="requires EngineConfig.mesh"):
        port.plan(QueryBatch.knn(pts, 3, backend="sharded"))
    with pytest.raises(ValueError, match="points"):
        QueryBatch.knn(np.zeros((3, 3)), 2)


def test_knn_config_validation(world):
    idx = world["mixed"]["ports"]["plain"]
    assert texec._knn_backstop(idx, idx.config) == ("cdf", "sort")
    bad = TConfig(knn_topk="pallas")
    with pytest.raises(ValueError, match="knn_topk"):
        texec._knn_backstop(idx, bad)
    with pytest.raises(ValueError, match="knn_seed"):
        texec._knn_backstop(idx, TConfig(knn_seed="x"))
    empty = QueryBatch.knn(world["mixed"]["pts"][:16], 0)
    res = idx.query(empty)
    assert res.plan.backend == "device"
    assert all(r.size == 0 for r in res.ids)
    assert res.distances is not None and len(res.distances) == 16


def test_capless_ladder_ignores_the_cap(world, monkeypatch):
    """With the compact kernel (capless) a budget at or past the cap still
    runs two-stage: at initial_cap=16 every rung and fat-row dispatch
    compacts (none takes the dense path, whose bounds probe fails once a run
    outgrows max_cap), and the answer is the reference's."""
    from repro_torch.core import engine as teng

    w = world["mixed"]
    port = TIndex.build(_port_store("mixed", 2000, 3),
                        TGLINConfig(piece_limitation=500),
                        TConfig(exact_budget=16, initial_cap=16,
                                **PORT_MODES["kernel"]), device="cpu")
    calls = []
    plain = teng.batch_query

    def spy(*a, **kw):
        calls.append((kw["exact_budget"], kw["cap"], kw["compaction"]))
        return plain(*a, **kw)

    monkeypatch.setattr(teng, "batch_query", spy)
    got = port.query(QueryBatch.knn(w["pts"], 10))
    want = w["want"][10]
    _same_rows(got, want, rtol=1e-6)
    a, b = got.stages[-1], want.stages[-1]
    assert (a.rungs, a.rung_hist, a.seed_hits) == (b.rungs, b.rung_hist,
                                                   b.seed_hits)
    assert all(kb > 0 and comp == "kernel" for kb, _, comp in calls)
    assert any(kb > cap for kb, cap, _ in calls)     # fat rows past the cap
    assert port.device_cap == 16 and a.escalations == 0


def test_overflow_ladder_two_stage_rule():
    cfg = TConfig(exact_budget=256, max_cap=1 << 12)
    scan = texec.OverflowLadder(cfg, 512)
    kern = texec.OverflowLadder(cfg, 512, max_budget=cfg.max_cap,
                                compaction="kernel")
    assert not scan.capless and kern.capless
    assert scan.use_budget == kern.use_budget == 256
    scan.grow_budget(256, 700)          # 1024 >= cap: dense for a scan
    kern.grow_budget(256, 700)          # capless: two-stage at 1024
    assert (scan.budget, scan.use_budget) == (0, 0)
    assert kern.use_budget == 1024
    # a capless budget overflow grows the budget with no bounds probe; a
    # scan's overflow (here a run past the cap) probes and grows the cap
    probes = []

    def probe():
        probes.append(1)
        return np.array([0]), np.array([3000])

    kern.on_staged_overflow(np.array([-2001]), 1024, probe, 1)
    assert (probes, kern.use_budget, kern.cap) == ([], 2048, 512)
    scan.on_staged_overflow(np.array([-3001]), 0, probe, 1)
    assert (probes, scan.cap) == ([1], 4096)
    kern.grow_budget(2048, 5000)        # past max_budget: dense
    assert kern.use_budget == 0


def test_straggler_host_fallback(world, monkeypatch):
    """A fat row whose ladder raises OverflowError (its run outgrew max_cap)
    finishes on the fp64 host loop, and the note says so. Its truncated
    tier-1 `within` may exceed k: such rows take no radius growth (the
    reference indexes past k there, fault F6)."""
    w = world["mixed"]
    port = w["ports"]["plain"]

    def overflow(*a, **kw):
        raise OverflowError("run outgrew max_cap")

    monkeypatch.setattr(texec, "_knn_refine", overflow)
    got = port.query(QueryBatch.knn(w["pts"], 10))
    want = w["want"][10]
    assert got.stages[-1].note == ("straggler radius outgrew max_cap: "
                                   "host fallback")
    for i, (a, b) in enumerate(zip(got.ids, want.ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"point {i}")
        np.testing.assert_allclose(got.distances[i], want.distances[i],
                                   rtol=1e-4, atol=1e-7)
