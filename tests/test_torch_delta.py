"""The ``device+delta`` slice: the port's added-set side table, its check,
the kNN rank with a delta, the patch-or-republish planner and the
double-buffered (async) republish, against the reference.

Both packages build the same fp32-representable ``mixed`` store of 2,000
records from the same seed and take the same writes. The reference compiles
``batch_check_added`` once per (table bucket, relation, window shape), so
every check here reuses one table of 70 added records (bucket 128) and one
window batch. Hit ids, plans, table fields and within-radius counts must be
equal; kNN distances agree to ``rtol=1e-6`` (``rect_geom_sqdist``: XLA on the
CPU contracts multiply-adds into FMAs). The async tests hold the background
build on a ``threading.Event`` (no sleeps decide anything), and every wait
is bounded and fails the test when it runs out.
"""
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro.core.engine import EngineConfig as RConfig  # noqa: E402
from repro.core.engine import QueryBatch as RBatch  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.engine import QueryBatch  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.core.index import GLINConfig as TGLINConfig  # noqa: E402

DEVICE_RELATIONS = ("intersects", "contains", "covers", "within", "touches",
                    "crosses", "dwithin:0.003")
N = 2000
WAIT_S = 30.0


def _fp32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _port_store(n, seed):
    gs = tdata.generate("mixed", n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = tgeom.mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def _ring(rng, c, r, nv):
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    return _fp32(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                          -1))


def _pair(seed=3, pl=300, **cfg):
    ref = RIndex.build(mixed_store(N, seed=seed),
                       RGLINConfig(piece_limitation=pl), RConfig(**cfg))
    port = TIndex.build(_port_store(N, seed), TGLINConfig(piece_limitation=pl),
                        TConfig(**cfg), device="cpu")
    return ref, port


def _same_ids(a, b, msg=""):
    assert len(a) == len(b), msg
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} row {i}")


def _table_np(t, module):
    """A delta table's fields as numpy (either package)."""
    out = {f: np.asarray(getattr(t, f) if module is rdev
                         else getattr(t, f).numpy())
           for f in ("ids", "zmin_hi", "zmin_lo", "zmax_hi", "zmax_lo",
                     "mbrs", "pool", "off", "nverts", "kinds")}
    out["max_width"] = t.max_width
    return out


@pytest.fixture(scope="module")
def world():
    """Both facades, published, then the same 70 inserts (rings of 1 to 64
    vertices, polylines among them) and 5 deletes of published records; the
    added-set tables at deltas of 0, 1 and 70, and 16 windows: some around
    added records, some flush against an added record's MBR (touches), some
    random."""
    ref, port = _pair(device_min_batch=1, stale_rebuild_min_batch=1)
    for idx in (ref, port):
        idx.snapshot()
    tables = {0: (_table_np(ref._delta_table(), rdev),
                  _table_np(port._delta_table(), tdev))}
    rng = np.random.default_rng(7)
    added = []
    for i in range(70):
        nv = (1, 2, 5, 9, 17, 64)[i % 6]
        kind = 1 if nv in (2, 9) else 0          # polylines
        ring = _ring(rng, rng.uniform(0.2, 0.8, 2), 10 ** rng.uniform(-4, -2),
                     nv)
        recs = [g.insert(ring, nv, kind) for g in (ref, port)]
        assert recs[0] == recs[1]
        added.append(recs[0])
        if i == 0:
            tables[1] = (_table_np(ref._delta_table(), rdev),
                         _table_np(port._delta_table(), tdev))
    for rec in (3, 40, 41, 1500, 1999):
        assert ref.delete(rec) and port.delete(rec)
    tables[70] = (_table_np(ref._delta_table(), rdev),
                  _table_np(port._delta_table(), tdev))
    mb = port.gs.mbrs[added]
    eps = 1e-3
    wins = np.concatenate([
        mb[:6] + np.array([-eps, -eps, eps, eps]),          # around
        np.stack([mb[6:11, 0] - eps, mb[6:11, 1], mb[6:11, 0],
                  mb[6:11, 3]], 1),                          # flush (touch)
        make_query_windows(ref.gs, 0.01, 5, seed=8)])
    return dict(ref=ref, port=port, tables=tables, added=added,
                wins=_fp32(wins).astype(np.float32))


@pytest.mark.parametrize("delta", [0, 1, 70])
def test_delta_table_fields_match_reference(world, delta):
    want, got = world["tables"][delta]
    assert got["max_width"] == want["max_width"]
    for f, v in want.items():
        if f != "max_width":
            assert got[f].dtype == v.dtype, f
            np.testing.assert_array_equal(got[f], v, err_msg=f)
    assert (want["ids"] >= 0).sum() == delta
    assert want["ids"].shape[0] == (128 if delta == 70 else 64)


@pytest.mark.parametrize("chunk", ["default", "small"])
@pytest.mark.parametrize("relation", DEVICE_RELATIONS)
def test_batch_check_added_matches_reference(world, relation, chunk,
                                             monkeypatch):
    ref, port, wins = world["ref"], world["port"], world["wins"]
    rs = ref.snapshot() if not ref.snapshot_is_stale() else ref._snapshot
    args = (relation, rs.grid_x0, rs.grid_y0, rs.grid_cell)
    want = np.asarray(rdev.batch_check_added(ref._delta_table(),
                                             jnp.asarray(wins), *args))
    if chunk == "small":    # one lane a chunk at the table's width 64
        monkeypatch.setattr(tgeom, "_EXACT_CHUNK_ELEMS", 64)
    got = tdev.batch_check_added(port._delta_table(), torch.from_numpy(wins),
                                 *args)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if relation in ("intersects", "touches", "dwithin:0.003"):
        assert want.any()


def test_batch_knn_rank_with_delta_matches_reference(world):
    """Snapshot hits (-1 padding, tombstones) plus the 70-record delta,
    ranked by exact distance: ids, distances and counts over both."""
    ref, port = world["ref"], world["port"]
    rpods = ref._device_payload(ref._snapshot_recs)[0]
    tpods = port._device_payload(port._snapshot_recs)
    rng = np.random.default_rng(13)
    q, b, k = 16, 32, 10
    hits = rng.integers(-1, N, (q, b)).astype(np.int32)
    tomb = np.asarray([3, 40, 41], np.int32)
    hits[:, 0] = 40
    pts = world["wins"][:, :2]
    wins = np.concatenate([pts, pts], 1).astype(np.float32)
    radius = rng.uniform(0.005, 0.1, q).astype(np.float32)
    want = rdev.batch_knn_rank(jnp.asarray(wins), rpods, jnp.asarray(hits),
                               jnp.asarray(radius), k, "sort",
                               tombstones=jnp.asarray(tomb),
                               delta=ref._delta_table())
    for impl in ("sort", "kernel"):
        got = tdev.batch_knn_rank(torch.from_numpy(wins), tpods,
                                  torch.from_numpy(hits),
                                  torch.from_numpy(radius), k, impl,
                                  tombstones=torch.from_numpy(tomb),
                                  delta=port._delta_table())
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.isin(np.asarray(want[0]), world["added"]).any()
    assert not np.isin(np.asarray(want[0]), tomb).any()


def test_facade_patch_matches_reference(world):
    """The facades on the stale snapshot: the window patch through the
    device table (70 added >= delta_device_min) for a relation, its
    complement and a host-finished relation, and device+delta kNN."""
    ref, port, wins = world["ref"], world["port"], world["wins"]
    w = wins.astype(np.float64)
    for rel in ("intersects", "disjoint"):
        a, b = ref.query(w, rel), port.query(w, rel)
        assert (a.plan.backend, a.plan.reason, a.plan.delta_size) == (
            b.plan.backend, b.plan.reason, b.plan.delta_size)
        assert b.plan.backend == "device+delta"
        _same_ids(b.ids, a.ids, rel)
        _same_ids(b.ids, port.query(w, rel, backend="host").ids, rel)
        st = {s.stage: s for s in b.stages}["delta-patch"]
        assert (st.delta_added, st.delta_tombstoned, st.dispatches) == (
            70, 5, 1)
    pts = np.concatenate([w[:, :2], w[:, 2:]])[:16]
    a = ref.query(RBatch.knn(pts, 5))
    b = port.query(QueryBatch.knn(pts, 5))
    assert a.plan.reason == b.plan.reason
    assert b.plan.backend == "device+delta"
    _same_ids(b.ids, a.ids, "knn")
    for x, y in zip(b.distances, a.distances):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)
    _same_ids(b.ids, port.query(QueryBatch.knn(pts, 5, backend="host")).ids)
    assert any(np.isin(r, world["added"]).any() for r in b.ids)
    st = b.stages[0]
    assert (st.delta_added, st.delta_tombstoned) == (70, 5)


# ------------------------------------------------------ write stream --
def test_write_heavy_stream_plans_and_ids_match_reference():
    """The reference's write-heavy parity stream, cut to 30 steps:
    interleaved inserts (one wider than any record between publishes) and
    deletes, three relations a step; plans, ids and the republish points
    equal the reference's, and the host's."""
    cfg = dict(device_min_batch=1, stale_rebuild_min_batch=1,
               refresh_threshold=12, delta_patch_max=4096)
    ref, port = _pair(seed=21, pl=100, **cfg)
    for idx in (ref, port):
        idx.snapshot()
    rng = np.random.default_rng(23)
    wins = _fp32(make_query_windows(ref.gs, 0.02, 3, seed=4))
    width0 = ref.gs.max_nverts
    kinds = set()
    for step in range(30):
        if step == 15:        # a ring wider than any record
            nv = width0 + 4
            v = _ring(rng, np.array([0.5, 0.5]), 3e-3, nv)
            assert ref.insert(v, nv, 0) == port.insert(v, nv, 0)
        elif rng.random() < 0.6:
            v = _ring(rng, rng.uniform(0.2, 0.8, 2), 3e-4, 6)
            assert ref.insert(v, 6, 0) == port.insert(v, 6, 0)
        else:
            live = np.nonzero(ref.glin._live_mask())[0]
            rec = int(rng.choice(live))
            assert ref.delete(rec) and port.delete(rec)
        for rel in ("intersects", "contains", "disjoint"):
            a, b = ref.query(wins, rel), port.query(wins, rel)
            key = ("backend", "reason", "delta_size", "rebuild_snapshot")
            assert [getattr(b.plan, f) for f in key] == [
                getattr(a.plan, f) for f in key], (step, rel)
            kinds.add(b.plan.backend)
            _same_ids(b.ids, a.ids, f"step {step} {rel}")
            _same_ids(b.ids, port.query(wins, rel, backend="host").ids)
        assert port.stats()["snapshot_publishes"] == ref._publishes
    assert kinds == {"device", "device+delta"}
    assert port.stats()["snapshot_publishes"] >= 2


# ------------------------------------------------- double buffering --
class HeldBuild:
    """Stands in for ``engine.snapshot_from_capture``: on the build thread it
    signals ``entered``, waits for ``release`` (bounded), then builds — or
    raises, to test a failed build; a synchronous publish passes through."""

    def __init__(self, monkeypatch, fail=False):
        self.real = teng.snapshot_from_capture
        self.entered, self.release = threading.Event(), threading.Event()
        self.fail = fail
        monkeypatch.setattr(teng, "snapshot_from_capture", self)

    def __call__(self, cap, device):
        if threading.current_thread().name != "glin-republish":
            return self.real(cap, device)
        self.entered.set()
        if not self.release.wait(WAIT_S):
            raise TimeoutError("the test never released the build")
        if self.fail:
            raise ValueError("build failed")
        return self.real(cap, device)

    def finish(self, idx):
        """Release the build and wait (bounded) until it is done."""
        self.release.set()
        inf = idx._inflight
        assert inf is not None and inf.done.wait(WAIT_S), "build never ended"


def _async_index(n, seed, threshold):
    gs = _port_store(n, seed)
    idx = TIndex.build(gs, TGLINConfig(piece_limitation=300),
                       TConfig(device_min_batch=1, stale_rebuild_min_batch=1,
                               delta_patch_max=threshold,
                               refresh_threshold=threshold,
                               async_republish=True), device="cpu")
    idx.snapshot()
    wins = _fp32(make_query_windows(gs, 0.02, 4, seed=6))
    return idx, wins


def _check_exact(idx, wins, rel="intersects"):
    res = idx.query(wins, rel)
    _same_ids(res.ids, idx.query(wins, rel, backend="host").ids, rel)
    return res


def test_async_republish_streams_exact_across_swap(monkeypatch):
    """Queries streamed while the next snapshot builds on the side are
    exact, including writes landing mid-build: a deleted record the pending
    snapshot holds comes out tombstoned after the swap, and a record
    inserted mid-build stays in the delta."""
    idx, wins = _async_index(N, 21, 8)
    rng = np.random.default_rng(23)
    held = HeldBuild(monkeypatch)
    for _ in range(9):                       # delta over refresh_threshold
        idx.insert(_ring(rng, rng.uniform(0.3, 0.7, 2), 3e-4, 6), 6, 0)
    pubs0 = idx.stats()["snapshot_publishes"]
    res = _check_exact(idx, wins)            # starts the build
    assert held.entered.wait(WAIT_S) and idx.republish_inflight()
    assert res.plan.backend == "device+delta"
    assert "async republish in flight" in res.plan.reason
    assert idx.stats()["republish_inflight"]
    victim = int(idx.query(wins, "intersects", backend="host")[0][0])
    assert idx.delete(victim)
    c = np.array([wins[0][[0, 2]].mean(), wins[0][[1, 3]].mean()])
    late = idx.insert(_ring(rng, c, 2e-3, 6), 6, 0)
    for rel in ("intersects", "contains", "disjoint"):   # served in flight
        res = _check_exact(idx, wins, rel)
        assert res.plan.backend == "device+delta"
    assert idx.stats()["snapshot_publishes"] == pubs0
    held.finish(idx)
    res = _check_exact(idx, wins)            # the poll swaps it in
    assert idx.stats()["snapshot_publishes"] == pubs0 + 1
    assert not idx.republish_inflight()
    assert victim in idx._tombstones and late in idx._added
    assert idx.delta_size() == 2
    assert victim not in res[0] and late in res[0]
    assert res.plan.backend == "device+delta"


def test_async_republish_discarded_by_sync_publish(monkeypatch):
    """A synchronous publish that overtakes the in-flight build wins: the
    pending snapshot (an older epoch) is discarded, never swapped in."""
    idx, wins = _async_index(N, 29, 4)
    rng = np.random.default_rng(31)
    held = HeldBuild(monkeypatch)
    for _ in range(5):
        idx.insert(_ring(rng, rng.uniform(0.3, 0.7, 2), 3e-4, 6), 6, 0)
    idx.query(wins, "intersects")
    assert held.entered.wait(WAIT_S) and idx.republish_inflight()
    inflight_epoch = idx._inflight.epoch
    idx.insert(_ring(rng, rng.uniform(0.3, 0.7, 2), 3e-4, 6), 6, 0)
    inf = idx._inflight
    snap = idx.snapshot()                    # sync publish at a newer epoch
    pubs = idx.stats()["snapshot_publishes"]
    assert idx._inflight is inf              # still building, still held
    held.release.set()
    assert inf.done.wait(WAIT_S), "build never ended"
    _check_exact(idx, wins)                  # poll point
    assert idx.stats()["snapshot_publishes"] == pubs
    assert idx._snapshot is snap and not idx.republish_inflight()
    assert idx.snapshot_epoch > inflight_epoch


def test_failed_async_build_raises_on_the_caller(monkeypatch):
    idx, wins = _async_index(1000, 5, 4)
    rng = np.random.default_rng(2)
    held = HeldBuild(monkeypatch, fail=True)
    for _ in range(5):
        idx.insert(_ring(rng, rng.uniform(0.3, 0.7, 2), 3e-4, 6), 6, 0)
    idx.query(wins, "intersects")
    held.finish(idx)
    with pytest.raises(RuntimeError, match="async snapshot republish "
                       "failed") as e:
        idx.query(wins, "intersects")
    assert isinstance(e.value.__cause__, ValueError)
    assert not idx.republish_inflight()


def test_serving_generation_moves_on_write_and_publish():
    idx = TIndex.build(_port_store(1000, 4), TGLINConfig(piece_limitation=300),
                       TConfig(device_min_batch=1), device="cpu")
    g0 = idx.serving_generation
    idx.snapshot()
    g1 = idx.serving_generation
    assert g1 != g0 and g1[0] == g0[0]
    idx.insert(_ring(np.random.default_rng(3), np.array([0.5, 0.5]), 1e-3,
                     10), 10, 0)
    g2 = idx.serving_generation
    assert g2 != g1 and g2[1] == g1[1]


def test_replica_queries_exact_and_collapse_on_one_device(monkeypatch):
    idx = TIndex.build(_port_store(1000, 6), TGLINConfig(piece_limitation=300),
                       TConfig(device_min_batch=1, stale_rebuild_min_batch=1,
                               replicas=2), device="cpu")
    wins = _fp32(make_query_windows(idx.gs, 0.02, 4, seed=9))
    host = idx.query(wins, "intersects", backend="host")
    for rep in (0, 1, 3):
        res = idx.query(wins, "intersects", replica=rep)
        _same_ids(res.ids, host.ids, f"replica {rep}")
    assert idx._replica_places == {}        # one device: the primary
    assert idx.stats()["replicas"] == 2
    # a replica on another device (stood in by cpu:0): its own placement,
    # made once per publish, refreshed after a write republishes
    monkeypatch.setattr(idx, "_replica_device",
                        lambda rep: torch.device("cpu", 0) if rep
                        else idx.device)
    for _ in range(2):
        res = idx.query(wins, "intersects", replica=1)
        _same_ids(res.ids, host.ids, "replica 1 placed")
    key = idx._replica_places[1][0]
    assert key[0] == idx.stats()["snapshot_publishes"]
    idx.insert(_ring(np.random.default_rng(1),
                     np.array([wins[0][[0, 2]].mean(),
                               wins[0][[1, 3]].mean()]), 1e-3, 6), 6, 0)
    idx.snapshot()
    res = idx.query(wins, "intersects", replica=1)
    _same_ids(res.ids, idx.query(wins, "intersects", backend="host").ids)
    assert idx._replica_places[1][0][0] == key[0] + 1
    pts = np.concatenate([wins[:, :2]] * 4)[:16]
    a = idx.query(QueryBatch.knn(pts, 3), replica=1)
    b = idx.query(QueryBatch.knn(pts, 3, backend="host"))
    _same_ids(a.ids, b.ids, "knn replica 1")


def test_replica_delta_table_placed_once_per_table(monkeypatch):
    """A replica on another device (stood in by cpu:0) checks the added set
    on its own copy of the delta table: one copy per table, a new one after
    a write, none for the primary; window and kNN answers exact."""
    idx = TIndex.build(_port_store(1000, 7), TGLINConfig(piece_limitation=300),
                       TConfig(device_min_batch=1, delta_device_min=1,
                               replicas=2), device="cpu")
    wins = _fp32(make_query_windows(idx.gs, 0.02, 4, seed=10))
    idx.snapshot()
    monkeypatch.setattr(idx, "_replica_device",
                        lambda rep: torch.device("cpu", 0) if rep
                        else idx.device)
    rng = np.random.default_rng(4)
    for w in wins[:2]:
        c = np.array([w[[0, 2]].mean(), w[[1, 3]].mean()])
        idx.insert(_ring(rng, c, 1e-3, 6), 6, 0)
    pts = np.concatenate([wins[:, :2]] * 4)[:16]
    copies = []
    for step in range(2):
        for _ in range(2):
            res = idx.query(wins, "intersects", replica=1)
            assert res.plan.backend == "device+delta"
            _same_ids(res.ids, idx.query(wins, "intersects",
                                         backend="host").ids, "replica 1")
            copies.append(idx._replica_dtables[1])
        a = idx.query(QueryBatch.knn(pts, 3), replica=1)
        assert a.plan.backend == "device+delta"
        _same_ids(a.ids, idx.query(QueryBatch.knn(pts, 3,
                                                  backend="host")).ids,
                  "knn replica 1")
        assert idx._replica_dtables[1] is copies[-1]
        assert copies[-1][0] is idx._dtable
        assert copies[-1][1] is not idx._dtable
        if step == 0:
            c = np.array([wins[2][[0, 2]].mean(), wins[2][[1, 3]].mean()])
            idx.insert(_ring(rng, c, 1e-3, 6), 6, 0)
    assert copies[0] is copies[1] and copies[2] is copies[3]
    assert copies[1] is not copies[2]
    idx.query(wins, "intersects", replica=0)
    assert set(idx._replica_dtables) == {1}     # the primary keeps its own
    idx.snapshot()
    assert idx._replica_dtables == {}


def test_sync_publish_is_timed_by_part():
    idx = TIndex.build(_port_store(1000, 8), TGLINConfig(piece_limitation=300),
                       TConfig(), device="cpu")
    assert idx.stats()["sync_publish"] is None
    idx.snapshot()
    first = idx.stats()["sync_publish"]
    assert first["records"] == len(idx)
    assert all(first[k] >= 0 for k in ("capture_ms", "build_ms",
                                        "upload_ms"))
    idx.snapshot()                               # current: no publish
    assert idx.stats()["sync_publish"] == first
    idx.insert(_ring(np.random.default_rng(2), np.array([0.5, 0.5]), 1e-3,
                     6), 6, 0)
    idx.snapshot()
    assert idx.stats()["sync_publish"]["records"] == len(idx)
