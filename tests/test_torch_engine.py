"""The slice as a whole: the port's ``SpatialIndex`` facade against the
reference facade on the window scenarios of ``test_exec.py`` and
``test_oracle_parity.py``.

Both facades run with ``delta_patch_max=0`` — the planner without delta
patching (``tests/test_torch_delta.py`` holds the patch path) — and the
reference's device refine through the XLA reference of the fused kernel
(``fusion="reference"``). The port runs on the CPU with
``fusion="reference"`` (plain composition), ``fusion="kernel"`` (the
``refine_fused`` wrapper, which takes its plain version for CPU tensors) and
``fusion="off"`` (the staged path through the ``refine_compact`` wrapper).
Hit sets, plan backends and reasons, overflow-ladder escalations, the
insert/delete republish and ``count_candidates`` must agree exactly.
"""
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
# small tensors: one torch thread per xdist worker beats oversubscribing
# the cores the workers share
torch.set_num_threads(1)

from _oracle import mixed_store, oracle_query  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro.core.engine import EngineConfig as RConfig  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.engine import QueryBatch  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.core.index import GLINConfig as TGLINConfig  # noqa: E402

RELATIONS = ("intersects", "contains", "covers", "within", "disjoint",
             "touches", "crosses", "dwithin:0.004")
FUSIONS = ("reference", "kernel", "off")
_N = 400


def _fp32(w):
    return np.asarray(w, np.float32).astype(np.float64)


def port_mixed_store(n, seed):
    gs = tdata.generate("mixed", n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = tgeom.mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def build_pair(n=_N, seed=3, pl=500, fusions=FUSIONS, **cfg):
    """The reference facade and one port facade per fusion mode over the
    same store (each package generates its own copy from the seed)."""
    ref = RIndex.build(mixed_store(n, seed=seed),
                       RGLINConfig(piece_limitation=pl),
                       RConfig(delta_patch_max=0, fusion="reference", **cfg))
    ports = {f: TIndex.build(port_mixed_store(n, seed),
                             TGLINConfig(piece_limitation=pl),
                             TConfig(delta_patch_max=0, fusion=f, **cfg),
                             device="cpu")
             for f in fusions}
    return ref, ports


def _same_ids(a, b, msg=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} window {i}")


@pytest.fixture(scope="module")
def parity():
    ref, ports = build_pair(device_min_batch=1, stale_rebuild_min_batch=1)
    wins = _fp32(make_query_windows(ref.gs, 0.02, 6, seed=7))
    return ref, ports, wins


# ------------------------------------------------------------ hit sets --
@pytest.mark.parametrize("relation", RELATIONS)
def test_facade_parity_all_fusion_modes(parity, relation):
    ref, ports, wins = parity
    want = ref.query(wins, relation)
    assert want.plan.backend == "device"
    host = ref.query(wins, relation, backend="host")
    live = ref.glin._live_mask()
    gs = ref.gs
    for qi, w in enumerate(wins):    # the fp32 oracle, as test_oracle_parity
        np.testing.assert_array_equal(want[qi], oracle_query(
            w.astype(np.float32), gs.verts.astype(np.float32), gs.nverts,
            gs.kinds, relation, live))
    rstage = {s.stage: s for s in want.stages}
    for fusion, idx in ports.items():
        got = idx.query(wins, relation)
        assert got.plan.backend == "device"
        assert got.plan.fused == (fusion != "off")
        _same_ids(got.ids, want.ids, f"{fusion}/{relation}")
        _same_ids(idx.query(wins, relation, backend="host").ids, host.ids,
                  f"host/{relation}")
        st = {s.stage: s for s in got.stages}
        assert [s.stage for s in got.stages] == ["refine",
                                                 "complement-finish"]
        assert st["refine"].impl == ("device" if fusion == "off"
                                     else rstage["refine"].impl)
        assert st["refine"].survivors == rstage["refine"].survivors
        assert (st["complement-finish"].skipped
                == rstage["complement-finish"].skipped)
        assert got.total_hits == want.total_hits


def test_explain_and_stats_match_reference(parity):
    ref, ports, wins = parity
    idx = ports["reference"]
    a, b = ref.explain(wins, "disjoint"), idx.explain(wins, "disjoint")
    assert a == b, (a, b)
    st = idx.stats()["stages"]
    if st:    # earlier parity tests ran queries on this facade
        assert st["device"]["refine"]["impl"] == "fused"
    res = ports["off"].query(wins, "intersects")
    assert res.stages[0].dispatches == 3


# ------------------------------------------------------ planner decisions --
def test_plan_backends_and_reasons_match_reference():
    """Default planner thresholds: small batches, stale snapshots before
    and after the first publish, forced backends, stats-collecting batches,
    and the synchronous republish that replaces delta patching."""
    from repro.core.engine import QueryBatch as RQueryBatch

    ref, ports = build_pair(fusions=("reference",))
    idx = ports["reference"]
    w8 = _fp32(make_query_windows(ref.gs, 0.01, 8, seed=1))
    w80 = _fp32(make_query_windows(ref.gs, 0.01, 80, seed=2))

    def plans(wins, rel="intersects", **kw):
        return (ref.plan(RQueryBatch.window(wins, rel, **kw)),
                idx.plan(QueryBatch.window(wins, rel, **kw)))

    def check(*args, **kw):
        a, b = plans(*args, **kw)
        assert (a.backend, a.reason, a.fused, a.rebuild_snapshot,
                a.base_relation, a.delta_size) == (
                    b.backend, b.reason, b.fused, b.rebuild_snapshot,
                    b.base_relation, b.delta_size)
        return b

    assert check(w8).backend == "host"                 # small batch
    assert check(w80).reason.startswith("no published snapshot yet")
    assert check(w80, collect_stats=True).backend == "host"
    assert check(w8, backend="device").backend == "device"
    assert check(w80, backend="host").backend == "host"
    assert check(w80, "disjoint").base_relation == "intersects"
    ref.snapshot()
    idx.snapshot()
    assert check(w80).reason == "batch of 80 windows on cpu; fused " \
        "one-kernel refine"
    ring = _fp32(0.5 + 0.01 * np.random.default_rng(4).uniform(-1, 1,
                                                               (6, 2)))
    for g in (ref, idx):                               # stale + delta
        g.insert(ring, 6, 0)
        assert g.delete(3)
    assert check(w8).backend == "host"                 # stale, small batch
    a, b = plans(w80)
    assert a.backend == b.backend == "device" and b.rebuild_snapshot
    assert a.delta_size == b.delta_size == 2
    head = "snapshot stale; delta of 2 not patchable"
    tail = "republishing for batch of 80; fused one-kernel refine"
    assert a.reason.startswith(head) and b.reason.startswith(head)
    assert a.reason.endswith(tail) and b.reason.endswith(tail)
    with pytest.raises(ValueError, match="requires EngineConfig.mesh"):
        idx.plan(QueryBatch.window(w8, "intersects", backend="sharded"))
    from repro.core.engine import QueryBatch as RBatch   # kNN plans too
    a = idx.plan(QueryBatch.knn([[0.5, 0.5]], k=3))
    b = ref.plan(RBatch.knn([[0.5, 0.5]], k=3))
    assert (a.kind, a.backend, a.reason) == (b.kind, b.backend, b.reason)
    assert a.backend == "host"              # one point < knn_device_min_batch


def test_first_publish_reason_matches_reference():
    ref, ports = build_pair(fusions=("reference",),
                            stale_rebuild_min_batch=16)
    w = _fp32(make_query_windows(ref.gs, 0.01, 20, seed=3))
    a = ref.query(w, "within")
    b = ports["reference"].query(w, "within")
    assert a.plan.reason == b.plan.reason
    assert a.plan.reason.startswith("no published snapshot yet")
    _same_ids(b.ids, a.ids)


# ---------------------------------------------------------- overflow ladder --
@pytest.mark.parametrize("fused", [True, False])
def test_overflow_ladder_matches_reference(fused):
    """A budget of 8 against a whole-domain window: the shared ladder grows
    the budget straight past the survivor count — same escalations,
    dispatches and settled budget/cap as the reference, exact hits."""
    cfg = dict(device_min_batch=1, stale_rebuild_min_batch=1, exact_budget=8,
               initial_cap=1 << 14)
    ref = RIndex.build(mixed_store(_N, seed=5), RGLINConfig(
        piece_limitation=200), RConfig(
            delta_patch_max=0, fusion="reference" if fused else "off",
            compaction="scan", **cfg))
    fusions = ("reference", "kernel") if fused else ("off",)
    lo = ref.gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = ref.gs.mbrs[:, 2:].max(axis=0) + 0.01
    w = np.array([[lo[0], lo[1], hi[0], hi[1]],
                  [0.4, 0.4, 0.45, 0.45]])
    want = ref.query(w, "intersects")
    rst = want.stages[0]
    assert rst.escalations >= 1
    for fusion in fusions:
        for comp in (("scan", "kernel") if fusion == "off" else (None,)):
            idx = TIndex.build(port_mixed_store(_N, 5),
                               TGLINConfig(piece_limitation=200),
                               TConfig(fusion=fusion, compaction=comp, **cfg),
                               device="cpu")
            got = idx.query(w, "intersects")
            _same_ids(got.ids, want.ids, f"{fusion}/{comp}")
            st = got.stages[0]
            # the compact kernel is capless: its budget overflows need no
            # disambiguating bounds probe, which the reference's staged
            # stage spends (and counts) on every escalation
            probes = rst.escalations if comp == "kernel" else 0
            assert (st.escalations, st.dispatches, st.budget, st.cap) == (
                rst.escalations, rst.dispatches - probes, rst.budget,
                rst.cap), (fusion, comp, st, rst)
            assert idx.device_cap == ref.device_cap


def test_fused_ladder_escalates_to_dense():
    """Survivors past MAX_COMPACT_BUDGET: the fused stage hands the dense
    retry to the staged path and stays exact. (The reference's fused stage
    raises here — it reads the escalated budget 0 as the configured one;
    ROADMAP fault F4.)"""
    idx = TIndex.build(port_mixed_store(1500, 6),
                       TGLINConfig(piece_limitation=250),
                       TConfig(device_min_batch=1, stale_rebuild_min_batch=1,
                               exact_budget=8, fusion="kernel"),
                       device="cpu")
    lo = idx.gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = idx.gs.mbrs[:, 2:].max(axis=0) + 0.01
    w = np.array([[lo[0], lo[1], hi[0], hi[1]], [0.4, 0.4, 0.42, 0.42]])
    res = idx.query(w, "intersects")
    st = res.stages[0]
    assert st.impl == "fused" and st.budget == 0 and st.escalations >= 1
    assert st.note == "fused envelope exceeded: staged fallback"
    _same_ids(res.ids, idx.query(w, "intersects", backend="host").ids)
    assert len(res[0]) == len(idx.gs) > 1024


# --------------------------------------------------- writes and republish --
def test_insert_delete_republish_matches_reference(parity):
    """Writes after a publish: a device-sized batch republishes the
    snapshot synchronously in both packages; results equal the host and the
    reference's, and the epoch/publish counters move alike."""
    ref, ports = build_pair(fusions=("kernel",), device_min_batch=1,
                            stale_rebuild_min_batch=4)
    idx = ports["kernel"]
    wins = np.concatenate([_fp32(make_query_windows(ref.gs, 0.02, 4, seed=9)),
                           _fp32([[0.3, 0.3, 0.5, 0.5],
                                  [0.58, 0.58, 0.72, 0.72]])])
    for g in (ref, idx):
        g.snapshot()
        rng = np.random.default_rng(11)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 10))
        rad = np.where(np.arange(10) % 2 == 0, 0.05, 0.0175)
        star = _fp32(np.stack([0.4 + rad * np.cos(ang),
                               0.4 + rad * np.sin(ang)], -1))
        g.insert(star, 10, 0)
        g.insert(_fp32([[0.35, 0.45], [0.55, 0.38], [0.6, 0.5]]), 3, 1)
        for rec in (5, 17, 40):
            assert g.delete(rec)
        assert g.snapshot_is_stale() and g.delta_size() == 5
    for rel in ("intersects", "disjoint"):
        a, b = ref.query(wins, rel), idx.query(wins, rel)
        assert a.plan.backend == b.plan.backend == "device"
        # the first batch republishes; the second finds the snapshot fresh
        assert (a.plan.rebuild_snapshot == b.plan.rebuild_snapshot
                == (rel == "intersects"))
        _same_ids(b.ids, a.ids, rel)
        _same_ids(b.ids, idx.query(wins, rel, backend="host").ids, rel)
    assert not idx.snapshot_is_stale()
    assert (idx.epoch, idx.stats()["snapshot_publishes"]) == (
        ref.epoch, ref.stats()["snapshot_publishes"])
    small = idx.query(wins[:2], "intersects")   # fresh again: device
    assert small.plan.backend == "device"


def test_count_candidates_matches_reference(parity):
    ref, ports, wins = parity
    for rel in ("intersects", "within", "dwithin:0.004", "disjoint"):
        want = ref.count_candidates(wins, rel)
        for idx in ports.values():
            got = idx.count_candidates(wins, rel)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32


# -------------------------------------------- complement under writers --
def test_complement_finish_exact_at_frozen_epoch_under_writes(monkeypatch):
    """The device pipeline freezes the live-id set under the lock BEFORE its
    unlocked device compute: records inserted while the compute runs must
    not leak into a complement answer."""
    import repro_torch.core.engine as eng

    idx = TIndex.build(port_mixed_store(600, 2),
                       TGLINConfig(piece_limitation=250),
                       TConfig(device_min_batch=1, stale_rebuild_min_batch=1,
                               fusion="off"), device="cpu")
    idx.snapshot()
    w = _fp32([0.4, 0.4, 0.6, 0.6])
    base = idx.query(w[None], "intersects", backend="host")[0]
    live0 = np.nonzero(idx.glin._live_mask())[0].astype(np.int64)
    entered, release = threading.Event(), threading.Event()
    real = eng.batch_query

    def slow(*a, **kw):
        entered.set()
        release.wait(10.0)
        return real(*a, **kw)

    monkeypatch.setattr(eng, "batch_query", slow)
    inserted = []

    def writer():
        entered.wait(10.0)
        rng = np.random.default_rng(13)
        for _ in range(5):
            c = rng.uniform(0.9, 0.95, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
            v = np.stack([c[0] + 5e-4 * np.cos(ang),
                          c[1] + 5e-4 * np.sin(ang)], -1)
            inserted.append(idx.insert(_fp32(v), 8, 0))
        release.set()

    t = threading.Thread(target=writer)
    t.start()
    try:
        res = idx.query(w[None], "disjoint", backend="device")
    finally:
        release.set()
        t.join(10.0)
    assert len(inserted) == 5
    assert not np.isin(inserted, res[0]).any()
    np.testing.assert_array_equal(res[0], np.setdiff1d(live0, base))
    assert texec.PIPELINE_STAGES[-1] == "complement-finish"
