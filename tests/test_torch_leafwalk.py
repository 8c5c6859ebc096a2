"""The leaf-level walk of the compact and fused refine kernels, on the CPU.

The kernels (``csrc/refine.cu``, ``walk_run``) walk each query's slot run
group -> leaf -> slot over tables built once per publish, and must give
exactly what the per-slot definition (the plain versions, and the
reference's ``refine_compact_ref``) gives. Here, where no card is:

* the group rows (``core.device.leaf_group_mbrs``) against a numpy
  min/max union — empty leaves, NaN and inverted rows, ``L`` not a multiple
  of 32 — and the property the walk needs of them;
* the invariant the walk rests on, ``slot_lmbr[s] == leaf_mbr[rec_leaf[s]]``
  with ``leaf_start`` consistent with ``rec_leaf``, on a snapshot carried
  from the reference, on the port's own padded snapshot and after an
  insert + delete republish;
* the containment the count walk rests on: every real slot's record MBR
  inside its leaf's MBR in fp32, on the carried snapshot and after an
  insert + delete republish;
* the walk's design, as a plain loop (``_leafwalk.walk_emulation``), against
  the plain per-slot version: real leaves, spliced empty leaves, slot-as-leaf
  tables, runs that start and end mid-leaf, both prefilters, past the budget,
  and the count kernel's count-only walk against ``refine_count_plain``;
* the wrappers' checks of the new operands and the arguments they hand the
  kernel (the launch recorded, not run);
* ``ops.refine_compact``: the reference's signature, and its results.
"""
import inspect

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from _leafwalk import slot_walk, spliced_walk, walk_emulation  # noqa: E402
from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro.core.engine import EngineConfig as REngineConfig  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLIN as RGLIN  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import refine as kr  # noqa: E402


@pytest.fixture(scope="module")
def world():
    """The reference snapshot of an odd N=347 mixed store carried into the
    port, 15 windows, runs that start and end mid-leaf, an empty, an
    inverted and a whole-table run."""
    gs = mixed_store(347, seed=3)
    g = RGLIN.build(gs, RGLINConfig(piece_limitation=200))
    rs = RIndex(g, REngineConfig(pad_quantum=0)).snapshot()
    fields = {k: np.asarray(getattr(rs, k)) for k in tdev.SNAPSHOT_FIELDS}
    meta = {k: getattr(rs, k) for k in tdev.SNAPSHOT_META}
    ts = tdev.snapshot_from_numpy(fields, meta, device="cpu")
    lo = gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = gs.mbrs[:, 2:].max(axis=0) + 0.01
    wins = np.concatenate([
        make_query_windows(gs, 0.004, 13, seed=4),
        [[hi[0] + 1, hi[1] + 1, hi[0] + 2, hi[1] + 2],     # meets no leaf
         [lo[0], lo[1], hi[0], hi[1]]]]).astype(np.float32)
    rng = np.random.default_rng(5)
    n = len(gs)
    a = rng.integers(0, n, len(wins))
    b = rng.integers(0, n + 1, len(wins))
    bounds = np.stack([a, b], 1).astype(np.int32)   # some inverted
    bounds[0] = [5, 5]                               # empty run
    bounds[1] = [0, n]                               # the whole table
    bounds[-2] = [0, n]                              # ... for the far window
    rpods = rdev.pods_from_store(gs)
    tpods = tdev.pods_from_numpy(
        {k: np.asarray(getattr(rpods, k))
         for k in ("pool", "off", "nv", "kd", "bucket")}
        | {"max_width": rpods.max_width}, device="cpu")
    return dict(ts=ts, tpods=tpods, wins=torch.from_numpy(wins),
                bounds=torch.from_numpy(bounds))


@pytest.fixture(scope="module")
def port_index():
    """The port's own CPU index (bucket-padded snapshot: padding slots and
    empty padding leaves) over a 2,000-record mixed store."""
    return TIndex.build(tdata.generate("mixed", 2000, seed=7), device="cpu")


# ------------------------------------------------------------ group rows --
def _numpy_groups(mbr, start):
    """Row g: per column, the min (x0, y0) or max (x1, y1) of the non-NaN
    values of the non-empty leaves among 32 g .. 32 g + 31; inf / -inf when
    there is none."""
    n = mbr.shape[0]
    out = np.empty((-(-n // 32), 4), np.float32)
    for g in range(out.shape[0]):
        rows = [mbr[i] for i in range(32 * g, min(32 * g + 32, n))
                if start is None or start[i] < start[i + 1]]
        for c in range(4):
            vals = [r[c] for r in rows if not np.isnan(r[c])]
            if c < 2:
                out[g, c] = min(vals) if vals else np.inf
            else:
                out[g, c] = max(vals) if vals else -np.inf
    return out


@pytest.mark.parametrize("nl", [1, 31, 32, 77, 130])
def test_group_rows_match_numpy_union(nl):
    rng = np.random.default_rng(nl)
    lo = rng.uniform(-1, 1, (nl, 2)).astype(np.float32)
    mbr = np.concatenate([lo, lo + rng.uniform(0, 0.2, (nl, 2))], 1)
    mbr = mbr.astype(np.float32)
    sizes = rng.integers(0, 3, nl)                 # about a third empty
    start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    empty = np.flatnonzero(sizes == 0)
    mbr[empty[0::3]] = np.nan                       # NaN rows
    mbr[empty[1::3]] = [np.inf, np.inf, -np.inf, -np.inf]   # inverted
    mbr[empty[2::3]] = [-9, -9, 9, 9]               # covers everything
    if nl > 5:
        mbr[3, 0] = np.nan                          # one NaN coordinate
    got = tdev.leaf_group_mbrs(torch.from_numpy(mbr), torch.from_numpy(start))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _numpy_groups(mbr, start))
    # no empty leaf widens a row: every row lies in [-1, 1.2] or is inverted
    rows = got.numpy()
    assert np.all((rows[:, :2] >= -1) | np.isinf(rows[:, :2]))
    got_all = tdev.leaf_group_mbrs(torch.from_numpy(mbr))   # every leaf
    np.testing.assert_array_equal(got_all.numpy(), _numpy_groups(mbr, None))


def test_group_row_miss_rules_out_its_leaves(port_index):
    """What the walk needs: a window that misses group row g meets none of
    its non-empty leaves (min and max select, they never round)."""
    s = port_index.snapshot()
    walk = s.leaf_walk
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 1, (200, 2))
    r = rng.uniform(0, 0.05, (200, 1))
    wins = torch.from_numpy(np.concatenate([c - r, c + r], 1).astype(
        np.float32))
    nl = walk.leaf_mbr.shape[0]
    full = walk.leaf_start[1:] > walk.leaf_start[:-1]
    leaf_meets = tdev.geom.mbr_intersects(walk.leaf_mbr[None], wins[:, None])
    group_meets = tdev.geom.mbr_intersects(walk.group_mbr[None],
                                           wins[:, None])
    of_leaf = group_meets[:, torch.arange(nl) // 32]
    assert not bool((leaf_meets & full & ~of_leaf).any())
    assert bool((leaf_meets & full).any())


# ------------------------------------------------------------- invariant --
def _check_invariant(s):
    rl, ls = s.rec_leaf.long(), s.leaf_start.long()
    nl = s.leaf_mbr.shape[0]
    real = int(ls[-1])                  # padding slots lie past the sentinel
    assert ls.shape[0] == nl + 1 and bool((ls[1:] >= ls[:-1]).all())
    assert bool((rl[1:] >= rl[:-1]).all())
    r = rl[:real]
    assert bool(((r >= 0) & (r < nl)).all())
    slot = torch.arange(real)
    assert bool(((ls[r] <= slot) & (slot < ls[r + 1])).all())
    assert torch.equal(s.slot_lmbr[:real], s.leaf_mbr[r])


def test_walk_invariant_on_carried_snapshot(world):
    _check_invariant(world["ts"])


def test_walk_invariant_after_insert_delete_republish():
    idx = TIndex.build(tdata.generate("mixed", 2000, seed=7), device="cpu")
    s0 = idx.snapshot()
    _check_invariant(s0)
    assert s0.num_slots > int(s0.leaf_start[-1])       # padding slots
    assert s0.leaf_mbr.shape[0] + 1 > int(torch.unique(s0.leaf_start).numel())
    ring = np.asarray([[0.5, 0.5], [0.5001, 0.5], [0.5, 0.5001]])
    idx.insert(ring, 3, 0)
    assert idx.delete(11)
    s1 = idx.snapshot()
    assert s1 is not s0
    _check_invariant(s1)
    assert s1.leaf_walk is s1.leaf_walk           # built once per publish
    assert s1.fused_operands is s1.fused_operands


def _check_containment(s):
    """Every real slot's record MBR lies inside its leaf's MBR, in fp32:
    the count walk skips a leaf whose MBR misses, and the per-slot count
    tests record MBRs alone."""
    real = int(s.leaf_start[-1])
    rec = s.slot_rmbr[:real]
    leaf = s.leaf_mbr[s.rec_leaf[:real].long()]
    assert not bool(torch.isnan(rec).any())
    assert bool(((leaf[:, :2] <= rec[:, :2]) & (rec[:, 2:] <= leaf[:, 2:]))
                .all())


@pytest.mark.parametrize("case", ["carried", "republished"])
def test_record_mbrs_inside_leaf_mbrs(world, case):
    """On the snapshot carried from the reference; on the port's own padded
    snapshot, and again after inserts that grow leaf MBRs (a wide ring, a
    point outside every record) and a delete, republished."""
    if case == "carried":
        _check_containment(world["ts"])
        return
    idx = TIndex.build(tdata.generate("mixed", 2000, seed=8), device="cpu")
    s0 = idx.snapshot()
    _check_containment(s0)
    wide = np.asarray([[0.2, 0.3], [0.7, 0.31], [0.45, 0.9], [0.21, 0.6]])
    idx.insert(wide, 4, 2)
    idx.insert(np.asarray([[1.3, -0.2]]), 1, 0)
    assert idx.delete(17)
    s1 = idx.snapshot()
    assert s1 is not s0
    _check_containment(s1)


# ------------------------------------------------- the walk's design --
def _walks(s):
    return {"leaves": s.leaf_walk, "spliced": spliced_walk(s),
            "slots": slot_walk(s.slot_lmbr)}


@pytest.mark.parametrize("prefilter", ["intersects", "contains"])
@pytest.mark.parametrize("budget", [7, 4096])
def test_walk_emulation_matches_per_slot_plain(world, prefilter, budget):
    ts, w, b = world["ts"], world["wins"], world["bounds"]
    if prefilter == "contains":   # tiny windows that records can cover
        c = (w[:, :2] + w[:, 2:]) / 2
        w = torch.cat([c, c + 1e-5], 1)
    want = kr.refine_compact_plain(w, b, ts.slot_lmbr, ts.slot_rmbr, budget,
                                   prefilter)
    for name, walk in _walks(ts).items():
        got_s, got_c, _ = walk_emulation(w, b, ts.slot_rmbr, walk, budget,
                                         prefilter)
        assert torch.equal(got_s, want[0]), name
        assert torch.equal(got_c, want[1]), name
    assert (want[1] > 0).any()
    if prefilter == "intersects":
        assert want[1][-2] == 0                     # the far window
        if budget == 7:
            assert (want[1] > budget).any()         # a truncated row


def test_walk_emulation_on_padded_probe_runs(port_index):
    """The padded snapshot's probe runs and whole-table runs (padding slots
    and leaves included) walk to the per-slot answer, with far fewer group
    and leaf tests than run slots."""
    s = port_index.snapshot()
    gs = port_index.glin.gs
    w = torch.from_numpy(make_query_windows(gs, 0.002, 24, seed=9).astype(
        np.float32))
    start, end = tdev.batch_query_bounds(s, w, "intersects")
    b = torch.stack([start, end], 1)
    b[0] = torch.tensor([0, s.num_slots])
    want = kr.refine_compact_plain(w, b, s.slot_lmbr, s.slot_rmbr, 64,
                                   "intersects")
    for name, walk in _walks(s).items():
        got_s, got_c, tested = walk_emulation(w, b, s.slot_rmbr, walk, 64,
                                              "intersects")
        assert torch.equal(got_s, want[0]) and torch.equal(got_c, want[1]), \
            name
        if name == "leaves":
            assert sum(tested) < int((b[:, 1] - b[:, 0]).sum())


def _count_walks(s):
    """The count kernel's walks: the snapshot's leaves, spliced empty
    leaves, and slot-as-leaf mode, whose leaf rows are the record MBRs."""
    return {"leaves": s.leaf_walk, "spliced": spliced_walk(s),
            "slots": slot_walk(s.slot_rmbr)}


@pytest.mark.parametrize("walk_name", ["leaves", "spliced", "slots"])
@pytest.mark.parametrize("runs", ["mid-leaf", "padded probe"])
def test_count_walk_emulation_matches_plain(world, port_index, walk_name,
                                            runs):
    """The count-only walk (budget 0) equals the per-slot count of record
    MBRs: on the carried snapshot's mid-leaf, inverted, empty and
    whole-table runs, and on the padded snapshot's probe runs (one over
    every slot, padding included)."""
    if runs == "mid-leaf":
        s, w, b = world["ts"], world["wins"], world["bounds"]
    else:
        s = port_index.snapshot()
        w = torch.from_numpy(make_query_windows(
            port_index.glin.gs, 0.002, 24, seed=9).astype(np.float32))
        start, end = tdev.batch_query_bounds(s, w, "intersects")
        b = torch.stack([start, end], 1)
        b[0] = torch.tensor([0, s.num_slots])
    want = kr.refine_count_plain(w, b, s.slot_rmbr)
    slots, got, tested = walk_emulation(w, b, s.slot_rmbr,
                                        _count_walks(s)[walk_name], 0,
                                        "intersects")
    assert slots.shape == (w.shape[0], 0)
    assert torch.equal(got, want)
    assert (want > 0).any()
    if walk_name == "leaves" and runs == "padded probe":
        assert sum(tested) < int((b[:, 1] - b[:, 0]).sum())


# ------------------------------------------------------------- wrappers --
def test_walk_operand_validation(world):
    ts, w, b = world["ts"], world["wins"], world["bounds"]
    walk = ts.leaf_walk
    args = (w, b, ts.slot_lmbr, ts.slot_rmbr)
    with pytest.raises(TypeError, match="rec_leaf"):
        kr.refine_compact(*args, budget=8, leaves=walk._replace(
            rec_leaf=walk.rec_leaf.long()))
    with pytest.raises(ValueError, match="group_mbr"):
        kr.refine_compact(*args, budget=8, leaves=walk._replace(
            group_mbr=walk.group_mbr[:-1]))
    with pytest.raises(ValueError, match="leaf_start"):
        kr.refine_compact(*args, budget=8, leaves=walk._replace(
            leaf_start=walk.leaf_start[:-1]))
    with pytest.raises(ValueError, match="rec_leaf"):
        kr.refine_compact(*args, budget=8, leaves=walk._replace(
            rec_leaf=walk.rec_leaf[:-1]))
    with pytest.raises(ValueError, match="devices"):
        kr.refine_compact(*args, budget=8, leaves=walk._replace(
            leaf_mbr=walk.leaf_mbr.to("meta")))
    rel = tdev._device_relation("intersects")
    qk = torch.stack(tdev._raw_query_keys(ts, w, rel), 1)
    pods = world["tpods"]
    fused = (w, rel.probe_window(w), qk, *ts.fused_operands, pods.headers,
             pods.pool, ts.slot_lmbr, ts.slot_rmbr)
    kw = dict(budget=8, prefilter="intersects", code=0, dist=0.0,
              augment=False, search_steps=ts.search_steps, depth=ts.depth)
    with pytest.raises(TypeError, match="leaf_mbr"):
        kr.refine_fused(*fused, **kw, leaves=walk._replace(
            leaf_mbr=walk.leaf_mbr.double()))
    with pytest.raises(ValueError, match="devices"):
        kr.refine_fused(*fused, **kw, leaves=walk._replace(
            rec_leaf=walk.rec_leaf.to("meta")))
    # well-formed tables on the CPU: the plain version, no launch
    n0 = kr.refine_fused.launches
    h, c = kr.refine_fused(*fused, **kw, leaves=walk)
    want = kr.refine_fused_plain(*fused, **kw)
    assert torch.equal(h, want[0]) and torch.equal(c, want[1])
    assert kr.refine_fused.launches == n0


def test_kernel_arguments(world, monkeypatch):
    """What the wrappers hand the kernel (the route forced, the launch
    recorded): the walk tables in the C interface's order and counts; for
    compact in slot-as-leaf mode no leaf tables but group rows of the
    slot-aligned MBRs; the fused kernel refuses to run without tables."""
    ts, w, b = world["ts"], world["wins"], world["bounds"]
    calls = []
    monkeypatch.setattr(kr, "_route", lambda *t: True)
    monkeypatch.setattr(kr, "_launch",
                        lambda name, device, *a: calls.append((name, a)))
    walk = ts.leaf_walk
    n, nl = ts.num_slots, walk.leaf_mbr.shape[0]
    kr.refine_compact(w, b, ts.slot_lmbr, ts.slot_rmbr, budget=8,
                      prefilter="contains", leaves=walk)
    kr.refine_compact(w, b, ts.slot_lmbr, ts.slot_rmbr, budget=8)
    rel = tdev._device_relation("intersects")
    qk = torch.stack(tdev._raw_query_keys(ts, w, rel), 1)
    pods = world["tpods"]
    fused = (w, rel.probe_window(w), qk, *ts.fused_operands, pods.headers,
             pods.pool, ts.slot_lmbr, ts.slot_rmbr)
    kw = dict(budget=8, prefilter="intersects", code=0, dist=0.0,
              augment=False, search_steps=ts.search_steps, depth=ts.depth)
    kr.refine_fused(*fused, **kw, leaves=walk)
    with pytest.raises(ValueError, match="leaf_walk"):
        kr.refine_fused(*fused, **kw)
    for name, a in calls:
        assert len(a) + 1 == len(_build._SIGNATURES[name]), name
    (_, c1), (_, c2), (_, f1) = calls
    assert c1[2] is walk.rec_leaf and c1[3] is walk.leaf_start
    assert c1[4] is walk.leaf_mbr and c1[5] is walk.group_mbr
    assert c1[9:] == (w.shape[0], n, nl, 8, 1, 0)
    assert c2[2] is None and c2[3] is None and c2[4] is ts.slot_lmbr
    assert torch.equal(c2[5], tdev.leaf_group_mbrs(ts.slot_lmbr))
    assert c2[9:] == (w.shape[0], n, n, 8, 0, 1)
    assert f1[13] is walk.rec_leaf and f1[16] is walk.group_mbr
    assert f1[17] is ts.slot_rmbr and f1[-1] == nl


def test_count_kernel_arguments(world, monkeypatch):
    """What refine_count hands the kernel: the walk tables with ``leaves``;
    in slot-as-leaf mode (and through ``ops.refine_count``) no leaf tables,
    the record MBRs as leaf rows and their group rows. Bad walk operands
    raise before any route is taken."""
    ts, w, b = world["ts"], world["wins"], world["bounds"]
    walk = ts.leaf_walk
    rm = ts.slot_rmbr
    with pytest.raises(TypeError, match="rec_leaf"):
        kr.refine_count(w, b, rm, leaves=walk._replace(
            rec_leaf=walk.rec_leaf.long()))
    with pytest.raises(ValueError, match="group_mbr"):
        kr.refine_count(w, b, rm, leaves=walk._replace(
            group_mbr=walk.group_mbr[:-1]))
    with pytest.raises(ValueError, match="leaf_start"):
        kr.refine_count(w, b, rm, leaves=walk._replace(
            leaf_start=walk.leaf_start[:-1]))
    with pytest.raises(ValueError, match="rec_leaf"):
        kr.refine_count(w, b, rm, leaves=walk._replace(
            rec_leaf=walk.rec_leaf[:-1]))
    with pytest.raises(ValueError, match="devices"):
        kr.refine_count(w, b, rm, leaves=walk._replace(
            group_mbr=walk.group_mbr.to("meta")))
    n0 = kr.refine_count.launches
    assert torch.equal(kr.refine_count(w, b, rm, leaves=walk),
                       kr.refine_count_plain(w, b, rm))   # CPU: plain
    assert kr.refine_count.launches == n0
    calls = []
    monkeypatch.setattr(kr, "_route", lambda *t: True)
    monkeypatch.setattr(kr, "_launch",
                        lambda name, device, *a: calls.append((name, a)))
    kr.refine_count(w, b, rm, leaves=walk)
    kr.refine_count(w, b, rm)
    tops.refine_count(w, b, rm)
    assert kr.refine_count.launches == n0 + 3
    assert [name for name, _ in calls] == ["glin_refine_count"] * 3
    for name, a in calls:
        assert len(a) + 1 == len(_build._SIGNATURES[name])
    (_, c1), (_, c2), (_, c3) = calls
    n, nl, q = ts.num_slots, walk.leaf_mbr.shape[0], w.shape[0]
    assert c1[0] is w and c1[1] is b and c1[6] is rm
    assert c1[2] is walk.rec_leaf and c1[3] is walk.leaf_start
    assert c1[4] is walk.leaf_mbr and c1[5] is walk.group_mbr
    assert c1[7].shape == (q,) and c1[7].dtype == torch.int32
    assert c1[8:] == (q, n, nl, 0)
    for c in (c2, c3):
        assert c[2] is None and c[3] is None
        assert c[4] is rm and c[6] is rm
        assert torch.equal(c[5], tdev.leaf_group_mbrs(rm))
        assert c[8:] == (q, n, n, 1)


# ------------------------------------------------------- ops entry point --
def test_ops_refine_compact_keeps_reference_signature(world):
    ref = inspect.signature(rops.refine_compact).parameters
    got = inspect.signature(tops.refine_compact).parameters
    assert [p for p in ref if p != "use_pallas"] == [
        p for p in got if p != "use_kernel"]
    ts, w, b = world["ts"], world["wins"], world["bounds"]
    want = rops.refine_compact(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                               jnp.asarray(ts.slot_lmbr.numpy()),
                               jnp.asarray(ts.slot_rmbr.numpy()), budget=9,
                               use_pallas=False)
    got_s, got_c = tops.refine_compact(w, b, ts.slot_lmbr, ts.slot_rmbr,
                                       budget=9)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want[1]))
