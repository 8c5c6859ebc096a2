"""The sharded backend: the port's ``core.distributed`` and its stages
against the reference, on small fp32-representable stores.

The reference's sharded step is a ``shard_map`` over a JAX mesh, which
needs ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before JAX
is imported, so it runs ONCE per module in a subprocess (``_REF``), started
by the first test and read by a module fixture: a facade on a (4, 2) mesh
over the 3,000-record ``mixed`` store (every relation, kNN, a stale
snapshot served patched), the steps it built called again on fixed windows
(per-shard hits, counts and overflow codes, read back from its jit cache, so
nothing compiles twice), the overflow cases (a cap of 64, budgets of 8 and
0), one interpret-mode Pallas compaction, and a ``cluster`` store. Its
snapshots and sharded tables are carried into the port, so each port step
runs on the reference's own inputs. The port's mesh is the same (4, 2) grid,
every position on the CPU (``devices=["cpu"] * 8``).

Everything else runs in this process while the subprocess compiles: the
sharded tables against the reference's (numpy), each shard's leaf walk
against the per-slot compaction, the planner's sharded branches (plans
only), the ladder, and the facade against the port's fp64 host path.
Hit ids, counts and overflow codes must be equal; kNN distances agree to
``rtol=1e-6`` (``rect_geom_sqdist``: XLA on the CPU contracts multiply-adds
into FMAs).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from _leafwalk import walk_emulation  # noqa: E402
from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core import distributed as rdist  # noqa: E402
from repro.core import exec as rexec  # noqa: E402
from repro.core.datasets import generate as rgenerate  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro.core.engine import EngineConfig as RConfig  # noqa: E402
from repro.core.engine import QueryBatch as RBatch  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLIN as RGLIN  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.engine import QueryBatch  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.core.index import GLIN as TGLIN  # noqa: E402
from repro_torch.core.index import GLINConfig as TGLINConfig  # noqa: E402
from repro_torch.kernels import refine as kref  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RELATIONS = ("intersects", "contains", "covers", "within", "touches",
             "crosses", "dwithin:0.004", "disjoint")
DEVICE_RELATIONS = RELATIONS[:-1]
N, Q, K = 3000, 16, 5
PL = 300
# (relation, cap, budget, compaction, windows) of the reference's extra
# step calls: runs past the cap, survivors past the budget, the dense path
OVERFLOW_CASES = (("intersects", 64, 8, "scan", Q),
                  ("within", 64, 8, "scan", Q),
                  ("intersects", 64, 0, "scan", Q),
                  ("dwithin:0.004", 64, 0, "scan", Q),
                  ("intersects", 64, 8, "pallas", 4))
# (k, cap, budget) of the kNN step calls besides the facade's own: k past
# the budget (padded columns) with overflow codes, and the dense path
KNN_CASES = ((20, 64, 8), (K, 64, 0))
WAIT_S = 900

_REF = r'''
import dataclasses, json, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
from _oracle import mixed_store
from repro.core import exec as rexec
from repro.core.datasets import generate, make_query_windows
from repro.core.distributed import TABLE_KEYS, shard_arrays_from_capture
from repro.core.engine import EngineConfig, QueryBatch, SpatialIndex
from repro.core.geometry import mbrs_of_verts
from repro.core.index import GLINConfig, initial_knn_radius
from repro.utils.compat import make_auto_mesh

N, Q, K, PL = {N}, {Q}, {K}, {PL}
RELATIONS = {RELATIONS}
OVERFLOW_CASES = {OVERFLOW_CASES}
KNN_CASES = {KNN_CASES}
out, meta = {{}}, {{}}
assert jax.device_count() == 8
mesh = make_auto_mesh((4, 2), ("data", "model"))


def pack(key, rows):
    out[key + "/flat"] = np.concatenate(
        [np.asarray(r) for r in rows] + [np.empty(0)])
    out[key + "/lens"] = np.asarray([len(r) for r in rows])


def carry(key, idx):
    """The published snapshot and its sharded table, as numpy."""
    snap = idx._snapshot
    for f in dataclasses.fields(snap):
        if not f.metadata.get("static"):
            out[f"{{key}}/snap/{{f.name}}"] = np.asarray(getattr(snap, f.name))
    meta[key + "/snap_meta"] = {{
        k: getattr(snap, k) for k in ("search_steps", "depth", "grid_x0",
                                      "grid_y0", "grid_cell")}}
    table = shard_arrays_from_capture(idx._capture, 4)
    for k in TABLE_KEYS:
        out[f"{{key}}/table/{{k}}"] = table[k]


def stats(st):
    return {{k: getattr(st, k) for k in (
        "impl", "escalations", "dispatches", "cap", "budget", "survivors",
        "rungs", "seed_hits", "merge_bytes", "note")}} | {{
        "rung_hist": list(st.rung_hist)}}


cfg = EngineConfig(mesh=mesh, shard_min_records=1, device_min_batch=1,
                   stale_rebuild_min_batch=1, knn_device_min_batch=1,
                   knn_seed="global")
gs = mixed_store(N, seed=3)
F = SpatialIndex.build(gs, GLINConfig(piece_limitation=PL), cfg)
F.snapshot()
snap_repl, table, shards, maxw = F._sharded_placement()
carry("mixed", F)
meta["maxw"] = maxw
wins = make_query_windows(gs, 3e-3, Q, seed=5).astype(np.float32)
w64 = wins.astype(np.float64)
out["wins"] = wins
pts = ((wins[:, :2] + wins[:, 2:]) / 2).astype(np.float64)
pw = np.concatenate([pts, pts], 1).astype(np.float32)
r0 = float(rexec._pow2_radii(np.asarray(
    [initial_knn_radius(F.glin, K)]))[0])
relname = f"dwithin:{{r0:.17g}}"
meta["knn_relation"] = relname
cap0, b0 = cfg.initial_cap, cfg.exact_budget

# a cluster store: one step at a cap and budget of its own
g = generate("cluster", N, seed=3)
g.verts = g.verts.astype(np.float32).astype(np.float64)
g.mbrs = mbrs_of_verts(g.verts, g.nverts)
G = SpatialIndex.build(g, GLINConfig(piece_limitation=PL), cfg)
G.snapshot()
g_repl, g_table, _, g_maxw = G._sharded_placement()
carry("cluster", G)
meta["cluster_maxw"] = g_maxw
gw = make_query_windows(g, 3e-3, Q, seed=6).astype(np.float32)
out["cluster/wins"] = gw


def window_case(rel, cap, budget, comp, q):
    h, c = F._sharded_step(rel, cap, budget, comp, maxw)(
        snap_repl, wins[:q], table)
    return np.asarray(h), np.asarray(c)


def cluster_case():
    h, c = G._sharded_step("intersects", 128, 16, "scan", g_maxw)(
        g_repl, gw, g_table)
    return np.asarray(h), np.asarray(c)


def knn_case(k, cap, budget):
    comp = F._compaction(relname, budget or None)
    return tuple(np.asarray(a) for a in F._sharded_knn_step(
        relname, k, cap, budget, comp, maxw)(snap_repl, pw, table))


# every step this script calls, compiled side by side in four threads
# (XLA compiles outside the GIL; four leave the suite's other workers
# their cores); the facade below then finds its steps built
cases = {{f"step/{{rel}}": (window_case, (rel, cap0, b0, "scan", Q))
          for rel in RELATIONS[:-1]}}
cases.update({{f"step/{{rel}}/{{cap}}/{{budget}}/{{comp}}":
               (window_case, (rel, cap, budget, comp, q))
               for rel, cap, budget, comp, q in OVERFLOW_CASES}})
cases.update({{f"knnstep/{{k}}/{{cap}}/{{budget}}": (knn_case, (k, cap, budget))
               for k, cap, budget in ((K, cap0, b0),) + KNN_CASES}})
cases["cluster"] = (cluster_case, ())
with ThreadPoolExecutor(4) as ex:
    futs = {{key: ex.submit(fn, *args) for key, (fn, args) in cases.items()}}
    for key, fut in futs.items():
        got = fut.result()
        names = (("ids", "dist", "counts") if key.startswith("knn")
                 else ("hits", "counts"))
        for name, a in zip(names, got):
            out[f"{{key}}/{{name}}"] = a
for rel in RELATIONS:
    res = F.query(w64, rel)
    pack(f"facade/{{rel}}", res.ids)
    meta[f"facade/{{rel}}"] = {{"reason": res.plan.reason,
                              "backend": res.plan.backend,
                              "stages": [stats(s) for s in res.stages]}}
    if rel != "disjoint":
        st = res.stages[0]
        assert (st.cap, st.budget) == (cap0, b0), (rel, st.cap, st.budget)
res = F.query(QueryBatch.knn(pts, K))
pack("knn/ids", res.ids)
pack("knn/dist", res.distances)
meta["knn"] = {{"reason": res.plan.reason, "stages": [stats(res.stages[0])]}}

# a stale snapshot, served sharded with the delta patched on top
rng = np.random.default_rng(11)
c0 = (wins[0, :2] + wins[0, 2:]) / 2
ring = np.float32([[c0[0] - 4e-3, c0[1] - 4e-3], [c0[0] + 4e-3, c0[1]],
                   [c0[0], c0[1] + 4e-3]]).astype(np.float64)
meta["stale_new"] = int(F.insert(ring, 3, 0))
victim = int(out["facade/intersects/flat"][0])
assert F.delete(victim)
meta["stale_victim"] = victim
res = F.query(w64, "intersects")
pack("stale/ids", res.ids)
meta["stale"] = {{"reason": res.plan.reason, "backend": res.plan.backend,
                 "stages": [stats(s) for s in res.stages]}}

out["meta"] = np.asarray(json.dumps(meta))
np.savez(sys.argv[1], **out)
print("REF-OK")
'''


def _ref_script() -> str:
    return textwrap.dedent(_REF).format(
        N=N, Q=Q, K=K, PL=PL, RELATIONS=repr(RELATIONS),
        OVERFLOW_CASES=repr(OVERFLOW_CASES), KNN_CASES=repr(KNN_CASES))


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """Starts the reference subprocess (the tests that need its output wait
    in ``ref``); the in-process tests run meanwhile."""
    d = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    logs = [open(d / "stdout.txt", "w"), open(d / "stderr.txt", "w")]
    proc = subprocess.Popen([sys.executable, "-c", _ref_script(),
                             str(d / "ref.npz")], env=env, stdout=logs[0],
                            stderr=logs[1], cwd=str(ROOT))
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in logs:
        f.close()


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, d = ref_run
    rc = proc.wait(timeout=WAIT_S)
    err = (d / "stderr.txt").read_text()[-4000:]
    assert rc == 0, f"reference subprocess failed:\n{err}"
    with np.load(d / "ref.npz") as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(str(data["meta"]))
    return data


def _unpack(data, key):
    flat, lens = data[key + "/flat"], data[key + "/lens"]
    return np.split(flat, np.cumsum(lens)[:-1]) if len(lens) else []


# ------------------------------------------------------------------ stores
def _fp32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _port_store(family, n=N, seed=3):
    gs = tdata.generate(family, n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = tgeom.mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def _ref_store(family, n=N, seed=3):
    if family == "mixed":
        return mixed_store(n, seed=seed)
    from repro.core.geometry import mbrs_of_verts

    gs = rgenerate(family, n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def _mesh(shape=(4, 2), axes=("data", "model")):
    return make_test_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _port_facade(family="mixed", shape=(4, 2), **cfg):
    kw = dict(mesh=_mesh(shape), shard_min_records=1, device_min_batch=1,
              stale_rebuild_min_batch=1, knn_device_min_batch=1)
    kw.update(cfg)
    idx = TIndex.build(_port_store(family), TGLINConfig(piece_limitation=PL),
                       TConfig(**kw), device="cpu")
    idx.snapshot()
    return idx


_FACADES = {}


def _facade(key="mixed"):
    """Module-cached port facades, each over its own store copy."""
    if key not in _FACADES:
        _FACADES[key] = _port_facade(
            "cluster" if key == "cluster" else "mixed",
            knn_seed="global" if key == "mixed" else None)
    return _FACADES[key]


def _wins(gs=None, seed=5):
    gs = gs if gs is not None else _facade().gs
    return make_query_windows(gs, 3e-3, Q, seed=seed).astype(np.float32)


def _same_ids(a, b, msg=""):
    assert len(a) == len(b), msg
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x, np.int64),
                                      np.asarray(y, np.int64),
                                      err_msg=f"{msg} row {i}")


# ------------------------------------------------------- tables (numpy)
@pytest.mark.parametrize("family,shards,floor", [
    ("mixed", 1, 0), ("mixed", 3, 0), ("mixed", 8, 0), ("mixed", 3, 5000),
    ("cluster", 3, 0), ("cluster", 8, 0)])
def test_shard_arrays_match_reference(ref_run, family, shards, floor):
    rg = RGLIN.build(_ref_store(family, 1000), RGLINConfig(piece_limitation=PL))
    tg = TGLIN.build(_port_store(family, 1000),
                     TGLINConfig(piece_limitation=PL))
    want = rdist.shard_arrays_from_capture(rdev.snapshot_capture(rg), shards,
                                           pool_pad_to=floor)
    got = (tdist.shard_arrays_from_capture(tdev.snapshot_capture(tg), shards,
                                           pool_pad_to=floor) if floor
           else tdist.shard_glin_arrays(tg, shards))
    assert tuple(got) == tdist.TABLE_KEYS == rdist.TABLE_KEYS
    for k in tdist.TABLE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["recs"].shape[0] % shards == 0
    if floor:
        assert got["vpool"].shape[0] // shards >= floor


# ------------------------------------------------------------ the mesh
def test_make_mesh_devices():
    mesh = _mesh()
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    pos = tdist.mesh_positions(mesh)
    assert [(s, m) for s, m, _ in pos] == [(s, m) for s in range(4)
                                            for m in range(2)]
    pod = make_test_mesh((2, 3, 2), ("pod", "data", "model"),
                         devices=["cpu"] * 12)
    assert tdist.shard_count(pod) == 6
    assert sorted({s for s, _, _ in tdist.mesh_positions(pod)}) == list(
        range(6))
    with pytest.raises(ValueError, match="takes 8 devices"):
        tdist.make_mesh((4, 2), ("data", "model"), ["cpu"] * 7)
    with pytest.raises(ValueError, match="differ in length"):
        tdist.make_mesh((4, 2), ("data",), ["cpu"] * 8)
    if not torch.cuda.is_available():
        # no card: the default takes CUDA devices and raises, never the CPU
        with pytest.raises(RuntimeError, match="CUDA cards"):
            tdist.make_mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="model"):
        tdist.mesh_positions(make_test_mesh((8,), ("data",),
                                            devices=["cpu"] * 8))


# ------------------------------------------------------- the leaf walk
def test_shard_walk_mirrors_per_slot_compaction():
    """Each shard's walk through the kernel's design (``walk_emulation``)
    equals the per-slot compaction on that shard's tables: leaves that
    straddle two shards, the padded last shard (3,000 records over 7
    shards), both prefilters, budgets below and above the survivors."""
    idx = _facade()
    cap = tdev.snapshot_capture(idx.glin)
    shards = 7
    table_np = tdist.shard_arrays_from_capture(cap, shards)
    mesh = tdist.make_mesh((shards, 1), ("data", "model"),
                           ["cpu"] * shards)
    table = tdist.place_table(table_np, mesh)
    wins = torch.from_numpy(_wins(idx.gs))
    snap = idx.snapshot()
    straddle = 0
    for s in range(shards):
        t = table.at(s, torch.device("cpu"))
        walk = t.walk
        n_leaf = walk.leaf_mbr.shape[0]
        ls = walk.leaf_start.numpy()
        # non-decreasing leaf ids over every slot, the sentinel last
        assert (np.diff(walk.rec_leaf.numpy()) >= 0).all()
        assert ls[0] == 0 and ls[-1] == t.local_n
        np.testing.assert_array_equal(
            t.lmbrs.numpy(), walk.leaf_mbr.numpy()[walk.rec_leaf.numpy()])
        straddle += int(table_np["rec_leaf"][s * t.local_n] ==
                        table_np["rec_leaf"][s * t.local_n - 1]) if s else 0
        for rel in ("intersects", "within"):
            r = tdev.get_relation(rel)
            lstart, lend = tdist._local_bounds(snap, wins, t, rel)
            bounds = torch.stack([lstart, lend], 1)
            probe = r.probe_window(wins).contiguous()
            for budget in (4, 64):
                want = kref.compact_plain(probe, lstart, lend, t.lmbrs,
                                          t.mbrs, budget, r.prefilter_kind)
                got = walk_emulation(probe, bounds, t.mbrs, walk, budget,
                                     r.prefilter_kind)
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
                torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        assert n_leaf >= 1
    assert straddle > 0, "no leaf straddles two shards"
    last = table.at(shards - 1, torch.device("cpu"))
    assert (last.recs.numpy() < 0).any(), "the last shard holds no padding"


# ------------------------------------------------------------- the ladder
@pytest.mark.parametrize("counts,budget,comp_pair", [
    ([[3, -100], [5, 2]], 16, ("scan", "scan")),          # budget overflow
    ([[-9000, 1], [0, 0]], 16, ("scan", "scan")),         # run past the cap
    ([[-9000, 1], [0, 0]], 0, ("scan", "scan")),          # dense, run > cap
    ([[-9000, 1], [0, 0]], 16, ("kernel", "pallas")),     # capless: budget
    ([[-40, 2], [1, -3]], 16, ("kernel", "pallas")),
    ([[-2000, 2], [1, -3]], 512, ("kernel", "pallas")),   # budget past max
])
def test_on_sharded_overflow_matches_reference(counts, budget, comp_pair):
    counts = np.asarray(counts, np.int32)
    cfg = dict(initial_cap=4096, exact_budget=budget, max_cap=1 << 16)
    for max_budget in (None, 1 << 16):
        lt = texec.OverflowLadder(TConfig(**cfg), 4096, max_budget=max_budget)
        lr = rexec.OverflowLadder(RConfig(**cfg), 4096, max_budget=max_budget)
        for _ in range(3):
            ub_t, ub_r = lt.use_budget, lr.use_budget
            assert ub_t == ub_r
            errs = []
            for lad, comp, ub in ((lt, comp_pair[0], ub_t),
                                  (lr, comp_pair[1], ub_r)):
                try:
                    lad.on_sharded_overflow(counts, ub, comp)
                    errs.append(None)
                except (OverflowError, AssertionError) as e:
                    errs.append(type(e))
            assert errs[0] == errs[1]
            assert (lt.cap, lt.budget, lt.escalations) == (
                lr.cap, lr.budget, lr.escalations)
            if errs[0]:
                break


def test_pow2_radii_match_reference():
    r = np.asarray([1e-12, 3e-4, 0.004, 0.25, 1.0, 3.0])
    np.testing.assert_array_equal(texec._pow2_radii(r), rexec._pow2_radii(r))


# ------------------------------------------------ planner (plans only)
def _planner_pair(**cfg):
    """A reference facade on a (1, 1) mesh and a port facade on a (1, 1)
    CPU mesh over the same 1,000-record cluster store (the reasons name the
    shard count, so both have one shard)."""
    from repro.utils.compat import make_auto_mesh

    rm = make_auto_mesh((1, 1), ("data", "model"))
    tm = tdist.make_mesh((1, 1), ("data", "model"), ["cpu"])
    ref = RIndex.build(_ref_store("cluster", 1000),
                       RGLINConfig(piece_limitation=100),
                       RConfig(mesh=rm, **cfg))
    port = TIndex.build(_port_store("cluster", 1000),
                        TGLINConfig(piece_limitation=100),
                        TConfig(mesh=tm, **cfg), device="cpu")
    return ref, port


def test_plan_reason_sharded_branches():
    """``tests/test_engine.py::test_plan_reason_sharded_branches`` on both
    facades: forced, publishing, fresh, patched on top, republishing, the
    stale_rebuild_min_batch and device_min_batch gates, and
    shard_min_records handing the batch to the device path."""
    cfg = dict(shard_min_records=1, device_min_batch=4,
               stale_rebuild_min_batch=8, delta_patch_max=2,
               refresh_threshold=2)
    ref, port = _planner_pair(**cfg)
    one = _fp32(make_query_windows(ref.gs, 0.01, 1, seed=2))
    big = np.repeat(one, 8, axis=0)
    rng = np.random.default_rng(43)

    def plans(batch, rel="intersects", **kw):
        a = port.plan(QueryBatch.window(batch, rel, **kw))
        b = ref.plan(RBatch.window(batch, rel, **kw))
        assert (a.backend, a.reason, a.rebuild_snapshot, a.delta_size) == (
            b.backend, b.reason, b.rebuild_snapshot, b.delta_size)
        return a

    p = plans(big, backend="sharded")
    assert p.backend == "sharded" and p.reason == "forced by caller"
    assert "device_min_batch" in plans(one).reason
    p = plans(big)                              # nothing published yet
    assert p.backend == "sharded" and "publishing" in p.reason
    assert p.rebuild_snapshot
    ref.snapshot()
    port.snapshot()
    p = plans(big)
    assert p.backend == "sharded" and "windows on cpu mesh" in p.reason
    assert not p.rebuild_snapshot
    assert plans(big, "disjoint").backend == "sharded"
    poly = _fp32(np.stack([0.5 + 1e-3 * np.cos(np.linspace(0, 6, 10)),
                           0.5 + 1e-3 * np.sin(np.linspace(0, 6, 10))], -1))
    for g in (ref, port):
        g.insert(poly, 10, 0)
    p = plans(big)
    assert p.backend == "sharded" and "patched on top" in p.reason
    p = plans(big, backend="sharded")           # forced, patchable
    assert not p.rebuild_snapshot
    poly2 = _fp32(poly + rng.uniform(0, 1e-2))
    for g in (ref, port):
        g.insert(poly2, 10, 0)
    p = plans(big)                              # delta >= refresh_threshold
    assert p.backend == "sharded" and "republishing" in p.reason
    assert p.rebuild_snapshot
    assert plans(big, backend="sharded").rebuild_snapshot
    p = plans(np.repeat(one, 5, axis=0))
    assert p.backend == "host" and "stale_rebuild_min_batch" in p.reason
    # kNN: forced and chosen, a stale snapshot republished first
    pts = _fp32(np.random.default_rng(2).uniform(0.2, 0.8, (20, 2)))
    for kw in ({}, {"backend": "sharded"}):
        a = port.plan(QueryBatch.knn(pts, 3, **kw))
        b = ref.plan(RBatch.knn(pts, 3, **kw))
        assert (a.backend, a.reason, a.rebuild_snapshot) == (
            b.backend, b.reason, b.rebuild_snapshot)
        assert a.backend == "sharded" and a.rebuild_snapshot
    # below shard_min_records the single-device path wins
    for g in (ref, port):
        g.snapshot()
    tsmall = TIndex(port.glin, TConfig(mesh=port.config.mesh,
                                       shard_min_records=1 << 20),
                    device="cpu")
    rsmall = RIndex(ref.glin, RConfig(mesh=ref.config.mesh,
                                      shard_min_records=1 << 20))
    tsmall.snapshot()
    rsmall.snapshot()
    w32 = np.repeat(one, 32, axis=0)
    a, b = tsmall.plan(w32, "intersects"), rsmall.plan(w32, "intersects")
    assert a.backend == b.backend == "device"
    a = tsmall.plan(QueryBatch.knn(pts, 3))
    b = rsmall.plan(RBatch.knn(pts, 3))
    assert a.backend == b.backend == "device" and a.reason == b.reason


def test_sharded_refused_without_mesh_or_with_a_bad_one():
    idx = TIndex.build(_port_store("cluster", 500), device="cpu")
    w = _fp32(make_query_windows(idx.gs, 0.01, 4, seed=2))
    for batch in (QueryBatch.window(w, "intersects", backend="sharded"),
                  QueryBatch.knn([[0.5, 0.5]], 3, backend="sharded")):
        with pytest.raises(ValueError, match="requires EngineConfig.mesh"):
            idx.plan(batch)
    bad = TIndex(idx.glin, TConfig(mesh=tdist.make_mesh(
        (8,), ("data",), ["cpu"] * 8)), device="cpu")
    with pytest.raises(ValueError, match="unusable"):
        bad.plan(QueryBatch.window(w, "intersects", backend="sharded"))
    with pytest.raises(ValueError, match="unknown backend"):
        idx.plan(QueryBatch.window(w, "intersects", backend="mesh"))


# ----------------------------------------- the facade vs the host path
@pytest.mark.parametrize("rel", RELATIONS)
def test_sharded_facade_matches_host(rel):
    idx = _facade("cluster")
    w = _fp32(_wins(idx.gs, seed=6))
    got = idx.query(w, rel)
    assert got.plan.backend == "sharded"
    assert got.stages[0].impl == "sharded"
    _same_ids(got.ids, idx.query(w, rel, backend="host").ids, rel)


def test_pod_mesh_and_kernel_routes_match_host():
    """A (pod, data, model) = (2, 2, 2) mesh (shard = pod * 2 + data), with
    the wrappers' routes (compaction and top-k "kernel": their plain
    versions on CPU tensors), at a small budget that walks the ladder."""
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                          devices=["cpu"] * 8)
    base = _facade("cluster")
    idx = TIndex(base.glin, TConfig(
        mesh=mesh, shard_min_records=1, device_min_batch=1,
        knn_device_min_batch=1, compaction="kernel", knn_topk="kernel",
        exact_budget=8, initial_cap=64), device="cpu")
    idx.snapshot()
    w = _fp32(_wins(idx.gs, seed=6))[:15]       # odd: padded to 16
    for rel in ("intersects", "within", "dwithin:0.004"):
        got = idx.query(w, rel)
        assert got.plan.backend == "sharded"
        _same_ids(got.ids, idx.query(w, rel, backend="host").ids, rel)
    assert idx.stats()["stages"]["sharded"]["refine"]["escalations"] > 0
    pts = _fp32((w[:, :2] + w[:, 2:]) / 2)
    got = idx.query(QueryBatch.knn(pts, 7))
    want = idx.query(QueryBatch.knn(pts, 7, backend="host"))
    assert got.plan.backend == "sharded" and "topk=kernel" in \
        got.stages[0].note
    _same_ids(got.ids, want.ids, "knn")
    for a, b in zip(got.distances, want.distances):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_sharded_knn_cdf_seed_matches_host():
    idx = _facade("cluster")
    w = _wins(idx.gs, seed=6)
    pts = _fp32((w[:, :2] + w[:, 2:]) / 2)
    for k in (1, 12):
        got = idx.query(QueryBatch.knn(pts, k))
        want = idx.query(QueryBatch.knn(pts, k, backend="host"))
        st = got.stages[0]
        assert got.plan.backend == "sharded" and st.impl == "sharded"
        assert st.merge_bytes > 0 and sum(st.rung_hist) == len(pts)
        _same_ids(got.ids, want.ids, f"k={k}")
        for a, b in zip(got.distances, want.distances):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_sharded_knn_straggler_host_fallback(monkeypatch):
    idx = _port_facade("cluster", shape=(2, 2))
    w = _wins(idx.gs, seed=6)
    pts = _fp32((w[:, :2] + w[:, 2:]) / 2)

    def overflow(*a, **kw):
        raise OverflowError("run past max_cap")

    monkeypatch.setattr(texec.KnnShardedStage, "_rank", overflow)
    got = idx.query(QueryBatch.knn(pts, 4))
    assert "host fallback" in got.stages[0].note
    _same_ids(got.ids, idx.query(QueryBatch.knn(pts, 4,
                                                backend="host")).ids)


def test_stale_knn_republishes_and_stats_aggregate():
    idx = _port_facade("cluster", shape=(2, 2))
    w = _wins(idx.gs, seed=6)
    pts = _fp32((w[:, :2] + w[:, 2:]) / 2)
    c = pts[0]
    ring = _fp32([[c[0] - 1e-4, c[1] - 1e-4], [c[0] + 1e-4, c[1]],
                  [c[0], c[1] + 1e-4]])
    new = idx.insert(ring, 3, 0)
    assert idx.snapshot_is_stale()
    got = idx.query(QueryBatch.knn(pts, 3))
    assert got.plan.backend == "sharded" and got.plan.rebuild_snapshot
    assert not idx.snapshot_is_stale() and new in got.ids[0]
    _same_ids(got.ids, idx.query(QueryBatch.knn(pts, 3,
                                                backend="host")).ids)
    agg = idx.stats()["stages"]["sharded"]["knn-rank"]
    assert agg["merge_bytes"] == got.stages[0].merge_bytes > 0
    assert "dispatches=4" in idx.explain(QueryBatch.knn(pts, 3))


# ---------------------------------------------- async republish, staged
class _HeldBuild:
    """``engine.snapshot_from_capture`` held on the build thread until the
    test releases it (a synchronous publish passes through)."""

    def __init__(self, monkeypatch):
        self.real = teng.snapshot_from_capture
        self.release = threading.Event()
        monkeypatch.setattr(teng, "snapshot_from_capture", self)

    def __call__(self, cap, device):
        if threading.current_thread().name == "glin-republish":
            if not self.release.wait(60):
                raise TimeoutError("the test never released the build")
        return self.real(cap, device)


def _async_facade():
    mesh = tdist.make_mesh((2, 1), ("data", "model"), ["cpu"] * 2)
    gs = _port_store("cluster", 2000, seed=61)
    idx = TIndex.build(gs, TGLINConfig(piece_limitation=200), TConfig(
        mesh=mesh, shard_min_records=1, device_min_batch=1,
        stale_rebuild_min_batch=1, delta_patch_max=4, refresh_threshold=4,
        async_republish=True), device="cpu")
    idx.snapshot()
    return idx, _fp32(make_query_windows(gs, 0.02, 4, seed=6))


def _ring(c, r=3e-4, nv=6):
    ang = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    return _fp32(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                          -1))


def test_plan_reason_sharded_async_inflight(monkeypatch):
    """The mesh keeps serving the published placement + delta while the
    async build runs; the staged table is served after the swap."""
    idx, wins = _async_facade()
    held = _HeldBuild(monkeypatch)
    rng = np.random.default_rng(67)
    for _ in range(5):
        idx.insert(_ring(rng.uniform(0.3, 0.7, 2)), 6, 0)
    res = idx.query(wins, "intersects")      # starts the build, serves patched
    assert idx.republish_inflight()
    assert res.plan.backend == "sharded"
    assert res.plan.reason == ("sharded over 2 shards; async republish in "
                               "flight, delta of 5 patched on top")
    _same_ids(res.ids, idx.query(wins, "intersects", backend="host").ids)
    held.release.set()
    assert idx._inflight.done.wait(60)
    res = idx.query(wins, "intersects")      # the swap lands at the prologue
    assert not idx.snapshot_is_stale() and not idx.republish_inflight()
    assert idx._staged_table is None          # consumed by the placement
    assert res.plan.backend == "sharded"
    _same_ids(res.ids, idx.query(wins, "intersects", backend="host").ids)


def test_sync_publish_discards_staged_sharded_table(monkeypatch):
    """An async swap stages its sharded table; a synchronous republish right
    after it (a post-capture write + forced rebuild) must not serve that
    table — post-capture records would vanish from sharded results."""
    idx, wins = _async_facade()
    held = _HeldBuild(monkeypatch)
    rng = np.random.default_rng(73)
    for _ in range(5):
        idx.insert(_ring(rng.uniform(0.3, 0.7, 2)), 6, 0)
    idx.query(wins, "intersects")            # starts the async build
    held.release.set()
    assert idx._inflight.done.wait(60)       # finished, not yet polled
    c = np.array([np.mean(wins[0][[0, 2]]), np.mean(wins[0][[1, 3]])])
    late = idx.insert(_ring(c, r=2e-3), 6, 0)
    idx.snapshot()                           # polls (swap), then sync publish
    assert not idx.snapshot_is_stale() and idx._staged_table is None
    res = idx.query(wins, "intersects")
    assert res.plan.backend == "sharded" and late in res[0]
    _same_ids(res.ids, idx.query(wins, "intersects", backend="host").ids)


# ------------------------------------ steps and facade vs the reference
def _carried(ref, key):
    """The reference's published snapshot and sharded table, in the port."""
    fields = {k: ref[f"{key}/snap/{k}"] for k in tdev.SNAPSHOT_FIELDS}
    snap = tdev.snapshot_from_numpy(fields, ref["meta"][key + "/snap_meta"],
                                    "cpu")
    table_np = {k: ref[f"{key}/table/{k}"] for k in tdist.TABLE_KEYS}
    mesh = _mesh()
    return (tdist.replicate_model(snap, mesh),
            tdist.place_table(table_np, mesh))


def _check_step(ref, key, got):
    hits, counts = got
    np.testing.assert_array_equal(hits.numpy(), ref[key + "/hits"])
    np.testing.assert_array_equal(counts.numpy(), ref[key + "/counts"])


@pytest.mark.parametrize("rel", DEVICE_RELATIONS)
def test_window_step_matches_reference(ref, rel):
    snaps, table = _carried(ref, "mixed")
    cfg = TConfig()       # the facade's cap and budget, which never grew
    step = tdist.build_glin_query_step(_mesh(), rel, cap=cfg.initial_cap,
                                       exact_budget=cfg.exact_budget,
                                       compaction="scan",
                                       max_width=ref["meta"]["maxw"])
    _check_step(ref, f"step/{rel}", step(snaps, ref["wins"], table))


@pytest.mark.parametrize("case", OVERFLOW_CASES,
                         ids=["/".join(map(str, c[:4])) for c in
                              OVERFLOW_CASES])
def test_step_overflow_codes_match_reference(ref, case):
    rel, cap, budget, comp, q = case
    snaps, table = _carried(ref, "mixed")
    key = f"step/{rel}/{cap}/{budget}/{comp}"
    counts = ref[key + "/counts"]
    if budget:
        assert (counts < 0).any(), "the case overflows nowhere"
    for port_comp in (("kernel",) if comp == "pallas" else ("scan",
                                                             "kernel")):
        if port_comp == "kernel" and comp == "scan" and budget:
            continue        # the scan's run codes are not the kernel's
        step = tdist.build_glin_query_step(
            _mesh(), rel, cap=cap, exact_budget=budget, compaction=port_comp,
            max_width=ref["meta"]["maxw"])
        _check_step(ref, key, step(snaps, ref["wins"][:q], table))


def test_cluster_step_matches_reference(ref):
    snaps, table = _carried(ref, "cluster")
    step = tdist.build_glin_query_step(_mesh(), "intersects", cap=128,
                                       exact_budget=16, compaction="scan",
                                       max_width=ref["meta"]["cluster_maxw"])
    _check_step(ref, "cluster", step(snaps, ref["cluster/wins"], table))


@pytest.mark.parametrize("case", ((K, 4096, 256),) + KNN_CASES,
                         ids=lambda c: "/".join(map(str, c)))
@pytest.mark.parametrize("topk", ("sort", "kernel"))
def test_knn_step_matches_reference(ref, case, topk):
    k, cap, budget = case
    snaps, table = _carried(ref, "mixed")
    w = ref["wins"]
    pts = (w[:, :2] + w[:, 2:]) / 2
    pw = np.concatenate([pts, pts], 1).astype(np.float32)
    key = f"knnstep/{k}/{cap}/{budget}"
    step = tdist.build_glin_knn_step(
        _mesh(), ref["meta"]["knn_relation"], k, cap=cap,
        exact_budget=budget, compaction="scan",
        max_width=ref["meta"]["maxw"], topk=topk)
    ids, dist, counts = step(snaps, pw, table)
    np.testing.assert_array_equal(counts.numpy(), ref[key + "/counts"])
    np.testing.assert_array_equal(ids.numpy(), ref[key + "/ids"])
    np.testing.assert_allclose(dist.numpy(), ref[key + "/dist"], rtol=1e-6,
                               atol=0)
    if budget and k > budget:
        assert (ref[key + "/counts"] < 0).any()


def _stage_stats(st):
    return {k: getattr(st, k) for k in (
        "impl", "escalations", "dispatches", "cap", "budget", "survivors",
        "rungs", "seed_hits", "merge_bytes", "note")} | {
        "rung_hist": list(st.rung_hist)}


@pytest.mark.parametrize("rel", RELATIONS)
def test_facade_matches_reference(ref, rel):
    idx = _facade()
    w = ref["wins"].astype(np.float64)
    np.testing.assert_array_equal(_wins(idx.gs), ref["wins"])
    got = idx.query(w, rel)
    want = ref["meta"][f"facade/{rel}"]
    assert (got.plan.backend, got.plan.reason) == (want["backend"],
                                                   want["reason"])
    assert [_stage_stats(s) for s in got.stages] == want["stages"]
    _same_ids(got.ids, _unpack(ref, f"facade/{rel}"), rel)
    _same_ids(got.ids, idx.query(w, rel, backend="host").ids, rel)


def test_knn_facade_matches_reference(ref):
    idx = _facade()
    w = ref["wins"]
    pts = ((w[:, :2] + w[:, 2:]) / 2).astype(np.float64)
    got = idx.query(QueryBatch.knn(pts, K))
    want = ref["meta"]["knn"]
    assert got.plan.reason == want["reason"]
    st = _stage_stats(got.stages[0])
    # the note names the top-k the port ranks by (the reference's says
    # only the seed)
    assert st.pop("note") == want["stages"][0].pop("note") + " topk=sort"
    assert st == want["stages"][0] and st["merge_bytes"] > 0
    _same_ids(got.ids, _unpack(ref, "knn/ids"), "knn")
    for a, b in zip(got.distances, _unpack(ref, "knn/dist")):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    _same_ids(got.ids, idx.query(QueryBatch.knn(pts, K,
                                                backend="host")).ids)


def test_stale_snapshot_served_sharded_and_patched(ref):
    """The reference's write (an insert in window 0, a delete of one of its
    hits) on a fresh port facade: the stale snapshot is served sharded and
    patched, equal to the reference and to the host path."""
    idx = _port_facade("mixed")
    w = ref["wins"]
    c0 = (w[0, :2] + w[0, 2:]) / 2
    ring = np.float32([[c0[0] - 4e-3, c0[1] - 4e-3], [c0[0] + 4e-3, c0[1]],
                       [c0[0], c0[1] + 4e-3]]).astype(np.float64)
    assert idx.insert(ring, 3, 0) == ref["meta"]["stale_new"]
    assert idx.delete(ref["meta"]["stale_victim"])
    got = idx.query(w.astype(np.float64), "intersects")
    want = ref["meta"]["stale"]
    assert (got.plan.backend, got.plan.reason) == (want["backend"],
                                                   want["reason"])
    assert "patched on top" in got.plan.reason
    assert [_stage_stats(s) for s in got.stages] == want["stages"]
    assert got.stages[1].delta_added == 1 == got.stages[1].delta_tombstoned
    _same_ids(got.ids, _unpack(ref, "stale/ids"), "stale")
    _same_ids(got.ids, idx.query(w.astype(np.float64), "intersects",
                                 backend="host").ids)
