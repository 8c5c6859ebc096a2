"""The serving tier of the port (``repro_torch.serve``) against the
reference's (``repro.serve``), in the scenarios of ``tests/test_serving.py``.

Both packages build the same fp32-representable ``cluster`` store from the
same seed, so the fp64 host path and the fp32 device path decide alike and
every served result compares exactly with the host oracle. Where a scenario
is deterministic (flush-mode streams, shedding, fair admission, a failed
group, replicas, coalescing) the port's server and the reference's take the
same submissions and must return the same tickets, ids, ``Rejected``
reasons and counters. Where threads decide the interleaving (concurrent
flushers, the pump loop, an async swap) the port is held to the oracle.
Every wait is bounded.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference needs jax
torch.set_num_threads(1)

import repro.core.datasets as rdata  # noqa: E402
import repro.core.engine as reng  # noqa: E402
import repro.core.geometry as rgeom  # noqa: E402
import repro.core.index as rindex  # noqa: E402
import repro.serve as rserve  # noqa: E402
import repro_torch.core.datasets as tdata  # noqa: E402
import repro_torch.core.engine as teng  # noqa: E402
import repro_torch.core.geometry as tgeom  # noqa: E402
import repro_torch.core.index as tindex  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.core.relations import get_relation  # noqa: E402
from repro_torch.kernels import knn as kk  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import refine as kr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 30.0
REF = SimpleNamespace(data=rdata, eng=reng, geom=rgeom, index=rindex,
                      serve=rserve, build_kw={})
PORT = SimpleNamespace(data=tdata, eng=teng, geom=tgeom, index=tindex,
                       serve=tserve, build_kw={"device": "cpu"})


def _fp32_index(pkg, n=3000, pl=200, seed=0, **eng):
    gs = pkg.data.generate("cluster", n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = pkg.geom.mbrs_of_verts(gs.verts, gs.nverts)
    cfg = pkg.eng.EngineConfig(device_min_batch=1, stale_rebuild_min_batch=1,
                               **eng)
    return pkg.eng.SpatialIndex.build(
        gs, pkg.index.GLINConfig(piece_limitation=pl), config=cfg,
        **pkg.build_kw)


def _fp32_windows(idx, sel, k, seed):
    w = tdata.make_query_windows(idx.gs, sel, k, seed=seed)
    return w.astype(np.float32).astype(np.float64)


def _fp32_polygon(rng, c, r=1e-3, nv=8):
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    v = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)
    return v.astype(np.float32).astype(np.float64)


def _host(idx, w, rel):
    return idx.query(np.atleast_2d(w), rel, backend="host")


def _same_value(a, b, msg):
    """One ticket's value in both packages: ids, a kNN (ids, distances)
    pair, or a Rejected (compared by its fields)."""
    if isinstance(a, tuple):
        np.testing.assert_array_equal(a[0], b[0], err_msg=msg)
        np.testing.assert_allclose(a[1], b[1], rtol=1e-6, atol=0,
                                   err_msg=msg)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=msg)
    else:
        assert (type(a).__name__, a.reason, a.tenant, a.relation) == (
            type(b).__name__, b.reason, b.tenant, b.relation), msg


def _same_outputs(port_out, ref_out):
    assert set(port_out) == set(ref_out)
    for t in ref_out:
        _same_value(port_out[t], ref_out[t], f"ticket {t}")


def _counters(server):
    st = server.stats()
    return {k: st[k] for k in ("shed", "failed_batches", "tenants",
                               "batch_size_hist", "replica_queries",
                               "replicas", "backend_counts", "cache_hits",
                               "cache_misses", "coalesced", "served_queries",
                               "served_batches", "write_ops", "queue_depth")}


# ------------------------------------------------- flush-mode parity --
def _flush_stream(pkg):
    """Rounds of submissions over window relations and a complement from
    two tenants with duplicates, inserts between rounds (the delta
    grows, then passes refresh_threshold=4 and republishes), one delete; no
    write after the last round."""
    idx = _fp32_index(pkg, n=2500, refresh_threshold=4)
    server = pkg.serve.SpatialQueryServer(
        idx, config=pkg.serve.ServerConfig(replicas=2))
    rng = np.random.default_rng(41)
    wins = _fp32_windows(idx, 2e-3, 6, seed=42)
    outs, plans, meta = [], [], {}
    for rnd in range(3):
        for q in range(len(wins)):
            for rel in ("intersects", "contains", "dwithin:0.003",
                        "disjoint"):
                meta[server.submit(wins[q], rel, tenant=f"t{q % 2}")] = (
                    q, rel)
        meta[server.submit(wins[0], "intersects", tenant="t1")] = (
            0, "intersects")                                  # a duplicate
        outs.append(server.flush())
        plans.append(idx.plan(wins, "intersects").backend)
        if rnd == 2:
            for q in range(len(wins)):           # the same generation:
                meta[server.submit(wins[q], "contains")] = (q, "contains")
            outs.append(server.flush())          # served from the cache
            break
        for _ in range(3):
            c = (wins[rnd][:2] + wins[rnd][2:]) / 2 + rng.uniform(-2e-3,
                                                                  2e-3, 2)
            server.insert(_fp32_polygon(rng, c, r=3e-4), 8, 0)
        if rnd == 0:
            server.delete(5)
    return idx, wins, outs, plans, meta, _counters(server)


def test_flush_stream_matches_reference_window_for_window():
    *_, ref_outs, ref_plans, _, ref_st = _flush_stream(REF)
    idx, wins, outs, plans, meta, st = _flush_stream(PORT)
    assert plans == ref_plans
    assert set(st["backend_counts"]) == {"device", "device+delta", "cache"}
    for a, b in zip(outs, ref_outs):
        _same_outputs(a, b)
    # overlapped groups pick replicas in the order they start: only the
    # total is deterministic
    assert sum(st.pop("replica_queries")) == sum(ref_st.pop("replica_queries"))
    assert st == ref_st
    # the last rounds against the host oracle (no write came after them)
    for t, v in {**outs[-2], **outs[-1]}.items():
        q, rel = meta[t]
        np.testing.assert_array_equal(v, _host(idx, wins[q], rel)[0])


# ------------------------------------------------------------- concurrency --
def test_concurrent_submit_flush_insert_exact_vs_oracle():
    """Three flusher threads and one writer hammer one server. Inserts are
    append-only, so every served result is the base hit set plus a prefix
    (in insertion order) of the inserted hitters: exact at the epoch the
    engine froze for that batch."""
    idx = _fp32_index(PORT, n=3000, refresh_threshold=24)
    server = tserve.SpatialQueryServer(idx, async_republish=True)
    relation = "intersects"
    wins = _fp32_windows(idx, 2e-3, 6, seed=3)
    base = [set(ids.tolist())
            for ids in idx.query(wins, relation, backend="host")]
    pred = get_relation(relation).predicate
    log, errors = [], []

    def writer():
        rng = np.random.default_rng(11)
        try:
            for j in range(48):
                if j % 2 == 0:
                    w = wins[(j // 2) % len(wins)]
                    c = np.array([(w[0] + w[2]) / 2, (w[1] + w[3]) / 2])
                else:
                    c = rng.uniform(0.05, 0.95, 2)
                v = _fp32_polygon(rng, c, r=2e-4)
                v32 = v.astype(np.float32)[None]
                hits = [bool(np.asarray(pred(
                    wins[q].astype(np.float32), v32, np.array([8]),
                    np.array([0])))[0]) for q in range(len(wins))]
                log.append((server.insert(v, 8, 0), hits))
                time.sleep(0.002)
        except BaseException as e:   # noqa: BLE001 — re-raised via `errors`
            errors.append(e)

    ticket_win, collected = {}, {}
    t_lock = threading.Lock()

    def flusher(tid):
        try:
            for _ in range(8):
                mine = {server.submit(wins[q], relation, tenant=f"t{tid}"): q
                        for q in range(len(wins))}
                with t_lock:
                    ticket_win.update(mine)
                out = server.flush()
                with t_lock:
                    collected.update(out)
                time.sleep(0.001)
        except BaseException as e:   # noqa: BLE001 — re-raised via `errors`
            errors.append(e)

    threads = [threading.Thread(target=flusher, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 4)
        assert not t.is_alive(), "a thread never finished"
    assert not errors, errors
    collected.update(server.flush())
    assert set(collected) == set(ticket_win)
    hitters = [[rec for rec, h in log if h[q]] for q in range(len(wins))]
    for ticket, ids in collected.items():
        q = ticket_win[ticket]
        assert not isinstance(ids, tserve.Rejected)
        s = set(ids.tolist())
        assert base[q] <= s
        extra = sorted(s - base[q])
        assert extra == hitters[q][:len(extra)]
    final = server.query(wins, relation)
    for q, ids in enumerate(idx.query(wins, relation, backend="host")):
        np.testing.assert_array_equal(final[q], ids)
    st = server.stats()
    assert (st["queue_depth"], st["write_ops"], st["shed"]) == (0, 48, 0)
    _drain(idx, wins[0])


def _drain(idx, w):
    """Let the async builds land (queries drive the poll). A build that
    captured before the last writes leaves a delta that may start one more
    at its swap; that one covers every write, so two rounds end it."""
    idx.query(w[None], "intersects")
    for _ in range(3):
        inf = idx._inflight
        if inf is None:
            break
        assert inf.done.wait(WAIT_S), "async build never ended"
        idx.query(w[None], "intersects")
    assert not idx.republish_inflight()


def test_cache_never_serves_across_generation_swap(monkeypatch):
    """Writes bump the epoch and an async republish bumps the publish count;
    a cached result of either dead generation never resurfaces. The build is
    held on an event, so the swap lands exactly where the test says."""
    idx = _fp32_index(PORT, n=2000, refresh_threshold=4)
    server = tserve.SpatialQueryServer(idx, async_republish=True)
    assert idx.config.async_republish
    real = teng.snapshot_from_capture
    release = threading.Event()

    def held(cap, device):
        if threading.current_thread().name == "glin-republish":
            assert release.wait(WAIT_S), "never released"
        return real(cap, device)

    monkeypatch.setattr(teng, "snapshot_from_capture", held)
    rng = np.random.default_rng(13)
    w = _fp32_windows(idx, 2e-3, 1, seed=12)[0]
    for j in range(5):
        c = np.array([(w[0] + w[2]) / 2 + (j - 2) * 1e-5,
                      (w[1] + w[3]) / 2])
        rec = server.insert(_fp32_polygon(rng, c, r=2e-4), 8, 0)
        t = server.submit(w, "intersects")
        out = server.flush()[t]
        assert rec in set(out.tolist())       # a stale hit would miss it
        np.testing.assert_array_equal(out, _host(idx, w, "intersects")[0])
    assert idx.republish_inflight()           # the delta reached 4
    gen = idx.serving_generation
    hits0 = server.cache_hits
    t = server.submit(w, "intersects")
    np.testing.assert_array_equal(server.flush()[t], out)
    assert server.cache_hits == hits0 + 1     # same generation: a hit
    release.set()
    assert idx._inflight.done.wait(WAIT_S)
    idx.query(w[None], "intersects")          # the poll: the swap lands
    t = server.submit(w, "intersects")
    got = server.flush()[t]
    assert idx.serving_generation == (gen[0], gen[1] + 1)
    assert server.cache_hits == hits0 + 1     # new generation: a miss
    np.testing.assert_array_equal(got, _host(idx, w, "intersects")[0])
    np.testing.assert_array_equal(got, out)   # the swap is invisible


# --------------------------------------------------- admission + fairness --
def _shed(pkg):
    idx = _fp32_index(pkg, n=1500)
    server = pkg.serve.SpatialQueryServer(
        idx, config=pkg.serve.ServerConfig(max_queue=8, fair_watermark=1.0))
    w = _fp32_windows(idx, 2e-3, 1, seed=5)[0]
    tickets = [server.submit(w, "intersects") for _ in range(12)]
    return idx, w, tickets, server.flush(), _counters(server)


def test_shed_requests_surface_as_rejected():
    _, _, rt, rout, rst = _shed(REF)
    idx, w, tickets, out, st = _shed(PORT)
    assert tickets == rt
    _same_outputs(out, rout)
    assert st == rst
    rejected = [t for t in tickets if isinstance(out[t], tserve.Rejected)]
    assert rejected == tickets[8:]
    assert out[rejected[0]].reason.startswith("queue full")
    for t in tickets[:8]:
        np.testing.assert_array_equal(out[t], _host(idx, w, "intersects")[0])
    assert st["tenants"]["default"] == {"admitted": 8, "rejected": 4,
                                        "served": 8}


def _fair(pkg):
    idx = _fp32_index(pkg, n=1500)
    server = pkg.serve.SpatialQueryServer(
        idx, config=pkg.serve.ServerConfig(max_queue=16, fair_watermark=0.25))
    w = _fp32_windows(idx, 2e-3, 1, seed=6)[0]
    tb0 = server.submit(w, "intersects", tenant="B")
    ta = [server.submit(w, "intersects", tenant="A") for _ in range(30)]
    mid = server.stats()["tenants"]
    tb = [server.submit(w, "intersects", tenant="B") for _ in range(5)]
    return [tb0] + ta + tb, mid, server.flush(), _counters(server)


def test_weighted_fair_admission_protects_trickle_tenant():
    rt, rmid, rout, rst = _fair(REF)
    tickets, mid, out, st = _fair(PORT)
    assert tickets == rt and mid == rmid
    _same_outputs(out, rout)
    assert st == rst
    assert mid["A"] == {"admitted": 8, "rejected": 22, "served": 0}
    assert st["tenants"]["B"]["rejected"] == 0
    assert sum(isinstance(v, tserve.Rejected) for v in out.values()) == 22


# ------------------------------------------------------ flush atomicity -----
def _atomic(pkg):
    idx = _fp32_index(pkg, n=1500)
    server = pkg.serve.SpatialQueryServer(idx)     # overlapped groups
    wins = _fp32_windows(idx, 2e-3, 4, seed=7)
    real_query = idx.query

    def flaky(batch, relation=None, **kw):
        if getattr(batch, "relation", relation) == "contains":
            raise RuntimeError("boom")
        return real_query(batch, relation, **kw)

    idx.query = flaky
    try:
        t1 = [server.submit(w, "intersects") for w in wins]
        t2 = [server.submit(w, "contains") for w in wins]
        before = _counters(server)
        with pytest.raises(RuntimeError, match="boom"):
            server.flush()
        assert _counters(server) == {**before, "queue_depth": 8}
    finally:
        idx.query = real_query
    return idx, wins, t1, t2, server.flush(), _counters(server)


def test_overlapped_flush_atomicity_on_group_failure():
    *_, rout, rst = _atomic(REF)
    idx, wins, t1, t2, out, st = _atomic(PORT)
    _same_outputs(out, rout)
    assert st == rst
    assert set(out) == set(t1 + t2)
    for rel, tickets in (("intersects", t1), ("contains", t2)):
        for q, t in enumerate(tickets):
            np.testing.assert_array_equal(out[t], _host(idx, wins[q], rel)[0])
    assert (st["served_queries"], st["served_batches"]) == (8, 2)


# -------------------------------------------------------------- replicas ----
def _replicas(pkg):
    """Three flushes of two relation groups. Each group picks the
    least-loaded replica as it starts; a barrier holds each group's facade
    query until both groups have picked, so the two never run one after
    the other on one replica (which the worker pool's timing would
    otherwise allow)."""
    idx = _fp32_index(pkg, n=3000)
    server = pkg.serve.SpatialQueryServer(
        idx, config=pkg.serve.ServerConfig(replicas=2, max_workers=2))
    assert idx.config.replicas == 2      # the server raised the engine knob
    both_picked = threading.Barrier(2, timeout=WAIT_S)
    query = idx.query

    def held_query(*args, **kw):
        both_picked.wait()
        return query(*args, **kw)

    outs = []
    idx.query = held_query
    try:
        for rnd in range(3):
            wins = _fp32_windows(idx, 2e-3, 4, seed=20 + rnd)
            for rel in ("intersects", "contains"):
                for w in wins:
                    server.submit(w, rel)
            outs.append((wins, server.flush()))
    finally:
        del idx.query
    with server._lock:
        picks = {server._pick_replica_locked(), server._pick_replica_locked()}
        server._replica_inflight = [0, 0]
    return idx, outs, picks, _counters(server)


def test_replica_fanout_exact_and_counted():
    _, routs, rpicks, rst = _replicas(REF)
    idx, outs, picks, st = _replicas(PORT)
    for (_, a), (_, b) in zip(outs, routs):
        _same_outputs(a, b)
    assert st == rst and picks == rpicks == {0, 1}
    assert sum(st["replica_queries"]) == 24
    assert st["replica_queries"] == [12, 12]
    for wins, out in outs:
        t0 = min(out)
        for i, t in enumerate(sorted(out)):
            rel = "intersects" if i < 4 else "contains"
            np.testing.assert_array_equal(
                out[t], _host(idx, wins[i % 4], rel)[0])
        assert t0 >= 0
    wins = _fp32_windows(idx, 2e-3, 4, seed=40)
    host = idx.query(wins, "intersects", backend="host")
    for rep in (0, 1):
        res = idx.query(wins, "intersects", replica=rep)
        for q in range(len(wins)):
            np.testing.assert_array_equal(res[q], host[q])


# ------------------------------------------------------------- pump mode ----
def test_serving_loop_resolves_tickets_with_adaptive_batching():
    idx = _fp32_index(PORT, n=2000)
    server = tserve.SpatialQueryServer(
        idx, config=tserve.ServerConfig(min_batch=4, gather_window_s=0.01))
    wins = _fp32_windows(idx, 2e-3, 8, seed=9)
    host = idx.query(wins, "intersects", backend="host")
    server.start()
    try:
        tickets = [(server.submit(wins[i % 8], "intersects"), i % 8)
                   for i in range(40)]
        pts = np.random.default_rng(8).uniform(0.2, 0.8, (16, 2))
        knn = [server.submit_knn(p, 4) for p in pts]
        for t, q in tickets:
            val, ts = server.result_at(t, timeout=WAIT_S)
            assert not isinstance(val, tserve.Rejected)
            np.testing.assert_array_equal(val, host[q])
            assert ts <= time.perf_counter()
        got = [server.result(t, timeout=WAIT_S) for t in knn]
    finally:
        server.stop()
    want = idx.query(teng.QueryBatch.knn(pts, 4, backend="host"))
    for (ids, dists), wi, wd in zip(got, want.ids, want.distances):
        np.testing.assert_array_equal(ids, wi)
        np.testing.assert_allclose(dists, wd, rtol=1e-4, atol=1e-7)
    st = server.stats()
    assert (st["queue_depth"], st["served_queries"], st["failed_batches"]) \
        == (0, 56, 0)
    assert st["batch_size_hist"]
    with pytest.raises(TimeoutError):
        server.result(tickets[0][0], timeout=0.0)


def test_pump_mode_sheds_with_rejected_results_under_backpressure():
    """The single worker gated: the pump blocks on the slot semaphore, the
    queue saturates and admission sheds; every shed ticket still resolves
    through result() as an explicit Rejected."""
    idx = _fp32_index(PORT, n=1500)
    server = tserve.SpatialQueryServer(idx, config=tserve.ServerConfig(
        max_queue=4, fair_watermark=1.0, max_workers=1, min_batch=1,
        adaptive_batch=False))
    w = _fp32_windows(idx, 2e-3, 1, seed=10)[0]
    real_query = idx.query
    gate = threading.Event()

    def slow(batch, relation=None, **kw):
        gate.wait(WAIT_S)
        return real_query(batch, relation, **kw)

    idx.query = slow
    tickets = []
    try:
        server.start()
        deadline = time.perf_counter() + WAIT_S
        while server.shed_count == 0:
            assert time.perf_counter() < deadline, "backpressure never shed"
            tickets.append(server.submit(w, "intersects"))
            time.sleep(0.001)
    finally:
        gate.set()
        idx.query = real_query
        server.stop()
    outs = [server.result(t, timeout=WAIT_S) for t in tickets]
    rejected = [o for o in outs if isinstance(o, tserve.Rejected)]
    assert rejected and len(rejected) == server.shed_count
    assert "queue full" in rejected[0].reason
    for o in outs:
        if not isinstance(o, tserve.Rejected):
            np.testing.assert_array_equal(o, _host(idx, w, "intersects")[0])
    assert server.stats()["queue_depth"] == 0


def test_stop_drains_pending_tickets():
    idx = _fp32_index(PORT, n=1500)
    server = tserve.SpatialQueryServer(idx, config=tserve.ServerConfig(
        min_batch=64))
    wins = _fp32_windows(idx, 2e-3, 4, seed=14)
    host = idx.query(wins, "intersects", backend="host")
    server.start()
    tickets = [server.submit(wins[q], "intersects") for q in range(4)]
    server.stop()
    for q, t in enumerate(tickets):
        np.testing.assert_array_equal(server.result(t, timeout=5.0), host[q])


# ------------------------------------------------------------- coalescing ---
def _coalesce(pkg):
    idx = _fp32_index(pkg, n=2000)
    server = pkg.serve.SpatialQueryServer(idx)
    w = _fp32_windows(idx, 2e-3, 2, seed=31)
    rows, real_query = [], idx.query

    def spy(batch, relation=None, **kw):
        rows.append(len(batch))
        return real_query(batch, relation, **kw)

    idx.query = spy
    try:
        dup = [server.submit(w[0], "intersects", tenant=t)
               for t in ("a", "b", "c")]
        server.submit(w[1], "intersects", tenant="a")
        out = server.flush()
    finally:
        idx.query = real_query
    return idx, w, dup, out, rows, server


def test_flush_coalesces_duplicates_into_independent_results():
    *_, rout, rrows, rserver = _coalesce(REF)
    idx, w, dup, out, rows, server = _coalesce(PORT)
    _same_outputs(out, rout)
    assert rows == rrows == [2]
    assert server.stats()["coalesced"] == rserver.stats()["coalesced"] == 2
    ref = _host(idx, w[0], "intersects")[0]
    results = [out[t] for t in dup]
    for r in results:
        np.testing.assert_array_equal(r, ref)
        assert r.flags.writeable
    assert len({id(r) for r in results}) == 3
    results[0][:] = -7                        # one caller's copy
    np.testing.assert_array_equal(results[1], ref)
    t2 = server.submit(w[0], "intersects")
    np.testing.assert_array_equal(server.flush()[t2], ref)   # cache intact


def test_pump_mode_coalesces_and_counts():
    idx = _fp32_index(PORT, n=1500)
    server = tserve.SpatialQueryServer(idx, config=tserve.ServerConfig(
        min_batch=64))
    w = _fp32_windows(idx, 2e-3, 1, seed=33)[0]
    tickets = [server.submit(w, "disjoint") for _ in range(6)]
    server.start()
    server.stop()
    outs = [server.result(t, timeout=10.0) for t in tickets]
    for o in outs:
        np.testing.assert_array_equal(o, _host(idx, w, "disjoint")[0])
    st = server.stats()
    assert st["cache_hits"] + st["cache_misses"] == len(tickets)
    assert st["coalesced"] >= 1 and st["engine_stages"]


# ------------------------------------------- launch counters under threads --
def test_launch_counters_exact_under_threads(monkeypatch):
    """Eight threads drive the counted wrappers through ``ops`` (the route
    forced, the launch a no-op, so CPU tensors reach the counting code) with
    a short switch interval: no count is lost."""
    for mod in (kr, kk):
        monkeypatch.setattr(mod, "_route", lambda *t: True)
        monkeypatch.setattr(mod, "_launch", lambda *a: None)
    rng = np.random.default_rng(0)
    n, q = 64, 4
    lo = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    mbrs = torch.from_numpy(np.concatenate([lo, lo + 0.01], 1))
    wins = mbrs[:q].clone()
    bounds = torch.tensor([[0, n]] * q, dtype=torch.int32)
    d = torch.rand(q, 32)
    ids = torch.arange(32, dtype=torch.int32).repeat(q, 1)
    fns = {"refine_mask": lambda: kops.refine_mask(wins, bounds, mbrs),
           "refine_count": lambda: kops.refine_count(wins, bounds, mbrs),
           "refine_compact": lambda: kops.refine_compact(
               wins, bounds, mbrs, mbrs, budget=8),
           "knn_topk": lambda: kops.knn_topk(d, ids, k=4)}
    wrappers = {"refine_mask": kr.refine_mask, "refine_count": kr.refine_count,
                "refine_compact": kr.refine_compact, "knn_topk": kk.knn_topk}
    before = {k: f.launches for k, f in wrappers.items()}
    reps, nthreads = 200, 8
    errors = []

    def drive():
        try:
            for _ in range(reps):
                for fn in fns.values():
                    fn()
        except BaseException as e:   # noqa: BLE001 — re-raised via `errors`
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S * 4)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for k, f in wrappers.items():
        assert f.launches - before[k] == reps * nthreads, k


# ---------------------------------------------------------------- the CLI --
def test_serve_spatial_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "spatial",
         "--device", "cpu", "--n", "5000", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
        stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stderr[-2000:]
    head, _, body = r.stdout.partition("\n")
    assert head.startswith("[serve] cluster n=5000") and "on cpu" in head
    st = json.loads(body)
    assert st["device"] == "cpu" and st["queue_depth"] == 0
    assert st["served_queries"] > 0 and st["failed_batches"] == 0
    assert st["replicas"] == 2 and st["engine_stages"]
