"""Serving tier: the GLIN spatial-query front-end.

:class:`SpatialQueryServer` is a micro-batching server over
:class:`repro_torch.core.SpatialIndex`:

* **replica router** — query batches are dispatched to the least-loaded of
  ``ServerConfig.replicas`` device placements (``EngineConfig.replicas``:
  copies of the published snapshot + payload on the host's cards, refreshed
  at every publish, so the write/delta stream republishes to all replicas
  at once; on one card every replica serves the primary placement);
* **bounded queues, backpressure, admission control** — per-tenant FIFO
  queues drained in weighted-fair round-robin order; past
  ``ServerConfig.max_queue`` (and, above the ``fair_watermark``, past a
  tenant's weighted share) submissions are shed with an explicit
  :class:`Rejected` result, never silently dropped;
* **adaptive micro-batching** — the serving loop sizes each batch from the
  observed queue depth (clamped to ``min_batch``/``max_batch``) and, under
  light load, waits a gather window derived from the EWMA per-query service
  time so batches fill instead of fragmenting;
* **overlapped group flushes** — distinct relation groups execute
  concurrently on a worker pool (each picking its own replica) instead of
  serially, with the telemetry-atomicity contract intact: ``flush()``
  commits counters, cache entries and the drained queue slice only once
  EVERY group succeeded — a failed group restores all sibling tickets
  untouched and unreported.

The worker threads launch the index's kernels on the device's current
(default) stream, the stream the index allocates on, so no tensor is
handed back to the caching allocator while a kernel queued on another
stream still reads it.

The ``SlotServer`` (continuous-batching LM demo) lives in
``repro_torch.launch.serve``, its only consumer.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.engine import QueryBatch, SpatialIndex
from ..core.relations import get_relation

__all__ = ["Rejected", "ServerConfig", "SpatialQueryServer"]


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Explicit load-shed marker: a submission the admission controller (or a
    failed serving batch) turned away. Delivered through the same channels as
    hit ids — ``flush()`` values and ``result()`` — so shed requests surface
    to the caller instead of vanishing."""

    reason: str
    tenant: str = "default"
    relation: str = ""


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving-tier knobs (all backpressure off by default: ``max_queue=0``
    admits everything, ``replicas=1``/``overlap_groups=True`` still overlap
    relation groups on one placement)."""

    replicas: int = 1            # device placements to route over (also
                                 # raises EngineConfig.replicas on the index)
    max_queue: int = 0           # total queued requests before shedding
                                 # (0 = unbounded, admission control off)
    fair_watermark: float = 0.5  # fraction of max_queue above which a tenant
                                 # is capped at its weighted share
    tenant_weights: Optional[Dict[str, float]] = None  # default weight 1.0
    min_batch: int = 8           # adaptive micro-batch floor (pump mode)
    max_batch: int = 4096        # micro-batch ceiling (depth is clamped here)
    adaptive_batch: bool = True  # gather-window batching in the pump loop
    gather_window_s: float = 0.002  # max extra wait for a batch to fill
    overlap_groups: bool = True  # relation groups run concurrently
    max_workers: Optional[int] = None  # pool size; default max(replicas, 2)
                                       # when overlapping, capped at the
                                       # host's core count, else 1

    def workers(self) -> int:
        if self.max_workers is not None:
            return max(1, self.max_workers)
        if not self.overlap_groups:
            return 1
        # overlap degree is capped at the core count: concurrent host work
        # on an oversubscribed machine thrashes instead of overlapping, and
        # a single-core host serves groups fastest back-to-back. An explicit
        # max_workers overrides the cap verbatim.
        return max(1, min(max(self.replicas, 2), os.cpu_count() or 1))


# one queued request: (ticket, tenant, relation, window)
_Pending = Tuple[int, str, str, np.ndarray]


class SpatialQueryServer:
    """Micro-batching spatial-query server over a :class:`SpatialIndex`.

    ``submit`` enqueues a window and returns a ticket; ``flush`` drains the
    queues in weighted-fair order, groups by relation, issues ONE facade
    query per relation group (so the planner sees the full batch and can
    take the device path) — groups overlapping on the worker pool, each
    routed to the least-loaded replica — and returns ``{ticket: hit ids}``
    (shed tickets map to :class:`Rejected`). ``query`` is the submit-all +
    flush convenience. Writes are delegated to the facade, which records
    them as a delta against the published device snapshot — a flush after a
    write can never serve stale results, and under a write-heavy stream the
    planner serves the ``device+delta`` backend (snapshot + tombstone/added
    patch) instead of republishing per write (``backend_counts`` records the
    mix).

    **Serving loop.** ``start()`` spawns a dispatcher thread that drains the
    queues continuously with adaptive micro-batching (batch size from queue
    depth, gather window from the per-batch service-time EWMA) and resolves
    tickets asynchronously; ``result(ticket)`` blocks for one. ``submit`` /
    ``insert`` / ``delete`` are thread-safe in both modes — the facade
    serializes writes against query prologues internally.

    **Result cache.** Flushed results are cached per window, keyed on the
    facade's **serving generation** — ``(index epoch, snapshot publish
    count)`` — plus window bytes and relation: repeated windows (hot map
    tiles, dashboard refreshes) are served from the cache without touching
    the facade. The epoch component makes every write an implicit
    invalidation, and the publish component makes every snapshot swap one
    too — an async double-buffered republish (``EngineConfig.
    async_republish``) replaces the served snapshot WITHOUT bumping the
    epoch, so keying on the epoch alone could serve a hit computed against
    the previous snapshot. Entries from dead generations are dropped
    eagerly. ``backend_counts["cache"]`` counts cache-served queries next to
    the facade backends; ``cache_hits`` / ``cache_misses`` give the raw
    telemetry.

    **kNN.** ``submit_knn(point, k)`` rides the same machinery: the point is
    encoded as its degenerate window under the pseudo-relation ``knn:<k>``,
    so one flush issues ONE device-complete knn batch per distinct k,
    duplicate points coalesce, and kNN batches become cacheable single-plan
    flushes — a repeated point is served its ``(ids, distances)`` pair
    straight from the result cache under the same generation keying.

    **Request coalescing.** Within one relation group of a micro-batch,
    duplicate windows (byte-identical) are folded into a single engine row
    before the facade call — under hot-query skew the engine sees the
    distinct working set, not the arrival stream. Each caller still gets an
    independent writable result array, and the ``coalesced`` counter tracks
    how many duplicates were folded.

    ``async_republish=True`` flips the facade's double-buffering on at
    construction: under a write-heavy stream, snapshot republishes build on
    a background thread while ``flush``/``query`` keep serving the current
    snapshot + delta — the query stream never blocks on a rebuild.
    """

    CACHE_MAX_ENTRIES = 4096

    def __init__(self, index: SpatialIndex,
                 async_republish: Optional[bool] = None,
                 config: Optional[ServerConfig] = None):
        self.index = index
        self.config = config or ServerConfig()
        eng_updates = {}
        if async_republish is not None:
            eng_updates["async_republish"] = async_republish
        if self.config.replicas > index.config.replicas:
            eng_updates["replicas"] = self.config.replicas
        if eng_updates:
            index.config = dataclasses.replace(index.config, **eng_updates)
        # one lock (the Condition's) guards every mutable server field;
        # facade queries run OUTSIDE it (the engine has its own lock)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, Deque[_Pending]] = {}
        self._tenant_order: List[str] = []
        self._rr = 0                       # weighted round-robin cursor
        self._depth = 0                    # total queued requests
        self._next_ticket = 0
        self._rejected: Dict[int, Rejected] = {}   # shed, awaiting flush()
        self._done: Dict[int, Any] = {}            # pump-mode results
        self._pool: Optional[ThreadPoolExecutor] = None
        self._slots: Optional[threading.Semaphore] = None
        self._pump: Optional[threading.Thread] = None
        self._running = False
        # telemetry (commit rules: flush() counters move only after every
        # group of a flush succeeded; pump-mode batches commit per group)
        self.served_queries = 0
        self.served_batches = 0
        self.write_ops = 0
        self.shed_count = 0
        self.failed_batches = 0
        self.backend_counts: Dict[str, int] = {}  # plan.backend -> batches
        self.batch_hist: Dict[int, int] = {}      # pow2 bucket -> batches
        self.replica_queries = [0] * max(1, self.config.replicas)
        self._replica_inflight = [0] * max(1, self.config.replicas)
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._service_ewma: Optional[float] = None  # s per served batch
        self._query_ewma: Optional[float] = None    # s per served query
        # window rows cache an ids array; knn rows an (ids, distances) pair
        self._cache: Dict[Tuple[Tuple[int, int], bytes, str], Any] = {}
        self._cache_gen: Tuple[int, int] = (-1, -1)
        self.cache_hits = 0
        self.cache_misses = 0
        self.coalesced = 0      # duplicate windows folded within a group

    # ------------------------------------------------------------------ cache
    def _record_plan(self, res) -> None:
        b = res.plan.backend
        self.backend_counts[b] = self.backend_counts.get(b, 0) + 1

    def _cache_lookup(self, gen: Tuple[int, int], w: np.ndarray,
                      relation: str):
        """Return a writable copy of the cached hit ids for a window, or
        None. A write bumps the epoch and a snapshot swap bumps the publish
        count, so stale entries never match; the whole cache is dropped when
        the serving generation moves (dead keys can never hit again). Hits
        are copies so callers get the same mutable-array contract on hits
        and misses alike. Call under the server lock."""
        if self._cache_gen != gen:
            self._cache.clear()
            self._cache_gen = gen
        hit = self._cache.get((gen, w.tobytes(), relation))
        if hit is None:
            return None
        if isinstance(hit, tuple):          # knn: (ids, distances)
            return tuple(a.copy() for a in hit)
        return hit.copy()

    def _cache_store(self, gen: Tuple[int, int], w: np.ndarray, relation: str,
                     ids: np.ndarray) -> None:
        if gen != self._cache_gen or gen != self.index.serving_generation:
            return         # a write or a snapshot swap landed mid-flush
        if len(self._cache) >= self.CACHE_MAX_ENTRIES:
            self._cache.pop(next(iter(self._cache)))   # FIFO eviction
        # cache a frozen copy, not the array handed to the caller: an
        # in-place mutation by one caller must not poison later hits
        def freeze(a):
            f = a.copy()
            f.setflags(write=False)
            return f
        frozen = (tuple(freeze(a) for a in ids) if isinstance(ids, tuple)
                  else freeze(ids))          # knn rows are (ids, distances)
        self._cache[(gen, w.tobytes(), relation)] = frozen

    # ------------------------------------------------------------- admission
    def _weight(self, tenant: str) -> float:
        w = (self.config.tenant_weights or {}).get(tenant, 1.0)
        return max(w, 1e-9)

    def _tenant(self, tenant: str) -> Dict[str, int]:
        ts = self._tenant_stats.get(tenant)
        if ts is None:
            ts = self._tenant_stats[tenant] = {
                "admitted": 0, "rejected": 0, "served": 0}
        return ts

    def _admit_locked(self, tenant: str) -> Tuple[bool, str]:
        """Admission control: global queue bound, then (above the fairness
        watermark) a per-tenant weighted share of the bound — a flooding
        tenant saturates only its share while others keep being admitted.
        Shares divide over every tenant SEEN so far (not just the currently
        queued ones), so a trickle tenant's slice is reserved even while its
        queue happens to be empty."""
        cfg = self.config
        if cfg.max_queue <= 0:
            return True, ""
        if self._depth >= cfg.max_queue:
            return False, f"queue full ({self._depth}/{cfg.max_queue})"
        if self._depth >= cfg.fair_watermark * cfg.max_queue:
            known = set(self._tenant_stats)
            known.add(tenant)
            total = sum(self._weight(t) for t in known)
            share = max(1, int(cfg.max_queue * self._weight(tenant) / total))
            mine = len(self._queues.get(tenant, ()))
            if mine >= share:
                return False, (f"tenant {tenant!r} over fair share "
                               f"({mine}/{share} above watermark)")
        return True, ""

    # ------------------------------------------------------------------ reads
    def submit(self, window: np.ndarray, relation: str = "intersects",
               tenant: str = "default") -> int:
        """Enqueue one window; returns a ticket. A shed submission still
        returns a ticket — it resolves to a :class:`Rejected` (via
        ``flush()`` or ``result()``), never a silent drop."""
        get_relation(relation)  # fail fast, not at flush time
        w = np.asarray(window, np.float64).reshape(4)
        return self._enqueue(w, relation, tenant)

    def submit_knn(self, point: np.ndarray, k: int,
                   tenant: str = "default") -> int:
        """Enqueue one kNN point; the ticket resolves to ``(ids,
        distances)``. The point is encoded as its degenerate window and
        grouped under the pseudo-relation ``knn:<k>`` — one flush issues ONE
        device-complete knn batch per distinct k, duplicate points coalesce,
        repeated points hit the result cache."""
        if int(k) < 1:
            raise ValueError(f"knn needs k >= 1, got {k}")
        p = np.asarray(point, np.float64).reshape(2)
        w = np.array([p[0], p[1], p[0], p[1]], np.float64)
        return self._enqueue(w, f"knn:{int(k)}", tenant)

    def _enqueue(self, w: np.ndarray, relation: str, tenant: str) -> int:
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            ts = self._tenant(tenant)
            ok, reason = self._admit_locked(tenant)
            if not ok:
                rej = Rejected(reason=reason, tenant=tenant, relation=relation)
                self.shed_count += 1
                ts["rejected"] += 1
                if self._running:
                    self._done[ticket] = (rej, time.perf_counter())
                else:
                    self._rejected[ticket] = rej
                self._cond.notify_all()
                return ticket
            ts["admitted"] += 1
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._tenant_order.append(tenant)
            q.append((ticket, tenant, relation, w))
            self._depth += 1
            self._cond.notify_all()
        return ticket

    def _drain_locked(self, limit: Optional[int]) -> List[_Pending]:
        """Pop up to ``limit`` requests (all when None) in weighted
        round-robin order over tenants, FIFO within a tenant: each pass
        hands tenant *t* up to ``remaining * w_t / W`` slots (min 1),
        rotating the starting tenant so no tenant is structurally first."""
        take = self._depth if limit is None else min(limit, self._depth)
        out: List[_Pending] = []
        while len(out) < take:
            active = [t for t in self._tenant_order if self._queues.get(t)]
            if not active:
                break
            total = sum(self._weight(t) for t in active)
            start, n = self._rr, len(active)
            self._rr = (self._rr + 1) % n
            rem = take - len(out)
            for i in range(n):
                t = active[(start + i) % n]
                quota = max(1, int(rem * self._weight(t) / total))
                q = self._queues[t]
                for _ in range(min(quota, len(q))):
                    if len(out) >= take:
                        break
                    out.append(q.popleft())
        self._depth -= len(out)
        return out

    def _restore_locked(self, items: List[_Pending]) -> None:
        """Push a drained slice back to the FRONT of the queues, preserving
        per-tenant FIFO order (a failed flush leaves every ticket
        retryable)."""
        for item in reversed(items):
            t = item[1]
            q = self._queues.get(t)
            if q is None:
                q = self._queues[t] = deque()
                self._tenant_order.append(t)
            q.appendleft(item)
        self._depth += len(items)

    # --------------------------------------------------------- group dispatch
    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            w = self.config.workers()
            self._pool = ThreadPoolExecutor(
                max_workers=w, thread_name_prefix="glin-serve")
            self._slots = threading.Semaphore(w)
        return self._pool

    def _pick_replica_locked(self) -> int:
        """Least-loaded dispatch over the configured replica placements."""
        inflight = self._replica_inflight
        rep = min(range(len(inflight)), key=inflight.__getitem__)
        inflight[rep] += 1
        return rep

    def _run_group(self, rel: str, items: List[_Pending]):
        """One facade query for one relation group, routed to the
        least-loaded replica. Duplicate windows within the group are
        coalesced into one engine row; every caller still receives its own
        writable ids array (the first claim gets the engine's array, each
        duplicate a copy). Returns ``(res, per_item, ncoal, replica,
        seconds)`` with ``per_item`` aligned to ``items``."""
        uniq: Dict[bytes, int] = {}
        slot: List[int] = []
        rows: List[np.ndarray] = []
        for _, _, _, w in items:
            k = w.tobytes()
            mi = uniq.get(k)
            if mi is None:
                mi = uniq[k] = len(rows)
                rows.append(w)
            slot.append(mi)
        ncoal = len(items) - len(rows)
        windows = np.stack(rows)
        knn_k = int(rel[4:]) if rel.startswith("knn:") else None
        batch = (QueryBatch.knn(windows[:, :2], knn_k)
                 if knn_k is not None else QueryBatch.window(windows, rel))
        with self._lock:
            rep = self._pick_replica_locked()
        t0 = time.perf_counter()
        try:
            res = self.index.query(batch, replica=rep)
        finally:
            dt = time.perf_counter() - t0
            dtq = dt / max(1, len(items))
            with self._lock:
                self._replica_inflight[rep] -= 1
                a = 0.3       # EWMAs of service time (pump gather sizing)
                self._service_ewma = (dt if self._service_ewma is None
                                      else a * dt + (1 - a) * self._service_ewma)
                self._query_ewma = (dtq if self._query_ewma is None
                                    else a * dtq + (1 - a) * self._query_ewma)
        claimed = [False] * len(rows)
        per_item: List[Any] = []
        for mi in slot:
            if knn_k is not None:           # knn rows: (ids, distances)
                v = (res.ids[mi], res.distances[mi])
                per_item.append(tuple(a.copy() for a in v)
                                if claimed[mi] else v)
            else:
                per_item.append(res[mi].copy() if claimed[mi] else res[mi])
            claimed[mi] = True
        return res, per_item, ncoal, rep, dt

    @staticmethod
    def _hist_bucket(n: int) -> int:
        return 1 << max(n - 1, 0).bit_length()

    def flush(self) -> Dict[int, Any]:
        """Serve everything queued; returns ``{ticket: hit ids | Rejected}``.

        Relation groups run concurrently on the worker pool
        (``ServerConfig.overlap_groups``), each on its least-loaded replica.
        Telemetry atomicity, on the overlapped path too: counters, cache
        entries and the queue drain commit only once EVERY group
        succeeded — one failed group restores all drained
        tickets (including its siblings' completed work, which is discarded)
        and re-raises without double-counting or dropping anything."""
        with self._cond:
            items = self._drain_locked(None)
            if not items and not self._rejected:
                return {}
            gen = self.index.serving_generation
            out: Dict[int, Any] = {}
            cached: List[_Pending] = []
            by_rel: Dict[str, List[_Pending]] = {}
            for item in items:
                ticket, tenant, rel, w = item
                hit = self._cache_lookup(gen, w, rel)
                if hit is not None:
                    out[ticket] = hit
                    cached.append(item)
                else:
                    by_rel.setdefault(rel, []).append(item)
        groups = list(by_rel.items())
        results: List[Tuple[str, List[_Pending], Any]] = []
        try:
            if len(groups) > 1 and self.config.overlap_groups:
                pool = self._ensure_pool()
                futs = [(rel, g, pool.submit(self._run_group, rel, g))
                        for rel, g in groups]
                first_err = None
                for rel, g, f in futs:
                    try:
                        results.append((rel, g, f.result()))
                    except BaseException as e:   # noqa: BLE001 — re-raised
                        if first_err is None:
                            first_err = e
                if first_err is not None:
                    raise first_err
            else:
                for rel, g in groups:
                    results.append((rel, g, self._run_group(rel, g)))
        except BaseException:
            with self._cond:
                self._restore_locked(items)
            raise
        # ---- commit: every group succeeded ----
        with self._cond:
            for rel, g, (res, per_item, ncoal, rep, _dt) in results:
                for (ticket, tenant, r, w), ids in zip(g, per_item):
                    out[ticket] = ids
                    self._cache_store(gen, w, r, ids)
                    self._tenant(tenant)["served"] += 1
                self._record_plan(res)
                self.coalesced += ncoal
                self.replica_queries[rep] += len(g)
                b = self._hist_bucket(len(g))
                self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
            for item in cached:
                self._tenant(item[1])["served"] += 1
            shed = self._rejected
            self._rejected = {}
            out.update(shed)
            self.cache_hits += len(cached)
            self.cache_misses += sum(len(g) for _, g in groups)
            if cached:
                self.backend_counts["cache"] = (
                    self.backend_counts.get("cache", 0) + len(cached))
            self.served_queries += len(out) - len(shed)
            self.served_batches += len(groups)
        return out

    def query(self, windows: np.ndarray, relation: str = "intersects",
              backend: Optional[str] = None):
        """Batched one-shot: queue nothing, serve ``windows`` directly."""
        res = self.index.query(
            QueryBatch.window(windows, relation, backend=backend))
        with self._lock:
            self._record_plan(res)
            self.served_queries += len(res)
            self.served_batches += 1
        return res

    # ----------------------------------------------------------- serving loop
    def start(self) -> "SpatialQueryServer":
        """Spawn the dispatcher thread: queues drain continuously with
        adaptive micro-batching; results resolve via :meth:`result`."""
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._ensure_pool()
            self._pump = threading.Thread(
                target=self._pump_loop, daemon=True, name="glin-serve-pump")
            self._pump.start()
        return self

    def stop(self) -> None:
        """Stop the dispatcher, drain what is left (no waiter hangs), and
        wait for in-flight groups."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._cond.notify_all()
        if self._pump is not None:
            self._pump.join()
            self._pump = None
        while True:
            with self._cond:
                items = self._drain_locked(None)
            if not items:
                break
            self._dispatch(items, wait=True)
        # barrier: drain every worker slot so in-flight groups finish
        w = self.config.workers()
        for _ in range(w):
            self._slots.acquire()
        for _ in range(w):
            self._slots.release()

    def result(self, ticket: int, timeout: Optional[float] = None):
        """Block until ``ticket`` resolves (pump mode); returns hit ids or a
        :class:`Rejected`."""
        val, _ts = self.result_at(ticket, timeout)
        return val

    def result_at(self, ticket: int, timeout: Optional[float] = None):
        """Like :meth:`result` but returns ``(value, perf_counter at
        resolution)`` — load harnesses measure latency from the resolution
        stamp, not from when the collector got around to asking."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while ticket not in self._done:
                rem = (None if deadline is None
                       else deadline - time.perf_counter())
                if rem is not None and rem <= 0:
                    raise TimeoutError(f"ticket {ticket} not served")
                self._cond.wait(0.1 if rem is None else min(rem, 0.1))
            return self._done.pop(ticket)

    def _batch_target_locked(self) -> int:
        cfg = self.config
        return max(min(self._depth, cfg.max_batch), min(cfg.min_batch,
                                                        cfg.max_batch))

    def _gather_window(self) -> float:
        """How long the pump may wait for a batch to fill: half the EWMA
        service time of the batch it is trying to BUILD (``min_batch``
        queries at the per-query EWMA), capped by ``gather_window_s``.
        Scaling by the target batch rather than the last-served batch
        matters: under light load the last batch is size 1 and its service
        time is a few ms — a window derived from it would never open and
        the pump would be trapped serving singletons forever."""
        ewma_q = self._query_ewma or 0.0
        floor = min(self.config.min_batch, self.config.max_batch)
        return min(self.config.gather_window_s, 0.5 * floor * ewma_q)

    def _pump_loop(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                ahead = self._depth == 0   # idle => the server is ahead of
                while self._running and self._depth == 0:   # the load
                    self._cond.wait(0.05)
                if not self._running:
                    return
                depth = self._depth
                target = self._batch_target_locked()
            # Gather (wait for the batch to fill) ONLY when the pump went
            # idle before this cycle: anything queued then is fresh, so the
            # wait costs bounded latency and buys a fuller batch. When work
            # was already waiting as the previous batch finished, the server
            # is at or past saturation — every gather tick would be idle
            # time repaid later with interest (draining the whole queue,
            # idling a window, and repeating caps throughput at roughly
            # min_batch per window, well below the batched service rate).
            if (cfg.adaptive_batch and ahead
                    and depth < min(cfg.min_batch, cfg.max_batch)):
                deadline = time.perf_counter() + self._gather_window()
                with self._cond:
                    while (self._running and self._depth < cfg.min_batch):
                        rem = deadline - time.perf_counter()
                        if rem <= 0:
                            break
                        self._cond.wait(rem)
                    target = self._batch_target_locked()
            with self._cond:
                items = self._drain_locked(target)
            if items:
                self._dispatch(items, wait=False)

    def _dispatch(self, items: List[_Pending], wait: bool) -> None:
        """Group a drained batch by relation and hand each group to the
        worker pool, bounded by the slot semaphore — when every worker is
        busy the pump blocks here, queue depth grows, and admission control
        sheds: backpressure end to end."""
        by_rel: Dict[str, List[_Pending]] = {}
        for item in items:
            by_rel.setdefault(item[2], []).append(item)
        pool = self._ensure_pool()
        futs = []
        for rel, g in by_rel.items():
            self._slots.acquire()
            futs.append(pool.submit(self._serve_group_task, rel, g))
        if wait:
            for f in futs:
                f.result()

    def _serve_group_task(self, rel: str, items: List[_Pending]) -> None:
        """Pump-mode worker: serve one relation group, resolve its tickets.
        A failed group resolves every ticket as :class:`Rejected` (counted
        in ``failed_batches``) — waiters never hang on an exception."""
        try:
            with self._cond:
                gen = self.index.serving_generation
                todo: List[_Pending] = []
                for item in items:
                    ticket, tenant, r, w = item
                    hit = self._cache_lookup(gen, w, r)
                    if hit is not None:
                        self._done[ticket] = (hit, time.perf_counter())
                        self._tenant(tenant)["served"] += 1
                        self.cache_hits += 1
                        self.served_queries += 1
                        self.backend_counts["cache"] = (
                            self.backend_counts.get("cache", 0) + 1)
                    else:
                        todo.append(item)
                self._cond.notify_all()
            if not todo:
                return
            res, per_item, ncoal, rep, _dt = self._run_group(rel, todo)
            now = time.perf_counter()
            with self._cond:
                for (ticket, tenant, r, w), ids in zip(todo, per_item):
                    self._cache_store(gen, w, r, ids)
                    self._done[ticket] = (ids, now)
                    self._tenant(tenant)["served"] += 1
                self._record_plan(res)
                self.coalesced += ncoal
                self.cache_misses += len(todo)
                self.served_queries += len(todo)
                self.served_batches += 1
                self.replica_queries[rep] += len(todo)
                b = self._hist_bucket(len(todo))
                self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
                self._cond.notify_all()
        except BaseException as e:   # noqa: BLE001 — resolved as Rejected
            now = time.perf_counter()
            with self._cond:
                self.failed_batches += 1
                for ticket, tenant, r, w in items:
                    if ticket not in self._done:
                        self._done[ticket] = (
                            Rejected(f"serve error: {e!r}", tenant, r), now)
                self._cond.notify_all()
        finally:
            self._slots.release()

    # ------------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """One JSON-serializable snapshot of the serving tier. Includes the
        facade's per-stage execution telemetry (``engine_stages``) so one
        stats call covers the whole pipeline: queue → stage → replica."""
        # grab engine telemetry before taking the server lock (the facade
        # has its own lock; never hold both)
        eng_stages = self.index.stats().get("stages", {})
        with self._lock:
            return {
                "queue_depth": self._depth,
                "queued_by_tenant": {t: len(q)
                                     for t, q in self._queues.items() if q},
                "shed": self.shed_count,
                "failed_batches": self.failed_batches,
                "tenants": {t: dict(v)
                            for t, v in sorted(self._tenant_stats.items())},
                "batch_size_hist": {str(k): v for k, v in
                                    sorted(self.batch_hist.items())},
                "replica_queries": list(self.replica_queries),
                "replica_inflight": list(self._replica_inflight),
                "replicas": max(1, self.config.replicas),
                "workers": self.config.workers(),
                "backend_counts": dict(self.backend_counts),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "coalesced": self.coalesced,
                "engine_stages": eng_stages,
                "served_queries": self.served_queries,
                "served_batches": self.served_batches,
                "write_ops": self.write_ops,
                "service_time_ms": (None if self._service_ewma is None
                                    else 1e3 * self._service_ewma),
            }

    # ----------------------------------------------------------------- writes
    def insert(self, verts: np.ndarray, nverts: int, kind: int = 0) -> int:
        rec = self.index.insert(verts, nverts, kind)
        with self._lock:
            self.write_ops += 1
        return rec

    def delete(self, rec: int) -> bool:
        ok = self.index.delete(rec)
        with self._lock:
            self.write_ops += 1
        return ok
