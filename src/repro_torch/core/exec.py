"""The staged query-execution pipeline behind :meth:`SpatialIndex.query`.

GLIN's query path is ONE pipeline regardless of where it runs::

    probe -> compact -> refine -> delta-patch -> complement-finish

What differs per backend is which *implementation* serves each stage and how
many adjacent stages it fuses: the host loop walks the mutable tree one
window at a time (probe+compact+refine in one pass), the device
``batch_query`` composes the same three stages as THREE device dispatches
(probe, compact kernel, exact gather+check), ``batch_query_fused``
collapses them into ONE (:class:`FusedDeviceStage`, selected by
``EngineConfig.fusion``), and the sharded step runs them per record shard
over a mesh (:class:`ShardedRefineStage`, ``core.distributed``). Delta
patching (the ``device+delta`` backend:
tombstones masked, the added set checked) and complement finishing are
backend-independent — they operate on id lists against state frozen under
the facade lock — so exactly ONE implementation of each exists, here.

A knn batch compiles to ONE stage that covers probe, compaction, refine
and the rank: :class:`KnnHostStage` (the fp64 host ladder, one point at a
time) or :class:`KnnDeviceStage` (seeded radius rungs of ``intersects``
probes, each ranked on the device by exact distance and a top-k; on
``device+delta`` with the tombstones masked and the added set merged into
the rank) or :class:`KnnShardedStage` (each record shard ranks its own
candidates, and a k-merge takes the global k).

``SpatialIndex.plan()`` picks a backend; :func:`compile_plan` turns that
:class:`QueryPlan` into an :class:`ExecutionPlan` — an ordered stage tuple —
and :meth:`ExecutionPlan.execute` runs it, timing every stage into
:class:`StageStats` (wall time, survivor counts, overflow-ladder
escalations, dispatches). The stats ride out on ``QueryResult.stages`` and
aggregate into ``SpatialIndex.stats()["stages"]``;
:meth:`SpatialIndex.explain` pretty-prints the compiled pipeline without
executing it.

**The overflow ladder** (:class:`OverflowLadder`) is the one shared
cap/budget escalation policy. Device-side refinement signals overflow with
negative counts: ``-(run length) - 1`` when a query's candidate run outgrew
``cap`` (magnitude > cap disambiguates), else ``-(survivors) - 1`` when the
MBR survivors outgrew ``exact_budget``. The ladder jumps the cap straight
to a sufficient power of two (a cheap bounds-only probe tells the two
overflows apart), grows the budget geometrically past the true survivor
count, and escalates to the single-stage dense path only once the needed
budget exceeds ``MAX_COMPACT_BUDGET`` (or, with scan compaction, the
cap). The compact kernel and
the fused one-dispatch path scan the full run (they are capless), so with a
budget active their overflow is ALWAYS the budget — their retries need no
disambiguating bounds probe (:meth:`OverflowLadder.on_capless_overflow`).
(The reference sends the staged compact kernel's overflow through the
cap-aware probe, which raises ``OverflowError`` once a run outgrows
``max_cap`` even though the kernel never needed the cap.)

**Locking contract**: the host refine stage runs under the facade lock (it
walks the mutable host tree) and freezes the live-id set for complement
finishing in that same critical section; the device refine stages freeze
the snapshot, payload, delta and live-id set under the lock, then run their
device compute OUTSIDE it. Delta patching and complement finishing run
lock-free on the frozen copies, so their answers are exact at the frozen
epoch no matter how writers interleave.

**Dispatch telemetry**: every stage counts the device dispatches it issued
into ``StageStats.dispatches`` (a staged two-stage attempt is 3 — probe,
compact, exact; a dense attempt 2; a fused attempt 1; each disambiguating
bounds probe adds 1).

**Locking on a mesh**: the sharded stages run entirely under the facade
lock, as the reference's do (its mesh owns every device; here one
controller drives every position in turn), and freeze the delta and
live-id sets in that same critical section for the shared stages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .device import batch_check_added, batch_knn_rank, knn_seed_radii
from .index import QueryStats, initial_knn_radius
from .index import knn as _host_knn
from .relations import get_relation

__all__ = ["StageStats", "ExecContext", "Stage", "ExecutionPlan",
           "OverflowLadder", "DeltaPatchStage", "KnnHostStage",
           "KnnDeviceStage", "ShardedRefineStage", "KnnShardedStage",
           "compile_plan", "PIPELINE_STAGES"]

# canonical stage order
PIPELINE_STAGES = ("probe", "compact", "refine", "delta-patch",
                   "complement-finish")


def _engine():
    """The engine module namespace, resolved at call time — tests patch
    ``repro_torch.core.engine.batch_query`` and friends, and the stages must
    see the patched bindings. Deferred to avoid the circular import (engine
    imports this module)."""
    from . import engine
    return engine


# --------------------------------------------------------------- observability
@dataclasses.dataclass
class StageStats:
    """Per-stage telemetry for one executed query batch.

    ``survivors`` is the total id count LEAVING the stage (-1 when the stage
    does not produce ids); ``escalations`` counts overflow-ladder retries;
    ``cap``/``budget`` are the settled ladder values a refine stage ended on
    (budget 0 = single-stage dense, -1 = n/a); ``dispatches`` counts device
    dispatches issued (staged two-stage attempt = 3, dense = 2, fused = 1,
    +1 per disambiguating bounds probe — 0 for host/shared stages)."""

    stage: str                       # primary canonical stage name
    impl: str                        # "host" | "device" | "fused" |
                                     # "sharded" | "shared"
    covers: Tuple[str, ...] = ()     # canonical stages this impl fuses
    wall_ms: float = 0.0
    queries: int = 0
    survivors: int = -1
    escalations: int = 0
    dispatches: int = 0
    cap: int = 0
    budget: int = -1
    delta_added: int = 0
    delta_tombstoned: int = 0
    skipped: bool = False            # compiled in, but a no-op this run
    note: str = ""
    # knn-rank telemetry (zero/empty on every other stage)
    rungs: int = 0                   # deepest per-point radius-ladder depth
    rung_hist: Tuple[int, ...] = ()  # points settled per rung; [0] = seeded
    seed_hits: int = 0               # points settled at their seeded radius
    seed_radius: float = 0.0         # median seed radius
    merge_bytes: int = 0             # sharded kNN: the k-merge's block bytes


@dataclasses.dataclass
class ExecContext:
    """Mutable state threaded through the stages of one execution.

    The refine stage freezes everything downstream stages read (``epoch``,
    ``frozen_delta``, ``live``, ``snap``) under the facade lock; the stages
    after it touch only this context, never the live index fields."""

    index: Any                       # the SpatialIndex facade
    batch: Any                       # QueryBatch
    plan: Any                        # QueryPlan
    rel: Any                         # Relation (None for knn)
    base: Any                        # probed base Relation (None for knn)
    replica: int = 0                 # placement the device stages serve
    # frozen under the facade lock by the refine stage
    epoch: int = -1
    frozen_delta: Optional[Tuple] = None   # SpatialIndex._freeze_delta()
    live: Optional[np.ndarray] = None
    snap: Any = None                 # the snapshot served (its grid params
                                     # quantize the delta patch's windows)
    # outputs
    ids: Optional[List[np.ndarray]] = None
    distances: Optional[List[np.ndarray]] = None
    host_stats: Optional[List[QueryStats]] = None
    stage_stats: List[StageStats] = dataclasses.field(default_factory=list)


def _total(ids: Optional[List[np.ndarray]]) -> int:
    return -1 if ids is None else int(sum(r.shape[0] for r in ids))


# -------------------------------------------------------------- overflow ladder
class OverflowLadder:
    """THE cap/budget escalation policy, shared by every refine
    implementation (staged and fused). See the module docstring for
    the negative-count encoding contract this consumes.

    Holds the adaptive state for one query's retries; the settled ``cap`` is
    max-merged back into the facade by the refine stage so the ladder is
    walked once per workload, not once per call."""

    def __init__(self, config, cap: int, max_budget: Optional[int] = None,
                 compaction: str = "scan"):
        from ..kernels.refine import MAX_COMPACT_BUDGET

        self.config = config
        self.cap = int(cap)
        self.budget = int(config.exact_budget)
        # budget-growth ceiling before the ladder falls back to the dense
        # single-stage path. Window refines keep MAX_COMPACT_BUDGET (a dense
        # retry only re-checks cheap predicates); knn raises it to max_cap
        # because the rank's exact-distance work scales with the hit-matrix
        # WIDTH — compaction at a large budget is far cheaper than ranking
        # a dense (Q, cap) matrix every rung.
        self.max_budget = (MAX_COMPACT_BUDGET if max_budget is None
                           else int(max_budget))
        # the staged attempts' stage-1 implementation. THE place that knows
        # the compact kernel walks whole runs: its two-stage attempts need
        # no cap (which then bounds only the dense path) and its overflow
        # is always the budget
        self.compaction = compaction
        self.capless = compaction == "kernel"
        self.escalations = 0

    def two_stage(self, budget: int) -> bool:
        """Whether ``budget`` runs two-stage: it must be positive, and below
        the cap unless the compaction is capless (a scan windows each run
        to the cap, so a budget at the cap buys nothing)."""
        return budget > 0 and (self.capless or budget < self.cap)

    @property
    def use_budget(self) -> int:
        """The budget the next call actually uses (0: the dense path)."""
        return self.budget if self.two_stage(self.budget) else 0

    def grow_cap(self, need: int) -> None:
        cfg = self.config
        if self.cap >= cfg.max_cap or need > cfg.max_cap:
            raise OverflowError(
                f"candidate run of {need} exceeded max_cap="
                f"{cfg.max_cap}; raise EngineConfig.max_cap or "
                f"narrow the windows")
        self.cap = min(max(self.cap * 2, 1 << (need - 1).bit_length()),
                       cfg.max_cap)

    def grow_budget(self, use_budget: int, survivors: int) -> None:
        """Budget overflow: the negative-count encoding carries the TRUE
        survivor count, so the budget grows geometrically straight past it
        (re-running compaction) and only falls back to the single-stage
        dense path (budget 0) once the needed budget exceeds
        ``max_budget`` (``MAX_COMPACT_BUDGET`` unless the caller raised it)
        or, unless capless, the cap."""
        target = max(use_budget * 2,
                     1 << max(survivors - 1, 0).bit_length())
        self.budget = (target if target <= self.max_budget
                       and self.two_stage(target) else 0)

    def on_device_overflow(self, counts: np.ndarray, use_budget: int,
                           probe_bounds, batch_len: int) -> None:
        """Single-device retry: the overflow signal conflates run-length >
        cap with survivors > budget; ``probe_bounds`` (a cheap bounds-only
        probe) tells them apart, so the cap jumps straight to sufficiency —
        keeping the LOGICAL budget (one the old cap disabled because
        ``budget >= cap`` comes back into play once the cap outgrows it)."""
        self.escalations += 1
        start, end = probe_bounds()
        need = int(np.max(np.asarray(end - start))) if batch_len else 0
        if need > self.cap:
            self.grow_cap(need)
            return
        if not use_budget:
            raise AssertionError(
                "single-stage overflow with run <= cap")  # unreachable
        self.grow_budget(use_budget, int(-(counts.min()) - 1))

    def on_staged_overflow(self, counts: np.ndarray, use_budget: int,
                           probe_bounds, batch_len: int) -> None:
        """Retry after a staged ``batch_query`` attempt: a capless two-stage
        attempt overflowed its budget; anything else takes the bounds
        probe."""
        if use_budget and self.capless:
            self.on_capless_overflow(counts, use_budget)
        else:
            self.on_device_overflow(counts, use_budget, probe_bounds,
                                    batch_len)

    def on_capless_overflow(self, counts: np.ndarray,
                            use_budget: int) -> None:
        """Retry after a capless attempt — the fused kernel or the compact
        kernel, which walk each query's whole run: a negative count is
        ALWAYS budget overflow carrying the total survivor count, so the
        budget jumps straight past it with no disambiguating bounds probe
        (and no cap to outgrow). A zeroed budget hands the retry to the
        staged dense path."""
        self.escalations += 1
        if not use_budget:
            raise AssertionError(
                "fused overflow without an active budget")  # unreachable
        self.grow_budget(use_budget, int(-(counts.min()) - 1))

    def on_sharded_overflow(self, counts: np.ndarray, use_budget: int,
                            compaction: str) -> None:
        """Sharded retry: the step encodes the exact LOCAL need — no global
        bounds probe, whose run is a useless overestimate of any one
        shard's. The compact kernel walks the whole local run (capless), so
        with a budget active its overflow is ALWAYS the budget. (The
        sharded stages keep the reference's cap-bound ``use_budget``: their
        ladder is built without ``compaction``.)"""
        self.escalations += 1
        need = int(-(counts.min()) - 1)
        if use_budget and compaction == "kernel":
            self.grow_budget(use_budget, need)
        elif need > self.cap:
            self.grow_cap(need)
        elif not use_budget:
            raise AssertionError(
                "single-stage overflow with run <= cap")  # unreachable
        else:
            self.grow_budget(use_budget, need)


# ------------------------------------------------------------------- stages
class Stage:
    """One pipeline stage: fill ``ctx`` (and its own ``StageStats``). A
    fused implementation covers several adjacent canonical stages —
    ``covers`` names them for ``explain()`` and the telemetry.
    ``dispatches`` is the static per-attempt device-dispatch count of the
    implementation (what ``explain()`` prints before execution; the
    executed count lands in ``StageStats.dispatches``)."""

    name: str = "?"
    covers: Tuple[str, ...] = ()
    impl: str = "?"
    dispatches: int = 0

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        raise NotImplementedError


class HostRefineStage(Stage):
    """fp64 probe+compact+refine: one ``GLIN.query`` walk per window over
    the mutable host tree, under the facade lock. Queries the BASE relation
    only — complement finishing is the shared downstream stage (the live-id
    set it needs is frozen here, in the same critical section)."""

    name = "refine"
    covers = ("probe", "compact", "refine")
    impl = "host"

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        idx, batch = ctx.index, ctx.batch
        stats = ([QueryStats() for _ in range(len(batch))]
                 if batch.collect_stats else None)
        ids: List[np.ndarray] = []
        with idx._lock:
            for i, w in enumerate(batch.windows):
                s = stats[i] if stats is not None else None
                ids.append(np.sort(idx.glin.query(w, ctx.base.name, s)))
            ctx.live = idx._freeze_live(ctx.rel)
            ctx.epoch = idx._epoch
        ctx.ids = ids
        ctx.host_stats = stats
        st.survivors = _total(ids)


class _DeviceStage(Stage):
    """Shared prologue/epilogue of the two device refine implementations."""

    def _freeze(self, ctx: ExecContext):
        """Under the facade lock: the served snapshot and payload (immutable
        device tensors) at the requested replica's placement, copies of the
        delta, the live-id set and the epoch — a writer landing after this
        block changes none of them. ``device+delta`` serves the published
        snapshot and patches the delta on top; plain ``device`` republishes
        first — either way the answer is exact at the frozen epoch. Returns
        ``(snap, pods, ladder, windows)``."""
        idx, batch = ctx.index, ctx.batch
        cfg = idx.config
        patch = ctx.plan.backend == "device+delta"
        with idx._lock:
            snap = idx._published_snapshot() if patch else idx.snapshot()
            pods = idx._device_payload(idx._snapshot_recs)
            snap, pods = idx._replica_view(ctx.replica, snap, pods)
            ctx.frozen_delta = (idx._freeze_delta(ctx.replica) if patch
                                else None)
            ctx.live = idx._freeze_live(ctx.rel)
            ctx.epoch = idx._epoch
            ladder = OverflowLadder(cfg, idx._cap,
                                    compaction=idx._compaction(ctx.base.name))
        ctx.snap = snap
        q = len(batch.windows)
        wq = batch.windows.astype(np.float32)
        if cfg.pad_quantum > 0 and q:
            # bucket the query axis to a power of two, as the reference does
            # (its compiled query is per batch shape); padding rows repeat
            # the last window and are sliced off in _finish
            qb = 1 << (q - 1).bit_length()
            if qb > q:
                wq = np.concatenate([wq, np.repeat(wq[-1:], qb - q, 0)])
        return snap, pods, ladder, torch.as_tensor(wq).to(snap.device)

    @staticmethod
    def _settle(idx, ladder) -> None:
        with idx._lock:
            # max-merge: a concurrent query may have grown it further
            idx._cap = max(idx._cap, ladder.cap)

    @staticmethod
    def _finish(ctx: ExecContext, st: StageStats, hits, ladder) -> None:
        hits = hits.cpu().numpy()[: len(ctx.batch.windows)]
        ctx.ids = [np.sort(row[row >= 0]).astype(np.int64) for row in hits]
        st.survivors = _total(ctx.ids)
        st.escalations = ladder.escalations
        st.cap, st.budget = ladder.cap, ladder.use_budget


def _staged_attempt(idx, eng, snap, wt, pods, base, ladder, st):
    """One staged ``batch_query`` attempt under the ladder. Returns the hits
    when every count is non-negative, else walks the ladder and returns
    None."""
    ub = ladder.use_budget
    hits, counts = eng.batch_query(
        snap, wt, pods, relation=base, cap=ladder.cap, exact_budget=ub,
        compaction=ladder.compaction)
    st.dispatches += 3 if ub else 2   # probe/compact/exact vs dense
    counts = counts.cpu().numpy()
    if (counts >= 0).all():
        return hits

    def probe_bounds():
        st.dispatches += 1            # disambiguating bounds probe
        return tuple(t.cpu().numpy() for t in
                     eng.batch_query_bounds(snap, wt, relation=base))

    ladder.on_staged_overflow(counts, ub, probe_bounds, wt.shape[0])
    return None


class DeviceRefineStage(_DeviceStage):
    """The staged probe+compact+refine dispatches (fp32). Freezes the
    served snapshot/payload and the live-id set under the facade lock, then
    runs the overflow-ladder retry loop OUTSIDE it — writers are never
    blocked by device compute, and the answer is exact at the frozen
    epoch."""

    name = "refine"
    covers = ("probe", "compact", "refine")
    impl = "device"
    dispatches = 3

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        eng, idx = _engine(), ctx.index
        snap, pods, ladder, wt = self._freeze(ctx)
        while True:
            hits = _staged_attempt(idx, eng, snap, wt, pods, ctx.base.name,
                                   ladder, st)
            if hits is not None:
                break
        self._settle(idx, ladder)
        self._finish(ctx, st, hits, ladder)


class FusedDeviceStage(_DeviceStage):
    """ONE-dispatch probe+compact+refine: the whole staged pipeline of
    :class:`DeviceRefineStage` executed by a single fused kernel launch
    (``core.device.batch_query_fused``). Same freeze/retry/epilogue
    contract; what changes is the vehicle — and ``dispatches`` telemetry
    asserting the 3 -> 1 collapse.

    The fused path is two-stage only, so the stage re-resolves
    ``SpatialIndex._fusion_mode`` every ladder step: a zeroed budget (dense
    escalation) or a budget past ``MAX_COMPACT_BUDGET`` falls back to the
    staged ``batch_query`` for that attempt — correctness never depends on
    fusion being available."""

    name = "refine"
    covers = ("probe", "compact", "refine")
    impl = "fused"
    dispatches = 1

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        eng, idx = _engine(), ctx.index
        snap, pods, ladder, wt = self._freeze(ctx)
        base = ctx.base.name
        while True:
            ub = ladder.use_budget
            # the budget this attempt uses, 0 included: a dense escalation
            # must leave the fused envelope (the reference passes
            # ``ub or None`` here, which reads 0 as the configured budget
            # and then refuses exact_budget=0)
            mode = idx._fusion_mode(base, ub)
            if mode is None:
                # budget ladder left the fused envelope (dense escalation /
                # budget past MAX_COMPACT_BUDGET): staged fallback
                st.note = "fused envelope exceeded: staged fallback"
                hits = _staged_attempt(idx, eng, snap, wt, pods, base,
                                       ladder, st)
                if hits is not None:
                    break
                continue
            hits, counts = eng.batch_query_fused(
                snap, wt, pods, relation=base, exact_budget=ub, mode=mode)
            st.dispatches += 1
            counts = counts.cpu().numpy()
            if (counts >= 0).all():
                break
            ladder.on_capless_overflow(counts, ub)
        self._settle(idx, ladder)
        self._finish(ctx, st, hits, ladder)


class ShardedRefineStage(Stage):
    """Per-record-shard probe+compact+refine over the mesh
    (``core.distributed.build_glin_query_step``), query windows split over
    the model axis. Runs entirely under the facade lock (one controller
    drives every mesh position) and freezes the delta + live-id sets in
    that same critical section for the downstream shared stages. A stale
    snapshot is served with its delta patched on top, unless the plan
    republishes first."""

    name = "refine"
    covers = ("probe", "compact", "refine")
    impl = "sharded"
    dispatches = 3

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        idx, batch = ctx.index, ctx.batch
        cfg = idx.config
        with idx._lock:
            if ctx.plan.rebuild_snapshot:
                idx.snapshot()
            else:
                idx._published_snapshot()
            patch = idx.snapshot_is_stale()
            q = len(batch)
            # pad the batch to a model-axis multiple (the step splits Q
            # evenly); padded rows repeat the last window, sliced off after
            m = cfg.mesh.shape["model"]
            wins32 = batch.windows.astype(np.float32)
            qpad = (-q) % m
            if qpad:
                wins32 = np.concatenate(
                    [wins32, np.repeat(wins32[-1:], qpad, axis=0)])
            snap_repl, table, _, maxw = idx._sharded_placement()
            ladder = OverflowLadder(cfg, idx._cap)
            base = ctx.base.name
            comp = idx._compaction(base)
            while True:
                ub = ladder.use_budget
                step = idx._sharded_step(base, ladder.cap, ub, comp, maxw)
                hits, counts = step(snap_repl, wins32, table)
                st.dispatches += 3 if ub else 2
                counts = counts.cpu().numpy()
                if (counts >= 0).all():
                    idx._cap = max(idx._cap, ladder.cap)
                    break
                ladder.on_sharded_overflow(counts, ub, comp)
            hits = hits.cpu().numpy()[:q]            # (Q, shards, K)
            ctx.ids = [np.sort(row[row >= 0]).astype(np.int64)
                       for row in hits.reshape(q, -1)]
            ctx.frozen_delta = idx._freeze_delta() if patch else None
            ctx.live = idx._freeze_live(ctx.rel)
            ctx.epoch = idx._epoch
            ctx.snap = idx._snapshot
        st.survivors = _total(ctx.ids)
        st.escalations = ladder.escalations
        st.cap, st.budget = ladder.cap, ladder.use_budget


class DeltaPatchStage(Stage):
    """Restore exactness of snapshot results at the frozen epoch: mask out
    tombstoned records and check the added set (fp32, the device precision
    contract) against the *base* relation — complement finishing happens
    after, on top of the patched ids.

    Operates only on the ``ExecContext`` freeze (the refine stage captured
    the delta under the lock), so it runs lock-free — THE one patch
    implementation. Small added sets are checked in a host loop; from
    ``EngineConfig.delta_device_min`` on, the check runs on the device
    through the Zmin-sorted :class:`~repro_torch.core.device.DeltaTable`
    (one (Q x A) pass, ``batch_check_added``)."""

    name = "delta-patch"
    covers = ("delta-patch",)
    impl = "shared"

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        frozen = ctx.frozen_delta
        if frozen is None:
            st.skipped = True
            st.note = "no delta against the served snapshot"
            return
        tombs, added, table, av, an, ak = frozen
        st.delta_added = int(added.shape[0])
        st.delta_tombstoned = 0 if tombs is None else int(tombs.shape[0])
        batch, snap = ctx.batch, ctx.snap
        base = ctx.base.name
        added_hits: Optional[List[np.ndarray]] = None
        if table is not None:
            wt = torch.as_tensor(batch.windows.astype(np.float32)).to(
                table.ids.device)
            st.dispatches += 1           # device DeltaTable added-set check
            ok = batch_check_added(table, wt, base, snap.grid_x0,
                                   snap.grid_y0, snap.grid_cell).cpu().numpy()
            tbl_ids = table.ids.cpu().numpy().astype(np.int64)
            added_hits = [np.sort(tbl_ids[row]) for row in ok]
        elif added.shape[0]:
            pred = get_relation(base).predicate
            added_hits = []
            for qi in range(len(ctx.ids)):
                w32 = batch.windows[qi].astype(np.float32)
                added_hits.append(added[np.asarray(pred(w32, av, an, ak))])
        out: List[np.ndarray] = []
        for qi, h in enumerate(ctx.ids):
            if tombs is not None:
                h = h[~np.isin(h, tombs)]
            if added_hits is not None:
                # added ids all postdate (exceed) every snapshot id, so the
                # concatenation stays ascending
                h = np.concatenate([h, added_hits[qi]])
            out.append(h)
        ctx.ids = out
        st.survivors = _total(out)


class ComplementFinishStage(Stage):
    """Complement relations (e.g. ``disjoint``): subtract the base hits from
    the live-id set the refine stage froze under the lock — THE one
    complement implementation, identical lock story on every backend."""

    name = "complement-finish"
    covers = ("complement-finish",)
    impl = "shared"

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        rel = ctx.rel
        if not rel.is_complement:
            st.skipped = True
            st.note = "relation is not a complement"
            return
        live = ctx.live
        if live is None:   # refine stages freeze it whenever rel needs it
            with ctx.index._lock:
                live = ctx.index._freeze_live(rel)
        ctx.ids = [np.setdiff1d(live, r) for r in ctx.ids]
        if ctx.host_stats is not None:
            # candidates/checked/leaves_* honestly describe the base
            # probe's work, but the hit count must be the complement's
            for s, r in zip(ctx.host_stats, ctx.ids):
                s.results = int(r.shape[0])
        st.survivors = _total(ctx.ids)


class KnnHostStage(Stage):
    """knn on the mutable host tree, one point at a time under the lock."""

    name = "knn-rank"
    covers = ("probe", "refine", "knn-rank")
    impl = "host"

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        idx, batch = ctx.index, ctx.batch
        ids, dists = [], []
        with idx._lock:      # the host knn walks the mutable tree
            for p in batch.points:
                i, d = _host_knn(idx.glin, p, batch.k)
                ids.append(np.asarray(i, np.int64))
                dists.append(np.asarray(d))
            ctx.epoch = idx._epoch
        ctx.ids, ctx.distances = ids, dists
        st.survivors = _total(ids)


def _pow2_radii(r: np.ndarray) -> np.ndarray:
    """Per-point power-of-two radius snap: each (bucket, radius) pair builds
    one sharded step, not one per distinct estimate."""
    return np.power(2.0, np.ceil(np.log2(np.maximum(r, 1e-9))))


def _seed_radii(snap, wins, k, seed_mode, r_global, st,
                pow2: bool = True) -> np.ndarray:
    """Initial radii for the degenerate windows ``wins``. CDF seeds route
    through the published model (``device.knn_seed_radii``); a seed that
    comes back non-finite or non-positive (a point routed to an empty leaf,
    whose aggregate-MBR sentinel has no area) falls back to the global
    density radius — the seed is a performance prior, never allowed to
    poison the probe. ``pow2`` snaps UP to powers of two — what the sharded
    ``dwithin:<r>`` classes need (the radius is part of the relation); the
    device stage passes ``pow2=False``: its radii ride in the window
    coordinates, and an up-snap only widens the probe."""
    if seed_mode != "cdf":
        seeds = np.full(wins.shape[0], r_global)
    else:
        wq = torch.as_tensor(wins.astype(np.float32)).to(snap.device)
        seeds = knn_seed_radii(snap, wq, k).cpu().numpy().astype(np.float64)
        st.dispatches += 1
        bad = ~np.isfinite(seeds) | (seeds <= 0.0)
        seeds[bad] = r_global
    return _pow2_radii(seeds) if pow2 else seeds


def _knn_backstop(idx, cfg) -> tuple:
    """Resolve the knn config knobs: (seed mode, top-k impl).
    ``knn_seed=None`` -> the CDF density seed; ``knn_topk=None`` -> the
    ``knn_topk`` kernel on a CUDA index, the plain two-key sort on the
    CPU."""
    seed = cfg.knn_seed or "cdf"
    if seed not in ("cdf", "global"):
        raise ValueError(f"unknown knn_seed {cfg.knn_seed!r} "
                         "(use 'cdf' or 'global')")
    impl = cfg.knn_topk or ("kernel" if idx.device.type == "cuda"
                            else "sort")
    if impl not in ("sort", "kernel"):
        raise ValueError(f"unknown knn_topk {cfg.knn_topk!r} "
                         "(use 'sort' or 'kernel')")
    return seed, impl


class KnnDeviceStage(Stage):
    """Device-complete knn (cf. LISA): each point probes at its OWN seeded
    radius and the survivors are ranked ON DEVICE by exact squared distance
    (:func:`~repro_torch.core.device.batch_knn_rank`) — only the final
    ``(Q, k)`` ids + distances and the within-radius counts that drive the
    ladder cross back to the host. Candidate sets never do.

    Each rung probes EVERY still-undone point in ONE ``intersects`` batch:
    the probe window is the point's L-inf inflation by its own radius, a
    square superset of the dwithin disc whose corner candidates the exact
    distance test in the rank discards. A point is DONE once its
    within-radius count reaches k (the within set is exactly {distance <=
    r}: no closer geometry can be missing) or covers every live record.

    Radius selection: ``knn_seed_radii`` seeds each point near its expected
    k-th-neighbour distance. Between rungs an undone point grows by the 2D
    density scaling ``d_within * sqrt(k / within)`` of the exact distances
    it already holds, clamped to [2r, 4r]. The first dispatch of a rung
    pins the configured ``exact_budget``; rows that overflow it (fat rows)
    re-dispatch on their own through the overflow ladder with
    ``max_budget=max_cap`` — compaction at a large budget stays cheaper
    than ranking a dense (Q, cap) matrix. A straggler whose run outgrows
    ``max_cap`` finishes on the host loop, and ``note`` says so.
    ``rung_hist`` / ``seed_hits`` / ``seed_radius`` report how well the
    seeding worked; ``escalations`` counts overflow-ladder retries (not
    rungs). On ``device+delta`` the frozen tombstones are masked out of the
    ranking and the unpublished added set is distance-merged before the
    top-k: inserted-but-unpublished records rank with no republish."""

    name = "knn-rank"
    covers = ("probe", "compact", "refine", "knn-rank")
    impl = "device"
    dispatches = 4

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        eng = _engine()
        idx, batch = ctx.index, ctx.batch
        cfg = idx.config
        pts = np.asarray(batch.points, np.float64)
        q, k = len(batch), int(batch.k)
        wins = np.concatenate([pts, pts], axis=1)    # degenerate windows
        patch = ctx.plan.backend == "device+delta"
        with idx._lock:
            # same freeze contract as the window stages: snapshot + payload
            # + delta copies captured under the lock, device compute outside
            # it — every rung serves the SAME frozen epoch
            snap = idx._published_snapshot() if patch else idx.snapshot()
            pods = idx._device_payload(idx._snapshot_recs)
            snap, pods = idx._replica_view(ctx.replica, snap, pods)
            ctx.frozen_delta = (idx._freeze_delta(ctx.replica) if patch
                                else None)
            ctx.epoch = idx._epoch
            ladder = OverflowLadder(cfg, idx._cap, max_budget=cfg.max_cap,
                                    compaction=idx._compaction("intersects"))
            n_live = idx.glin.num_records
            r_global = initial_knn_radius(idx.glin, k)
            seed_mode, impl = _knn_backstop(idx, cfg)
            # the rank needs the added set as a device DeltaTable whatever
            # the host/device patching threshold (cached per epoch)
            dtab = (idx._delta_table(ctx.replica) if patch and idx._added
                    else None)
        ctx.snap = snap
        dev = snap.device
        tomb = None
        if ctx.frozen_delta is not None:
            tombs, added = ctx.frozen_delta[0], ctx.frozen_delta[1]
            st.delta_added = int(added.shape[0])
            st.delta_tombstoned = 0 if tombs is None else int(tombs.shape[0])
            if tombs is not None:
                tomb = torch.as_tensor(tombs.astype(np.int32)).to(dev)
        out_ids: List[np.ndarray] = [np.empty(0, np.int64)] * q
        out_d: List[np.ndarray] = [np.empty(0, np.float64)] * q
        ctx.ids, ctx.distances = out_ids, out_d
        if k <= 0 or n_live == 0 or q == 0:
            st.survivors = 0
            return
        radius = _seed_radii(snap, wins, k, seed_mode, r_global, st,
                             pow2=False)
        st.seed_radius = float(np.median(radius))
        st.note = f"seed={seed_mode} topk={impl}"
        # tier-1 budget: the CONFIGURED exact budget, pinned — the rank
        # stays narrow for the common case and only fat rows escalate
        # through `ladder` below
        b0 = int(cfg.exact_budget)
        done = np.zeros(q, bool)
        probes = np.zeros(q, np.int32)
        for _ in range(64):
            todo = np.nonzero(~done)[0]
            if todo.size == 0:
                break
            ctr = wins[todo].astype(np.float32)
            rr = radius[todo].astype(np.float32)
            sq = np.stack([ctr[:, 0] - rr, ctr[:, 1] - rr,
                           ctr[:, 2] + rr, ctr[:, 3] + rr], axis=1)
            sq_t = torch.as_tensor(sq).to(dev)
            ctr_t = torch.as_tensor(ctr).to(dev)
            rr_t = torch.as_tensor(rr).to(dev)
            probes[todo] += 1
            # tier 1: ONE fixed-budget dispatch for every undone point; a
            # fat row (a square that swallowed a dense core) signals a
            # negative count and re-dispatches below on its own
            c1 = ladder.cap
            ub = b0 if ladder.two_stage(b0) else 0
            hits, ch = eng.batch_query(
                snap, sq_t, pods, relation="intersects", cap=c1,
                exact_budget=ub, compaction=ladder.compaction)
            st.dispatches += 3 if ub else 2
            ch = ch.cpu().numpy()
            good = ch >= 0
            idk, dk, within = (t.cpu().numpy() for t in batch_knn_rank(
                ctr_t, pods, hits, rr_t, k, impl, tombstones=tomb,
                delta=dtab))
            st.dispatches += 1
            fat = np.nonzero(~good)[0]
            if fat.size:
                # tier 2: only the overflowed rows walk the ladder, with a
                # budget right-sized from THIS rung's survivor counts
                need = int((-ch[fat] - 1).max())
                t = 1 << max(need - 1, b0 - 1, 1).bit_length()
                ladder.budget = (t if t <= ladder.max_budget
                                 and ladder.two_stage(t) else 0)
                fat_t = torch.as_tensor(fat).to(dev)
                try:
                    fhits = _knn_refine(idx, eng, snap, pods, sq_t[fat_t],
                                        ladder, st)
                except OverflowError:
                    # a straggler's run outgrew max_cap: the host loop has
                    # no cap — finish the stragglers there
                    st.note = ("straggler radius outgrew max_cap: "
                               "host fallback")
                    with idx._lock:
                        for i in todo[fat]:
                            hi, hd = _host_knn(idx.glin, pts[int(i)], k)
                            out_ids[int(i)] = np.asarray(hi, np.int64)
                            out_d[int(i)] = np.asarray(hd)
                    done[todo[fat]] = True
                else:
                    fidk, fdk, fwit = batch_knn_rank(
                        ctr_t[fat_t], pods, fhits, rr_t[fat_t], k, impl,
                        tombstones=tomb, delta=dtab)
                    st.dispatches += 1
                    idk[fat] = fidk.cpu().numpy()
                    dk[fat] = fdk.cpu().numpy()
                    within[fat] = fwit.cpu().numpy()
                    good[fat] = True
            settle = good & ((within >= k) | (within >= n_live))
            for j in np.nonzero(settle)[0]:
                i = int(todo[j])
                keep = idk[j] >= 0
                out_ids[i] = idk[j][keep].astype(np.int64)
                out_d[i] = dk[j][keep].astype(np.float64)
            done[todo[settle]] = True
            # rows finished on the host above are done too: they take no
            # radius growth (their `within` may exceed k — the reference
            # indexes `dk` with it here and fails, fault F6)
            und = np.nonzero(~done[todo])[0]
            if und.size:
                # count-informed growth: an undone row holds the exact
                # distances of its `within` (< k) nearest, so the 2D density
                # scaling d_within * sqrt(k / within) estimates the k-th
                # neighbour radius; clamped to [2r, 4r] (an empty row, still
                # crossing empty space toward the data, takes 4r)
                ru = radius[todo[und]]
                cnt = within[und].astype(np.float64)
                dlast = dk[und, np.maximum(within[und] - 1, 0)]
                est = np.where(
                    cnt > 0,
                    dlast.astype(np.float64)
                    * np.sqrt(k / np.maximum(cnt, 1.0)),
                    np.inf)
                radius[todo[und]] = np.maximum(
                    2.0 * ru, np.minimum(est, 4.0 * ru))
        else:
            raise RuntimeError("knn did not converge")
        st.survivors = _total(out_ids)
        st.escalations = ladder.escalations
        st.cap, st.budget = ladder.cap, ladder.use_budget
        maxp = int(probes.max())
        st.rungs = maxp
        st.rung_hist = tuple(int((probes == i).sum())
                             for i in range(1, maxp + 1))
        st.seed_hits = int((probes == 1).sum())


def _knn_refine(idx, eng, snap, pods, wt, ladder, st):
    """One knn rung's fat rows through the staged device refine under the
    shared overflow ladder — ``_staged_attempt``'s retry contract, so the
    compact kernel's overflow is read as capless (no bounds probe that a
    run past ``max_cap`` would fail). The hit matrix stays on the device
    for ``batch_knn_rank``; only the overflow counts cross to the host."""
    while True:
        hits = _staged_attempt(idx, eng, snap, wt, pods, "intersects",
                               ladder, st)
        if hits is not None:
            _DeviceStage._settle(idx, ladder)
            return hits


class KnnShardedStage(Stage):
    """Device-complete knn over the mesh: every record shard ranks its own
    dwithin survivors to a local ``(Q, k)`` block (exact squared distances
    gathered from the shard-local vertex pool at the widest surviving width
    bucket), then the blocks meet on the merge device for a two-key
    k-merge — the host sees only the final ``(Q, k)`` ids + distances plus
    the per-shard within-radius counts driving the ladder.
    ``merge_bytes`` accounts the blocks' payload (k f32 distances and k i32
    ids per shard and point, plus the counts), as the reference counts its
    all-gather.

    Exactness contract: the k-merge ranks SNAPSHOT records only, so a stale
    snapshot is always republished before probing — the fresh snapshot has
    no delta to merge, and results are exact at the published epoch. Radii
    are CDF-seeded and snapped up to powers of two; each rung groups the
    undone points by radius (one ``dwithin:<r>`` step per class, the batch
    bucket rounded up to a model-axis multiple) and doubles the undone
    points' radii. A straggler whose run outgrows ``max_cap`` finishes on
    the host loop, and ``note`` says so."""

    name = "knn-rank"
    covers = ("probe", "compact", "refine", "knn-rank")
    impl = "sharded"
    dispatches = 4

    def run(self, ctx: ExecContext, st: StageStats) -> None:
        idx, batch = ctx.index, ctx.batch
        cfg = idx.config
        pts = np.asarray(batch.points, np.float64)
        q, k = len(batch), int(batch.k)
        wins = np.concatenate([pts, pts], axis=1)
        with idx._lock:     # one controller drives the mesh: under the lock
            if idx.snapshot_is_stale():
                idx.snapshot()         # k-merge exactness: no delta on top
            else:
                idx._published_snapshot()
            snap_repl, table, shards, maxw = idx._sharded_placement()
            snap = idx._snapshot
            ctx.snap = snap
            ctx.epoch = idx._epoch
            n_live = idx.glin.num_records
            r_global = initial_knn_radius(idx.glin, k)
            seed_mode, impl = _knn_backstop(idx, cfg)
            ladder = OverflowLadder(cfg, idx._cap, max_budget=cfg.max_cap)
            m = cfg.mesh.shape["model"]
            out_ids: List[np.ndarray] = [np.empty(0, np.int64)] * q
            out_d: List[np.ndarray] = [np.empty(0, np.float64)] * q
            ctx.ids, ctx.distances = out_ids, out_d
            if k <= 0 or n_live == 0 or q == 0:
                st.survivors = 0
                return
            radius = _seed_radii(snap, wins, k, seed_mode, r_global, st)
            st.seed_radius = float(np.median(radius))
            st.note = f"seed={seed_mode} topk={impl}"
            done = np.zeros(q, bool)
            probes = np.zeros(q, np.int32)
            for _ in range(64):
                todo = np.nonzero(~done)[0]
                if todo.size == 0:
                    break
                for r in [float(v) for v in np.unique(radius[todo])]:
                    sel = todo[radius[todo] == r]
                    sub = wins[sel].astype(np.float32)
                    # pow2 bucket rounded up to a model-axis multiple (the
                    # step splits Q evenly)
                    b = 1 << max(len(sel) - 1, 0).bit_length()
                    b += (-b) % m
                    if b > len(sel):
                        sub = np.concatenate(
                            [sub, np.repeat(sub[-1:], b - len(sel), 0)])
                    relname = f"dwithin:{r:.17g}"
                    probes[sel] += 1
                    try:
                        idk, dk, within = self._rank(
                            idx, snap_repl, table, sub, relname, k, maxw,
                            impl, ladder, st, b, shards)
                    except OverflowError:
                        st.note = ("straggler radius outgrew max_cap: "
                                   "host fallback")
                        for i in sel:
                            hi, hd = _host_knn(idx.glin, pts[int(i)], k)
                            out_ids[int(i)] = np.asarray(hi, np.int64)
                            out_d[int(i)] = np.asarray(hd)
                        done[sel] = True
                        continue
                    idk, dk = idk[: len(sel)], dk[: len(sel)]
                    within = within[: len(sel)]
                    settle = (within >= k) | (within >= n_live)
                    for j in np.nonzero(settle)[0]:
                        i = int(sel[j])
                        keep = idk[j] >= 0
                        out_ids[i] = idk[j][keep].astype(np.int64)
                        out_d[i] = dk[j][keep].astype(np.float64)
                    done[sel[settle]] = True
                radius[~done] *= 2.0
            else:
                raise RuntimeError("knn did not converge")
        st.survivors = _total(out_ids)
        st.escalations = ladder.escalations
        st.cap, st.budget = ladder.cap, ladder.use_budget
        maxp = int(probes.max())
        st.rungs = maxp
        st.rung_hist = tuple(int((probes == i).sum())
                             for i in range(1, maxp + 1))
        st.seed_hits = int((probes == 1).sum())

    @staticmethod
    def _rank(idx, snap_repl, table, wins, relname, k, maxw, impl, ladder,
              st, qpad, shards):
        """One sharded probe+rank+k-merge under the ladder -> numpy ``(ids,
        dists, within)``. Caller holds the facade lock."""
        while True:
            ub = ladder.use_budget
            comp = idx._compaction(relname)
            step = idx._sharded_knn_step(relname, k, ladder.cap, ub, comp,
                                         maxw, impl)
            idk, dk, counts = step(snap_repl, wins, table)
            st.dispatches += 4 if ub else 3
            # the (shards, Q, k) blocks — k f32 distances + k i32 ids per
            # shard — plus the (Q, shards) i32 counts
            st.merge_bytes += qpad * shards * (k * 8 + 4)
            counts = counts.cpu().numpy()
            if (counts >= 0).all():
                idx._cap = max(idx._cap, ladder.cap)
                return (idk.cpu().numpy(), dk.cpu().numpy(),
                        counts.sum(axis=1))
            ladder.on_sharded_overflow(counts, ub, comp)


# ------------------------------------------------------------- execution plan
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compiled stage composition for one planned backend."""

    backend: str
    stages: Tuple[Stage, ...]

    def execute(self, ctx: ExecContext) -> ExecContext:
        for stage in self.stages:
            st = StageStats(stage=stage.name, impl=stage.impl,
                            covers=stage.covers, queries=len(ctx.batch))
            t0 = time.perf_counter()
            stage.run(ctx, st)
            st.wall_ms = 1e3 * (time.perf_counter() - t0)
            ctx.stage_stats.append(st)
        return ctx

    def describe(self) -> List[str]:
        return [f"{i}. {s.name:<18} impl={s.impl:<8} "
                f"covers={'+'.join(s.covers)}"
                + (f" dispatches={s.dispatches}" if s.dispatches else "")
                for i, s in enumerate(self.stages)]


def compile_plan(plan) -> ExecutionPlan:
    """``QueryPlan`` -> ordered stage tuple. Every backend ends in the SAME
    shared delta-patch / complement-finish implementations; conditional
    stages (an empty delta, a non-complement relation) stay compiled in and
    no-op with ``skipped=True``, so the pipeline shape is static per
    backend."""
    if plan.kind == "knn":
        if plan.backend == "sharded":
            return ExecutionPlan("sharded", (KnnShardedStage(),))
        if plan.backend in ("device", "device+delta"):
            return ExecutionPlan(plan.backend, (KnnDeviceStage(),))
        if plan.backend == "host":
            return ExecutionPlan("host", (KnnHostStage(),))
        raise ValueError(f"unknown knn backend {plan.backend!r}")
    if plan.backend == "host":
        return ExecutionPlan("host", (HostRefineStage(),
                                      ComplementFinishStage()))
    if plan.backend == "sharded":
        return ExecutionPlan("sharded", (ShardedRefineStage(),
                                         DeltaPatchStage(),
                                         ComplementFinishStage()))
    refine = FusedDeviceStage() if plan.fused else DeviceRefineStage()
    if plan.backend == "device":
        return ExecutionPlan("device", (refine, ComplementFinishStage()))
    if plan.backend == "device+delta":
        return ExecutionPlan("device+delta", (refine, DeltaPatchStage(),
                                              ComplementFinishStage()))
    raise ValueError(f"unknown backend {plan.backend!r}")
