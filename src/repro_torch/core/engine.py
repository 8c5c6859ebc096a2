"""`SpatialIndex` — the one public way to build, mutate, snapshot and query.

The paper's mechanism (probe an interval, refine with a predicate) is the same
whether one window runs on the host or ten thousand run on a GPU. This facade
owns the plumbing:

* **relations** are first-class (``core.relations``): ``contains``,
  ``intersects``, ``within``, ``covers``, ``disjoint``, ``touches``,
  ``crosses`` and ``dwithin:<d>``, all through one entry point,
  ``SpatialIndex.query``;
* **snapshots are epoch-invalidated**: every insert/delete bumps a mutation
  epoch; the flattened device snapshot is materialized lazily and
  republished automatically when stale, so a stale snapshot is never served
  unpatched;
* **writes are LSM-style deltas**: every insert/delete is applied to the
  host ``GLIN`` immediately (host queries are always exact) and recorded in
  a small delta against the last *published* snapshot: inserted record ids
  in an added-set, deleted published records in a tombstone-set. Device
  queries are then served from the stale snapshot and *patched* —
  tombstones masked out, added records checked on the device
  (``DeltaTable``) — instead of paying a full republish per write. Once the
  delta reaches ``EngineConfig.refresh_threshold`` the snapshot is
  republished: synchronously, or with ``async_republish`` on a background
  thread while queries keep serving the published snapshot plus the patch
  (double buffering);
* **execution is planned, then staged**: ``plan(batch)`` picks a backend
  (host loop for small or stats-collecting batches; ``device`` for large
  batches against a fresh or republished snapshot; ``device+delta`` for a
  stale snapshot with a patchable delta — window queries and
  device-complete kNN, ``QueryBatch.knn``, alike; ``sharded`` when a mesh
  is configured, ``EngineConfig.mesh``) and
  ``core.exec.compile_plan`` turns the choice into an
  :class:`~repro_torch.core.exec.ExecutionPlan` with per-stage telemetry on
  every result (``QueryResult.stages``, ``stats()["stages"]``,
  :meth:`SpatialIndex.explain`); ``count_candidates`` routes through the
  ``refine_count`` kernel;
* **devices**: an index lives on one torch device, ``"cuda"`` unless the
  caller asks for ``"cpu"``. On a CUDA index the refine runs through the
  CUDA kernels (``kernels.refine``); ``fusion="reference"`` is the plain
  tensor composition of the same stages. A mesh
  (``core.distributed.make_mesh``) is a grid of devices that one
  controller drives: the record table range-partitioned over its data
  axes, the windows split over its model axis;
* **precision**: host execution refines in fp64; device execution refines in
  fp32 (results can differ at exact window boundaries, by design — the probe
  interval is quantized conservatively so hits are never missed).

Typical use::

    from repro_torch.core import SpatialIndex, generate, make_query_windows

    index = SpatialIndex.build(generate("cluster", 100_000))   # on the card
    res = index.query(make_query_windows(index.gs, 1e-3, 256), "intersects")
    ids0 = res[0]                       # hits of window 0, ascending record id
    rec = index.insert(verts, nverts=8, kind=0)   # bumps the epoch
    res = index.query(windows, "contains")        # snapshot auto-rebuilt
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from . import exec as qexec
from .datasets import GeometrySet
# batch_query / batch_query_fused are re-exported for the exec stages (and
# tests), which resolve them through THIS module's namespace so a patched
# binding is honored
from .device import batch_query, batch_query_fused  # noqa: F401
from .device import (DeltaTable, GLINSnapshot, HostCapture, VertexPods,
                     _pow2ceil, batch_query_bounds, delta_table_from_host,
                     place, pods_from_store, snapshot_arrays,
                     snapshot_capture, snapshot_from_capture,
                     snapshot_from_numpy)
from .index import GLIN, GLINConfig, QueryStats
from .relations import get_relation

__all__ = ["EngineConfig", "QueryBatch", "QueryPlan", "QueryResult",
           "SpatialIndex", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``"cuda"`` or ``"cpu"`` as a torch device. Asking for CUDA on a
    machine without it raises: nothing silently carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or "
                         "'cpu')")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Planner / execution knobs for :class:`SpatialIndex`."""

    device_min_batch: int = 16        # smaller window batches run on host
    stale_rebuild_min_batch: int = 64  # stale snapshot: republish only for
                                       # batches this big, else host
    initial_cap: int = 4096           # device candidate capacity per query
    max_cap: int = 1 << 20            # give up (OverflowError) past this
    exact_budget: int = 256           # two-stage refinement budget (0 = off):
                                      # stage 1 masks + compacts, stage 2
                                      # exact-checks at most this many
                                      # candidates per query
    compaction: Optional[str] = None  # stage-1 impl: "kernel" (the
                                      # refine_compact wrapper, any budget)
                                      # or "scan" (tensor reference); None =
                                      # kernel on a CUDA index, scan on the
                                      # CPU
    fusion: Optional[str] = None      # one-launch probe+compact+refine:
                                      # "kernel" (the refine_fused wrapper),
                                      # "reference" (plain tensor composition
                                      # of the same stages) or "off"; None =
                                      # kernel on a CUDA index, off on the
                                      # CPU. Custom-prefilter relations and
                                      # budgets outside (0, MAX_COMPACT_
                                      # BUDGET] fall back to the staged
                                      # pipeline automatically
    delta_device_min: int = 64        # added-set size at which device+delta
                                      # patching moves from the host loop to
                                      # the device-resident DeltaTable
    knn_device_min_batch: int = 16    # knn point batches this big run
                                      # device-complete (seeded probes +
                                      # on-device top-k ranking); smaller
                                      # ones loop on the host
    knn_seed: Optional[str] = None    # initial knn radius selection: "cdf"
                                      # (per-point density seed read off the
                                      # published learned model) or "global"
                                      # (one whole-store density estimate);
                                      # None = cdf. Either way the rung
                                      # ladder is the correctness backstop
    knn_topk: Optional[str] = None    # device top-k impl: "kernel" (the
                                      # knn_topk wrapper) or "sort" (plain
                                      # two-key sort); None = kernel on a
                                      # CUDA index, sort on the CPU. Both
                                      # obey the (distance, id) contract
    pad_quantum: int = 4096           # bucket-pad record/slot table lengths
                                      # so insert-driven growth keeps shapes
                                      # (0 disables padding)
    delta_patch_max: int = 4096       # patch a stale snapshot instead of
                                      # republishing while the delta (added +
                                      # tombstoned records) is at most this
                                      # (0 disables delta patching)
    refresh_threshold: int = 4096     # delta size at which the planner prefers
                                      # a republish over patching (0 means
                                      # republish on every stale query)
    mesh: Optional[object] = None     # core.distributed.Mesh with a "model"
                                      # axis (query split) and a "data"/"pod"
                                      # axis (record shards): activates the
                                      # "sharded" planner backend
    shard_min_records: int = 1 << 16  # below this the single-device path
                                      # beats per-shard dispatch overhead;
                                      # the sharded backend is not chosen
    async_republish: bool = False     # double-buffered snapshots: a stale
                                      # delta past refresh_threshold builds
                                      # the NEXT snapshot on a background
                                      # thread while queries keep serving the
                                      # current snapshot + delta patch; the
                                      # finished build swaps in at a query
                                      # boundary
    replicas: int = 1                 # placements of the published snapshot
                                      # + geometry payload for serving
                                      # fan-out, all refreshed at every
                                      # publish; query(..., replica=r) serves
                                      # placement r: a copy on cuda:(r %
                                      # device_count) where there are several
                                      # cards, the primary placement on one


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """One or many queries of one kind against one relation.

    Build with :meth:`window` / :meth:`knn`; ``backend`` forces a specific
    execution path (benchmarks, tests), otherwise the planner decides.
    """

    kind: str = "window"                    # "window" | "knn"
    windows: Optional[np.ndarray] = None    # (Q, 4) fp64
    relation: str = "intersects"
    points: Optional[np.ndarray] = None     # (Q, 2) fp64, knn only
    k: int = 1
    backend: Optional[str] = None     # force "host" / "device" /
                                      # "device+delta" / "sharded"
    collect_stats: bool = False       # per-window QueryStats (host path)

    @classmethod
    def window(cls, windows, relation: str = "intersects",
               backend: Optional[str] = None,
               collect_stats: bool = False) -> "QueryBatch":
        w = np.atleast_2d(np.asarray(windows, np.float64))
        if w.ndim != 2 or w.shape[1] != 4:
            raise ValueError(f"windows must be (Q, 4); got {w.shape}")
        get_relation(relation)  # fail fast on unknown relations
        return cls(kind="window", windows=w, relation=relation,
                   backend=backend, collect_stats=collect_stats)

    @classmethod
    def knn(cls, points, k: int,
            backend: Optional[str] = None) -> "QueryBatch":
        p = np.atleast_2d(np.asarray(points, np.float64))
        if p.ndim != 2 or p.shape[1] != 2:
            raise ValueError(f"points must be (Q, 2); got {p.shape}")
        return cls(kind="knn", points=p, k=int(k), backend=backend)

    def __len__(self) -> int:
        arr = self.windows if self.kind == "window" else self.points
        return 0 if arr is None else int(arr.shape[0])


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """How a batch will execute (returned by ``plan``, recorded on results)."""

    backend: str                  # "host" | "device" | "device+delta" |
                                  # "sharded"
    kind: str                     # "window" | "knn"
    relation: Optional[str]       # None for knn
    base_relation: Optional[str]  # probed relation (complements differ)
    rebuild_snapshot: bool        # device path will republish the snapshot
    reason: str
    delta_size: int = 0           # added + tombstoned records vs the snapshot
    fused: bool = False           # device refine compiles to the one-launch
                                  # FusedDeviceStage (EngineConfig.fusion)


@dataclasses.dataclass
class QueryResult:
    """Per-query hit ids (ascending record id) plus execution metadata."""

    ids: List[np.ndarray]
    plan: QueryPlan
    epoch: int                                  # index epoch that was served
    stats: Optional[List[QueryStats]] = None    # host path, when requested
    distances: Optional[List[np.ndarray]] = None  # knn only
    stages: Optional[List["qexec.StageStats"]] = None  # per-stage telemetry

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.ids[i]

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.ids)

    @property
    def total_hits(self) -> int:
        return int(sum(r.shape[0] for r in self.ids))


@dataclasses.dataclass
class _InflightPublish:
    """A double-buffered snapshot build running on a background thread.

    ``capture`` is the synchronous host flattening at ``epoch``; the thread
    turns it into the padded snapshot on the index's device (+ the sharded
    table's numpy arrays when a mesh is active) and sets ``done``.
    ``tombs_after`` collects records deleted while the build runs that the
    PENDING snapshot contains (``rec < recs``) — they become the tombstone
    set of the swapped-in snapshot."""

    capture: HostCapture
    epoch: int
    recs: int
    done: threading.Event
    tombs_after: Set[int]
    thread: Optional[threading.Thread] = None
    snapshot: Optional[GLINSnapshot] = None
    table_np: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None


class SpatialIndex:
    """Facade over the host ``GLIN`` + lazily-materialized device snapshot.

    All mutations MUST go through :meth:`insert` / :meth:`delete` so the
    mutation epoch tracks the host structure; the device snapshot and device
    geometry payload are invalidated by epoch and rebuilt on demand.

    Thread-safe for concurrent callers (the serving tier drives it from many
    worker threads): writes and the query prologue (planning, snapshot
    install/swap, delta freezing) serialize on one internal lock, while the
    device compute of the ``device``/``device+delta`` backends runs OUTSIDE
    it against frozen immutable tensors. The host and sharded paths hold
    the lock for their whole run (they walk the mutable host tree, or drive
    every mesh position from this one controller). ``async_republish``
    runs the snapshot REBUILD on a background thread; every state
    transition (start, swap) happens under the lock at query boundaries.

    CUDA streams: every tensor of the index, the background build's
    included, is allocated and written on the device's current (default)
    stream, which is shared by all threads. A query reading the new
    snapshot is therefore ordered after the build's copies, and a block of
    the old snapshot handed back to the caching allocator is reused only
    after the kernels queued on it before.
    """

    def __init__(self, glin: GLIN, config: Optional[EngineConfig] = None,
                 device="cuda"):
        self.glin = glin
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._epoch = 0
        self._snapshot: Optional[GLINSnapshot] = None
        self._snapshot_epoch = -1
        self._snapshot_recs = 0         # store length at publish time
        self._publishes = 0             # snapshot (re)publish count
        # where the latest synchronous publish's time went (stats())
        self._sync_publish: Optional[Dict[str, float]] = None
        # writes since the last publish (what a republish folds in)
        self._added: Set[int] = set()   # record ids inserted since publish
        self._tombstones: Set[int] = set()  # published records deleted since
        self._dtable: Optional[DeltaTable] = None  # device added-set index
        self._dtable_epoch = -1
        self._payload: Optional[VertexPods] = None
        self._payload_key = None        # (real records, store layout gen.)
        # adaptive candidate capacity: remembered across queries so the
        # overflow ladder (cap doubling) is walked once, not per call
        self._cap = self.config.initial_cap
        # sticky floors for the snapshot's fixed trip counts: serving the
        # larger value after a refit is still correct (extra bounded-search
        # / traversal trips no-op) and keeps republished shapes stable
        self._steps_floor = 0
        self._depth_floor = 0
        # sticky floors for the geometry payload's shapes: the pod pool may
        # SHRINK at a compacting republish and the width ladder after wide
        # records die — serving the larger padded shape is still correct
        self._pool_floor = 0
        self._width_floor = 1
        self._shard_pool_floor = 0
        # host capture backing the published snapshot (the sharded
        # placement's source; kept only while a mesh is configured)
        self._capture: Optional[HostCapture] = None
        # sharded backend caches: built steps per (relation, cap, budget,
        # compaction, width); the mesh placement (replicated model snapshot
        # + sharded record table) per publish; a table staged by the async
        # build
        self._shard_steps: Dict[Tuple, object] = {}
        self._shard_placement: Optional[Tuple] = None   # (publishes, ...)
        self._staged_table: Optional[Dict[str, np.ndarray]] = None
        # double-buffered republish in flight (async_republish)
        self._inflight: Optional[_InflightPublish] = None
        # replica placements (config.replicas > 1 on several cards): per
        # replica r a copy of the published snapshot + payload, keyed on
        # the (publish, payload) generation it was copied from
        self._replica_places: Dict[int, Tuple] = {}
        # and per replica on another card a copy of the delta table, keyed
        # on the primary table it was copied from (one copy per epoch)
        self._replica_dtables: Dict[int, Tuple] = {}
        # per-(backend, stage) telemetry aggregates (stats()["stages"])
        self._stage_totals: Dict[str, Dict[str, Dict[str, float]]] = {}

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, gs: GeometrySet, glin_cfg: GLINConfig = GLINConfig(),
              config: Optional[EngineConfig] = None,
              device="cuda") -> "SpatialIndex":
        dev = resolve_device(device)    # fail before the host build
        return cls(GLIN.build(gs, glin_cfg), config, dev)

    @property
    def gs(self) -> GeometrySet:
        return self.glin.gs

    def __len__(self) -> int:
        return self.glin.num_records

    def stats(self) -> dict:
        with self._lock:
            st = self.glin.stats()
            st["device"] = str(self.device)
            st["epoch"] = self._epoch
            st["snapshot_epoch"] = self._snapshot_epoch
            st["snapshot_stale"] = self.snapshot_is_stale()
            st["delta_size"] = self.delta_size()
            st["snapshot_publishes"] = self._publishes
            st["republish_inflight"] = self._inflight is not None
            st["sync_publish"] = (dict(self._sync_publish)
                                  if self._sync_publish else None)
            st["replicas"] = max(1, self.config.replicas)
            st["stages"] = {b: {s: dict(v) for s, v in per.items()}
                            for b, per in self._stage_totals.items()}
            return st

    def _record_stages(self, backend: str,
                       stage_stats: List["qexec.StageStats"]) -> None:
        """Fold one execution's per-stage telemetry into the aggregates
        surfaced by ``stats()["stages"]`` (keyed backend -> stage label)."""
        with self._lock:
            per = self._stage_totals.setdefault(backend, {})
            for ss in stage_stats:
                ent = per.setdefault(ss.stage, {
                    "impl": ss.impl, "calls": 0, "skipped": 0,
                    "wall_ms": 0.0, "queries": 0, "survivors": 0,
                    "escalations": 0, "dispatches": 0, "delta_added": 0,
                    "delta_tombstoned": 0, "rungs": 0, "seed_hits": 0,
                    "merge_bytes": 0, "rung_hist": []})
                ent["calls"] += 1
                ent["wall_ms"] += ss.wall_ms
                # the executing impl may differ per call (staged vs fused
                # refine share the "refine" label): report the latest
                ent["impl"] = ss.impl
                if ss.skipped:
                    ent["skipped"] += 1
                    continue
                ent["queries"] += ss.queries
                ent["survivors"] += max(ss.survivors, 0)
                ent["escalations"] += ss.escalations
                ent["dispatches"] += ss.dispatches
                ent["delta_added"] += ss.delta_added
                ent["delta_tombstoned"] += ss.delta_tombstoned
                # knn-rank seeding/merge telemetry (zero for window
                # stages): rung_hist sums element-wise — entry i is the
                # points that settled after i+1 probes, so hist[0]/queries
                # is the seed hit-rate across every call
                ent["rungs"] += ss.rungs
                ent["seed_hits"] += ss.seed_hits
                ent["merge_bytes"] += ss.merge_bytes
                hist = ent["rung_hist"]
                for i, v in enumerate(ss.rung_hist):
                    if i < len(hist):
                        hist[i] += v
                    else:
                        hist.append(v)

    # ------------------------------------------------------------ maintenance
    def insert(self, verts: np.ndarray, nverts: int, kind: int = 0) -> int:
        with self._lock:
            rec = self.glin.insert(verts, nverts, kind)
            self._epoch += 1
            self._added.add(rec)
            return rec

    def delete(self, rec: int) -> bool:
        with self._lock:
            ok = self.glin.delete(rec)
            if ok:
                self._epoch += 1
                if rec in self._added:
                    self._added.remove(rec)
                elif rec < self._snapshot_recs:
                    self._tombstones.add(rec)
                # else: never published nor added since the last publish —
                # it cannot appear in snapshot results, nothing to patch
                if self._inflight is not None and rec < self._inflight.recs:
                    # the PENDING snapshot contains this record (it was live
                    # at capture time): the swap installs it as a tombstone
                    self._inflight.tombs_after.add(rec)
            return ok

    def delta_size(self) -> int:
        """Records added plus published records tombstoned since the last
        snapshot publish (the work a ``device+delta`` query must patch)."""
        return len(self._added) + len(self._tombstones)

    # --------------------------------------------------------------- snapshot
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def device_cap(self) -> int:
        """Current adaptive per-query candidate capacity of the device path."""
        return self._cap

    @property
    def snapshot_epoch(self) -> int:
        return self._snapshot_epoch

    def snapshot_is_stale(self) -> bool:
        return self._snapshot is None or self._snapshot_epoch != self._epoch

    def _padded(self, n: int) -> int:
        return self._bucket(n, self.config.pad_quantum)

    # bucket quanta for the small model tables (pad_quantum > 0): a republish
    # that grew the tree or the piecewise function keeps the SAME shapes as
    # long as each table stays inside its bucket
    _LEAF_QUANTUM = 256
    _NODE_QUANTUM = 64
    _CODE_QUANTUM = 256
    _PW_QUANTUM = 1024
    _INF_HI = 1 << 30   # > any valid 30-bit limb

    @staticmethod
    def _bucket(n: int, q: int) -> int:
        return n if q <= 0 else max(q, -(-n // q) * q)

    def _pad_snapshot(self, snap: GLINSnapshot) -> GLINSnapshot:
        """Bucket-pad every snapshot table (``EngineConfig.pad_quantum``
        disables all of it when 0).

        * slot arrays — padding slots sit past the ``leaf_start`` sentinel,
          so no probe or candidate window ever reaches them;
        * leaf tables — padding leaves carry +inf domain bounds (the ±2
          routing fix-up can never step onto one), empty ``leaf_start`` runs
          and far-away MBRs;
        * node tables / child codes — only reachable through ``child_codes``
          entries of real nodes, so zero padding is inert;
        * piecewise pieces — +inf ``zmax_end`` (sorts after every real
          piece) with +inf suffix-min (an augmentation landing there is a
          no-op by the ``z_less`` take-test).
        """
        if self.config.pad_quantum <= 0:
            return snap
        dev = snap.device
        i32, f32 = torch.int32, torch.float32

        def full(n, v, dtype, cols=None):
            shape = (n,) if cols is None else (n, cols)
            return torch.full(shape, v, dtype=dtype, device=dev)

        reps: dict = {}
        # fixed trip counts: sticky-monotonic with generous floors (16 steps
        # cover a model-error window of 2^16 slots — clipped to the leaf size
        # anyway — at a few extra cheap binary-search gathers per probe);
        # growing them stays correct (extra trips no-op)
        steps = max(self._steps_floor, snap.search_steps, 16)
        depth = max(self._depth_floor, snap.depth, 8)
        if (steps, depth) != (snap.search_steps, snap.depth):
            reps.update(search_steps=steps, depth=depth)
        # slot arrays
        n = snap.keys_hi.shape[0]
        pad = self._padded(n) - n
        if pad:
            big = full(pad, (1 << 30) - 1, i32)
            far = full(pad, 2e30, f32, 4)   # hits nothing
            reps.update(
                keys_hi=torch.cat([snap.keys_hi, big]),
                keys_lo=torch.cat([snap.keys_lo, big]),
                recs=torch.cat([snap.recs, full(pad, 0, i32)]),
                rec_leaf=torch.cat([snap.rec_leaf,
                                    full(pad, snap.num_leaves - 1, i32)]),
                slot_lmbr=torch.cat([snap.slot_lmbr, far]),
                slot_rmbr=torch.cat([snap.slot_rmbr, far]),
            )
        # leaf tables ((L,) and (L+1,) shapes share one bucket). The domain
        # sentinel dlo[L] (the last leaf's nominal dhi) is REPLACED together
        # with the pads by a strictly-infinite bound: inserted keys may
        # legitimately exceed the nominal dhi (the host tree stores them in
        # the last leaf), and without padding it was the fix-up's clamp to
        # ``num_leaves - 1`` that kept such probes on the last REAL leaf —
        # the infinite sentinel reproduces exactly that, so the ±2 routing
        # fix-up can never step onto a (empty-windowed) pad leaf.
        L = snap.num_leaves
        lb = self._bucket(L, self._LEAF_QUANTUM)
        if lb > L:
            reps.update(
                leaf_dlo_hi=torch.cat([snap.leaf_dlo_hi[:L],
                                       full(lb + 1 - L, self._INF_HI, i32)]),
                leaf_dlo_lo=torch.cat([snap.leaf_dlo_lo[:L],
                                       full(lb + 1 - L, 1 << 30, i32)]),
                leaf_start=torch.cat([snap.leaf_start,
                                      snap.leaf_start[-1:].expand(lb - L)]),
                leaf_mbr=torch.cat([snap.leaf_mbr,
                                    full(lb - L, 2e30, f32, 4)]),
                leaf_k0_hi=torch.cat([snap.leaf_k0_hi, full(lb - L, 0, i32)]),
                leaf_k0_lo=torch.cat([snap.leaf_k0_lo, full(lb - L, 0, i32)]),
                leaf_slope=torch.cat([snap.leaf_slope,
                                      full(lb - L, 0.0, f32)]),
                leaf_icpt=torch.cat([snap.leaf_icpt, full(lb - L, 0.0, f32)]),
            )
        # node tables + child codes (reachable only via real child_codes)
        M = snap.node_scale.shape[0]
        mb = self._bucket(M, self._NODE_QUANTUM)
        if mb > M:
            k = mb - M
            reps.update(
                node_dlo_hi=torch.cat([snap.node_dlo_hi, full(k, 0, i32)]),
                node_dlo_lo=torch.cat([snap.node_dlo_lo, full(k, 0, i32)]),
                node_scale=torch.cat([snap.node_scale, full(k, 0.0, f32)]),
                node_fanout=torch.cat([snap.node_fanout, full(k, 1, i32)]),
                node_child_base=torch.cat([snap.node_child_base,
                                           full(k, 0, i32)]),
            )
        C = snap.child_codes.shape[0]
        cb = self._bucket(C, self._CODE_QUANTUM)
        if cb > C:
            reps["child_codes"] = torch.cat([snap.child_codes,
                                             full(cb - C, 0, i32)])
        # piecewise pieces (only when the function exists at all)
        Pn = snap.pw_zmax_hi.shape[0]
        pb = self._bucket(Pn, self._PW_QUANTUM) if Pn else 0
        if pb > Pn:
            k = pb - Pn
            inf, zero = full(k, self._INF_HI, i32), full(k, 0, i32)
            reps.update(
                pw_zmax_hi=torch.cat([snap.pw_zmax_hi, inf]),
                pw_zmax_lo=torch.cat([snap.pw_zmax_lo, zero]),
                pw_sufmin_hi=torch.cat([snap.pw_sufmin_hi, inf]),
                pw_sufmin_lo=torch.cat([snap.pw_sufmin_lo, zero]),
            )
        return dataclasses.replace(snap, **reps) if reps else snap

    def snapshot(self) -> GLINSnapshot:
        """The flattened device snapshot at the CURRENT epoch (rebuilds when
        stale; a stale snapshot is never handed out)."""
        with self._lock:
            if self.snapshot_is_stale():
                # a finished double-buffered build may already BE the current
                # epoch — swap it in instead of rebuilding synchronously
                self._poll_republish()
            if self.snapshot_is_stale():
                # timed by part (stats()["sync_publish"]): the capture of
                # the host tree, the numpy flattening, and the upload with
                # its bucket padding, whose copies have run when it is read
                t0 = time.perf_counter()
                cap = snapshot_capture(self.glin)
                t1 = time.perf_counter()
                fields, meta = snapshot_arrays(cap)
                t2 = time.perf_counter()
                snap = self._pad_snapshot(
                    snapshot_from_numpy(fields, meta, self.device))
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                t3 = time.perf_counter()
                self._install_snapshot(snap, cap, self._epoch, added=set(),
                                       tombstones=set())
                self._sync_publish = {
                    "records": cap.num_records,
                    "capture_ms": (t1 - t0) * 1e3,
                    "build_ms": (t2 - t1) * 1e3,
                    "upload_ms": (t3 - t2) * 1e3}
            return self._snapshot

    def _install_snapshot(self, snap: GLINSnapshot, capture: HostCapture,
                          epoch: int, added: Set[int],
                          tombstones: Set[int]) -> None:
        """Publish ``snap`` as the served snapshot (every dependent field
        moves together, under the lock, on the caller's thread)."""
        self._snapshot = snap
        self._snapshot_epoch = epoch
        self._snapshot_recs = capture.num_records
        # the capture is only read by the sharded placement; without a mesh,
        # keeping it would pin O(N) dead host copies per publish
        self._capture = capture if self.config.mesh is not None else None
        self._publishes += 1
        self._added = added
        self._tombstones = tombstones
        self._dtable = None
        self._dtable_epoch = -1
        # a sharded table staged by a (now superseded) async build belongs
        # to another capture — serving it would drop post-capture writes
        self._staged_table = None
        # replica placements describe the previous snapshot: refreshed
        # lazily (the first query routed to each replica copies the new one)
        self._replica_places.clear()
        self._replica_dtables.clear()
        # the trip-count floors are committed here only (_pad_snapshot reads
        # them on the build thread too)
        self._steps_floor = max(self._steps_floor, snap.search_steps)
        self._depth_floor = max(self._depth_floor, snap.depth)

    # ------------------------------------------------- async double-buffering
    @property
    def serving_generation(self) -> Tuple[int, int]:
        """Identity of what a query at this instant would serve: the mutation
        epoch AND the published-snapshot generation. Result caches key on
        this (not the epoch alone): an async snapshot swap does not bump the
        epoch."""
        with self._lock:
            return (self._epoch, self._publishes)

    def republish_inflight(self) -> bool:
        return self._inflight is not None

    def _maintain_async(self) -> None:
        """Per-query async upkeep: swap in a finished double-buffered build,
        then start a new one when the delta has reached the republish point.
        Runs on the caller's thread, under the lock, at the top of
        :meth:`query`."""
        self._poll_republish()
        cfg = self.config
        if (cfg.async_republish and self._inflight is None
                and self._snapshot is not None and self.snapshot_is_stale()
                and self.delta_size() >= max(cfg.refresh_threshold, 1)):
            self._start_republish()

    def _start_republish(self) -> None:
        """Capture the host tree NOW (synchronous) and build the next padded
        snapshot (+ the sharded table's arrays when a mesh is active) on a
        daemon thread. Queries keep serving the current snapshot + delta
        until :meth:`_poll_republish` swaps."""
        capture = snapshot_capture(self.glin)
        inf = _InflightPublish(capture=capture, epoch=self._epoch,
                               recs=capture.num_records,
                               done=threading.Event(), tombs_after=set())
        dev = self.device
        shards = self._shard_count() if self._sharded_available() else 0

        def build():
            try:
                # serve-first: SCHED_IDLE (runs only on cycles the query
                # threads leave idle; Linux applies it per native thread id),
                # falling back to niceness. On a single-core host SCHED_IDLE
                # starves the build forever under a saturated serving thread,
                # so niceness — a weighted share — is the policy there.
                tid = threading.get_native_id()
                if (os.cpu_count() or 1) > 1:
                    try:
                        os.sched_setscheduler(tid, os.SCHED_IDLE,
                                              os.sched_param(0))
                    except (AttributeError, OSError):
                        os.setpriority(os.PRIO_PROCESS, tid, 10)
                else:
                    os.setpriority(os.PRIO_PROCESS, tid, 10)
            except (AttributeError, OSError):
                pass
            try:
                # the index's card as this thread's current device (a new
                # thread starts on cuda:0)
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    inf.snapshot = self._pad_snapshot(
                        snapshot_from_capture(capture, dev))
                    if dev.type == "cuda":
                        # the copies and pads have run before done is set
                        torch.cuda.current_stream(dev).synchronize()
                if shards:
                    from .distributed import shard_arrays_from_capture
                    # the sticky per-shard pool floor is read-only here
                    # (committed under the lock in _sharded_placement)
                    inf.table_np = shard_arrays_from_capture(
                        capture, shards, pool_pad_to=self._shard_pool_floor)
            except BaseException as e:   # raised on the caller's thread
                inf.error = e
            finally:
                inf.done.set()

        inf.thread = threading.Thread(target=build, daemon=True,
                                      name="glin-republish")
        self._inflight = inf
        inf.thread.start()

    def _poll_republish(self) -> None:
        """Non-blocking: if the background build finished, swap it in. The
        swap is epoch-tagged — a synchronous publish that overtook the build
        (``snapshot()``, ``count_candidates``, a forced ``device`` batch)
        discards it."""
        inf = self._inflight
        if inf is None or not inf.done.is_set():
            return
        self._inflight = None
        inf.thread.join()
        if inf.epoch <= self._snapshot_epoch:
            return   # a newer (or identical) snapshot is already published:
            # the build, even a failed one, is superseded
        if inf.error is not None:
            raise RuntimeError(
                "async snapshot republish failed") from inf.error
        # post-capture delta: record ids are append-only, so everything
        # inserted after the capture has id >= capture recs; deletes of
        # pending-snapshot records were collected in tombs_after
        added = {r for r in self._added if r >= inf.recs}
        self._install_snapshot(inf.snapshot, inf.capture, inf.epoch,
                               added=added, tombstones=set(inf.tombs_after))
        if inf.table_np is not None:
            self._staged_table = inf.table_np

    def _published_snapshot(self) -> GLINSnapshot:
        """The last *published* snapshot, possibly behind the current epoch —
        only the ``device+delta`` path serves it, and only together with the
        tombstone/added patch that restores exactness. Publishes one when
        none exists yet (the delta is then empty)."""
        if self._snapshot is None:
            return self.snapshot()
        return self._snapshot

    def _replica_device(self, rep: int) -> torch.device:
        """Where replica ``rep`` lives: ``cuda:(rep % device_count)`` on a
        host with several cards; the primary device otherwise."""
        if self.device.type == "cuda" and rep:
            n = torch.cuda.device_count()
            if n > 1:
                return torch.device("cuda", rep % n)
        return self.device

    def _replica_view(self, rep: int, snap: GLINSnapshot, pods: VertexPods):
        """The placement of ``(snap, pods)`` that replica ``rep`` serves.

        Replica 0 is the primary placement (the facade's own fields); a
        replica whose device is the primary's serves it too — on one card
        every replica does, as in the reference on one device: the serving
        tier's routing stays meaningful (per-replica inflight and
        telemetry), only the physical placement collapses. Elsewhere a copy
        on the replica's card, made once per (publish, payload) generation
        from the same snapshot the primary serves, so every publish reaches
        every replica. Call under ``self._lock``."""
        r = max(1, int(self.config.replicas))
        rep = rep % r
        dev = self._replica_device(rep)
        if rep == 0 or dev == snap.device:
            return snap, pods
        key = (self._publishes, self._payload_key)
        ent = self._replica_places.get(rep)
        if ent is None or ent[0] != key:
            ent = (key, place(snap, dev), place(pods, dev))
            self._replica_places[rep] = ent
        return ent[1], ent[2]

    def _device_payload(self, needed_recs: Optional[int] = None
                        ) -> VertexPods:
        """fp32 device copy of the geometry store as width-bucketed
        :class:`~repro_torch.core.device.VertexPods`, bucket-padded like the
        snapshot (padding records are never gathered: snapshot ``recs`` only
        holds real record ids). Keyed on (records, store layout generation)
        rather than the epoch, and reused as long as it covers
        ``needed_recs``: the pool is append-only between compactions, so
        only a compacting republish rebuilds it."""
        gs = self.glin.gs
        need = len(gs) if needed_recs is None else needed_recs
        if (self._payload is None
                or self._payload_key[1] != gs.layout_version
                or self._payload_key[0] < need):
            n = len(gs)
            m = self._padded(n)
            # pod shapes under sticky floors: the width ladder covers the
            # widest live record, the pool covers every record's pow2
            # bucket slots (quantum headroom absorbs insert-driven growth)
            maxw = max(self._width_floor, _pow2ceil(gs.max_nverts))
            nv = np.maximum(gs.nverts.astype(np.int64), 1)
            slots = int(np.sum(np.left_shift(
                1, np.ceil(np.log2(nv)).astype(np.int64))))
            pool_pad = max(self._pool_floor,
                           self._bucket(max(slots, 1),
                                        self.config.pad_quantum))
            self._payload = pods_from_store(gs, self.device,
                                            pad_records_to=m,
                                            pool_pad_to=pool_pad,
                                            max_width=maxw)
            self._payload_key = (n, gs.layout_version)
            self._pool_floor = max(self._pool_floor, pool_pad)
            self._width_floor = max(self._width_floor, maxw)
        return self._payload

    def _compaction(self, base_relation: str) -> str:
        """Stage-1 refinement implementation for ``batch_query``: the
        ``refine_compact`` wrapper on a CUDA index, the scan reference on
        the CPU, and the scan reference whenever the relation's MBR
        prefilter has no kernel shape (``prefilter_kind == "custom"``). The
        compact kernel takes any budget the overflow ladder grows to (up to
        ``max_cap`` for knn)."""
        mode = self.config.compaction
        if mode is None:
            mode = "kernel" if self.device.type == "cuda" else "scan"
        if mode not in ("kernel", "scan"):
            raise ValueError(f"unknown compaction {mode!r}")
        if (mode == "kernel"
                and get_relation(base_relation).prefilter_kind == "custom"):
            mode = "scan"
        return mode

    def _fusion_mode(self, base_relation: str,
                     budget: Optional[int] = None) -> Optional[str]:
        """Resolve ``EngineConfig.fusion`` to a ``batch_query_fused`` mode,
        or ``None`` when the fused one-launch path cannot serve the call and
        the staged pipeline must: fusion off, a custom-prefilter relation,
        or a budget outside the two-stage envelope
        ``(0, MAX_COMPACT_BUDGET]``. The kernel reads its tables from device
        memory, so unlike the reference's fast-memory bound no store size
        leaves the envelope."""
        from ..kernels.refine import MAX_COMPACT_BUDGET

        mode = self.config.fusion
        if mode is None:
            mode = "kernel" if self.device.type == "cuda" else "off"
        if mode == "off":
            return None
        if mode not in ("kernel", "reference"):
            raise ValueError(f"unknown fusion mode {mode!r}")
        if get_relation(base_relation).prefilter_kind == "custom":
            return None
        b = self.config.exact_budget if budget is None else budget
        if not 0 < b <= MAX_COMPACT_BUDGET:
            return None
        return mode

    # ---------------------------------------------------------------- sharded
    def _sharded_available(self) -> bool:
        """A mesh is configured and shaped for the sharded backend (a loud
        error on a malformed mesh beats silently planning around it)."""
        mesh = self.config.mesh
        if mesh is None:
            return False
        names = tuple(mesh.axis_names)
        if "model" not in names or not any(a in ("data", "pod")
                                           for a in names):
            raise ValueError(
                f"EngineConfig.mesh axes {names} unusable: the sharded "
                "backend needs a 'model' axis (query sharding) and a "
                "'data' and/or 'pod' axis (record sharding)")
        return True

    def _shard_count(self) -> int:
        """Number of record shards (product of the data/pod axis sizes)."""
        from .distributed import shard_count

        return shard_count(self.config.mesh)

    def _sharded_placement(self):
        """The mesh placement of the PUBLISHED snapshot, built once per
        publish: the record table range-partitioned over the data axes
        (slot order, slot-aligned MBR tables, each shard's walk), each
        shard uploaded once per distinct device holding it, and a
        model-only snapshot (record-level arrays stripped to 1-element
        stand-ins) once per distinct device. Returns ``(snapshots, table,
        shards, max_width)``. Call under ``self._lock``."""
        if self._shard_placement is not None \
                and self._shard_placement[0] == self._publishes:
            return self._shard_placement[1:]
        from .distributed import (place_table, replicate_model,
                                  shard_arrays_from_capture)

        mesh = self.config.mesh
        shards = self._shard_count()
        if self._capture is None:
            # no capture of the published snapshot is held (it is kept only
            # while a mesh is configured): re-derive it — from the live
            # tree when the snapshot is fresh (they are identical), via a
            # republish otherwise
            if self.snapshot_is_stale():
                self.snapshot()
            else:
                self._capture = snapshot_capture(self.glin)
        table_np = self._staged_table
        self._staged_table = None
        # a staged table (built by the async swap's background thread) must
        # describe exactly the published capture's slots — anything else is
        # rebuilt here (every publish clears stale stagings, so this is a
        # shape check only)
        n = self._capture.keys.shape[0]
        if (table_np is None
                or table_np["keys_hi"].shape[0] != n + (-n) % shards):
            table_np = shard_arrays_from_capture(
                self._capture, shards, pool_pad_to=self._shard_pool_floor)
        # sticky floors: a compacting republish may shrink the per-shard
        # pool or retire the widest records; serving the previous padded
        # shapes keeps the table shapes stable
        self._shard_pool_floor = max(self._shard_pool_floor,
                                     table_np["vpool"].shape[0] // shards)
        maxw = max(self._width_floor,
                   _pow2ceil(int(table_np["nverts"].max())))
        self._width_floor = max(self._width_floor, maxw)
        table = place_table(table_np, mesh)
        snaps = replicate_model(self._snapshot, mesh)
        # key read AFTER the potential republish above bumped the count
        self._shard_placement = (self._publishes, snaps, table, shards, maxw)
        return self._shard_placement[1:]

    def _sharded_step(self, base: str, cap: int, budget: int,
                      compaction: str, max_width: int):
        """Cache of built sharded window steps (the reference's jit
        cache), keyed on what a step is built from."""
        key = (base, cap, budget, compaction, max_width)
        fn = self._shard_steps.get(key)
        if fn is None:
            from .distributed import build_glin_query_step

            fn = build_glin_query_step(
                self.config.mesh, base, cap=cap, exact_budget=budget,
                compaction=compaction, max_width=max_width)
            self._shard_steps[key] = fn
        return fn

    def _sharded_knn_step(self, relation: str, k: int, cap: int, budget: int,
                          compaction: str, max_width: int, topk: str):
        """Cache of built sharded kNN probe+rank+k-merge steps, keyed like
        ``_sharded_step`` plus k and the top-k; pow2-snapped radii keep the
        relation-string key space bounded."""
        key = ("knn", relation, k, cap, budget, compaction, max_width, topk)
        fn = self._shard_steps.get(key)
        if fn is None:
            from .distributed import build_glin_knn_step

            fn = build_glin_knn_step(
                self.config.mesh, relation, k, cap=cap, exact_budget=budget,
                compaction=compaction, max_width=max_width, topk=topk)
            self._shard_steps[key] = fn
        return fn

    def _check_augmentable(self, relation: str, base) -> None:
        """Fail loudly when a relation needs the piecewise augmentation and
        the index was built without it — the device ``_augment()`` would
        silently no-op on an empty piecewise table and drop true hits."""
        if base.augment and self.glin.pw is None:
            raise ValueError(f"{relation} requires the piecewise function "
                             "(cfg.enable_piecewise=True)")

    # ------------------------------------------------------------------- plan
    def plan(self, batch, relation: Optional[str] = None) -> QueryPlan:
        """Planned execution for ``batch`` (same input forms as ``query``)."""
        if not isinstance(batch, QueryBatch):
            batch = QueryBatch.window(batch, relation or "intersects")
        cfg = self.config
        if batch.kind == "knn":
            return self._plan_knn(batch)
        rel = get_relation(batch.relation)
        base = get_relation(rel.base_name())
        self._check_augmentable(batch.relation, base)
        stale = self.snapshot_is_stale()
        delta = self.delta_size()
        inflight = self._inflight is not None
        # patch viable: a snapshot has been published, the per-query patch
        # work is bounded (delta_patch_max), and the delta has not yet hit
        # the republish point (refresh_threshold)
        patchable = (self._snapshot is not None
                     and delta <= cfg.delta_patch_max
                     and delta < cfg.refresh_threshold)

        def host(reason):
            return QueryPlan("host", "window", rel.name, base.name, False,
                             reason, delta)

        fused = self._fusion_mode(base.name) is not None
        fnote = "; fused one-kernel refine" if fused else ""

        def device(reason):
            return QueryPlan("device", "window", rel.name, base.name, stale,
                             reason + fnote, delta, fused=fused)

        def patched(reason):
            return QueryPlan("device+delta", "window", rel.name, base.name,
                             self._snapshot is None, reason + fnote, delta,
                             fused=fused)

        def sharded(reason, rebuild=False):
            return QueryPlan("sharded", "window", rel.name, base.name,
                             rebuild, reason, delta)

        if batch.collect_stats and batch.backend in ("device", "device+delta",
                                                     "sharded"):
            raise ValueError("collect_stats is host-only; drop it or force "
                             "backend='host'")
        if batch.backend == "host":
            return host("forced by caller")
        if batch.backend == "device":
            return device("forced by caller")
        if batch.backend == "device+delta":
            return patched("forced by caller")
        if batch.backend == "sharded":
            self._require_mesh()
            return sharded("forced by caller",
                           rebuild=stale and not (patchable or inflight))
        _check_backend(batch.backend)
        if batch.collect_stats:
            return host("QueryStats instrumentation is host-only")
        if not base.device_native:
            return host(f"relation {base.name!r} is not device-native")
        q = len(batch)
        if q < cfg.device_min_batch:
            return host(f"batch of {q} < device_min_batch="
                        f"{cfg.device_min_batch}")
        shard_ok = (self._sharded_available()
                    and self.glin.num_records >= cfg.shard_min_records)
        nsh = self._shard_count() if shard_ok else 0
        if not stale:
            if shard_ok:
                return sharded(f"sharded over {nsh} shards: batch of {q} "
                               f"windows on {cfg.mesh.merge_device.type} "
                               "mesh")
            return device(f"batch of {q} windows on {self.device.type}")
        if inflight and self._snapshot is not None:
            # double buffering: the next snapshot is building on the side;
            # keep serving the published one + delta patch (the patch bound
            # is waived — the delta stays bounded by write rate x build time)
            if shard_ok:
                return sharded(f"sharded over {nsh} shards; async republish "
                               f"in flight, delta of {delta} patched on top")
            return patched(f"async republish in flight; serving published "
                           f"snapshot + delta of {delta}")
        if patchable:
            if shard_ok:
                return sharded(f"sharded over {nsh} shards; snapshot stale, "
                               f"delta of {delta} patched on top")
            return patched(f"snapshot stale; delta of {delta} <= "
                           f"delta_patch_max={cfg.delta_patch_max}: patching "
                           "instead of republishing")
        if q < cfg.stale_rebuild_min_batch:
            return host(f"snapshot stale and batch of {q} < "
                        f"stale_rebuild_min_batch="
                        f"{cfg.stale_rebuild_min_batch}")
        if shard_ok:
            verb = ("publishing" if self._snapshot is None
                    else "republishing")
            return sharded(f"sharded over {nsh} shards; {verb} for "
                           f"batch of {q}", rebuild=True)
        if self._snapshot is None:
            return device(f"no published snapshot yet: publishing for "
                          f"batch of {q}")
        return device(f"snapshot stale; delta of {delta} not patchable "
                      f"(delta_patch_max={cfg.delta_patch_max}, "
                      f"refresh_threshold={cfg.refresh_threshold}): "
                      f"republishing for batch of {q}")

    def _plan_knn(self, batch: QueryBatch) -> QueryPlan:
        """The reference planner's knn branch: ``sharded`` when a mesh is
        configured and the store is big enough (a stale snapshot is
        republished first); else a stale snapshot with a patchable delta
        plans ``device+delta`` (the delta ranked in line), otherwise
        ``device`` republishes first."""
        cfg = self.config
        q = len(batch)
        seed = cfg.knn_seed or "cdf"
        delta = self.delta_size()
        stale = self.snapshot_is_stale()

        def knn_plan(backend, reason):
            return QueryPlan(backend, "knn", None, None,
                             backend in ("device", "sharded") and stale,
                             reason, delta)

        if batch.backend == "host":
            return knn_plan("host", "forced by caller")
        if batch.backend == "sharded":
            self._require_mesh()
            return knn_plan("sharded", "forced by caller")
        if batch.backend in ("device", "device+delta"):
            return knn_plan(batch.backend, "forced by caller")
        _check_backend(batch.backend)
        if q < cfg.knn_device_min_batch or self.glin.pw is None:
            why = (f"batch of {q} < knn_device_min_batch="
                   f"{cfg.knn_device_min_batch}"
                   if q < cfg.knn_device_min_batch
                   else "no piecewise function published")
            return knn_plan("host", f"knn executes on the host index ({why})")
        if (self._sharded_available()
                and self.glin.num_records >= cfg.shard_min_records):
            nsh = self._shard_count()
            return knn_plan(
                "sharded",
                f"device-complete knn over {nsh} shards: {seed}-seeded "
                f"radii, shard-local top-{batch.k}, one-collective "
                f"k-merge ({q} points)")
        patchable = (self._snapshot is not None
                     and delta <= cfg.delta_patch_max
                     and delta < cfg.refresh_threshold)
        if stale and patchable:
            return knn_plan(
                "device+delta",
                f"device-complete knn with {seed}-seeded radii; "
                f"snapshot stale, delta of {delta} ranked in-line "
                f"(tombstones masked, added set distance-merged before "
                f"the device top-{batch.k})")
        return knn_plan(
            "device",
            f"device-complete knn: {seed}-seeded dwithin ladder + "
            f"device top-{batch.k} ({q} points >= knn_device_min_batch="
            f"{cfg.knn_device_min_batch})")

    def _require_mesh(self) -> None:
        if not self._sharded_available():
            raise ValueError("backend='sharded' requires EngineConfig.mesh")

    # ------------------------------------------------------------------ query
    def query(self, batch, relation: Optional[str] = None,
              replica: Optional[int] = None, **kw) -> QueryResult:
        """THE entry point: one or thousands of queries, any relation or knn.

        ``batch`` is a :class:`QueryBatch`, or a bare (4,) / (Q, 4) window
        array (``relation`` then applies, default ``intersects``). A knn
        batch (:meth:`QueryBatch.knn`) returns ids and ``distances`` per
        point in ascending (distance, id) order. ``replica`` routes a
        device-backend batch to placement ``replica % EngineConfig.replicas``
        (the serving tier's least-loaded dispatcher sets it; default: the
        primary placement).

        Concurrency contract: safe to call from many threads, interleaved
        with :meth:`insert`/:meth:`delete`. A ``device``/``device+delta``
        batch is exact at the epoch frozen in its prologue
        (``result.epoch``) and runs its device compute without blocking
        writers; host batches serialize with writers and are exact at the
        epoch they hold the lock. A device knn batch freezes its snapshot +
        delta once up front: every rung serves that same epoch.
        """
        if not isinstance(batch, QueryBatch):
            batch = QueryBatch.window(batch, relation or "intersects", **kw)
        else:
            if relation is not None and relation != batch.relation:
                raise ValueError("pass the relation inside the QueryBatch")
            if kw:
                raise ValueError(f"{sorted(kw)} must be set on the QueryBatch "
                                 "itself")
        with self._lock:
            self._maintain_async()
            plan = self.plan(batch)
        rel = base = None
        if batch.kind == "window":
            rel = get_relation(batch.relation)
            base = get_relation(rel.base_name())
        ctx = qexec.ExecContext(index=self, batch=batch, plan=plan,
                                rel=rel, base=base, replica=replica or 0)
        qexec.compile_plan(plan).execute(ctx)
        self._record_stages(plan.backend, ctx.stage_stats)
        return QueryResult(ids=ctx.ids, plan=plan, epoch=ctx.epoch,
                           stats=ctx.host_stats, distances=ctx.distances,
                           stages=ctx.stage_stats)

    def explain(self, batch, relation: Optional[str] = None) -> str:
        """Pretty-print how ``batch`` WOULD execute (same input forms as
        :meth:`query`, nothing runs): the planner's decision plus the
        compiled stage composition — one line per stage with its
        implementation and the canonical pipeline stages it fuses."""
        if not isinstance(batch, QueryBatch):
            batch = QueryBatch.window(batch, relation or "intersects")
        with self._lock:
            plan = self.plan(batch)
        eplan = qexec.compile_plan(plan)
        head = (f"QueryPlan backend={plan.backend} kind={plan.kind} "
                f"relation={plan.relation} delta={plan.delta_size}"
                + (" rebuild" if plan.rebuild_snapshot else ""))
        lines = [head, f"  reason: {plan.reason}", "  stages:"]
        lines += [f"    {row}" for row in eplan.describe()]
        return "\n".join(lines)

    # ------------------------------------------------------------- estimation
    def count_candidates(self, windows, relation: str = "intersects"
                         ) -> np.ndarray:
        """MBR-level candidate counts per window (selectivity estimation)
        through ``kernels.refine.refine_count`` — the CUDA kernel walking the
        snapshot's leaf tables on a CUDA index, its plain version on the
        CPU."""
        from ..kernels.refine import refine_count

        base = get_relation(relation).base_name()
        base_rel = get_relation(base)
        self._check_augmentable(relation, base_rel)
        snap = self.snapshot()
        wt = torch.as_tensor(np.atleast_2d(np.asarray(windows))
                             .astype(np.float32)).to(self.device)
        start, end = batch_query_bounds(snap, wt, base)
        bounds = torch.stack([start, end], dim=1)
        # MBR-level counting uses the padded probe window so dwithin-style
        # relations count the candidates their refine step will actually see
        counts = refine_count(base_rel.probe_window(wt).contiguous(), bounds,
                              snap.slot_rmbr, leaves=snap.leaf_walk)
        return counts.cpu().numpy()

    # ----------------------------------------------------- execution support
    def _freeze_live(self, rel) -> Optional[np.ndarray]:
        """Live record ids for complement finishing, frozen under the lock
        (the live mask walks the mutable host leaves)."""
        if not rel.is_complement:
            return None
        return np.nonzero(self.glin._live_mask())[0].astype(np.int64)

    def _delta_table(self, rep: int = 0) -> DeltaTable:
        """The device-resident added-set side table at the current epoch,
        rebuilt lazily after a write burst (one upload per epoch served, not
        one host round-trip per query batch). Rows are padded to a power of
        two, at least ``delta_device_min``. ``rep`` names the replica it
        serves: a replica on another card (see :meth:`_replica_view`) gets
        a copy there, made once per table. Call under ``self._lock``."""
        if self._dtable is None or self._dtable_epoch != self._epoch:
            a = len(self._added)
            pad = max(self.config.delta_device_min,
                      1 << max(a - 1, 0).bit_length())
            self._dtable = delta_table_from_host(self.glin, self._added,
                                                 self.device, pad_to=pad)
            self._dtable_epoch = self._epoch
        rep %= max(1, int(self.config.replicas))
        dev = self._replica_device(rep)
        if rep == 0 or dev == self._dtable.ids.device:
            return self._dtable
        ent = self._replica_dtables.get(rep)
        if ent is None or ent[0] is not self._dtable:
            ent = (self._dtable, place(self._dtable, dev))
            self._replica_dtables[rep] = ent
        return ent[1]

    def _freeze_delta(self, rep: int = 0) -> Optional[Tuple]:
        """Copies of the tombstone/added delta plus the geometry slices (or
        the device :class:`DeltaTable`) the patch step needs, frozen under
        ``self._lock`` so the delta-patch stage can run outside it while
        writers keep mutating the live sets."""
        if not (self._tombstones or self._added):
            return None
        gs = self.glin.gs
        tombs = (np.fromiter(self._tombstones, np.int64,
                             len(self._tombstones))
                 if self._tombstones else None)
        added = np.asarray(sorted(self._added), np.int64)
        table = av = an = ak = None
        if added.shape[0] >= self.config.delta_device_min:
            table = self._delta_table(rep)
        elif added.shape[0]:
            av = gs.padded(added).astype(np.float32)
            an, ak = gs.nverts[added], gs.kinds[added]
        return (tombs, added, table, av, an, ak)


def _check_backend(backend: Optional[str]) -> None:
    """Refuse a forced backend the planner does not know."""
    if backend is not None:
        raise ValueError(f"unknown backend {backend!r}")
