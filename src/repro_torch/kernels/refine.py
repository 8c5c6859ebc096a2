"""GLIN refine kernels for Hopper: count, compact, fused and mask.

Four wrappers, each over a CUDA C++ kernel of ``csrc/refine.cu`` (sm_90a)
and with its plain torch version beside it:

* :func:`refine_count`   — per query, the count of slots in its run whose
  record MBR meets the probe window (``SpatialIndex.count_candidates``).
* :func:`refine_compact` — per query, the first ``budget`` survivors of
  interval + leaf-MBR + record-MBR tests in ascending slot order, ``-1``
  padded, and the TOTAL survivor count (the staged refine's stage 1).
* :func:`refine_fused`   — the whole query in one launch: learned-index probe,
  the compact stage, and the relation's exact predicate over the survivors'
  vertex pods (the engine's default refine on a card).
* :func:`refine_mask`    — the whole (Q, N) int8 candidate mask (the
  kernel-level ``ops`` entry point; no core path uses it).

Count, compact and fused walk each run group -> leaf -> slot over the
:class:`LeafWalk` tables. Count and compact also walk without them, every
slot its own leaf (slot-as-leaf mode, for the ``ops`` entry point, which
holds only slot-aligned tables). The mask kernel writes the whole mask in
16-byte stores, each thread 16 slots of a row.

A CUDA tensor always takes the kernel; a CPU tensor always takes the plain
version (the CPU tests reach the wrappers' layout code that way). Each
wrapper counts its kernel launches in ``<wrapper>.launches`` — a launch made
only to compare a kernel with its plain version counts too, so a caller that
wants the main path's count resets it around that path.

Every plain version processes the whole slot table in query chunks (a
``(chunk, N)`` mask of :data:`MASK_CHUNK_ELEMS` elements), so it also runs
at real store sizes on the card. The plain count, compact and fused
versions test every slot (compact and fused against the slot-aligned
``leaf_mbrs`` too): the per-slot definition the walk must reproduce.
"""
from __future__ import annotations

import math
import threading
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import geometry as geom

__all__ = ["MAX_COMPACT_BUDGET", "LeafWalk", "refine_count",
           "refine_compact", "refine_fused", "refine_mask",
           "refine_count_plain", "refine_compact_plain", "refine_fused_plain",
           "refine_mask_plain", "compact_plain", "fused_probe_plain",
           "DEFAULT_BQ", "DEFAULT_BN", "COMPACT_BN", "refine_cost",
           "sharded_refine_cost", "sharded_knn_cost"]

# The reference package's budget bound (there, its TPU scatter block had to
# fit fast memory). Kept for the fused kernel and the window ladder so both
# packages plan the same stages; it is not a limit of this card — the fused
# kernel's survivor list at this bound takes 4 KB of shared memory, and the
# compact kernel takes any budget.
MAX_COMPACT_BUDGET = 1024
PREFILTERS = ("intersects", "contains")
# query rows x slots per chunk of a whole-table mask (16M elements: ~64 MB
# per int32 intermediate)
MASK_CHUNK_ELEMS = 1 << 24
# The reference kernels' tile sizes (query rows, record slots; the compact
# kernel's smaller record tile), the defaults of the cost model below. No
# kernel here tiles by them.
DEFAULT_BQ = 8
DEFAULT_BN = 512
COMPACT_BN = 256

_I32 = torch.int32
_F32 = torch.float32


# ---------------------------------------------------------------- checking
def _route(*tensors) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); every operand must live on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"and {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(name, t, dtype, shape):
    """What the kernel takes: dtype, shape (None = any extent), contiguous
    rows, 16-byte aligned base (the kernels load rows as float4/int4)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and t.shape[i] != s for i, s in enumerate(shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _launch(name, device, *args):
    from . import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.call(name, *[a.data_ptr() if isinstance(a, torch.Tensor)
                            else a for a in args], stream)


_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    """One more launch in ``wrapper.launches``. Under a lock: the serving
    tier's worker threads launch concurrently, and a bare ``+=`` is a
    read-modify-write that can lose a count."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _chunk(n: int) -> int:
    return max(1, MASK_CHUNK_ELEMS // max(int(n), 1))


class LeafWalk(NamedTuple):
    """The tables the count, compact and fused kernels walk a run by (built
    once per publish: ``core.device.GLINSnapshot.leaf_walk``). The walk
    equals the per-slot definition when every slot ``s`` of a run lies in
    ``[leaf_start[rec_leaf[s]], leaf_start[rec_leaf[s] + 1])`` and its
    slot-aligned leaf MBR is ``leaf_mbr[rec_leaf[s]]``, as a snapshot
    builds them (the count's further condition: :func:`refine_count`)."""

    rec_leaf: torch.Tensor    # (N,) int32 leaf of each slot, non-decreasing
    leaf_start: torch.Tensor  # (L+1,) int32 slot offsets
    leaf_mbr: torch.Tensor    # (L, 4) f32 leaf MBRs
    group_mbr: torch.Tensor   # (ceil(L / 32), 4) f32 unions of 32 leaves'
                              # (core.device.leaf_group_mbrs)


def _check_walk(leaves: Optional[LeafWalk], n: int) -> None:
    """The walk operands' dtype and shape, on either device."""
    if leaves is None:
        return
    nl = leaves.leaf_mbr.shape[0]
    _check("rec_leaf", leaves.rec_leaf, _I32, (n,))
    _check("leaf_start", leaves.leaf_start, _I32, (nl + 1,))
    _check("leaf_mbr", leaves.leaf_mbr, _F32, (nl, 4))
    _check("group_mbr", leaves.group_mbr, _F32, (-(-nl // 32), 4))


def _walk_args(leaves: Optional[LeafWalk], slot_mbrs, n: int) -> tuple:
    """The C entry points' walk arguments ``(rec_leaf, leaf_start,
    leaf_mbr, group_mbr, num_leaves, slot_leaf)``: the leaf tables, or in
    slot-as-leaf mode (``leaves`` None) no leaf tables, ``slot_mbrs`` as
    the leaf rows and group rows built for the call."""
    if leaves is None:
        from ..core.device import leaf_group_mbrs

        return None, None, slot_mbrs, leaf_group_mbrs(slot_mbrs), n, 1
    return (*leaves, leaves.leaf_mbr.shape[0], 0)


# ---------------------------------------------------------------- mask
def _mask_chunks(windows, bounds, mbrs):
    """Yield ``(row0, (chunk, N) bool)``: slot in [start, end) and record
    MBR meets the window (``repro.kernels.ref.refine_mask_ref``), in query
    chunks of :data:`MASK_CHUNK_ELEMS` elements."""
    q, n = windows.shape[0], mbrs.shape[0]
    slot = torch.arange(n, dtype=_I32, device=windows.device)
    step = _chunk(n)
    for i in range(0, q, step):
        b = bounds[i:i + step]
        inter = geom.mbr_intersects(mbrs[None], windows[i:i + step, None, :])
        yield i, inter & (slot >= b[:, 0:1]) & (slot < b[:, 1:2])


def refine_mask_plain(windows, bounds, mbrs):
    """(Q, N) int8 candidate mask in tensor code."""
    out = torch.empty((windows.shape[0], mbrs.shape[0]), dtype=torch.int8,
                      device=windows.device)
    for i, m in _mask_chunks(windows, bounds, mbrs):
        out[i:i + m.shape[0]] = m.to(torch.int8)
    return out


def refine_mask(windows, bounds, mbrs):
    """windows (Q,4) f32, bounds (Q,2) i32 slot runs, mbrs (N,4) f32
    slot-aligned record MBRs -> (Q, N) int8: 1 where the slot lies in the
    query's run and its MBR meets the window.

    Replaces ``refine_mask_pallas`` (repro/kernels/refine.py). Bound on this
    card: bytes — the (Q, N) mask written, the MBR table read. A block
    stages a tile of 2048 slots' MBRs through shared memory (coalesced,
    each read once per block) and covers 64 query rows; each thread holds
    16 consecutive slots and writes their 16 bytes of a row in one
    streaming store, zeros untested where the row's run misses them. Rows
    whose base is not 16-byte aligned (``N`` not a multiple of 16) store
    the same way, shifted down to the aligned address, with a few bytes
    at each row's ends written one by one. ``N`` up to 65535 tiles
    (134,215,680 slots); past that the launch is refused and this raises.
    """
    if not _route(windows, bounds, mbrs):
        return refine_mask_plain(windows, bounds, mbrs)
    q, n = windows.shape[0], mbrs.shape[0]
    _check("windows", windows, _F32, (q, 4))
    _check("bounds", bounds, _I32, (q, 2))
    _check("mbrs", mbrs, _F32, (n, 4))
    out = torch.empty((q, n), dtype=torch.int8, device=windows.device)
    if q and n:
        _launch("glin_refine_mask", windows.device, windows, bounds, mbrs,
                out, q, n)
        _count(refine_mask)
    return out


refine_mask.launches = 0


# ---------------------------------------------------------------- count
def refine_count_plain(windows, bounds, mbrs):
    """(Q,) int32: slots in [start, end) whose record MBR meets the window
    (``repro.kernels.ref.refine_count_ref``, in query chunks)."""
    out = torch.zeros(windows.shape[0], dtype=_I32, device=windows.device)
    for i, m in _mask_chunks(windows, bounds, mbrs):
        out[i:i + m.shape[0]] = m.sum(dim=1, dtype=_I32)
    return out


def refine_count(windows, bounds, mbrs, *,
                 leaves: Optional[LeafWalk] = None):
    """windows (Q,4) f32 probe windows, bounds (Q,2) i32 slot runs, mbrs
    (N,4) f32 slot-aligned record MBRs, ``leaves`` the walk's leaf tables
    (None: each slot its own leaf) -> (Q,) i32 candidate counts.

    Replaces ``refine_count_pallas`` (repro/kernels/refine.py). One block
    per query walks its run group -> leaf -> slot as :func:`refine_compact`
    does and keeps only the total. What bounds it on this card: latency,
    the walk's barrier chain; the bytes it needs are the walked rows.

    The plain version tests every run slot's record MBR. With ``leaves`` the
    walk equals it when every real slot's record MBR lies inside its leaf's
    MBR (``leaf_mbr[rec_leaf[s]]``) and no padding slot (past
    ``leaf_start[-1]``) of a run meets its window, as a snapshot builds
    them (``GLINSnapshot.leaf_walk``; padding MBRs lie far away). Without
    ``leaves`` the leaf rows are ``mbrs`` themselves and the walk equals
    it on any input.
    """
    q, n = windows.shape[0], mbrs.shape[0]
    _check_walk(leaves, n)
    if not _route(windows, bounds, mbrs, *(leaves or ())):
        return refine_count_plain(windows, bounds, mbrs)
    _check("windows", windows, _F32, (q, 4))
    _check("bounds", bounds, _I32, (q, 2))
    _check("mbrs", mbrs, _F32, (n, 4))
    out = torch.empty(q, dtype=_I32, device=windows.device)
    if q:
        walk = _walk_args(leaves, mbrs, n)
        _launch("glin_refine_count", windows.device, windows, bounds,
                *walk[:4], mbrs, out, q, n, *walk[4:])
        _count(refine_count)
    return out


refine_count.launches = 0


# ---------------------------------------------------------------- compact
def compact_plain(probe_w, start, end, leaf_mbrs, rec_mbrs, budget: int,
                  prefilter: str):
    """Whole-table mask + stable compaction, in query chunks -> (slots
    (Q, budget) i32 [-1 padded, ascending], counts (Q,) i32 total
    survivors). Compaction is a cumsum plus a per-row search for the k-th
    survivor (``batch_query_fused``'s reference composition)."""
    q, n = probe_w.shape[0], leaf_mbrs.shape[0]
    dev = probe_w.device
    slots = torch.full((q, budget), -1, dtype=_I32, device=dev)
    counts = torch.zeros(q, dtype=_I32, device=dev)
    if n == 0 or q == 0:
        return slots, counts
    slot = torch.arange(n, dtype=_I32, device=dev)
    kth = torch.arange(1, budget + 1, dtype=_I32, device=dev)
    step = _chunk(n)
    for i in range(0, q, step):
        w = probe_w[i:i + step, None, :]
        leaf_ok = geom.mbr_intersects(leaf_mbrs[None], w)
        if prefilter == "contains":
            rec_ok = geom.mbr_contains(rec_mbrs[None], w)
        else:
            rec_ok = geom.mbr_intersects(rec_mbrs[None], w)
        in_run = (slot >= start[i:i + step, None]) & (slot < end[i:i + step,
                                                                 None])
        mask = in_run & leaf_ok & rec_ok
        cum = torch.cumsum(mask.to(_I32), dim=1, dtype=_I32)
        counts[i:i + step] = cum[:, -1]
        pos = torch.searchsorted(
            cum, kth.expand(cum.shape[0], budget).contiguous(), side="left")
        slots[i:i + step] = torch.where(pos < n, pos.to(_I32), -1)
    return slots, counts


def refine_compact_plain(windows, bounds, leaf_mbrs, rec_mbrs, budget: int,
                         prefilter: str = "intersects"):
    """``repro.kernels.ref.refine_compact_ref`` in query chunks."""
    return compact_plain(windows, bounds[:, 0], bounds[:, 1], leaf_mbrs,
                         rec_mbrs, budget, prefilter)


def refine_compact(windows, bounds, leaf_mbrs, rec_mbrs, *, budget: int,
                   prefilter: str = "intersects",
                   leaves: Optional[LeafWalk] = None):
    """windows (Q,4) f32 PROBE windows, bounds (Q,2) i32 slot runs,
    leaf_mbrs/rec_mbrs (N,4) f32 slot-aligned MBR tables, ``leaves`` the
    walk's leaf tables (None: each slot its own leaf) -> (slots (Q, budget)
    i32 [-1 padded, ascending slot order], counts (Q,) i32 TOTAL survivors;
    ``counts > budget`` means the list is truncated).

    Replaces ``refine_compact_pallas`` (repro/kernels/refine.py). One block
    per query walks its run group -> leaf -> slot: the group rows of the
    run, the leaves of the groups that meet, the record MBRs of the run
    slots inside the leaves that meet. On a card it reads ``leaves`` in
    place of ``leaf_mbrs``; the plain version tests every slot against
    ``leaf_mbrs``. What bounds it on this card: latency — a chain of block
    barriers, one per 256 groups, per 8 meeting groups and per 256 slots
    tested; the bytes it needs are those rows only. Survivors take their
    column from a block-wide exclusive prefix sum and are stored directly,
    in place of the reference's one-hot scatter — so, unlike the fused
    kernel, any positive budget works (the kNN ladder grows it up to
    ``EngineConfig.max_cap``).
    """
    if prefilter not in PREFILTERS:
        raise ValueError(f"unsupported prefilter {prefilter!r}")
    if budget < 1:
        raise ValueError(f"budget {budget} must be positive")
    q, n = windows.shape[0], leaf_mbrs.shape[0]
    _check_walk(leaves, n)
    if not _route(windows, bounds, leaf_mbrs, rec_mbrs, *(leaves or ())):
        return refine_compact_plain(windows, bounds, leaf_mbrs, rec_mbrs,
                                    budget, prefilter)
    _check("windows", windows, _F32, (q, 4))
    _check("bounds", bounds, _I32, (q, 2))
    _check("leaf_mbrs", leaf_mbrs, _F32, (n, 4))
    _check("rec_mbrs", rec_mbrs, _F32, (n, 4))
    slots = torch.empty((q, budget), dtype=_I32, device=windows.device)
    counts = torch.empty(q, dtype=_I32, device=windows.device)
    if q:
        walk = _walk_args(leaves, leaf_mbrs, n)
        _launch("glin_refine_compact", windows.device, windows, bounds,
                *walk[:4], rec_mbrs, slots, counts, q, n, walk[4], budget,
                int(prefilter == "contains"), walk[5])
        _count(refine_compact)
    return slots, counts


refine_compact.launches = 0


# ---------------------------------------------------------------- fused
def _packed_tables(keys, leaf_i, leaf_f, node_i, node_f, codes, pw,
                   search_steps, depth):
    """The fused operand columns under the snapshot's field names, so the
    plain probe runs ``core.device``'s own traversal and search."""
    return SimpleNamespace(
        keys_hi=keys[:, 0], keys_lo=keys[:, 1],
        leaf_start=leaf_i[:, 0], leaf_dlo_hi=leaf_i[:, 1],
        leaf_dlo_lo=leaf_i[:, 2], leaf_k0_hi=leaf_i[:, 3],
        leaf_k0_lo=leaf_i[:, 4], leaf_slope=leaf_f[:, 0],
        leaf_icpt=leaf_f[:, 1], node_dlo_hi=node_i[:, 0],
        node_dlo_lo=node_i[:, 1], node_fanout=node_i[:, 2],
        node_child_base=node_i[:, 3], node_scale=node_f[:, 0],
        child_codes=codes[:, 0], pw_zmax_hi=pw[:, 0], pw_zmax_lo=pw[:, 1],
        pw_sufmin_hi=pw[:, 2], pw_sufmin_lo=pw[:, 3],
        num_leaves=leaf_i.shape[0] - 1, search_steps=search_steps,
        depth=depth)


def fused_probe_plain(qkeys, keys, leaf_i, leaf_f, node_i, node_f, codes, pw,
                      *, augment: bool, search_steps: int, depth: int):
    """``_fused_probe``: the [start, end) slot run of each query from its
    pre-augmentation keys ``[zmin_hi, zmin_lo, ub_hi, ub_lo]``."""
    from ..core import device as dev

    t = _packed_tables(keys, leaf_i, leaf_f, node_i, node_f, codes, pw,
                       search_steps, depth)
    zmin_hi, zmin_lo = qkeys[:, 0], qkeys[:, 1]
    if augment:
        zmin_hi, zmin_lo = dev._augment(t, zmin_hi, zmin_lo)
    return (dev.batch_probe(t, zmin_hi, zmin_lo),
            dev.batch_probe(t, qkeys[:, 2], qkeys[:, 3]))


def refine_fused_plain(windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f,
                       node_i, node_f, codes, pw, pod_i, pool, leaf_mbrs,
                       rec_mbrs, *, budget, prefilter, code, dist, augment,
                       search_steps, depth):
    """Probe, whole-table compaction and the exact stage as plain tensor
    code (``batch_query_fused(mode="reference")`` on packed operands)."""
    start, end = fused_probe_plain(qkeys, keys, leaf_i, leaf_f, node_i,
                                   node_f, codes, pw, augment=augment,
                                   search_steps=search_steps, depth=depth)
    slots, total = compact_plain(probe_w, start, end, leaf_mbrs, rec_mbrs,
                                 budget, prefilter)
    taken = slots >= 0
    rec = torch.where(taken, recs[:, 0][torch.clamp(slots, min=0)], 0)
    ok = geom.map_over_pods(geom.device_predicate(code, dist), windows,
                            pool, pod_i[:, 0], pod_i[:, 1], pod_i[:, 2],
                            pod_i[:, 3], rec, taken, False)
    fmask = taken & ok
    hits = torch.where(fmask, rec, -1)
    counts = torch.where(total > budget, -total - 1,
                         fmask.sum(dim=1, dtype=_I32))
    return hits, counts


def refine_fused(windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f, node_i,
                 node_f, codes, pw, pod_i, pool, leaf_mbrs, rec_mbrs, *,
                 budget: int, prefilter: str, code: int, dist: float = 0.0,
                 augment: bool, search_steps: int, depth: int,
                 leaves: Optional[LeafWalk] = None):
    """One-launch probe + compact + exact refine.

    Per-query inputs (Q rows): ``windows``/``probe_w`` (Q, 4) f32 raw and
    relation-padded windows, ``qkeys`` (Q, 4) i32 pre-augmentation
    ``[zmin_hi, zmin_lo, ub_hi, ub_lo]`` keys. Tables (packed once per
    publish: ``core.device.GLINSnapshot.fused_operands``): ``keys`` (N, 2)
    i32, ``recs`` (N, 1) i32, ``leaf_i`` (L+1, 5) i32 ``[start, dlo_hi,
    dlo_lo, k0_hi, k0_lo]``, ``leaf_f`` (L+1, 2) f32 ``[slope, icpt]``,
    ``node_i`` (M, 4) i32 ``[dlo_hi, dlo_lo, fanout, child_base]``,
    ``node_f`` (M, 1) f32, ``codes`` (C, 1) i32, ``pw`` (P, 4) i32
    ``[zmax_hi, zmax_lo, sufmin_hi, sufmin_lo]``, ``pod_i`` (R, 4) i32
    ``[off, nv, kind, bucket]``, ``pool`` (V, 2) f32 vertex pods,
    ``leaf_mbrs``/``rec_mbrs`` (N, 4) f32 (the plain version tests every
    slot against ``leaf_mbrs``), ``leaves`` the walk's leaf tables (the
    kernel needs them; the plain version does not). ``code`` is the
    relation's predicate code (``geometry.PRED_*``), ``dist`` the
    ``dwithin`` distance.

    Returns ``(hits (Q, budget) i32 [record id where the exact predicate
    holds, else -1, column for column over the survivors], counts (Q,) i32
    exact hits, or -(survivors) - 1 when the survivors exceed the budget)``.

    Replaces ``refine_fused_pallas`` (repro/kernels/refine.py). One block
    per query: threads 0 and 1 run the two probes (a few dozen dependent
    loads through L2), the block walks its run as :func:`refine_compact`
    does into a shared-memory survivor list, orders the survivors by pod
    width and runs the exact predicate: a thread per survivor under 16
    vertices, a warp per wider one (its lanes split the vertex loop). What
    bounds it on this card: latency — the probe's dependent loads, the
    walk's barrier chain and the vertex loops; the bytes it needs are the
    walked rows, the survivors' ids, pod headers and vertices.
    """
    if prefilter not in PREFILTERS:
        raise ValueError(f"unsupported prefilter {prefilter!r}")
    if not 0 < budget <= MAX_COMPACT_BUDGET:
        raise ValueError(
            f"budget {budget} outside (0, MAX_COMPACT_BUDGET="
            f"{MAX_COMPACT_BUDGET}]: the fused kernel is two-stage only — "
            "use the staged batch_query for budget 0 or larger budgets")
    if not 0 <= code <= geom.PRED_DWITHIN:
        raise ValueError(f"unknown predicate code {code!r}")
    ops = (windows, probe_w, qkeys, keys, recs, leaf_i, leaf_f, node_i,
           node_f, codes, pw, pod_i, pool, leaf_mbrs, rec_mbrs)
    q, n = windows.shape[0], keys.shape[0]
    _check_walk(leaves, n)
    if not _route(*ops, *(leaves or ())):
        return refine_fused_plain(
            *ops, budget=budget, prefilter=prefilter, code=code, dist=dist,
            augment=augment, search_steps=search_steps, depth=depth)
    nl, npw = leaf_i.shape[0], pw.shape[0]
    for name, t, dt, shape in (
            ("windows", windows, _F32, (q, 4)),
            ("probe_w", probe_w, _F32, (q, 4)),
            ("qkeys", qkeys, _I32, (q, 4)), ("keys", keys, _I32, (n, 2)),
            ("recs", recs, _I32, (n, 1)), ("leaf_i", leaf_i, _I32, (nl, 5)),
            ("leaf_f", leaf_f, _F32, (nl, 2)),
            ("node_i", node_i, _I32, (None, 4)),
            ("node_f", node_f, _F32, (node_i.shape[0], 1)),
            ("codes", codes, _I32, (None, 1)), ("pw", pw, _I32, (npw, 4)),
            ("pod_i", pod_i, _I32, (None, 4)), ("pool", pool, _F32, (None, 2)),
            ("leaf_mbrs", leaf_mbrs, _F32, (n, 4)),
            ("rec_mbrs", rec_mbrs, _F32, (n, 4))):
        _check(name, t, dt, shape)
    if nl < 2 or npw < 1 or node_i.shape[0] < 1 or codes.shape[0] < 1:
        raise ValueError("fused tables must hold at least one leaf, node, "
                         "code and piece row (core.device._fused_operands)")
    if not 0 < search_steps < 30:
        raise ValueError(f"search_steps {search_steps} outside (0, 30)")
    if leaves is None:
        raise ValueError("the fused kernel walks the snapshot's leaf tables: "
                         "pass leaves=GLINSnapshot.leaf_walk")
    hits = torch.empty((q, budget), dtype=_I32, device=windows.device)
    counts = torch.empty(q, dtype=_I32, device=windows.device)
    if q:
        dist2 = float(np.float32(float(dist) ** 2))
        aug_steps = max(1, math.ceil(math.log2(npw + 1)))
        _launch("glin_refine_fused", windows.device, *ops[:13], *leaves,
                rec_mbrs, hits, counts, q, n, nl - 1, npw, aug_steps,
                pool.shape[0], budget, int(prefilter == "contains"), code,
                dist2, int(augment), search_steps, depth,
                leaves.leaf_mbr.shape[0])
        _count(refine_fused)
    return hits, counts


refine_fused.launches = 0


# ---------------------------------------------------------------------------
# The reference's analytic cost model
# ---------------------------------------------------------------------------
def refine_cost(kind: str, q: int, n: int, budget: int = 0,
                verts: int = 0, bq: int = DEFAULT_BQ,
                bn: int = DEFAULT_BN) -> dict:
    """Bytes / flops model of one kernel invocation: the reference's
    ``refine_cost``, value for value.

    It models the reference's Pallas kernels, which stream every query
    row-tile of ``bq`` windows over the whole ``(N, 4)`` MBR table(s) in
    ``bn``-slot tiles. The CUDA kernels here do not: they walk each query's
    run group -> leaf -> slot and read only the rows the walk reaches
    (``chip_smoke.py`` counts those for each kernel's bound). So these
    figures are the reference's, kept for the dry run's GLIN cell and for
    comparison, not a count of what the card reads.

    ``kind``: "mask" | "count" | "compact" | "exact" | "fused" | "knn".
    "exact" is the exact-shape stage over the compacted ``(Q, budget)``
    survivors at gather width ``verts`` (the widest surviving pow2 width
    bucket); "knn" the top-k stage: exact distances over ``n`` candidate
    columns at width ``verts`` and the k-round partial selection, with
    ``budget`` as k; "fused" the one-dispatch probe + compact + exact
    kernel: the compact and exact terms and the in-kernel probe, minus the
    ``(Q, budget)`` survivor and ``(Q, 2)`` bounds round trips the staged
    pipeline pays between dispatches.
    """
    tiles_q = -(-q // bq)
    if kind == "fused":
        c = refine_cost("compact", q, n, budget, bq=bq, bn=bn)
        e = refine_cost("exact", q, n, budget, verts=verts, bq=bq, bn=bn)
        # the staged pipeline's intermediates a single dispatch keeps
        saved = q * (2.0 * max(budget, 1) + 5.0) * 4.0
        # the probe: key limbs read once; ~2 searches x ~18 steps x ~12
        # operations a query
        probe_bytes = n * 8.0 + q * 32.0
        probe_flops = q * 2.0 * 18.0 * 12.0
        return {
            "flops": c["flops"] + e["flops"] + probe_flops,
            "bytes_accessed": max(
                c["bytes_accessed"] + e["bytes_accessed"]
                + probe_bytes - saved, 0.0),
            "transcendentals": 0,
        }
    if kind == "exact":
        # (verts, 2) f32 rings plus the 16-byte record header a survivor,
        # ~40 operations a vertex
        bytes_accessed = q * budget * (verts * 8 + 16) + q * budget * 4
        flops = q * budget * verts * 40
        return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
                "transcendentals": 0}
    if kind == "knn":
        # the exact distances over n columns, then k rounds over the n-wide
        # tile (its minimum and the tie mask); budget is k
        k = max(budget, 1)
        bytes_accessed = (q * n * (verts * 8 + 16)   # pod gather
                          + q * n * 8                # (d2, ids) tile
                          + q * k * 8)               # (Q, k) result
        flops = q * n * verts * 40 + q * k * n * 3.0
        return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
                "transcendentals": float(q * k)}     # a sqrt per winner
    # the streaming kernels: each query row-tile streams the MBR table(s)
    streams = 2 if kind == "compact" else 1
    bytes_accessed = tiles_q * n * 16 * streams + q * 24
    flops = q * n * 10.0          # interval and MBR comparisons a pair
    if kind == "mask":
        bytes_accessed += q * n   # the int8 mask
    elif kind == "count":
        bytes_accessed += tiles_q * bq * 4
    elif kind == "compact":
        flops += q * n * 6.0      # prefix sums
        flops += q * n * float(max(budget, 1)) * 2.0   # one-hot scatter
        bytes_accessed += q * (max(budget, 1) + 1) * 4
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
            "transcendentals": 0}


def sharded_refine_cost(q: int, n: int, budget: int, shards: int,
                        verts: int = 0, bq: int = DEFAULT_BQ,
                        bn: int = DEFAULT_BN) -> dict:
    """Per-device cost of the sharded compact + exact refine (the
    reference's ``sharded_refine_cost``, value for value, on its model of
    the Pallas kernels; see :func:`refine_cost`): each of ``shards``
    devices compacts its ``N / shards`` slots and exact-refines its
    ``(Q, budget)`` survivors; ``collective_bytes`` is the all-gather of
    ``(Q, shards, budget + 1)`` int32 every device receives."""
    n_local = -(-n // max(shards, 1))
    c = refine_cost("compact", q, n_local, budget, bq=bq, bn=bn)
    e = refine_cost("exact", q, n_local, budget, verts=verts)
    return {
        "flops": c["flops"] + e["flops"],
        "bytes_accessed": c["bytes_accessed"] + e["bytes_accessed"],
        "transcendentals": 0,
        "collective_bytes": float(q * shards * (budget + 1) * 4),
    }


def sharded_knn_cost(q: int, n: int, budget: int, k: int, shards: int,
                     verts: int = 0, bq: int = DEFAULT_BQ,
                     bn: int = DEFAULT_BN) -> dict:
    """Per-device cost of the sharded kNN rung (the reference's
    ``sharded_knn_cost``, value for value, on its model of the Pallas
    kernels; see :func:`refine_cost`): the local compact + refine over the
    shard's ``N / shards`` slots, the local top-k over its ``(Q, budget)``
    survivors and the k-merge of the gathered ``(Q, shards * k)`` block;
    ``collective_bytes`` is the all-gather of every shard's ``(Q, k)``
    (distance, id) block and the ``(Q,)`` within-radius counts."""
    n_local = -(-n // max(shards, 1))
    c = refine_cost("compact", q, n_local, budget, bq=bq, bn=bn)
    r = refine_cost("knn", q, budget, k, verts=verts, bq=bq, bn=bn)
    merge_flops = q * shards * k * math.log2(max(shards * k, 2)) * 4.0
    return {
        "flops": c["flops"] + r["flops"] + merge_flops,
        "bytes_accessed": (c["bytes_accessed"] + r["bytes_accessed"]
                           + q * shards * k * 8.0),
        "transcendentals": r["transcendentals"],
        "collective_bytes": float(q * shards * (k * 8 + 4)),
    }
