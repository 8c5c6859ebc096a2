"""Distributed GLIN — the index scaled over a mesh of devices.

Layout (as the reference's):

* the **learned model** (flattened node table, leaf models, leaf MBRs,
  piecewise suffix-min) is tiny and is **replicated**: one copy on every
  distinct device of the mesh;
* the **record table** (sorted Zmin limbs, record MBRs, packed vertex rings)
  is **range-partitioned by slot** over the ``data`` (and ``pod``) mesh
  axes;
* **query batches are split over the ``model`` axis**: each model column
  owns Q / model windows, each data row owns N / shards records, and every
  (shard, model) position evaluates its query x record tile on its own.

One controller: a :class:`Mesh` is a grid of torch devices, and the steps
built here are plain Python functions that run every position's block in
turn from the calling thread — the reference's step is one program over its
mesh driven from one process too, and the facade runs it under its one
lock. Where a position's device is not the merge device (the mesh's first),
its ``(Q / model, k)`` block is copied there: a peer copy between cards, a
no-op on one. Several positions may share a device, but only when the
caller lists them so (:func:`make_mesh`).

On CUDA devices the per-shard compaction runs the ``refine_compact`` kernel
over a per-shard :class:`~repro_torch.kernels.refine.LeafWalk`, and the kNN
step's shard-local top-k and k-merge run the ``knn_topk`` kernel; CPU
tensors take their plain versions, as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import geometry as geom
from .device import (GLINSnapshot, HostCapture, leaf_group_mbrs,
                     lower_bound_in_window, model_window, place, query_keys,
                     snapshot_capture)
from .relations import get_relation
from .zorder import LO_LIMB_SIZE

__all__ = ["Mesh", "make_mesh", "ShardTable", "ShardedTable",
           "shard_glin_arrays", "shard_arrays_from_capture",
           "shard_walk_arrays", "shard_count", "mesh_positions",
           "place_table", "replicate_model", "build_glin_query_step",
           "build_glin_knn_step", "TABLE_KEYS", "glin_input_specs"]

_I32 = torch.int32
_F32 = torch.float32
_NEVER = 2e30          # padding MBR coordinate: intersects/contains nothing

# Slot-ordered record-table keys sharded over the data axes. ``lmbrs`` /
# ``mbrs`` are the slot-aligned leaf / record MBR tables (the sharded
# analogue of the snapshot's ``slot_lmbr`` / ``slot_rmbr``). Vertices travel
# as PER-SHARD POOL SLICES: ``vpool`` is each shard's local CSR vertex pool
# (equal length across shards), ``voff`` the slot-aligned offsets INTO THAT
# LOCAL SLICE, and ``vbucket`` each slot's pow2 width-bucket index — the
# exact-refine stage gathers only the widest surviving bucket's width.
TABLE_KEYS = ("keys_hi", "keys_lo", "recs", "rec_leaf", "lmbrs", "mbrs",
              "vpool", "voff", "vbucket", "nverts", "kinds")

# per-shard pool slices are padded to this slot quantum so append-driven
# growth between publishes rarely changes the sharded table shapes
_POOL_QUANTUM = 1024

_SHARDED_COMPACTIONS = ("scan", "kernel")


# ---------------------------------------------------------------- the mesh
@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of torch devices: ``axis_names`` (e.g. ``("data",
    "model")``), ``sizes`` per axis, and ``flat`` — the devices in row-major
    mesh order. ``shape`` maps each axis to its size and ``devices`` is the
    same-shaped grid, as the reference's mesh has them."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    flat: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        grid = np.empty(len(self.flat), dtype=object)
        grid[:] = list(self.flat)
        return grid.reshape(self.sizes)

    @property
    def merge_device(self) -> torch.device:
        """Where a step's outputs are assembled: the first position's."""
        return self.flat[0]

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.flat))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes``. ``devices`` is a flat list
    in mesh order (strings or ``torch.device``); ``None`` takes the first
    ``prod(shape)`` CUDA cards and raises when there are fewer. Several
    positions share a device only where the list names it several times
    (``["cuda:0"] * 8``, ``["cpu"] * 8``): nothing colocates silently, and
    nothing falls back to the CPU."""
    from .engine import resolve_device

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if len(set(axes)) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {shape} over axes {axes}")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} CUDA cards, {have} found; list "
                "the devices to colocate positions (devices=['cuda:0'] * "
                f"{n}) or to run on the CPU (devices=['cpu'] * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    if len(devs) != n:
        raise ValueError(f"a {shape} mesh takes {n} devices, got {len(devs)}")
    return Mesh(axes, shape, devs)


def _data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def shard_count(mesh: Mesh) -> int:
    """Number of record shards (product of the data/pod axis sizes)."""
    return math.prod(mesh.shape[a] for a in _data_axes(mesh))


def mesh_positions(mesh: Mesh) -> List[Tuple[int, int, torch.device]]:
    """``(shard, model column, device)`` of every position, in mesh order.
    Shard id = ``pod_index * data_size + data_index`` (the reference's
    numbering). A position off index 0 of an axis that is neither a data
    nor the model axis repeats a computation and is left out."""
    names = mesh.axis_names
    if "model" not in names or not _data_axes(mesh):
        raise ValueError(
            f"mesh axes {names} unusable: the sharded steps need a 'model' "
            "axis (query split) and a 'data' and/or 'pod' axis (record "
            "shards)")
    daxes = _data_axes(mesh)
    out = []
    for i, coords in enumerate(np.ndindex(*mesh.sizes)):
        c = dict(zip(names, coords))
        if any(c[a] for a in names if a not in daxes and a != "model"):
            continue
        shard = 0
        for a in daxes:
            shard = shard * mesh.shape[a] + c[a]
        out.append((shard, c["model"], mesh.flat[i]))
    return out


# ------------------------------------------------------------ host tables
def shard_arrays_from_capture(c: HostCapture, num_shards: int,
                              pool_pad_to: int = 0) -> Dict[str, np.ndarray]:
    """Slot-ordered record payloads from a host capture, padded to
    ``num_shards``. Padding slots carry keys maximal in both limbs,
    ``recs == -1`` and ``_NEVER`` MBRs (they intersect and contain nothing),
    so neither prefilter shape can ever pick one up; their vertex pointers
    are inert ``(voff=0, nverts=1)``.

    Each shard's records' rings are gathered into a LOCAL vertex pool in
    slot order; every local pool is padded (zeros) to one common length —
    ``max(tightest shard, pool_pad_to)`` rounded up to ``_POOL_QUANTUM``.
    The caller passes the previous publish's per-shard length as
    ``pool_pad_to`` to keep the table shapes stable across (compacting)
    republishes. Array for array the reference's."""
    keys, recs = c.keys, c.recs
    n = keys.shape[0]
    pad = (-n) % num_shards
    local_n = (n + pad) // num_shards if num_shards else 0
    rec_leaf = np.repeat(np.arange(c.num_leaves, dtype=np.int32),
                         np.diff(c.starts).astype(np.int64))
    lmbrs32 = c.leaf_mbrs.astype(np.float32)
    nvr = c.gs_nverts[recs].astype(np.int64)
    # local CSR offsets: exclusive cumsum of ring widths within each shard
    cnt = np.zeros(n + pad, np.int64)
    cnt[:n] = nvr
    cnt2 = cnt.reshape(num_shards, local_n)
    loc_off = np.zeros((num_shards, local_n), np.int64)
    if local_n > 1:
        np.cumsum(cnt2[:, :-1], axis=1, out=loc_off[:, 1:])
    tight = int(cnt2.sum(axis=1).max()) if num_shards else 0
    plocal = max(tight, pool_pad_to, 1)
    plocal += (-plocal) % _POOL_QUANTUM
    vpool = np.zeros((num_shards * plocal, 2), np.float32)
    total = int(nvr.sum())
    if total:
        pos = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(nvr)[:-1]]), nvr)
        src = np.repeat(c.gs_offsets[recs], nvr) + pos
        loc_flat = loc_off.reshape(-1)
        dst_base = (np.arange(n) // local_n) * plocal + loc_flat[:n]
        vpool[np.repeat(dst_base, nvr) + pos] = \
            c.gs_pool[src].astype(np.float32)
    ladder = 1 << np.arange(31, dtype=np.int64)   # bucket b holds nv <= 2^b
    out = {
        "keys_hi": (keys >> 30).astype(np.int32),
        "keys_lo": (keys & (LO_LIMB_SIZE - 1)).astype(np.int32),
        "recs": recs.astype(np.int32),
        "rec_leaf": rec_leaf,
        "lmbrs": (lmbrs32[rec_leaf] if c.num_leaves
                  else np.empty((0, 4), np.float32)),
        "mbrs": c.gs_mbrs[recs].astype(np.float32),
        "vpool": vpool,
        "voff": loc_off.reshape(-1)[:n].astype(np.int32),
        "vbucket": np.searchsorted(ladder, nvr).astype(np.int32),
        "nverts": c.gs_nverts[recs].astype(np.int32),
        "kinds": c.gs_kinds[recs].astype(np.int32),
    }
    if pad:
        never = np.full((pad, 4), _NEVER, np.float32)
        # pad keys must be the MAXIMAL key in BOTH limbs: a real corner
        # record can carry hi == 2^30-1 with lo > 0, and a (hi, 0) pad
        # appended after it would break the shard-local sort order the
        # bounded binary search relies on
        out["keys_hi"] = np.concatenate(
            [out["keys_hi"], np.full(pad, 2**30 - 1, np.int32)])
        out["keys_lo"] = np.concatenate(
            [out["keys_lo"], np.full(pad, LO_LIMB_SIZE - 1, np.int32)])
        out["recs"] = np.concatenate([out["recs"], np.full(pad, -1, np.int32)])
        out["rec_leaf"] = np.concatenate(
            [out["rec_leaf"], np.zeros(pad, np.int32)])
        out["lmbrs"] = np.concatenate([out["lmbrs"], never])
        out["mbrs"] = np.concatenate([out["mbrs"], never])
        out["voff"] = np.concatenate([out["voff"], np.zeros(pad, np.int32)])
        out["vbucket"] = np.concatenate(
            [out["vbucket"], np.zeros(pad, np.int32)])
        out["nverts"] = np.concatenate([out["nverts"], np.ones(pad, np.int32)])
        out["kinds"] = np.concatenate([out["kinds"], np.zeros(pad, np.int32)])
    return out


def shard_glin_arrays(glin, num_shards: int) -> Dict[str, np.ndarray]:
    """``shard_arrays_from_capture`` over a fresh capture of the live index."""
    return shard_arrays_from_capture(snapshot_capture(glin), num_shards)


def shard_walk_arrays(table_np: Dict[str, np.ndarray], shard: int,
                      num_shards: int) -> Dict[str, np.ndarray]:
    """Shard ``shard``'s walk tables (numpy ``rec_leaf``, ``leaf_start``,
    ``leaf_mbr``) from the sharded table, re-based to its slots.

    Its leaves are the global leaves that hold one of its real slots, in
    order, each clipped to the shard; a leaf straddling two shards appears
    on both sides with its global MBR (still exact:
    ``lmbrs[s] == leaf_mbr[rec_leaf[s]]`` on every slot). One sentinel leaf
    with ``_NEVER`` rows holds the padding slots (the reference's padding
    has ``rec_leaf == 0``, which would break the walk's non-decreasing
    ``rec_leaf``); it is empty where the shard has none."""
    local_n = table_np["recs"].shape[0] // num_shards
    sl = slice(shard * local_n, (shard + 1) * local_n)
    recs, rl = table_np["recs"][sl], table_np["rec_leaf"][sl]
    nreal = int(np.count_nonzero(recs >= 0))
    if (recs[nreal:] >= 0).any():
        raise ValueError("padding slots must follow every real slot")
    real = rl[:nreal]
    first = np.flatnonzero(np.concatenate([[True], real[1:] != real[:-1]])) \
        if nreal else np.empty(0, np.int64)
    rec_leaf = np.full(local_n, first.shape[0], np.int32)
    if nreal:
        rec_leaf[:nreal] = np.cumsum(np.concatenate(
            [[0], (real[1:] != real[:-1]).astype(np.int32)]))
    leaf_start = np.concatenate([first, [nreal, local_n]]).astype(np.int32)
    leaf_mbr = np.concatenate([table_np["lmbrs"][sl][first],
                               np.full((1, 4), _NEVER, np.float32)])
    return {"rec_leaf": rec_leaf, "leaf_start": leaf_start,
            "leaf_mbr": leaf_mbr.astype(np.float32)}


# -------------------------------------------------------------- placement
@dataclasses.dataclass(frozen=True)
class ShardTable:
    """One record shard's tables on one device (:data:`TABLE_KEYS`, local
    slot order), its walk and its first global slot."""

    keys_hi: torch.Tensor
    keys_lo: torch.Tensor
    recs: torch.Tensor
    rec_leaf: torch.Tensor
    lmbrs: torch.Tensor
    mbrs: torch.Tensor
    vpool: torch.Tensor
    voff: torch.Tensor
    vbucket: torch.Tensor
    nverts: torch.Tensor
    kinds: torch.Tensor
    walk: "object"            # kernels.refine.LeafWalk over the shard
    offset: int               # global slot of local slot 0

    @property
    def local_n(self) -> int:
        return self.keys_hi.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   [getattr(self, k) for k in TABLE_KEYS] + list(self.walk))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTable:
    """The record table placed for a mesh: each shard uploaded once per
    distinct device that holds one of its positions (model columns on one
    device share it)."""

    local_n: int
    tables: Dict[Tuple[int, torch.device], ShardTable]

    def at(self, shard: int, device: torch.device) -> ShardTable:
        return self.tables[(shard, device)]


def place_table(table_np: Dict[str, np.ndarray], mesh: Mesh) -> ShardedTable:
    """Upload a :func:`shard_arrays_from_capture` table for ``mesh``, with
    each shard's walk (:func:`shard_walk_arrays`; group rows by
    ``core.device.leaf_group_mbrs``)."""
    from ..kernels.refine import LeafWalk

    shards = shard_count(mesh)
    local_n = table_np["recs"].shape[0] // shards
    plocal = table_np["vpool"].shape[0] // shards
    tables = {}
    for shard, _, dev in mesh_positions(mesh):
        if (shard, dev) in tables:
            continue
        sl = slice(shard * local_n, (shard + 1) * local_n)
        cols = {k: torch.from_numpy(np.ascontiguousarray(
                    table_np[k][sl] if k != "vpool"
                    else table_np[k][shard * plocal:(shard + 1) * plocal]))
                .to(dev) for k in TABLE_KEYS}
        w = shard_walk_arrays(table_np, shard, shards)
        lm = torch.from_numpy(w["leaf_mbr"]).to(dev)
        ls = torch.from_numpy(w["leaf_start"]).to(dev)
        walk = LeafWalk(torch.from_numpy(w["rec_leaf"]).to(dev), ls, lm,
                        leaf_group_mbrs(lm, ls))
        tables[(shard, dev)] = ShardTable(**cols, walk=walk,
                                          offset=shard * local_n)
    return ShardedTable(local_n, tables)


def replicate_model(snap: GLINSnapshot, mesh: Mesh
                    ) -> Dict[torch.device, GLINSnapshot]:
    """The model-only snapshot (record-level arrays stripped to one-element
    stand-ins: the sharded steps never read them) once on each distinct
    device of ``mesh``, through ``core.device.place``."""
    dev = snap.device
    tiny_i = torch.zeros(1, dtype=_I32, device=dev)
    tiny_f = torch.zeros((1, 4), dtype=_F32, device=dev)
    model_only = dataclasses.replace(
        snap, keys_hi=tiny_i, keys_lo=tiny_i, recs=tiny_i, rec_leaf=tiny_i,
        slot_lmbr=tiny_f, slot_rmbr=tiny_f)
    return {d: place(model_only, d) for d in mesh.distinct_devices()}


# ----------------------------------------------------------------- steps
def _check_step_args(compaction: str, max_width: int) -> None:
    if compaction not in _SHARDED_COMPACTIONS:
        raise ValueError(f"unsupported sharded compaction {compaction!r} "
                         "(use 'scan' or 'kernel')")
    if max_width < 1 or (max_width & (max_width - 1)):
        raise ValueError(f"max_width must be a power of two, got {max_width}")


def _windows_tensor(windows) -> torch.Tensor:
    w = torch.as_tensor(windows)
    if w.dtype != _F32 or w.dim() != 2 or w.shape[1] != 4:
        raise ValueError(f"windows must be (Q, 4) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    return w


def _blocks(w: torch.Tensor, mesh: Mesh, positions) -> Tuple[int, dict]:
    """Each model column's window block on each device that needs it."""
    m = mesh.shape["model"]
    q = w.shape[0]
    if q % m:
        raise ValueError(f"{q} windows do not split over a model axis of {m} "
                         "(pad the batch to a multiple)")
    qb = q // m
    blocks = {}
    for _, col, dev in positions:
        if (col, dev) not in blocks:
            blocks[(col, dev)] = w[col * qb:(col + 1) * qb].to(dev)
    return qb, blocks


def _local_bounds(snap: GLINSnapshot, windows: torch.Tensor, t: ShardTable,
                  relation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each window's run [lstart, lend) in the shard's local slots: the
    model predicts a GLOBAL window, clipped by the shard offset, and the
    final search runs on the LOCAL key shard (clipping makes out-of-shard
    answers land on the shard edge, which is exactly the local lower
    bound)."""
    zmin_hi, zmin_lo, ub_hi, ub_lo = query_keys(snap, windows, relation)
    n = t.local_n

    def local_lb(q_hi, q_lo):
        lo_g, hi_g = model_window(snap, q_hi, q_lo)
        lo_l = torch.clamp(lo_g - t.offset, 0, n)
        hi_l = torch.clamp(hi_g - t.offset, 0, n)
        return lower_bound_in_window(t.keys_hi, t.keys_lo, q_hi, q_lo, lo_l,
                                     hi_l, snap.search_steps + 2)

    return local_lb(zmin_hi, zmin_lo), local_lb(ub_hi, ub_lo)


def _select(rel, windows, probe_w, t: ShardTable, lstart, lend, cap: int,
            kb: int, compaction: str):
    """Stage 1 at budget ``kb`` > 0: ``(slots (Q, kb) local, -1 padded,
    surv (Q,), overflow (Q,) bool)``; ``surv`` is the need the overflow
    code carries (the survivors, or the local run length when a scan's run
    outgrew ``cap``)."""
    from ..kernels import refine as kref

    if compaction == "kernel":
        bounds = torch.stack([lstart, lend], dim=1)
        slots, surv = kref.refine_compact(
            probe_w, bounds, t.lmbrs, t.mbrs, budget=kb,
            prefilter=rel.prefilter_kind, leaves=t.walk)
        return slots, surv, surv > kb
    q = windows.shape[0]
    dev = windows.device
    pos = lstart[:, None] + torch.arange(cap, dtype=_I32, device=dev)
    valid = pos < torch.minimum(lend, lstart + cap)[:, None]
    posc = torch.clamp(pos, max=t.local_n - 1)
    # no leaf-MBR gather: padded slots sit at _NEVER and every record MBR
    # lies inside its leaf's aggregate MBR, so the record prefilter implies
    # the leaf test
    rec_ok = rel.mbr_prefilter(t.mbrs[posc], windows[:, None, :])
    mask = valid & rec_ok
    m32 = mask.to(_I32)
    excl = torch.cumsum(m32, dim=1, dtype=_I32) - m32
    col = torch.where(mask & (excl < kb), excl, kb)
    slots = torch.full((q, kb + 1), -1, dtype=_I32, device=dev).scatter_(
        1, col.to(torch.int64), posc)[:, :kb]
    surv = m32.sum(dim=1, dtype=_I32)
    runlen = lend - lstart
    run_over = runlen > cap
    # run overflow reports the local run length (> cap, so the caller can
    # tell it from a survivor count <= cap)
    return slots, torch.where(run_over, runlen, surv), run_over | (surv > kb)


def _dense_slots(rel, windows, probe_w, t: ShardTable, lstart, lend,
                 cap: int, leaf_test: bool):
    """The dense (Q, cap) candidate block: ``(posc, mask)``."""
    dev = windows.device
    pos = lstart[:, None] + torch.arange(cap, dtype=_I32, device=dev)
    valid = pos < torch.minimum(lend, lstart + cap)[:, None]
    posc = torch.clamp(pos, max=t.local_n - 1)
    mask = valid & rel.mbr_prefilter(t.mbrs[posc], windows[:, None, :])
    if leaf_test:
        # leaf pruning uses the padded probe window (dwithin); the record
        # prefilter pads internally and the predicate sees the raw window
        mask = mask & geom.mbr_intersects(t.lmbrs[posc], probe_w[:, None, :])
    return posc, mask


def _over_pods(fn, windows, t: ShardTable, slots, sel, fill):
    """``fn`` over the selected local slots, rings gathered from the
    shard-local pool at the widest surviving bucket's width."""
    return geom.map_over_pods(fn, windows, t.vpool, t.voff, t.nverts,
                              t.kinds, t.vbucket, slots, sel, fill)


def build_glin_query_step(mesh: Mesh, relation: str = "intersects",
                          cap: int = 512, exact_budget: int = 0,
                          compaction: str = "scan", max_width: int = 64):
    """The sharded window step for ``mesh``:
    ``step(snaps, windows, table) -> (hits, counts)``.

    ``snaps`` is :func:`replicate_model`'s dict (the model on each device),
    ``windows`` (Q, 4) float32 with Q a multiple of the model axis,
    ``table`` a :class:`ShardedTable`. On the merge device:

      hits  (Q, n_data_shards, K) int32 — -1 padded global record ids,
            K = ``exact_budget`` when two-stage refinement is on, else
            ``cap``
      counts(Q, n_data_shards)     int32 — per-shard hit counts

    ``exact_budget`` in (0, cap) runs probe -> compact -> exact refine PER
    SHARD: stage 1 tests the shard's slot-aligned MBR tables and compacts
    the survivors to ``(Q, exact_budget)`` local slots; stage 2 gathers
    rings and runs the exact predicate on those survivors only. Overflow is
    encoded per shard as ``-(need) - 1``: the local run length when a scan's
    run outgrew ``cap`` (the kernel walks the whole local run and has no
    cap), else the survivor count — ``core.exec.OverflowLadder.
    on_sharded_overflow`` consumes it. ``compaction`` is ``"scan"`` (the
    cumsum + scatter reference) or ``"kernel"`` (``refine_compact`` over
    the shard's walk). ``exact_budget == 0`` is the dense single-stage
    path. ``max_width`` is the power-of-two top of the width ladder
    (validated; the gather takes the widest surviving bucket)."""
    rel = get_relation(relation)
    if not rel.device_native:
        raise ValueError(f"relation {relation!r} is not device-native; shard "
                         f"its base relation {rel.base_name()!r} instead")
    _check_step_args(compaction, max_width)
    if exact_budget and compaction == "kernel" \
            and rel.prefilter_kind == "custom":
        raise ValueError(
            f"relation {relation!r} has a custom MBR prefilter; the compact "
            "kernel cannot evaluate it — use compaction='scan'")
    kb = exact_budget if 0 < exact_budget < cap else 0
    positions = mesh_positions(mesh)
    nshards = shard_count(mesh)
    pred = rel.device_predicate

    def local_step(snap, windows, t):
        lstart, lend = _local_bounds(snap, windows, t, relation)
        probe_w = rel.probe_window(windows).contiguous()
        if kb:
            slots, surv, overflow = _select(rel, windows, probe_w, t, lstart,
                                            lend, cap, kb, compaction)
            taken = slots >= 0
            slotc = torch.clamp(slots, min=0)
            rec = torch.where(taken, t.recs[slotc], -1)
            exact = _over_pods(pred, windows, t, slotc, taken, False)
            fmask = taken & exact & (rec >= 0)
            hits = torch.where(fmask, rec, -1)
            counts = fmask.sum(dim=1, dtype=_I32)
            return hits, torch.where(overflow, -surv - 1, counts)
        # dense single-stage path (exact_budget == 0)
        posc, mask = _dense_slots(rel, windows, probe_w, t, lstart, lend,
                                  cap, leaf_test=True)
        mask = mask & _over_pods(pred, windows, t, posc, mask, False)
        rec = t.recs[posc]
        mask = mask & (rec >= 0)
        hits = torch.where(mask, rec, -1)
        counts = mask.sum(dim=1, dtype=_I32)
        runlen = lend - lstart
        # truncation signal carries the local run length (the needed cap)
        return hits, torch.where(runlen > cap, -runlen - 1, counts)

    def step(snaps, windows, table: ShardedTable):
        w = _windows_tensor(windows)
        qb, blocks = _blocks(w, mesh, positions)
        merge = mesh.merge_device
        q = w.shape[0]
        hits = torch.full((q, nshards, kb or cap), -1, dtype=_I32,
                          device=merge)
        counts = torch.zeros((q, nshards), dtype=_I32, device=merge)
        if qb:
            for shard, col, dev in positions:
                h, c = local_step(snaps[dev], blocks[(col, dev)],
                                  table.at(shard, dev))
                rows = slice(col * qb, (col + 1) * qb)
                hits[rows, shard] = h.to(merge)
                counts[rows, shard] = c.to(merge)
        return hits, counts

    return step


def build_glin_knn_step(mesh: Mesh, relation: str, k: int, cap: int = 512,
                        exact_budget: int = 0, compaction: str = "scan",
                        max_width: int = 64, topk: str = "kernel"):
    """Device-complete sharded kNN: shard-local top-k + cross-shard k-merge.
    ``relation`` must be a bound ``dwithin:<r>`` (the probe radius rides on
    ``rel.probe_pad``).

    step(snaps, windows, table) -> (ids, dists, counts), as the window
    step takes them, on the merge device:
      ids   (Q, k) int32   — merged global record ids, ascending
                             (distance, id), -1 past the candidate count
      dists (Q, k) float32 — matching exact point-to-geometry distances
      counts(Q, n_data_shards) int32 — per-shard within-radius candidate
                             counts; negative = the shard's overflow signal
                             (the window step's encoding)

    Each position selects its dwithin candidates as the window step does,
    computes exact SQUARED distances from its local vertex pool at the
    widest surviving width bucket, and takes its own ``(Q / model, k)`` top-k
    by ascending ``(d2, global id)`` — candidate sets never leave their
    shard. The merge concatenates the blocks shard-major on the merge device
    (a copy per block where a position sits on another card) and a second
    top-k takes the global k. ``topk`` picks both top-ks: ``"kernel"``
    (``kernels.knn.knn_topk``) or ``"sort"`` (its plain two-key sort).

    The within-radius counts compare in squared form — exactly the dwithin
    predicate's test — so the caller's settlement rule (done once the summed
    counts reach k) never over-counts. Snapshot records only: the caller
    republishes a stale snapshot first."""
    from ..kernels import knn as kknn

    rel = get_relation(relation)
    if not relation.startswith("dwithin:") or rel.parametric:
        raise ValueError(f"knn step needs a bound dwithin relation, got "
                         f"{relation!r}")
    _check_step_args(compaction, max_width)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if topk not in ("kernel", "sort"):
        raise ValueError(f"unknown top-k {topk!r} (use 'kernel' or 'sort')")
    # squared in fp64, then cast: the reference's float32(float(r) ** 2)
    r2 = float(np.float32(float(rel.probe_pad) ** 2))
    kb = exact_budget if 0 < exact_budget < cap else 0
    positions = mesh_positions(mesh)
    nshards = shard_count(mesh)
    inf = float("inf")

    def top(d, ids, kk):
        # looked up at call time, as core.device's rank does
        fn = kknn.knn_topk if topk == "kernel" else kknn.knn_topk_plain
        return fn(d, ids, kk)

    def local_step(snap, windows, t):
        lstart, lend = _local_bounds(snap, windows, t, relation)
        probe_w = rel.probe_window(windows).contiguous()
        qn = windows.shape[0]
        if kb:
            slots, surv, overflow = _select(rel, windows, probe_w, t, lstart,
                                            lend, cap, kb, compaction)
        else:
            # dense selection: every in-run slot passing the
            # (radius-padded) record-MBR prefilter is a candidate
            posc, mask = _dense_slots(rel, windows, probe_w, t, lstart, lend,
                                      cap, leaf_test=False)
            slots = torch.where(mask, posc, -1)
            surv = lend - lstart
            overflow = surv > cap
        taken = slots >= 0
        slotc = torch.clamp(slots, min=0)
        rec = torch.where(taken, t.recs[slotc], -1)
        ok = taken & (rec >= 0)
        d2 = _over_pods(geom.rect_geom_sqdist_torch, windows, t, slotc, ok,
                        inf)
        d2 = torch.where(ok, d2, inf)
        idv = torch.where(ok, rec, kknn.ID_PAD)
        r2t = torch.tensor(r2, dtype=_F32, device=windows.device)
        within = (d2 <= r2t).sum(dim=1, dtype=_I32)
        counts = torch.where(overflow, -surv - 1, within)
        if d2.shape[1] < k:               # k > budget: pad the sort columns
            padw = k - d2.shape[1]
            d2 = torch.cat([d2, torch.full((qn, padw), inf, dtype=_F32,
                                           device=d2.device)], dim=1)
            idv = torch.cat([idv, torch.full((qn, padw), kknn.ID_PAD,
                                             dtype=_I32, device=d2.device)],
                            dim=1)
        d2k, idk = top(d2.contiguous(), idv.contiguous(), k)
        return d2k, idk, counts

    def step(snaps, windows, table: ShardedTable):
        w = _windows_tensor(windows)
        qb, blocks = _blocks(w, mesh, positions)
        merge = mesh.merge_device
        q = w.shape[0]
        d2b = torch.full((q, nshards, k), inf, dtype=_F32, device=merge)
        idb = torch.full((q, nshards, k), kknn.ID_PAD, dtype=_I32,
                         device=merge)
        counts = torch.zeros((q, nshards), dtype=_I32, device=merge)
        if qb:
            for shard, col, dev in positions:
                d2k, idk, c = local_step(snaps[dev], blocks[(col, dev)],
                                         table.at(shard, dev))
                rows = slice(col * qb, (col + 1) * qb)
                d2b[rows, shard] = d2k.to(merge)
                idb[rows, shard] = idk.to(merge)
                counts[rows, shard] = c.to(merge)
        # the k-merge: the (shards, k) blocks of a row side by side,
        # shard-major, and the global k by (distance, id)
        d2s, idss = top(d2b.reshape(q, nshards * k),
                        idb.reshape(q, nshards * k), k)
        dists = torch.sqrt(torch.clamp(d2s, min=0.0))
        return torch.where(torch.isinf(d2s), -1, idss), dists, counts

    return step


def glin_input_specs(num_records: int, num_queries: int, mesh: Mesh,
                     num_leaves: int = 1 << 20, num_nodes: int = 1 << 14,
                     num_pieces: int = 1 << 12, max_verts: int = 12,
                     fanout: int = 64, pool_slots: int = 0):
    """(shape, dtype) stand-ins of a sharded query step's inputs, nothing
    allocated (the reference's ``glin_input_specs``, its sizes): (a
    :class:`~.device.GLINSnapshot` of (shape, dtype) pairs with its
    scalars, the windows, the record table {key: (shape, dtype)} of
    :data:`TABLE_KEYS`). The defaults size a 2^30-record production index:
    the model tables are small and replicated (the snapshot's record-level
    arrays are one element: the records travel in the table, which splits
    over the data axes); ``pool_slots``, the vertex pool over every shard,
    defaults to ``num_records * (max_verts + 1) // 2`` (the pool stores the
    mean ring width, not the widest). ``mesh`` is the reference's argument;
    the shapes do not depend on it."""
    i32, f32 = _I32, _F32
    nl, nn, npc = num_leaves, num_nodes, num_pieces
    snap = GLINSnapshot(
        keys_hi=((1,), i32), keys_lo=((1,), i32), recs=((1,), i32),
        rec_leaf=((1,), i32), slot_lmbr=((1, 4), f32),
        slot_rmbr=((1, 4), f32),
        leaf_start=((nl + 1,), i32), leaf_dlo_hi=((nl + 1,), i32),
        leaf_dlo_lo=((nl + 1,), i32), leaf_mbr=((nl, 4), f32),
        leaf_k0_hi=((nl,), i32), leaf_k0_lo=((nl,), i32),
        leaf_slope=((nl,), f32), leaf_icpt=((nl,), f32),
        node_dlo_hi=((nn,), i32), node_dlo_lo=((nn,), i32),
        node_scale=((nn,), f32), node_fanout=((nn,), i32),
        node_child_base=((nn,), i32), child_codes=((nn * fanout,), i32),
        pw_zmax_hi=((npc,), i32), pw_zmax_lo=((npc,), i32),
        pw_sufmin_hi=((npc,), i32), pw_sufmin_lo=((npc,), i32),
        search_steps=8, depth=4, grid_x0=-180.0, grid_y0=-90.0,
        grid_cell=5e-7)
    windows = ((num_queries, 4), f32)
    if not pool_slots:
        pool_slots = num_records * (max_verts + 1) // 2
    n = num_records
    table = {"keys_hi": ((n,), i32), "keys_lo": ((n,), i32),
             "recs": ((n,), i32), "rec_leaf": ((n,), i32),
             "lmbrs": ((n, 4), f32), "mbrs": ((n, 4), f32),
             "vpool": ((pool_slots, 2), f32), "voff": ((n,), i32),
             "vbucket": ((n,), i32), "nverts": ((n,), i32),
             "kinds": ((n,), i32)}
    return snap, windows, table
