"""Device-resident GLIN: flattened snapshot + batched torch query path.

The host tree is flattened into struct-of-arrays form and thousands of query
windows are probed *simultaneously* with tensor ops on one device:

* model traversal  — bounded loop of gathers over the flattened node table
  (equal-width routing in re-centred fp32; exactness restored by a ±2 leaf
  fix-up against integer leaf-domain boundaries);
* leaf search      — fp32 linear model prediction + fixed-trip binary search
  whose window is the *device-side* max model error (recomputed in fp32 at
  snapshot time so the fp64→fp32 drop can never shrink the window);
* refinement       — leaf-MBR skip, record-MBR mask, compaction of the
  survivors and exact-shape checks over width-bucketed vertex pods, either
  as plain tensor code or through the CUDA kernels of ``kernels.refine``;
* kNN              — CDF-seeded radii read off the model, exact squared
  distances over the survivors' pods and a (distance, id) top-k
  (``kernels.knn``), so only the (Q, k) result leaves the device;
* delta            — the records inserted since the last publish as a small
  Zmin-sorted side table (:class:`DeltaTable`), checked against a window
  batch (``batch_check_added``) and merged into the kNN rank.

Z-addresses are (hi, lo) int32 limb pairs throughout — no 64-bit integers in
the probe. Every tensor lives on the snapshot's device; the same functions
run on the CPU (tests) and on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import geometry as geom
from .model import InternalNode, LeafNode
from .relations import get_relation
from .zorder import (LO_LIMB_SIZE, ZGrid, mbr_to_zinterval_hilo,
                     split_hilo_np, z_less_hilo)

__all__ = ["GLINSnapshot", "HostCapture", "VertexPods", "pack_pods",
           "pods_from_store", "pods_from_numpy", "snapshot_capture",
           "snapshot_arrays", "snapshot_from_capture", "snapshot_from_host",
           "snapshot_from_numpy", "place", "leaf_group_mbrs", "batch_probe",
           "batch_query_bounds",
           "batch_query", "batch_query_fused", "DeltaTable",
           "delta_table_from_host", "batch_check_added", "knn_seed_radii",
           "batch_knn_rank", "input_specs_like"]

_I32 = torch.int32
_F32 = torch.float32
_INF_HI = 2**30  # > any valid 30-bit limb
# snapshot tensor fields and their dtypes (float fields are fp32 tables)
SNAPSHOT_FIELDS = {
    "keys_hi": _I32, "keys_lo": _I32, "recs": _I32, "rec_leaf": _I32,
    "slot_lmbr": _F32, "slot_rmbr": _F32,
    "leaf_start": _I32, "leaf_dlo_hi": _I32, "leaf_dlo_lo": _I32,
    "leaf_mbr": _F32, "leaf_k0_hi": _I32, "leaf_k0_lo": _I32,
    "leaf_slope": _F32, "leaf_icpt": _F32,
    "node_dlo_hi": _I32, "node_dlo_lo": _I32, "node_scale": _F32,
    "node_fanout": _I32, "node_child_base": _I32, "child_codes": _I32,
    "pw_zmax_hi": _I32, "pw_zmax_lo": _I32, "pw_sufmin_hi": _I32,
    "pw_sufmin_lo": _I32,
}
SNAPSHOT_META = ("search_steps", "depth", "grid_x0", "grid_y0", "grid_cell")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class GLINSnapshot:
    """Flattened GLIN index as device tensors."""

    # sorted record table
    keys_hi: torch.Tensor      # (N,) int32
    keys_lo: torch.Tensor      # (N,) int32
    recs: torch.Tensor         # (N,) int32 record ids
    rec_leaf: torch.Tensor     # (N,) int32 leaf id of each slot
    # slot-aligned fp32 MBR tables (built once per publish): the refinement
    # mask streams these directly instead of chaining
    # leaf_mbr[rec_leaf[slot]] / mbrs[recs[slot]] gathers per query
    slot_lmbr: torch.Tensor    # (N, 4) float32 leaf MBR of each slot
    slot_rmbr: torch.Tensor    # (N, 4) float32 record MBR of each slot
    # leaf tables (L leaves; +1 sentinel on boundaries)
    leaf_start: torch.Tensor   # (L+1,) int32 slot offsets
    leaf_dlo_hi: torch.Tensor  # (L+1,) int32 leaf domain lower bounds
    leaf_dlo_lo: torch.Tensor  # (L+1,) int32
    leaf_mbr: torch.Tensor     # (L, 4) float32 aggregate MBRs
    leaf_k0_hi: torch.Tensor   # (L,) int32 model re-centring key
    leaf_k0_lo: torch.Tensor   # (L,) int32
    leaf_slope: torch.Tensor   # (L,) float32
    leaf_icpt: torch.Tensor    # (L,) float32
    # flattened internal nodes
    node_dlo_hi: torch.Tensor  # (M,) int32
    node_dlo_lo: torch.Tensor  # (M,) int32
    node_scale: torch.Tensor   # (M,) float32  fanout / domain-width
    node_fanout: torch.Tensor  # (M,) int32
    node_child_base: torch.Tensor  # (M,) int32 into child_codes
    child_codes: torch.Tensor  # (C,) int32  >=0: internal node id; <0: -(leaf+1)
    # piecewise augmentation (suffix-min form)
    pw_zmax_hi: torch.Tensor   # (P,) int32
    pw_zmax_lo: torch.Tensor   # (P,) int32
    pw_sufmin_hi: torch.Tensor  # (P,) int32
    pw_sufmin_lo: torch.Tensor  # (P,) int32
    # scalar meta: fixed trip counts and the quantization grid
    search_steps: int
    depth: int
    grid_x0: float
    grid_y0: float
    grid_cell: float

    @property
    def num_slots(self) -> int:
        return self.keys_hi.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.leaf_mbr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys_hi.device

    # Derived tables of the refine kernels, packed on first use and kept for
    # the snapshot's life (one publish), never per batch. They are not
    # SNAPSHOT_FIELDS: a snapshot carried from elsewhere derives them too.
    @functools.cached_property
    def fused_operands(self) -> Tuple[torch.Tensor, ...]:
        """The fused kernel's model tables (:func:`_fused_operands`)."""
        return _fused_operands(self)

    @functools.cached_property
    def leaf_walk(self):
        """The count, compact and fused kernels' walk tables
        (``kernels.refine.LeafWalk``), with the group rows of
        :func:`leaf_group_mbrs`."""
        from ..kernels.refine import LeafWalk

        return LeafWalk(self.rec_leaf, self.leaf_start, self.leaf_mbr,
                        leaf_group_mbrs(self.leaf_mbr, self.leaf_start))


# leaves per group row of the refine kernels' walk (the warp width)
LEAF_GROUP = 32


def leaf_group_mbrs(leaf_mbr: torch.Tensor,
                    leaf_start: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(L, 4) f32 leaf MBRs -> (ceil(L / 32), 4) f32 group rows: row g is
    the min/max union of the MBRs of leaves [32 g, 32 g + 32) that hold a
    slot (``leaf_start[l] < leaf_start[l + 1]``; every leaf when
    ``leaf_start`` is None, as in slot-as-leaf mode).

    Exact in fp32 (min and max select, they never round), so a window the
    row misses meets none of its leaves. Empty leaves are left out, whatever
    their rows hold, and so is every NaN coordinate: a leaf with one meets
    no window, since the meets test compares all four. A group with no such
    leaf gets (+inf, +inf, -inf, -inf), which meets nothing."""
    n = leaf_mbr.shape[0]
    g = -(-n // LEAF_GROUP)
    keep = torch.ones((n, 1), dtype=torch.bool, device=leaf_mbr.device)
    if leaf_start is not None:
        keep = (leaf_start[1:n + 1] > leaf_start[:n])[:, None]
    lo, hi = leaf_mbr[:, :2], leaf_mbr[:, 2:]
    lo = torch.where(keep & ~torch.isnan(lo), lo, float("inf"))
    hi = torch.where(keep & ~torch.isnan(hi), hi, float("-inf"))
    pad = g * LEAF_GROUP - n
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=float("-inf"))
    return torch.cat([lo.view(g, LEAF_GROUP, 2).amin(dim=1),
                      hi.view(g, LEAF_GROUP, 2).amax(dim=1)], dim=1)


def snapshot_from_numpy(fields: dict, meta: dict, device) -> GLINSnapshot:
    """Build a snapshot from numpy copies of its tables (``fields``: every
    name of :data:`SNAPSHOT_FIELDS`; ``meta``: :data:`SNAPSHOT_META`) — how
    a snapshot learned elsewhere, e.g. by the reference package, is carried
    onto a device."""
    return GLINSnapshot(
        **{k: _tensor(fields[k], dt, device)
           for k, dt in SNAPSHOT_FIELDS.items()},
        search_steps=int(meta["search_steps"]), depth=int(meta["depth"]),
        grid_x0=float(meta["grid_x0"]), grid_y0=float(meta["grid_y0"]),
        grid_cell=float(meta["grid_cell"]))


# ---------------------------------------------------------------------------
# Width-bucketed vertex pods (device half of the CSR vertex pool)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VertexPods:
    """Device-resident ragged geometry: one flat fp32 vertex pod pool plus
    per-record ``(off, nv)`` CSR addressing.

    Records are grouped by pow2 vertex-count bucket and each record's ring
    is padded (with its last valid vertex) to its bucket width, so every
    bucket is a contiguous run of equal-width, slot-aligned pods. Pod memory
    is <= 2x the tight ring total — independent of the widest geometry in
    the store.

    The exact-refine stage gathers survivors at the widest bucket PRESENT in
    the batch, not at the global max width: a batch of point/polyline
    survivors never pays a 64-vertex gather because one wide ring exists
    somewhere in the store. The CUDA kernel walks exactly ``nv`` vertices
    per record and decides the same.
    """

    pool: torch.Tensor    # (P, 2) float32 bucket-grouped padded pods
    off: torch.Tensor     # (N,) int32 pod start of each record
    nv: torch.Tensor      # (N,) int32 valid vertices of each record
    kd: torch.Tensor      # (N,) int32 GeomKind of each record
    bucket: torch.Tensor  # (N,) int32 pow2 bucket index (width = 1 << bucket)
    max_width: int        # pow2 width ceiling; buckets are 1 << (0..log2)

    @property
    def num_records(self) -> int:
        return self.off.shape[0]

    @property
    def num_buckets(self) -> int:
        return int(math.log2(self.max_width)) + 1

    @functools.cached_property
    def headers(self) -> torch.Tensor:
        """(N, 4) int32 ``[off, nv, kind, bucket]``: the fused kernel's pod
        headers, stacked once per payload."""
        return torch.stack([self.off, self.nv, self.kd, self.bucket], dim=1)


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def pack_pods(pool: np.ndarray, offsets: np.ndarray, nverts: np.ndarray,
              kinds: np.ndarray, *, pad_records_to: int = 0,
              pool_pad_to: int = 0, max_width: int = 0,
              dtype=np.float32) -> dict:
    """Pack host CSR rings into the bucket-grouped pod layout (numpy).

    Returns ``{"pool", "off", "nv", "kd", "bucket", "max_width"}``; arrays
    are numpy so callers control the upload (replicated payload, per-shard
    slices, tests). Records beyond ``len(nverts)`` (up to ``pad_records_to``)
    are inert: ``off=0, nv=1, bucket=0`` — in-bounds reads, masked upstream.
    ``max_width`` forces a wider static ladder than the data needs (sticky
    jit-signature floors); ``pool_pad_to`` likewise floors the pod count.
    """
    nverts = np.asarray(nverts, np.int64)
    n = nverts.shape[0]
    maxw = _pow2ceil(max(int(nverts.max()) if n else 1, 1))
    if max_width:
        if max_width != _pow2ceil(max_width):
            raise ValueError(f"max_width must be a power of 2, got {max_width}")
        maxw = max(maxw, int(max_width))
    ladder = 1 << np.arange(int(math.log2(maxw)) + 1, dtype=np.int64)
    bucket = np.searchsorted(ladder, nverts).astype(np.int32)
    widths = ladder[bucket]
    order = np.argsort(bucket, kind="stable")   # bucket-grouped, stable
    w_seq = widths[order]
    start_seq = np.zeros(n, np.int64)
    if n:
        np.cumsum(w_seq[:-1], out=start_seq[1:])
    total = int(w_seq.sum())
    p = max(total, int(pool_pad_to), 1)
    pod = np.zeros((p, 2), dtype)
    if total:
        lane = np.arange(total) - np.repeat(start_seq, w_seq)
        src_rec = np.repeat(order, w_seq)
        src = (np.asarray(offsets, np.int64)[src_rec]
               + np.minimum(lane, nverts[src_rec] - 1))
        pod[:total] = pool[src]
    m = max(n, int(pad_records_to))
    off = np.zeros(m, np.int32)
    nv = np.ones(m, np.int32)
    kd = np.zeros(m, np.int32)
    bk = np.zeros(m, np.int32)
    off[order] = start_seq.astype(np.int32)
    nv[:n] = nverts
    kd[:n] = np.asarray(kinds)
    bk[:n] = bucket
    return {"pool": pod, "off": off, "nv": nv, "kd": kd, "bucket": bk,
            "max_width": maxw}


def pods_from_numpy(p: dict, device) -> VertexPods:
    """Upload a :func:`pack_pods` dict (numpy arrays + ``max_width``)."""
    return VertexPods(pool=_tensor(p["pool"], _F32, device),
                      off=_tensor(p["off"], _I32, device),
                      nv=_tensor(p["nv"], _I32, device),
                      kd=_tensor(p["kd"], _I32, device),
                      bucket=_tensor(p["bucket"], _I32, device),
                      max_width=int(p["max_width"]))


def pods_from_store(gs, device, pad_records_to: int = 0, pool_pad_to: int = 0,
                    max_width: int = 0) -> VertexPods:
    """Pack a GeometrySet's pool into device-resident :class:`VertexPods`."""
    return pods_from_numpy(
        pack_pods(gs.pool, gs.offsets, gs.nverts, gs.kinds,
                  pad_records_to=pad_records_to, pool_pad_to=pool_pad_to,
                  max_width=max_width), device)


# ---------------------------------------------------------------------------
# Host tree -> capture -> snapshot
#
# ``snapshot_capture`` touches the live, mutable host structure (leaf list,
# node tree, piecewise arrays) and runs synchronously with respect to
# insert/delete; ``snapshot_from_capture`` does the O(N) numpy work and the
# device upload on plain numpy copies (or append-immutable store arrays).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HostCapture:
    """A consistent host-side flattening of the index at one epoch.

    ``keys``/``recs``/``starts``/``leaf_mbrs`` are fresh copies; the geometry
    store fields alias the store's live views, which are immutable once
    captured (the CSR pool only ever appends past the captured length, and
    growth/compaction replace the buffer rather than mutating it) — so the
    capture stays valid while the live index keeps mutating."""

    keys: np.ndarray        # (N,) int64 Zmin keys in slot order
    recs: np.ndarray        # (N,) int64 record ids in slot order
    starts: np.ndarray      # (L+1,) int64 leaf slot offsets
    leaf_mbrs: np.ndarray   # (L, 4) f64 aggregate leaf MBRs
    dlo_hi: np.ndarray      # (L+1,) int32 leaf domain bounds
    dlo_lo: np.ndarray
    k0_hi: np.ndarray       # (L,) int32 leaf model re-centring keys
    k0_lo: np.ndarray
    slope: np.ndarray       # (L,) float32
    icpt: np.ndarray        # (L,) float32
    node_dlo_hi: np.ndarray
    node_dlo_lo: np.ndarray
    node_scale: np.ndarray
    node_fanout: np.ndarray
    node_child_base: np.ndarray
    child_codes: np.ndarray
    depth: int
    pw_zmax_hi: np.ndarray
    pw_zmax_lo: np.ndarray
    pw_sufmin_hi: np.ndarray
    pw_sufmin_lo: np.ndarray
    grid_x0: float
    grid_y0: float
    grid_cell: float
    # geometry store at capture time (aliases; see class docstring)
    gs_mbrs: np.ndarray
    gs_pool: np.ndarray     # (P, 2) f64 CSR vertex pool (live view)
    gs_offsets: np.ndarray  # (N,) i64 ring starts into the pool
    gs_nverts: np.ndarray
    gs_kinds: np.ndarray
    num_records: int        # store length at capture time

    @property
    def num_leaves(self) -> int:
        return self.leaf_mbrs.shape[0]


def snapshot_capture(glin) -> HostCapture:
    """Flatten the live host tree into plain numpy (synchronous part).

    Also runs the store's pool compaction pass: records tombstoned since the
    last publish give their ring storage back here, where it's safe — the
    new snapshot's tree no longer references them, previously captured pool
    views are untouched (compaction replaces buffers), and device payloads
    key on the store's ``pool_version`` so they re-upload the slimmer pool.
    """
    glin.gs.compact()
    keys, recs, starts, mbrs = glin.all_leaf_arrays()
    leaves = glin.leaves
    L = len(leaves)

    dlos = np.array([lf.dlo for lf in leaves] + [leaves[-1].dhi if L else 1],
                    dtype=object)
    dlo_hi = np.array([int(d) >> 30 for d in dlos], np.int64).astype(np.int32)
    dlo_lo = np.array([int(d) & (LO_LIMB_SIZE - 1) for d in dlos], np.int32)

    k0_hi, k0_lo = split_hilo_np(
        np.array([lf.key0 for lf in leaves], np.int64))
    slope = np.array([lf.slope for lf in leaves], np.float32)
    icpt = np.array([lf.intercept for lf in leaves], np.float32)

    # Flatten internal nodes (BFS). A leaf root is wrapped in a fanout-1 node.
    leaf_ids = {id(lf): i for i, lf in enumerate(leaves)}
    root = glin.root
    if isinstance(root, LeafNode):
        wrapper = InternalNode(root.dlo, root.dhi, 1)
        wrapper.children[0] = root
        root = wrapper
    order = [root]
    index_of = {id(root): 0}
    qi = 0
    while qi < len(order):
        node = order[qi]
        qi += 1
        for c in node.children:
            if isinstance(c, InternalNode):
                index_of[id(c)] = len(order)
                order.append(c)
    M = len(order)
    n_dlo_hi = np.empty(M, np.int32)
    n_dlo_lo = np.empty(M, np.int32)
    n_scale = np.empty(M, np.float32)
    n_fan = np.empty(M, np.int32)
    n_base = np.empty(M, np.int32)
    codes = []
    depth = 1
    for i, node in enumerate(order):
        n_dlo_hi[i] = node.dlo >> 30
        n_dlo_lo[i] = node.dlo & (LO_LIMB_SIZE - 1)
        n_scale[i] = np.float32(node.fanout / float(node.dhi - node.dlo))
        n_fan[i] = node.fanout
        n_base[i] = len(codes)
        for c in node.children:
            if isinstance(c, InternalNode):
                codes.append(index_of[id(c)])
            else:
                codes.append(-(leaf_ids[id(c)] + 1))
    # tree depth for the fixed traversal trip count
    def _depth(node, d):
        nonlocal depth
        depth = max(depth, d)
        if isinstance(node, InternalNode):
            for c in node.children:
                _depth(c, d + 1)
    _depth(root, 1)

    # Piecewise function in suffix-min form (copied: pw mutates in place).
    if glin.pw is not None and glin.pw.num_pieces:
        pw = glin.pw
        pz_hi, pz_lo = split_hilo_np(np.array(pw.zmax_end, np.int64))
        ps_hi, ps_lo = split_hilo_np(pw.suffix_min().astype(np.int64))
    else:
        pz_hi = pz_lo = ps_hi = ps_lo = np.empty(0, np.int32)

    gs = glin.gs
    grid = gs.grid
    return HostCapture(
        keys=keys, recs=recs, starts=starts, leaf_mbrs=mbrs,
        dlo_hi=dlo_hi, dlo_lo=dlo_lo, k0_hi=k0_hi, k0_lo=k0_lo,
        slope=slope, icpt=icpt,
        node_dlo_hi=n_dlo_hi, node_dlo_lo=n_dlo_lo, node_scale=n_scale,
        node_fanout=n_fan, node_child_base=n_base,
        child_codes=np.asarray(codes, np.int32), depth=depth,
        pw_zmax_hi=pz_hi, pw_zmax_lo=pz_lo,
        pw_sufmin_hi=ps_hi, pw_sufmin_lo=ps_lo,
        grid_x0=float(grid.x0), grid_y0=float(grid.y0),
        grid_cell=float(grid.cell_size),
        gs_mbrs=gs.mbrs, gs_pool=gs.pool, gs_offsets=gs.offsets,
        gs_nverts=gs.nverts, gs_kinds=gs.kinds, num_records=len(gs),
    )


def snapshot_from_capture(c: HostCapture, device) -> GLINSnapshot:
    """O(N) flattening of a capture + upload to ``device``."""
    return snapshot_from_numpy(*snapshot_arrays(c), device)


def snapshot_arrays(c: HostCapture) -> Tuple[dict, dict]:
    """The O(N) numpy flattening of a capture: ``(fields, meta)`` for
    :func:`snapshot_from_numpy` (the host half of a publish)."""
    keys, recs, starts = c.keys, c.recs, c.starts
    L = c.num_leaves
    k_hi, k_lo = split_hilo_np(keys)
    rec_leaf = np.repeat(np.arange(L, dtype=np.int32),
                         np.diff(starts).astype(np.int64))

    # Device-side max error: re-evaluate the fp32 model on every key so the
    # binary-search window provably brackets the answer on device.
    max_err = 1
    key_f = ((k_hi - c.k0_hi[rec_leaf]).astype(np.float32)
             * np.float32(LO_LIMB_SIZE)
             + (k_lo - c.k0_lo[rec_leaf]).astype(np.float32))
    pred = np.rint(c.slope[rec_leaf] * key_f
                   + c.icpt[rec_leaf]).astype(np.int64)
    local = np.arange(keys.shape[0], dtype=np.int64) - starts[rec_leaf]
    if keys.shape[0]:
        max_err = max(1, int(np.max(np.abs(pred - local))))
    search_steps = max(1, math.ceil(math.log2(2 * max_err + 4)))

    mbrs32 = c.leaf_mbrs.astype(np.float32)
    fields = dict(
        keys_hi=k_hi, keys_lo=k_lo, recs=recs.astype(np.int32),
        rec_leaf=rec_leaf,
        slot_lmbr=(mbrs32[rec_leaf] if L else
                   np.empty((0, 4), np.float32)),
        slot_rmbr=c.gs_mbrs[recs].astype(np.float32),
        leaf_start=starts.astype(np.int32),
        leaf_dlo_hi=c.dlo_hi, leaf_dlo_lo=c.dlo_lo, leaf_mbr=mbrs32,
        leaf_k0_hi=c.k0_hi, leaf_k0_lo=c.k0_lo,
        leaf_slope=c.slope, leaf_icpt=c.icpt,
        node_dlo_hi=c.node_dlo_hi, node_dlo_lo=c.node_dlo_lo,
        node_scale=c.node_scale, node_fanout=c.node_fanout,
        node_child_base=c.node_child_base, child_codes=c.child_codes,
        pw_zmax_hi=c.pw_zmax_hi, pw_zmax_lo=c.pw_zmax_lo,
        pw_sufmin_hi=c.pw_sufmin_hi, pw_sufmin_lo=c.pw_sufmin_lo)
    meta = dict(search_steps=search_steps, depth=c.depth,
                grid_x0=c.grid_x0, grid_y0=c.grid_y0, grid_cell=c.grid_cell)
    return fields, meta


def snapshot_from_host(glin, device) -> GLINSnapshot:
    return snapshot_from_capture(snapshot_capture(glin), device)


def place(obj, device):
    """A copy of a frozen tensor dataclass (snapshot, pods, delta table)
    with every tensor field on ``device``: a replica's placement."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# Batched probing
# ---------------------------------------------------------------------------
def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> int32 with the reference's cast semantics: out-of-range
    values saturate and NaN maps to 0 (a bare ``.to(int32)`` gives INT_MIN on
    the CPU and is undefined in CUDA). Clamped in fp32 first; 2147483520 is
    the largest fp32 below 2^31, and every caller clips far inside it."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(_I32)


def _find_leaf(s, q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Model traversal (Alg 1 model_traversal), batched: (Q,) -> leaf ids.
    A fixed ``depth`` of steps; a lane that reached a leaf stops moving."""
    q = q_hi.shape[0]
    dev = q_hi.device
    node = torch.zeros(q, dtype=_I32, device=dev)
    leaf = torch.zeros(q, dtype=_I32, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    for _ in range(s.depth):
        dh = (q_hi - s.node_dlo_hi[node]).to(_F32)
        dl = (q_lo - s.node_dlo_lo[node]).to(_F32)
        key_f = dh * float(LO_LIMB_SIZE) + dl
        cell_f = torch.minimum(
            torch.clamp(torch.floor(key_f * s.node_scale[node]), min=0.0),
            (s.node_fanout[node] - 1).to(_F32))
        cell = cell_f.to(_I32)
        code = s.child_codes[s.node_child_base[node] + cell]
        is_leaf = code < 0
        leaf = torch.where(is_leaf & ~done, -code - 1, leaf)
        node = torch.where(is_leaf | done, node, code)
        done = done | is_leaf

    # fp32 routing fix-up against exact integer leaf-domain boundaries.
    for _ in range(2):
        too_low = z_less_hilo(q_hi, q_lo, s.leaf_dlo_hi[leaf],
                              s.leaf_dlo_lo[leaf])
        leaf = torch.clamp(leaf - too_low.to(_I32), min=0)
        too_high = ~z_less_hilo(q_hi, q_lo, s.leaf_dlo_hi[leaf + 1],
                                s.leaf_dlo_lo[leaf + 1])
        leaf = torch.clamp(leaf + too_high.to(_I32), max=s.num_leaves - 1)
    return leaf


def model_window(s, q_hi: torch.Tensor, q_lo: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model traversal + leaf prediction -> global slot window [lo, hi)
    guaranteed to bracket lower_bound(q). Uses only the small model tables
    (no record-level arrays)."""
    leaf = _find_leaf(s, q_hi, q_lo)
    start = s.leaf_start[leaf]
    end = s.leaf_start[leaf + 1]
    size = end - start

    key_f = ((q_hi - s.leaf_k0_hi[leaf]).to(_F32) * float(LO_LIMB_SIZE)
             + (q_lo - s.leaf_k0_lo[leaf]).to(_F32))
    pred = _f32_to_i32(torch.round(s.leaf_slope[leaf] * key_f
                                   + s.leaf_icpt[leaf]))
    pred = torch.minimum(torch.clamp(pred, min=0),
                         torch.clamp(size - 1, min=0))
    err = (1 << s.search_steps) // 2 + 2
    lo = torch.clamp(pred - err, min=0) + start
    hi = torch.minimum(pred + err, size) + start
    return lo, hi


def lower_bound_in_window(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                          q_hi: torch.Tensor, q_lo: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          steps: int) -> torch.Tensor:
    """Bounded binary search for the first key >= q within [lo, hi)."""
    last = keys_hi.shape[0] - 1
    for _ in range(steps):
        live = lo < hi  # converged lanes must not move (clamped gathers)
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, 0, last)
        less = z_less_hilo(keys_hi[midc], keys_lo[midc], q_hi, q_lo) & live
        lo, hi = (torch.where(less, mid + 1, lo),
                  torch.where(less | ~live, hi, mid))
    return lo


def batch_probe(s, q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Batched lower_bound: global slot of the first key >= query key."""
    lo, hi = model_window(s, q_hi, q_lo)
    return lower_bound_in_window(s.keys_hi, s.keys_lo, q_hi, q_lo, lo, hi,
                                 s.search_steps + 2)


def _augment(s, q_hi, q_lo):
    """Suffix-min piecewise augmentation, batched (Alg 2 equivalent)."""
    p = s.pw_zmax_hi.shape[0]
    if p == 0:
        return q_hi, q_lo
    # binary search: first piece with zmax_end >= q
    lo = torch.zeros_like(q_hi)
    hi = torch.full_like(q_hi, p)
    steps = max(1, math.ceil(math.log2(p + 1)))
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, max=p - 1)   # the reference clamps gathers
        less = z_less_hilo(s.pw_zmax_hi[midc], s.pw_zmax_lo[midc], q_hi, q_lo)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    in_range = lo < p
    idx = torch.clamp(lo, max=p - 1)
    m_hi = torch.where(in_range, s.pw_sufmin_hi[idx], _INF_HI)
    m_lo = torch.where(in_range, s.pw_sufmin_lo[idx], 0)
    take = z_less_hilo(m_hi, m_lo, q_hi, q_lo)
    return torch.where(take, m_hi, q_hi), torch.where(take, m_lo, q_lo)


def _raw_query_keys(s: GLINSnapshot, windows: torch.Tensor, rel
                    ) -> Tuple[torch.Tensor, ...]:
    """Window quantization WITHOUT the augmentation rewrite: (zmin, ub=
    zmax+1) hi/lo limbs. The fused kernel consumes these directly (its
    suffix-min search runs in-kernel); ``query_keys`` layers ``_augment``
    on top for the staged path."""
    grid = ZGrid(s.grid_x0, s.grid_y0, s.grid_cell)
    # probe with the relation's (possibly padded) window; conservative fp32
    # quantization on top (never lose a candidate)
    (zmin_hi, zmin_lo), (zmax_hi, zmax_lo) = mbr_to_zinterval_hilo(
        rel.probe_window(windows), grid, guard=ZGrid.FP32_GUARD_CELLS)
    carry = (zmax_lo + 1) >= LO_LIMB_SIZE
    ub_hi = zmax_hi + carry.to(_I32)
    ub_lo = torch.where(carry, 0, zmax_lo + 1)
    return zmin_hi, zmin_lo, ub_hi, ub_lo


def query_keys(s: GLINSnapshot, windows: torch.Tensor, relation: str
               ) -> Tuple[torch.Tensor, ...]:
    """Windows (Q,4) -> ((zmin', ub) hi/lo limbs): the probe key (augmented
    per the relation's rule) and the exclusive upper key zmax+1."""
    rel = _device_relation(relation)
    zmin_hi, zmin_lo, ub_hi, ub_lo = _raw_query_keys(s, windows, rel)
    if rel.augment:
        zmin_hi, zmin_lo = _augment(s, zmin_hi, zmin_lo)
    return zmin_hi, zmin_lo, ub_hi, ub_lo


def _device_relation(relation: str):
    """Registry lookup restricted to relations the batched path can serve."""
    rel = get_relation(relation)
    if not rel.device_native:
        raise ValueError(
            f"relation {relation!r} is not device-native (evaluate its base "
            f"relation {rel.base_name()!r} and finish on host — the "
            f"SpatialIndex facade does this automatically)")
    return rel


def batch_query_bounds(s: GLINSnapshot, windows: torch.Tensor,
                       relation: str = "contains"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windows (Q,4) float32 -> (start_slot, end_slot) per query."""
    zmin_hi, zmin_lo, ub_hi, ub_lo = query_keys(s, windows, relation)
    start = batch_probe(s, zmin_hi, zmin_lo)
    end = batch_probe(s, ub_hi, ub_lo)
    return start, end


def _exact_over(rel, windows: torch.Tensor, pods: VertexPods,
                rec: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Exact predicates over gathered records ``rec`` (Q, M) -> bool, at the
    widest pow2 bucket among the ``sel`` lanes (``geometry.map_over_pods``;
    unselected lanes come back False)."""
    return geom.map_over_pods(rel.device_predicate, windows, pods.pool,
                              pods.off, pods.nv, pods.kd, pods.bucket, rec,
                              sel, False)


def _exact_refine_compacted(rel, windows: torch.Tensor, s: GLINSnapshot,
                            pods: VertexPods, slots: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-shape stage over compacted survivor slots (Q, kb) -> (hits,
    counts). Shared by the two-stage ``batch_query`` paths and the fused
    reference composition."""
    taken = slots >= 0
    slotc = torch.clamp(slots, min=0)
    rec = torch.where(taken, s.recs[slotc], 0)
    fmask = taken & _exact_over(rel, windows, pods, rec, taken)
    hits = torch.where(fmask, rec, -1)
    counts = fmask.sum(dim=1, dtype=_I32)
    return hits, counts


def batch_query(s: GLINSnapshot, windows: torch.Tensor, pods: VertexPods,
                relation: str = "contains", cap: int = 4096,
                exact_budget: int = 0, compaction: str = "scan"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full two-step batched query.

    Returns ``(hits, counts)`` where ``hits`` is (Q, K) int32 record ids
    (-1 padded). ``cap`` bounds candidates per query; overflow is reported
    via negative counts, never silently. On the two-stage paths a negative
    count carries the exact need: ``-(run length) - 1`` when the slot run
    outgrew ``cap`` on the scan path (the magnitude being > cap
    disambiguates), else ``-(TOTAL MBR survivors) - 1`` so the caller can
    grow its ``exact_budget`` ladder straight to a sufficient budget
    (``core.exec.OverflowLadder``). On the single-stage dense path it
    encodes the truncated hit count and only signals that the slot run
    outgrew ``cap``.

    ``exact_budget`` > 0 enables TWO-STAGE refinement at any budget (the
    caller's ``core.exec.OverflowLadder`` keeps a scan's budget below the
    cap, where it buys something): stage 1 evaluates only the cheap
    interval + leaf-MBR + record-MBR masks; stage 2 compacts the survivors
    per query and runs exact-shape checks + vertex gathers on at most
    ``exact_budget`` candidates. ``compaction`` picks the stage-1
    implementation:

    * ``"kernel"`` — ``kernels.refine.refine_compact``: interval + leaf-MBR
      + record-MBR tests with block-wide prefix-sum compaction over each
      query's own run, walked group -> leaf -> slot over the snapshot's
      ``leaf_walk`` (the CUDA kernel on a card, its plain version on the
      CPU); capless, ``cap`` only bounds the dense fallback.
    * ``"scan"``   — tensor reference semantics: (Q, cap) candidate window
      from the probe run, masked via the slot-aligned MBR tables, compacted
      with a stable cumsum + scatter (no sort).
    """
    if compaction not in ("kernel", "scan"):
        raise ValueError(f"unknown compaction {compaction!r}")
    rel = _device_relation(relation)
    start, end = batch_query_bounds(s, windows, relation)
    q = windows.shape[0]
    dev = windows.device

    if exact_budget > 0:
        kb = exact_budget
        probe_w = rel.probe_window(windows)
        if compaction == "kernel":
            from ..kernels import refine as kref

            if rel.prefilter_kind == "custom":
                raise ValueError(
                    f"relation {relation!r} has a custom MBR prefilter; the "
                    "kernel cannot evaluate it — use compaction='scan'")
            bounds = torch.stack([start, end], dim=1)
            slots, mbr_counts = kref.refine_compact(
                probe_w, bounds, s.slot_lmbr, s.slot_rmbr, budget=kb,
                prefilter=rel.prefilter_kind, leaves=s.leaf_walk)
            hits, counts = _exact_refine_compacted(rel, windows, s, pods,
                                                   slots)
            overflow = mbr_counts > kb
            # overflow encodes the TOTAL survivor count (-(survivors) - 1),
            # so the caller can size its budget ladder in one step
            return hits, torch.where(overflow, -mbr_counts - 1, counts)

        pos = start[:, None] + torch.arange(cap, dtype=_I32, device=dev)
        valid = pos < torch.minimum(end, start + cap)[:, None]
        posc = torch.clamp(pos, max=s.num_slots - 1)
        # no leaf-MBR gather: every record MBR lies inside its leaf's
        # aggregate MBR (grow-only maintenance), so the record prefilter
        # implies the leaf test
        rmbr = s.slot_rmbr[posc]
        rec_ok = rel.mbr_prefilter(rmbr, windows[:, None, :])
        mask = valid & rec_ok
        # stable cumsum + scatter compaction (no argsort): survivor j of row
        # q lands in column (exclusive prefix of mask)[q, j]; survivors past
        # the budget go to a spill column kb that is sliced off
        m32 = mask.to(_I32)
        excl = torch.cumsum(m32, dim=1, dtype=_I32) - m32
        col = torch.where(mask & (excl < kb), excl, kb)
        slots = torch.full((q, kb + 1), -1, dtype=_I32, device=dev).scatter_(
            1, col.to(torch.int64), posc)[:, :kb]
        hits, counts = _exact_refine_compacted(rel, windows, s, pods, slots)
        surv = m32.sum(dim=1, dtype=_I32)
        runlen = end - start
        run_over = runlen > cap
        overflow = run_over | (surv > kb)
        # run overflow reports the run length (> cap, so callers can tell
        # it from a survivor count <= cap and grow the right knob)
        enc = torch.where(run_over, runlen, surv)
        return hits, torch.where(overflow, -enc - 1, counts)

    # single-stage dense path (exact_budget disabled)
    pos = start[:, None] + torch.arange(cap, dtype=_I32, device=dev)
    valid = pos < torch.minimum(end, start + cap)[:, None]
    posc = torch.clamp(pos, max=s.num_slots - 1)
    lmbr = s.slot_lmbr[posc]                     # (Q, cap, 4)
    wq = windows[:, None, :]                     # (Q, 1, 4)
    # leaf-MBR pruning against the padded probe window (a dwithin hit's leaf
    # may not overlap the raw window); the record prefilter pads internally
    leaf_ok = geom.mbr_intersects(lmbr, rel.probe_window(windows)[:, None, :])
    rec = s.recs[posc]
    rmbr = s.slot_rmbr[posc]
    rec_ok = rel.mbr_prefilter(rmbr, wq)
    mask = valid & leaf_ok & rec_ok
    mask = mask & _exact_over(rel, windows, pods, rec, mask)  # pod gathers
    hits = torch.where(mask, rec, -1)
    counts = mask.sum(dim=1, dtype=_I32)
    overflow = (end - start) > cap
    counts = torch.where(overflow, -counts - 1, counts)  # signal truncation
    return hits, counts


def _fused_operands(s: GLINSnapshot) -> Tuple[torch.Tensor, ...]:
    """Pack the snapshot's model tables into the fused kernel's column
    layouts (``kernels.refine.refine_fused`` documents them). Empty tables
    (a one-leaf tree has no internal nodes; a non-augmenting build has no
    pieces) pad to one zero row so no operand is empty — the kernel never
    reads them (the depth loop self-terminates on a done flag;
    ``augment=False`` skips the piecewise search)."""
    dev = s.device
    zi = torch.zeros(1, dtype=_I32, device=dev)
    zf = torch.zeros(1, dtype=_F32, device=dev)
    keys = torch.stack([s.keys_hi, s.keys_lo], dim=1)
    recs = s.recs[:, None].contiguous()
    leaf_i = torch.stack([
        s.leaf_start, s.leaf_dlo_hi, s.leaf_dlo_lo,
        torch.cat([s.leaf_k0_hi, zi]), torch.cat([s.leaf_k0_lo, zi]),
    ], dim=1)
    leaf_f = torch.stack([torch.cat([s.leaf_slope, zf]),
                          torch.cat([s.leaf_icpt, zf])], dim=1)
    if s.node_dlo_hi.shape[0]:
        node_i = torch.stack([s.node_dlo_hi, s.node_dlo_lo, s.node_fanout,
                              s.node_child_base], dim=1)
        node_f = s.node_scale[:, None].contiguous()
    else:
        node_i = torch.zeros((1, 4), dtype=_I32, device=dev)
        node_f = torch.zeros((1, 1), dtype=_F32, device=dev)
    codes = (s.child_codes[:, None].contiguous() if s.child_codes.shape[0]
             else torch.zeros((1, 1), dtype=_I32, device=dev))
    if s.pw_zmax_hi.shape[0]:
        pw = torch.stack([s.pw_zmax_hi, s.pw_zmax_lo,
                          s.pw_sufmin_hi, s.pw_sufmin_lo], dim=1)
    else:
        pw = torch.zeros((1, 4), dtype=_I32, device=dev)
    return keys, recs, leaf_i, leaf_f, node_i, node_f, codes, pw


def batch_query_fused(s: GLINSnapshot, windows: torch.Tensor,
                      pods: VertexPods, relation: str = "contains",
                      exact_budget: int = 256, mode: str = "reference"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE-dispatch batched query: learned-index probe + MBR prefilter with
    compaction + exact-shape refinement in a single kernel launch (vs
    ``batch_query``'s probe -> compact -> exact sequence).

    ``mode`` picks the execution vehicle, both identical to
    ``batch_query(..., compaction="scan")``:

    * ``"kernel"``    — ``kernels.refine.refine_fused`` (the CUDA kernel on
      a card; its plain version for CPU tensors).
    * ``"reference"`` — the plain tensor composition of the same three
      stages: probe bounds, whole-table mask + cumsum/searchsorted
      compaction (in query chunks), the shared exact stage.

    Returns ``(hits (Q, budget) i32 [-1 padded], counts (Q,) i32)``. The
    fused path is CAPLESS — the prefilter mask spans the whole slot table —
    so a negative count always means budget overflow and encodes the total
    MBR-survivor count ``-(survivors) - 1``
    (``core.exec.OverflowLadder.on_capless_overflow`` sizes the retry budget
    from it in one step, no disambiguating bounds probe needed)."""
    if mode not in ("kernel", "reference"):
        raise ValueError(f"unknown fused mode {mode!r}")
    rel = _device_relation(relation)
    if rel.prefilter_kind == "custom":
        raise ValueError(
            f"relation {relation!r} has a custom MBR prefilter; the fused "
            "path cannot evaluate it — use the staged batch_query")
    if exact_budget <= 0:
        raise ValueError("the fused path is two-stage only: exact_budget "
                         "must be > 0")
    from ..kernels import refine as kref

    kb = exact_budget
    probe_w = rel.probe_window(windows)

    if mode == "kernel":
        zmin_hi, zmin_lo, ub_hi, ub_lo = _raw_query_keys(s, windows, rel)
        qkeys = torch.stack([zmin_hi, zmin_lo, ub_hi, ub_lo], dim=1)
        return kref.refine_fused(
            windows, probe_w, qkeys, *s.fused_operands, pods.headers,
            pods.pool, s.slot_lmbr, s.slot_rmbr, budget=kb,
            prefilter=rel.prefilter_kind, code=rel.code, dist=rel.dist,
            augment=bool(rel.augment) and s.pw_zmax_hi.shape[0] > 0,
            search_steps=s.search_steps, depth=s.depth, leaves=s.leaf_walk)

    # "reference": the same probe + capless mask + (Q, kb) compaction +
    # exact stage as plain tensor code
    start, end = batch_query_bounds(s, windows, relation)
    slots, mbr_counts = kref.compact_plain(
        probe_w, start, end, s.slot_lmbr, s.slot_rmbr, kb,
        rel.prefilter_kind)
    hits, counts = _exact_refine_compacted(rel, windows, s, pods, slots)
    return hits, torch.where(mbr_counts > kb, -mbr_counts - 1, counts)


# ---------------------------------------------------------------------------
# Delta side table: device-resident secondary index over the added set
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeltaTable:
    """Small device-resident secondary index over the added-set delta (the
    records inserted since the last snapshot publish), sorted by Zmin key.

    ``SpatialIndex`` builds one lazily per mutation epoch so ``device+delta``
    queries check the added set on the device (:func:`batch_check_added`)
    instead of looping on the host per batch. Rows are padded to a size
    bucket with inert entries (``ids == -1``, +inf keys, far-away MBRs) and
    the vertex pool to a pow2 bucket, as the reference pads them: the same
    answers, and allocations of a stable size."""

    ids: torch.Tensor       # (A,) int32 record ids (-1 = padding), Zmin-sorted
    zmin_hi: torch.Tensor   # (A,) int32 z-interval lower key
    zmin_lo: torch.Tensor   # (A,) int32
    zmax_hi: torch.Tensor   # (A,) int32 z-interval upper key
    zmax_lo: torch.Tensor   # (A,) int32
    mbrs: torch.Tensor      # (A, 4) float32
    pool: torch.Tensor      # (P, 2) float32 CSR vertex pool over the added set
    off: torch.Tensor       # (A,) int32 ring starts (inert rows -> sentinel)
    nverts: torch.Tensor    # (A,) int32
    kinds: torch.Tensor     # (A,) int32
    max_width: int          # pow2 ceiling of the added set's widths

    @property
    def size(self) -> int:
        return self.ids.shape[0]


def delta_table_from_host(glin, added_ids, device, pad_to: int = 0
                          ) -> DeltaTable:
    """Build the added-set side table from the host index (one upload per
    mutation epoch). ``added_ids`` is any iterable of record ids; rows are
    sorted by Zmin (stable) and padded to ``pad_to`` with inert entries."""
    ids = np.asarray(sorted(added_ids), np.int64)
    zmin = glin.zmin[ids] if ids.shape[0] else np.empty(0, np.int64)
    zmax = glin.zmax[ids] if ids.shape[0] else np.empty(0, np.int64)
    order = np.argsort(zmin, kind="stable")
    ids, zmin, zmax = ids[order], zmin[order], zmax[order]
    gs = glin.gs
    a = ids.shape[0]
    m = max(a, int(pad_to))
    pad = m - a
    zmin_hi, zmin_lo = split_hilo_np(zmin)
    zmax_hi, zmax_lo = split_hilo_np(zmax)
    out_ids = np.full(m, -1, np.int32)
    out_ids[:a] = ids
    mbrs = np.full((m, 4), 2e30, np.float32)      # intersects nothing
    nverts = np.ones(m, np.int32)
    kinds = np.zeros(m, np.int32)
    # CSR ring pool over the added set, with one far-away sentinel vertex
    # that every inert pad row points at (intersects nothing, dwithin fails)
    counts = gs.nverts[ids].astype(np.int64) if a else np.empty(0, np.int64)
    off = np.zeros(m, np.int32)
    # pow2-bucket the pool axis: its size moves by buckets, not by one ring
    # per insert (and the last row is always the sentinel)
    total = int(counts.sum())
    pool = np.full((1 << max(6, total.bit_length()), 2), 2e30, np.float32)
    if a:
        starts = np.zeros(a, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        pos = np.arange(total) - np.repeat(starts, counts)
        src = gs.offsets[ids]
        pool[:total] = gs.pool[np.repeat(src, counts) + pos]
        off[:a] = starts
        off[a:] = pool.shape[0] - 1               # the sentinel row
        mbrs[:a] = gs.mbrs[ids]
        nverts[:a] = gs.nverts[ids]
        kinds[:a] = gs.kinds[ids]
    else:
        off[:] = pool.shape[0] - 1
    max_width = _pow2ceil(int(counts.max()) if a else 1)

    def padk(x, fill):
        return _tensor(np.concatenate([x, np.full(pad, fill, np.int32)]),
                       _I32, device)

    return DeltaTable(
        ids=_tensor(out_ids, _I32, device),
        zmin_hi=padk(zmin_hi, _INF_HI), zmin_lo=padk(zmin_lo, 0),
        zmax_hi=padk(zmax_hi, _INF_HI), zmax_lo=padk(zmax_lo, 0),
        mbrs=_tensor(mbrs, _F32, device), pool=_tensor(pool, _F32, device),
        off=_tensor(off, _I32, device), nverts=_tensor(nverts, _I32, device),
        kinds=_tensor(kinds, _I32, device), max_width=max_width)


def _delta_lanes(t: DeltaTable, q: int, sel: torch.Tensor, fn,
                 windows: torch.Tensor, fill) -> torch.Tensor:
    """``fn(rect, verts, nverts, kinds)`` over the (Q, A) lanes ``sel`` of
    the added set, at the table's width (``ragged_padded``'s gather, lane by
    lane): what the reference evaluates densely over (Q, A, max_width),
    evaluated only where ``sel`` holds and in chunks of lanes, so memory
    stays bounded however far the delta grows."""
    col = torch.arange(t.size, dtype=torch.int64, device=t.ids.device)
    return geom.map_over_pods(fn, windows, t.pool, t.off, t.nverts, t.kinds,
                              None, col.expand(q, t.size), sel, fill,
                              width=t.max_width)


def batch_check_added(t: DeltaTable, windows: torch.Tensor, relation: str,
                      grid_x0: float, grid_y0: float, grid_cell: float
                      ) -> torch.Tensor:
    """Windows (Q,4) f32 × added-set table -> (Q, A) bool hit matrix.

    The z-interval prune mirrors the index mechanism: a window and a record
    whose MBRs intersect always have overlapping z-intervals, so pruning on
    ``[zmin_g, zmax_g] ∩ [zmin_q, zmax_q] != ∅`` never loses a hit and needs
    no piecewise augmentation over the (unpublished) added set. The exact
    predicate runs on the lanes that pass the prune and the relation's MBR
    prefilter only (:func:`_delta_lanes`); the others are False in the
    reference's dense evaluation too."""
    rel = _device_relation(relation)
    grid = ZGrid(grid_x0, grid_y0, grid_cell)
    probe = rel.probe_window(windows)
    (qmin_hi, qmin_lo), (qmax_hi, qmax_lo) = mbr_to_zinterval_hilo(
        probe, grid, guard=ZGrid.FP32_GUARD_CELLS)
    lo_ok = ~z_less_hilo(t.zmax_hi[None, :], t.zmax_lo[None, :],
                         qmin_hi[:, None], qmin_lo[:, None])
    hi_ok = ~z_less_hilo(qmax_hi[:, None], qmax_lo[:, None],
                         t.zmin_hi[None, :], t.zmin_lo[None, :])
    cand = lo_ok & hi_ok & (t.ids[None, :] >= 0)
    sel = cand & rel.mbr_prefilter(t.mbrs[None, :, :], windows[:, None, :])
    exact = _delta_lanes(t, windows.shape[0], sel, rel.device_predicate,
                         windows, False)
    return sel & exact


# ---------------------------------------------------------------------------
# Device-complete kNN: CDF-seeded radii + exact-distance top-k ranking
# ---------------------------------------------------------------------------
def _sqdist_over(windows: torch.Tensor, pods: VertexPods, rec: torch.Tensor,
                 sel: torch.Tensor) -> torch.Tensor:
    """Exact squared window-to-geometry distances over gathered records
    ``rec`` (Q, M) -> f32, +inf on unselected lanes: the distance twin of
    ``_exact_over``, gathering at the widest pow2 bucket among the ``sel``
    lanes (``geometry.map_over_pods``, in lane chunks, so a budget-wide
    rank never gathers a (Q, M, width) block at once)."""
    return geom.map_over_pods(geom.rect_geom_sqdist_torch, windows,
                              pods.pool, pods.off, pods.nv, pods.kd,
                              pods.bucket, rec, sel, float("inf"))


def knn_seed_radii(s: GLINSnapshot, windows: torch.Tensor, k: float
                   ) -> torch.Tensor:
    """CDF-seeded initial kNN radii: degenerate windows (Q, 4) -> (Q,) f32.

    The published learned index doubles as a density estimate: each point
    routes through the model to its leaf (``_find_leaf``); the leaf's record
    count over its aggregate-MBR area is the local intensity rho, and the
    expected k-th-neighbour distance of a planar process of intensity rho is
    ``sqrt(k / (pi * rho))``, offset by the point's distance to the leaf's
    aggregate MBR (a point routed to a leaf it does not touch must first
    reach the data). An estimate only: the rung ladder above it is the
    correctness backstop, and settlement is always the exact within-radius
    count from :func:`batch_knn_rank`."""
    grid = ZGrid(s.grid_x0, s.grid_y0, s.grid_cell)
    (zmin_hi, zmin_lo), _ = mbr_to_zinterval_hilo(
        windows, grid, guard=ZGrid.FP32_GUARD_CELLS)
    leaf = _find_leaf(s, zmin_hi, zmin_lo)
    count = (s.leaf_start[leaf + 1] - s.leaf_start[leaf]).to(_F32)
    m = s.leaf_mbr[leaf]
    area = torch.clamp((m[:, 2] - m[:, 0]) * (m[:, 3] - m[:, 1]),
                       min=float(np.float32(1e-12)))
    rho = torch.clamp(count, min=1.0) / area
    zero = torch.zeros((), dtype=_F32, device=windows.device)
    gx = torch.maximum(torch.maximum(m[:, 0] - windows[:, 0],
                                     windows[:, 0] - m[:, 2]), zero)
    gy = torch.maximum(torch.maximum(m[:, 1] - windows[:, 1],
                                     windows[:, 1] - m[:, 3]), zero)
    gap = torch.sqrt(gx * gx + gy * gy)
    kf = torch.tensor(float(np.float32(k)), dtype=_F32, device=windows.device)
    return gap + torch.sqrt(kf / (float(np.float32(math.pi)) * rho))


def batch_knn_rank(windows: torch.Tensor, pods: VertexPods,
                   hits: torch.Tensor, radius: torch.Tensor, k: int,
                   impl: str = "sort", tombstones=None, delta=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device top-k over intersects survivors: (Q, B) hit ids -> ((Q, k)
    ids, (Q, k) distances, (Q,) within-radius candidate counts).

    ``hits`` is the refine stage's -1-padded id matrix; exact distances come
    from one widest-surviving-bucket pod gather (``_sqdist_over``), so the
    candidate set never leaves the device — only the (Q, k) result does.
    Ordering is the shared ``geometry.rank_knn`` (distance, id) contract
    over SQUARED distances: ``impl="kernel"`` ranks through the
    ``kernels.knn.knn_topk`` wrapper (the CUDA kernel on a card, its plain
    version for CPU tensors), ``impl="sort"`` through the plain two-key sort.

    ``radius`` ((Q,) f32) is each point's own probe radius this rung; the
    count is |{candidates with d2 <= radius^2}|, the dwithin predicate's
    test, which drives the ladder's settlement rule; it counts snapshot
    and delta rows together. ``tombstones`` (T,) i32 masks
    deleted-but-published ids out of the ranking; ``delta`` (a
    :class:`DeltaTable`) merges the unpublished added set by exact squared
    distance before the top-k (live rows only: pad rows rank as +inf
    ``ID_PAD``), so ``device+delta`` kNN ranks inserted records without a
    republish (added ids postdate snapshot ids: the two never collide)."""
    from ..kernels import knn as kknn

    if impl not in ("sort", "kernel"):
        raise ValueError(f"unknown knn top-k impl {impl!r}")
    q, dev = windows.shape[0], windows.device
    valid = hits >= 0
    rec = torch.clamp(hits, min=0)
    d2 = _sqdist_over(windows, pods, rec, valid)
    ids = torch.where(valid, hits, kknn.ID_PAD)
    if tombstones is not None and tombstones.shape[0]:
        dead = torch.isin(hits, tombstones)
        d2 = torch.where(dead, float("inf"), d2)
        ids = torch.where(dead, kknn.ID_PAD, ids)
    if delta is not None:
        live = delta.ids >= 0
        ad2 = _delta_lanes(delta, q, live[None, :].expand(q, delta.size),
                           geom.rect_geom_sqdist_torch, windows,
                           float("inf"))
        aid = torch.where(live, delta.ids, kknn.ID_PAD)
        d2 = torch.cat([d2, ad2], dim=1)
        ids = torch.cat([ids, aid[None, :].expand(q, delta.size)], dim=1)
    counts = (d2 <= (radius * radius)[:, None]).sum(dim=1, dtype=_I32)
    if d2.shape[1] < k:                    # k > budget(+delta): pad columns
        padw = k - d2.shape[1]
        d2 = torch.cat([d2, torch.full((q, padw), float("inf"), dtype=_F32,
                                       device=dev)], dim=1)
        ids = torch.cat([ids, torch.full((q, padw), kknn.ID_PAD, dtype=_I32,
                                         device=dev)], dim=1)
    top = kknn.knn_topk if impl == "kernel" else kknn.knn_topk_plain
    d2k, idk = top(d2.contiguous(), ids.contiguous(), k)
    dk = torch.sqrt(torch.clamp(d2k, min=0.0))
    idk = torch.where(torch.isinf(d2k), -1, idk)
    return idk, dk, counts


def input_specs_like(num_queries: int):
    """{name: (shape, dtype)} of a query batch (the dry run's stand-in; the
    reference's ``input_specs_like``): its windows (Q, 4) fp32."""
    return {"windows": ((num_queries, 4), _F32)}
