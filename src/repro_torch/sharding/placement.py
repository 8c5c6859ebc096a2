"""Placed values and the collectives over a named mesh axis, under one
controller.

The reference leaves partitioning to GSPMD: a ``jax.Array`` carries a
``NamedSharding`` and XLA inserts the collectives. The port has no XLA and
no process per device, so it does the same explicitly (design P4 of the
sharded backend, ``core.distributed``):

* :class:`Sharded` is a placed value: its global shape, its
  :class:`~.rules.PartitionSpec` and one local block per mesh position, on
  that position's device. A block is replicated over every mesh axis the
  spec does not name. Positions that share a device and hold the same
  block share one tensor: a value replicated over eight positions of one
  card is one tensor there, and an op on it runs once.
* :func:`place` is ``jax.device_put(x, NamedSharding(mesh, spec))``;
  :func:`gather` returns the global tensor on one device.
* The collectives (:func:`psum`, :func:`pmax`, :func:`all_gather`,
  :func:`reduce_scatter`, :func:`ppermute`, :func:`all_to_all`) are plain
  torch ops on the blocks of the positions that differ only along the
  named axes, taken in mesh order (deterministic), each block moved to the
  receiving position's device with ``.to()``. They differentiate through
  ``.to()``, ``cat`` and ``+``, so one autograd graph spans every position
  and autograd delivers the backward collectives itself: the gradient of
  an all-gather arrives summed over the positions that read the gathered
  value, and a value copied to several positions gets their gradients
  summed.
* :func:`smap` runs a function on every position's blocks; positions whose
  blocks are the same tensors (and device) share one call.
* Under a cost counter (``utils.cost``), :func:`smap` charges each call to
  the positions that share it, each collective charges the positions that
  receive a block its bytes, and :func:`sum_replicas` charges the
  all-reduce a mesh of separate devices would make.

A per-position value with no global layout (a partial sum before its
``psum``, a pipeline stage's state) is a :class:`Sharded` whose ``spec``
and ``shape`` are ``None``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils import cost as _cost
from ..utils.tree import tree_map
from .rules import PartitionSpec, shape_of

__all__ = ["Sharded", "NamedSharding", "place", "gather", "place_tree",
           "gather_tree", "smap", "psum", "pmax", "all_gather",
           "reduce_scatter", "ppermute", "all_to_all", "relayout", "split",
           "sum_replicas", "canonical_blocks", "canonical_groups",
           "unique_blocks", "block_slices",
           "shape_dtype"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: PartitionSpec


class Sharded:
    """A placed value: ``shape`` (global), ``spec``, ``mesh`` and
    ``blocks`` (one tensor per mesh position, in the mesh's flat order)."""

    __slots__ = ("shape", "spec", "mesh", "blocks")

    def __init__(self, shape, spec, mesh, blocks):
        self.shape = None if shape is None else tuple(shape)
        self.spec = spec
        self.mesh = mesh
        self.blocks = tuple(blocks)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"local={tuple(self.blocks[0].shape)}, dtype={self.dtype})")


# ------------------------------------------------------------ mesh helpers
@functools.lru_cache(maxsize=None)
def _coords(sizes: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    return tuple(np.ndindex(*sizes))


def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _index(mesh, p: int, axes: Sequence[str]) -> Tuple[int, int]:
    """(position ``p``'s index over ``axes`` (major first), their extent)."""
    c = _coords(mesh.sizes)[p]
    idx, ext = 0, 1
    for a in axes:
        k = mesh.axis_names.index(a)
        idx = idx * mesh.sizes[k] + c[k]
        ext *= mesh.sizes[k]
    return idx, ext


@functools.lru_cache(maxsize=None)
def _groups_of(names, sizes, axes) -> Tuple[Tuple[int, ...], ...]:
    idx = np.arange(math.prod(sizes)).reshape(sizes)
    src = [names.index(a) for a in axes]
    moved = np.moveaxis(idx, src, list(range(-len(axes), 0)))
    return tuple(tuple(int(i) for i in row)
                 for row in moved.reshape(-1, math.prod(
                     sizes[k] for k in src)))


def _groups(mesh, axes) -> Tuple[Tuple[int, ...], ...]:
    """The positions that differ only along ``axes``, each group in mesh
    order over them (the first axis the major)."""
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {a!r}")
    return _groups_of(tuple(mesh.axis_names), tuple(mesh.sizes), tuple(axes))


def normalize_spec(spec, ndim: int = None) -> PartitionSpec:
    """``spec`` (a PartitionSpec, tuple or None) as a PartitionSpec with
    single-axis entries as names and no trailing ``None``."""
    if spec is None:
        return PartitionSpec()
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    if ndim is not None and len(out) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"value's {ndim} dimensions")
    return PartitionSpec(*out)


def _check_spec(mesh, spec: PartitionSpec) -> None:
    seen = []
    for d in range(len(spec)):
        for a in spec.axes(d):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"{mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses {a!r} twice")
            seen.append(a)


def block_slices(mesh, spec: PartitionSpec, shape, p: int
                 ) -> Tuple[slice, ...]:
    """Position ``p``'s block of a ``shape`` value laid out by ``spec``."""
    out = []
    for d, n in enumerate(shape):
        axes = spec.axes(d)
        if not axes:
            out.append(slice(0, n))
            continue
        idx, ext = _index(mesh, p, axes)
        if n % ext:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split into {ext} blocks ({spec})")
        size = n // ext
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def _key(sl: Tuple[slice, ...]) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in sl)


def _global_shape(mesh, spec, local) -> Tuple[int, ...]:
    return tuple(n * _index(mesh, 0, spec.axes(d))[1]
                 for d, n in enumerate(local))


# ------------------------------------------------------ placing, gathering
def place(x, mesh, spec) -> Sharded:
    """``x`` (a tensor, or anything ``torch.as_tensor`` takes) laid out on
    ``mesh`` by ``spec``: each position's block copied, contiguous, to its
    device (one copy per distinct device and block)."""
    x = torch.as_tensor(x).detach()
    spec = normalize_spec(spec, x.dim())
    _check_spec(mesh, spec)
    made: Dict[Any, torch.Tensor] = {}
    blocks = []
    for p, dev in enumerate(mesh.flat):
        sl = block_slices(mesh, spec, x.shape, p)
        key = (dev, _key(sl))
        if key not in made:
            made[key] = x[sl].to(dev, copy=True,
                                 memory_format=torch.contiguous_format)
        blocks.append(made[key])
    return Sharded(x.shape, spec, mesh, blocks)


@torch.no_grad()
def gather(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``s`` on ``device`` (default: the mesh's merge
    device), each block read from the first position that holds it."""
    if s.spec is None:
        raise ValueError("a per-position value has no global tensor")
    device = s.mesh.merge_device if device is None else device
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    done = set()
    for p, b in enumerate(s.blocks):
        sl = block_slices(s.mesh, s.spec, s.shape, p)
        if _key(sl) not in done:
            done.add(_key(sl))
            out[sl] = b.to(device)
    return out


def place_tree(tree, shardings):
    """Each leaf of a nested dict placed by the matching
    :class:`NamedSharding` of ``shardings`` (a leaf already placed is laid
    out again; see :func:`relayout`)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return relayout(tree, shardings.spec)
    return place(tree, shardings.mesh, shardings.spec)


def gather_tree(tree, device=None):
    """Every :class:`Sharded` leaf of a nested dict gathered (others kept)."""
    return tree_map(tree, lambda t: gather(t, device)
                    if isinstance(t, Sharded) else t)


# --------------------------------------------------------- per position
def _mesh_of(args) -> Any:
    for a in args:
        if isinstance(a, Sharded):
            return a.mesh
    raise ValueError("no placed argument")


def smap(fn: Callable, *args, out=None, coord=None):
    """``fn`` on every position's blocks of the :class:`Sharded` arguments
    (other arguments passed as they are); positions whose blocks are the
    same tensors on the same device share one call. With ``coord`` (a mesh
    axis or a tuple of them), ``fn`` takes the position's index over it
    first (0 for an empty tuple). ``out``:
    the spec of the result (a tuple of specs where ``fn`` returns a
    tuple), or None for a per-position value with no global layout.
    Returns a :class:`Sharded` (or a tuple of them)."""
    mesh = _mesh_of(args)
    for a in args:
        if isinstance(a, Sharded) and a.mesh is not mesh and a.mesh != mesh:
            raise ValueError("placed arguments on different meshes")
    keys, calls = [], {}
    for p, dev in enumerate(mesh.flat):
        lead = () if coord is None else (_index(mesh, p, _axes(coord))[0],)
        key = (dev,) + lead + tuple(id(a.blocks[p]) for a in args
                                    if isinstance(a, Sharded))
        keys.append(key)
        if key in calls:
            calls[key][2] |= 1 << p
        else:
            calls[key] = [p, lead, 1 << p]
    counter = _cost.active()
    made: Dict[Any, Any] = {}
    for key, (p, lead, mask) in calls.items():
        blocks = [a.blocks[p] if isinstance(a, Sharded) else a for a in args]
        if counter is None:
            made[key] = fn(*lead, *blocks)
        else:
            with counter.at(mask):
                made[key] = fn(*lead, *blocks)
    results = [made[k] for k in keys]
    if isinstance(results[0], tuple):
        specs = out if out is not None else (None,) * len(results[0])
        return tuple(_wrap(mesh, [r[i] for r in results], specs[i])
                     for i in range(len(results[0])))
    return _wrap(mesh, results, out)


def _wrap(mesh, blocks, spec) -> Sharded:
    if spec is None:
        return Sharded(None, None, mesh, blocks)
    spec = normalize_spec(spec, blocks[0].dim())
    return Sharded(_global_shape(mesh, spec, blocks[0].shape), spec, mesh,
                   blocks)


# ------------------------------------------------------------ collectives
def _collective(s: Sharded, axes, combine, kind: str,
                by_rank: bool = False):
    """Blocks from ``combine(group blocks, device, rank)`` for every
    position; positions with the same group blocks and device (and, where
    ``by_rank``, rank) share one result. Under a cost counter each
    position of a group of several is charged the block it receives as a
    ``kind`` collective."""
    mesh = s.mesh
    counter = _cost.active()
    if counter is not None and counter.interchangeable(s.blocks):
        by_rank = False              # every rank's block has one shape
    blocks: List[Any] = [None] * len(mesh.flat)
    made: Dict[Any, torch.Tensor] = {}
    owners: Dict[Any, list] = {}
    for g in _groups(mesh, axes):
        gb = [s.blocks[q] for q in g]
        ids = tuple(id(b) for b in gb)
        for rank, p in enumerate(g):
            dev = mesh.flat[p]
            key = (dev, ids, rank if by_rank else None)
            if key not in made:
                if counter is None or len(g) == 1:
                    made[key] = combine(gb, dev, rank)
                else:
                    made[key], cell = counter.collective(kind, combine, gb,
                                                         dev, rank)
                    owners[key] = [gb[rank], cell, 0]
            blocks[p] = made[key]
            if key in owners:
                owners[key][2] |= 1 << p
    for key, (inp, cell, mask) in owners.items():
        counter.received(kind, made[key], inp, cell, mask)
    return blocks


def _sum(gb, dev, rank=None):
    acc = gb[0].to(dev)
    for b in gb[1:]:
        acc = acc + b.to(dev)
    return acc


def psum(s: Sharded, axis) -> Sharded:
    """Sum of the blocks over ``axis`` (a name or a tuple of names), in
    mesh order; the result is replicated over it."""
    axes = _axes(axis)
    if not axes:
        return s
    return Sharded(s.shape, s.spec, s.mesh,
                   _collective(s, axes, _sum, "all-reduce"))


def pmax(s: Sharded, axis) -> Sharded:
    """Elementwise maximum of the blocks over ``axis``."""
    axes = _axes(axis)
    if not axes:
        return s

    def mx(gb, dev, rank):
        acc = gb[0].to(dev)
        for b in gb[1:]:
            acc = torch.maximum(acc, b.to(dev))
        return acc
    return Sharded(s.shape, s.spec, s.mesh,
                   _collective(s, axes, mx, "all-reduce"))


def _drop_suffix(spec: PartitionSpec, dim: int, axes) -> PartitionSpec:
    have = spec.axes(dim)
    if have[len(have) - len(axes):] != tuple(axes):
        raise ValueError(f"dimension {dim} of {spec} is not split over "
                         f"{tuple(axes)} last")
    rest = have[:len(have) - len(axes)]
    entries = list(spec) + [None] * (dim + 1 - len(spec))
    entries[dim] = rest or None
    return normalize_spec(entries)


def _add_suffix(spec: PartitionSpec, dim: int, axes) -> PartitionSpec:
    used = {a for d in range(len(spec)) for a in spec.axes(d)}
    if used & set(axes):
        raise ValueError(f"{spec} already uses one of {tuple(axes)}")
    entries = list(spec) + [None] * (dim + 1 - len(spec))
    entries[dim] = spec.axes(dim) + tuple(axes)
    return normalize_spec(entries)


def all_gather(s: Sharded, axis, dim: int) -> Sharded:
    """The blocks over ``axis`` concatenated along ``dim`` in mesh order:
    a dimension split over ``axis`` (its last axes) becomes whole over
    it."""
    axes = _axes(axis)
    if not axes:
        return s

    def cat(gb, dev, rank):
        return torch.cat([b.to(dev) for b in gb], dim)
    blocks = _collective(s, axes, cat, "all-gather")
    if s.spec is None:
        return Sharded(None, None, s.mesh, blocks)
    return Sharded(s.shape, _drop_suffix(s.spec, dim, axes), s.mesh, blocks)


def reduce_scatter(s: Sharded, axis, dim: int) -> Sharded:
    """:func:`psum` over ``axis``, each position keeping its part of
    ``dim`` (which becomes split over ``axis``). The sum is made once a
    group and device, into a new tensor (a group of one is copied), and
    each position's part is a view of it: no result shares memory with
    the inputs."""
    axes = _axes(axis)
    if not axes:
        return s
    totals: Dict[Any, torch.Tensor] = {}

    def rs(gb, dev, rank):
        key = (dev, tuple(id(b) for b in gb))
        if key not in totals:
            totals[key] = (_sum(gb, dev) if len(gb) > 1
                           else gb[0].to(dev, copy=True))
        total = totals[key]
        n = total.shape[dim] // len(gb)
        return total.narrow(dim, rank * n, n)
    blocks = _collective(s, axes, rs, "reduce-scatter", by_rank=True)
    if s.spec is None:
        return Sharded(None, None, s.mesh, blocks)
    return Sharded(s.shape, _add_suffix(s.spec, dim, axes), s.mesh, blocks)


def ppermute(s: Sharded, axis: str, perm: Sequence[Tuple[int, int]]
             ) -> Sharded:
    """Each ``(source, destination)`` pair of coordinates along ``axis``
    sends the source's block to the destination (moved to its device); a
    position that receives nothing gets zeros. A per-position value."""
    dst = dict((d, src) for src, d in perm)

    def send(gb, dev, rank):
        if rank in dst:
            return gb[dst[rank]].to(dev)
        return torch.zeros_like(gb[rank], device=dev)
    return Sharded(None, None, s.mesh,
                   _collective(s, (axis,), send, "collective-permute",
                               by_rank=True))


def all_to_all(s: Sharded, axis, split_dim: int, concat_dim: int
               ) -> Sharded:
    """``jax.lax.all_to_all``: each position's block cut into ``n`` equal
    chunks along ``split_dim`` (``n`` the extent of ``axis``); chunk ``i``
    of the position at coordinate ``j`` goes to coordinate ``i``, which
    concatenates what it receives along ``concat_dim`` in mesh order. Its
    gradient is the reverse ``all_to_all`` (autograd's, through ``.to()``,
    ``chunk`` and ``cat``). A per-position value."""
    axes = _axes(axis)
    if not axes:
        return s

    def exchange(gb, dev, rank):
        n = len(gb)
        if gb[0].shape[split_dim] % n:
            raise ValueError(f"dimension {split_dim} of a block "
                             f"{tuple(gb[0].shape)} does not split into {n}")
        return torch.cat([b.chunk(n, split_dim)[rank].to(dev) for b in gb],
                         concat_dim)
    return Sharded(None, None, s.mesh,
                   _collective(s, axes, exchange, "all-to-all",
                               by_rank=True))


def split(s: Sharded, axis, dim: int) -> Sharded:
    """A dimension whole over ``axis`` split over it: each position keeps
    its part (a view), no data moves."""
    axes = _axes(axis)
    if not axes:
        return s
    spec = _add_suffix(s.spec, dim, axes)
    counter = _cost.active()
    shared = counter is not None and counter.interchangeable(s.blocks)
    made: Dict[Any, torch.Tensor] = {}
    blocks = []
    for p, b in enumerate(s.blocks):
        idx, ext = _index(s.mesh, p, axes)
        key = (id(b), s.mesh.flat[p], 0 if shared else idx)
        if key not in made:
            if b.shape[dim] % ext:
                raise ValueError(f"dimension {dim} of {s.shape} does not "
                                 f"split into {ext} blocks")
            n = b.shape[dim] // ext
            made[key] = b.narrow(dim, idx * n, n)
        blocks.append(made[key])
    return Sharded(s.shape, spec, s.mesh, blocks)


def relayout(s: Sharded, spec) -> Sharded:
    """``s`` laid out by ``spec``: itself where it already is; otherwise
    each dimension split differently gathered whole, then split as
    ``spec`` says."""
    spec = normalize_spec(spec, len(s.shape))
    _check_spec(s.mesh, spec)
    if normalize_spec(s.spec) == spec:
        return s
    for d in range(len(s.shape)):
        have = s.spec.axes(d)
        if have and have != spec.axes(d):
            s = all_gather(s, have, d)
    for d in range(len(s.shape)):
        if spec.axes(d) and not s.spec.axes(d):
            s = split(s, spec.axes(d), d)
    return s


# ------------------------------------------------------------- replicas
def _block_groups(s: Sharded) -> Dict[Any, List[int]]:
    """The positions holding each block of ``s`` (by its slices)."""
    out: Dict[Any, List[int]] = {}
    for p in range(len(s.blocks)):
        out.setdefault(_key(block_slices(s.mesh, s.spec, s.shape, p)),
                       []).append(p)
    return out


def canonical_blocks(s: Sharded) -> List[torch.Tensor]:
    """Each block of ``s`` once (the first position's that holds it): the
    elements of the global value, each counted once."""
    return [b for _, b in canonical_groups(s)]


def canonical_groups(s: Sharded) -> List[Tuple[List[int], torch.Tensor]]:
    """(the positions holding it, the first one's tensor) of each block of
    ``s``."""
    return [(ps, s.blocks[ps[0]]) for ps in _block_groups(s).values()]


def unique_blocks(s: Sharded) -> List[Tuple[int, torch.Tensor]]:
    """(first position, tensor) of each distinct tensor of ``s``."""
    seen, out = set(), []
    for p, b in enumerate(s.blocks):
        if id(b) not in seen:
            seen.add(id(b))
            out.append((p, b))
    return out


def sum_replicas(s: Sharded) -> Sharded:
    """Each block the sum of its distinct replicas (the tensors of the
    positions holding it: one per device). The gradient of a replicated
    parameter is the sum over its replicas' gradients, and autograd has
    already summed the uses of each tensor, so this changes only blocks
    held on several devices; on one device it returns ``s``."""
    groups = _block_groups(s)
    counter = _cost.active()
    if counter is not None:
        b = s.blocks[0]
        counter.replicas(groups.values(), b.numel() * b.element_size())
    blocks = list(s.blocks)
    changed = False
    for ps in groups.values():
        reps: Dict[int, torch.Tensor] = {}
        for p in ps:
            reps.setdefault(id(s.blocks[p]), s.blocks[p])
        if len(reps) < 2:
            continue
        changed = True
        parts = list(reps.values())
        made: Dict[Any, torch.Tensor] = {}
        for p in ps:
            dev = s.mesh.flat[p]
            if dev not in made:
                made[dev] = _sum(parts, dev)
            blocks[p] = made[dev]
    return Sharded(s.shape, s.spec, s.mesh, blocks) if changed else s


def shape_dtype(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) of a tensor, a :class:`Sharded` or a pair."""
    if isinstance(leaf, (torch.Tensor, Sharded)):
        return tuple(leaf.shape), leaf.dtype
    return shape_of(leaf), leaf[1]
