"""What one step of a sharded program costs each mesh position, counted
without running it: the port's counterpart of the reference's
``utils/hlo.py`` ``analyze_hlo``.

The reference compiles a step and walks the partitioned HLO: the dots'
flops, every top-level op's operand and result bytes, the collectives'
result bytes by kind, loop bodies weighted by their trip counts; every
chip runs that one program. The port has no HLO. It runs the step once on
``meta`` tensors (nothing is allocated, nothing computed: an op only makes
its output's shape and strides) under a :class:`Counter`, a
``TorchDispatchMode`` that sees every aten op, forward and backward, and
charges it to the mesh positions that would run it:

* inside ``sharding.placement.smap``, the positions that share the call
  (and in the backward of the kernels' autograd Functions, the positions
  of their forward: :func:`charged`, :func:`at`); elsewhere (autograd's
  backward, the in-place updates of shared blocks) the positions that hold
  every tensor operand (the intersection of the operands' positions). An
  op whose operands no position holds together exists only because
  positions share one tensor here (autograd summing the gradients of a
  block several positions read): it is charged to none, as is an op none
  of whose operands any position is known to hold (a program on plain
  tensors is one position, every op its own: :func:`count`).
* **flops**: the dot products' 2 M N K (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot``, convolutions), as ``analyze_hlo`` counts
  ``dot``s; elementwise arithmetic is not counted.
* **bytes**: each op that is not a view reads each tensor operand once and
  writes each output once: the port runs eagerly, an op a pass over memory
  (the reference's fusions hide some of these passes).
* the hand-written kernels B7 (``flash_attention``), B8
  (``decode_attention``) and B9 (``ssd_scan``) take a ``meta`` route in
  their wrappers (:func:`meta_route`): the same outputs and scratch,
  empty, charged by the kernel's own count of operations and bytes
  (:func:`charge_kernel` with ``kernels.attention.flash_work`` /
  ``decode_work``, ``kernels.ssd.ssd_work``). B8 counts every slot of the
  ring as live (there is no data to say which are). Their backward is the
  plain version's derivative, counted op by op, as the card runs it.
* **collectives** (``placement``'s ``psum`` and ``pmax`` as
  ``all-reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``,
  ``ppermute`` as ``collective-permute``): each position is charged the
  bytes of the block it receives, as the reference counts result shapes;
  autograd's backward through one charges the reverse collective
  (all-gather <-> reduce-scatter, all-reduce, all-to-all, permute) the
  bytes of each position's input block. A group of one position moves
  nothing and is no collective. A block several positions hold gets its
  gradient summed over them (``sum_replicas``): an all-reduce of the block
  (on one device the port needs none; each chip of a mesh would). A
  collective's own arithmetic is not counted as ops; its bytes in and out
  count as the reference counts a collective's operands and result.
* **memory**: every storage an op makes is live from that op until it is
  freed, on the devices of the positions that hold it; :class:`Cost`
  keeps each device's peak of live bytes (inputs included). Python's
  cyclic collector is off during a count, so that the peak does not
  depend on when it runs.

Where each position is its own device (the production meshes) and every
block is a meta tensor, blocks of one shape are interchangeable for the
count (:meth:`Counter.interchangeable`): the dry run's placement gives
every position whose block has one shape the same meta tensor, and
``placement.split`` and the by-rank collectives hand every position of a
group the same block, so a call ``smap`` makes for them serves them all
and is charged to each: a 256-position step costs about what its distinct
block shapes do. Where positions share a device (the one-card meshes), or
the blocks hold values, every block is its own, as in a real run, and the
program's output is its own.

The hooks: ``sharding.placement`` (``smap``, the collectives, ``split``,
``sum_replicas``), the kernel wrappers (:func:`meta_route`,
:func:`charge_kernel`, and :func:`charged` / :func:`at` in their autograd
Functions) and ``train.step`` (:func:`repeatable`, :func:`at`) each ask
:func:`active` for the counter and do nothing more where it is None. This
module imports nothing else of the port.

Depth: the dry run counts the step at depths 1, 2 and 3 and carries each
figure to full depth (:func:`extrapolate`), as the reference scales a loop
body by its trip count: flops and collective bytes grow by one layer's
each layer, exactly; bytes also by a term in the depth squared (the eager
backward of a stacked leaf); the peak, an estimate, by the last step's
rise. A function wrapped in
:func:`repeatable` (a microbatch's forward and backward) is counted at its
first call and its cost added again at each later call with inputs of the
same shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import math
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KINDS", "Counter", "Cost", "active", "charged", "at",
           "meta_route", "charge_kernel", "count", "repeatable",
           "extrapolate"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# the collective autograd's backward runs for each forward one
BACKWARD = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
            "all-reduce": "all-reduce", "all-to-all": "all-to-all",
            "collective-permute": "collective-permute"}

_aten = torch.ops.aten
# ops that move no bytes of their own (an allocation, a reshape of a fresh
# temporary)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten._unsafe_view.default}
_STATE = threading.local()


def active() -> Optional["Counter"]:
    """The counter counting on this thread, or None."""
    return getattr(_STATE, "counter", None)


def charged() -> Optional[int]:
    """The positions an op made now would be charged to inside a call, to
    charge a backward to later (:func:`at`); None outside one."""
    c = active()
    return None if c is None else c._ctx


@contextlib.contextmanager
def at(mask):
    """Charge the ops inside to ``mask``'s positions (a bit mask, or a
    sequence of positions); nothing changes where no counter counts, or
    ``mask`` is None."""
    c = active()
    if c is None or mask is None:
        yield
        return
    with c.at(mask if isinstance(mask, int) else c.mask(mask)):
        yield


def meta_route(*tensors) -> bool:
    """Whether a hand-written kernel's wrapper takes its meta route: a
    counter counts and every operand is a meta tensor. The route makes
    the kernel's outputs (and scratch) empty and charges
    :func:`charge_kernel` in place of the launch; outside a count, meta
    tensors reach the wrapper's device check, which refuses them."""
    return (active() is not None
            and all(t.device.type == "meta" for t in tensors))


def charge_kernel(ops: float, nbytes: float, *tensors) -> None:
    """A kernel's meta route: ``ops`` and ``nbytes`` charged where an op
    on ``tensors`` would be; nothing runs and no launch is counted."""
    c = active()
    if c is not None:
        c.kernel(ops, nbytes, *tensors)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, ins, outs) -> float:
    """2 M N K of a dot-product op (0 for any other op)."""
    if func in (_aten.mm.default, _aten.addmm.default):
        a = ins[0] if func is _aten.mm.default else ins[1]
        return 2.0 * outs[0].numel() * a.shape[1]
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        a = ins[0] if func is _aten.bmm.default else ins[1]
        return 2.0 * outs[0].numel() * a.shape[2]
    if func is _aten.mv.default:
        return 2.0 * ins[0].numel()
    if func is _aten.dot.default:
        return 2.0 * ins[0].numel()
    if func is _aten.convolution.default:
        return 2.0 * outs[0].numel() * math.prod(ins[1].shape[1:])
    return 0.0


def _tensors(args, kwargs) -> list:
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _outs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


# aten op -> whether its outputs are fresh tensors (Counter._run)
_FRESH: Dict[Any, bool] = {}


def _key(x):
    """A hashable stand-in for an op's arguments: a tensor by its layout."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


def _mask_of(t) -> Optional[int]:
    return getattr(t, "_cost_mask", None)


class Counter(TorchDispatchMode):
    """Counts what each of ``positions`` mesh positions runs (see the
    module docstring). ``devices[p]`` is position ``p``'s device (an int;
    default: each position its own), for the live bytes. Positions are bit
    masks (bit ``p`` for position ``p``)."""

    def __init__(self, positions: int = 1,
                 devices: Optional[Sequence[int]] = None):
        super().__init__()
        self.n = int(positions)
        self.all = (1 << self.n) - 1
        dev = np.arange(self.n) if devices is None else np.asarray(devices)
        self._dev = dev.astype(np.int64)
        # each position its own device (see :meth:`interchangeable`)
        self._own = len(np.unique(self._dev)) == self.n > 1
        nd = int(self._dev.max()) + 1
        self.live = np.zeros(nd)
        self.peak = np.zeros(nd)
        self.flops: Dict[int, float] = defaultdict(float)
        self.bytes: Dict[int, float] = defaultdict(float)
        self.coll: Dict[tuple, float] = defaultdict(float)
        self._ctx: Optional[int] = None
        self._paused = 0
        self._storages: Dict[int, list] = {}
        self._devbits: Dict[int, int] = {}
        self._index: Dict[int, np.ndarray] = {}
        self._replays: Dict[Any, Any] = {}
        self._forms: Dict[Any, Any] = {}

    # ------------------------------------------------------------- masks
    def positions(self, mask: int) -> np.ndarray:
        """The positions of a bit mask, rising."""
        bits = np.unpackbits(np.frombuffer(
            mask.to_bytes((self.n + 7) // 8, "little"), np.uint8),
            bitorder="little")[:self.n]
        return np.flatnonzero(bits)

    def mask(self, positions) -> int:
        """The bit mask of some positions."""
        m = 0
        for p in positions:
            m |= 1 << int(p)
        return m

    def _devices(self, mask: int) -> int:
        """The devices of ``mask``'s positions, as a bit mask."""
        d = self._devbits.get(mask)
        if d is None:
            d = 0
            for i in np.unique(self._dev[self.positions(mask)]):
                d |= 1 << int(i)
            self._devbits[mask] = d
        return d

    def _idx(self, devs: int) -> np.ndarray:
        """The device indices of a device bit mask."""
        idx = self._index.get(devs)
        if idx is None:
            idx = self._index[devs] = np.array(
                [i for i in range(len(self.live)) if devs >> i & 1],
                dtype=np.intp)
        return idx

    def interchangeable(self, blocks) -> bool:
        """Whether blocks of one shape may stand for each other (one
        block serving every position of a group): where each position is
        its own device and every block is a meta tensor, which has no
        values to tell them apart."""
        return self._own and all(b.device.type == "meta" for b in blocks)

    @contextlib.contextmanager
    def at(self, mask: int):
        """Charge the ops inside to ``mask``'s positions."""
        was, self._ctx = self._ctx, mask
        try:
            yield
        finally:
            self._ctx = was

    @contextlib.contextmanager
    def paused(self):
        """Count nothing inside."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def where(self, tensors) -> tuple:
        """(the positions an op on ``tensors`` is charged to, the positions
        its outputs live on, or None where no position is known)."""
        if self._ctx is not None:
            return self._ctx, self._ctx
        m, u = None, 0
        for t in tensors:
            x = _mask_of(t)
            if x is None:
                continue
            u |= x
            m = x if m is None else m & x
        if m is None:
            return 0, None
        return (m, m) if m else (0, u)

    # ------------------------------------------------------------ memory
    def hold(self, t: torch.Tensor, mask: int) -> None:
        """``t`` lives on ``mask``'s positions: marked, and its storage
        counted live on their devices until it is freed."""
        t._cost_mask = mask
        st = t.untyped_storage()
        key = st._cdata
        devs = self._devices(mask)
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [
                st.nbytes(), 0, weakref.ref(st, functools.partial(
                    self._free, key))]
        new = devs & ~rec[1]
        if new:
            rec[1] |= new
            idx = self._idx(new)
            live = self.live[idx] + rec[0]
            self.live[idx] = live
            self.peak[idx] = np.maximum(self.peak[idx], live)

    def _free(self, key: int, _ref=None) -> None:
        nb, devs, _ = self._storages.pop(key)
        self.live[self._idx(devs)] -= nb

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        ins = _tensors(args, kwargs)
        out = self._run(func, args, kwargs, ins)
        outs = _outs(out)
        if func.is_view:
            m = _mask_of(ins[0]) if ins else None
            if m is not None:
                for o in outs:
                    o._cost_mask = m
            return out
        mask, lives = self.where(ins)
        if mask:
            fl = _dot_flops(func, ins, outs)
            if fl:
                self.flops[mask] += fl
            if func not in _NO_TRAFFIC:
                nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(o)
                                                        for o in outs)
                if nb:
                    self.bytes[mask] += nb
        if not func._schema.is_mutable and lives:
            for o in outs:
                self.hold(o, lives)
        return out

    def _run(self, func, args, kwargs, ins):
        """``func`` on its arguments. On meta tensors a fresh op's outputs
        depend only on its operands' shapes, strides and dtypes and its
        other arguments: each such op is run once per signature, and new
        empty outputs of the same layout serve its later calls (a
        production cell counts in about half the time it takes with every
        op run)."""
        ok = _FRESH.get(func)
        if ok is None:
            ok = _FRESH[func] = (
                not func.is_view and not func._schema.is_mutable
                and func not in _NO_TRAFFIC and not any(
                    r.alias_info is not None for r in func._schema.returns)
                and all(str(r.type) == "Tensor"
                        for r in func._schema.returns))
        if not ok or not ins or any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        form = self._forms.get(key)
        if form is None:
            out = func(*args, **kwargs)
            outs = _outs(out)
            self._forms[key] = (isinstance(out, torch.Tensor), [
                (tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        single, layouts = form
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in layouts]
        return outs[0] if single else tuple(outs)

    def __enter__(self):
        # no cyclic collection inside a count: when a cycle's storages are
        # freed would depend on the collector's timing, and so the peak
        self._prev, self._gc = active(), gc.isenabled()
        gc.disable()
        _STATE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _STATE.counter = self._prev
        if self._gc:
            gc.enable()
        return super().__exit__(*exc)

    # ------------------------------------------------- kernels, collectives
    def kernel(self, flops: float, nbytes: float, *tensors) -> None:
        """A hand-written kernel's meta route: ``flops`` and ``nbytes``
        charged where an op on ``tensors`` would be."""
        mask, _ = self.where(tensors)
        if mask:
            self.flops[mask] += flops
            self.bytes[mask] += nbytes

    def collective(self, kind: str, combine: Callable, gb, dev, rank):
        """One result block of a collective (``combine(gb, dev, rank)``),
        its arithmetic not counted, linked for autograd so that its
        backward charges the reverse collective. Returns (the block, a cell
        :meth:`received` fills with its receivers)."""
        cell = [0]
        if torch.is_grad_enabled() and any(b.requires_grad for b in gb):
            r = _Link.apply(self, kind, cell, combine, dev, rank, *gb)
        else:
            with self.paused():
                r = combine(gb, dev, rank)
        return r, cell

    def received(self, kind: str, r: torch.Tensor, inp: torch.Tensor,
                 cell: list, owners: int) -> None:
        """``owners``' positions each received ``r`` (from their input
        block ``inp``) by a ``kind`` collective."""
        cell[0] = owners
        nb = _nbytes(r)
        self.coll[(kind, owners)] += nb
        self.bytes[owners] += nb + _nbytes(inp)
        self.hold(r, owners)

    def replicas(self, groups, nbytes: int) -> None:
        """Gradient blocks of ``nbytes`` each held by the positions of each
        of ``groups``: each summed over its group (an all-reduce)."""
        for ps in groups:
            if len(ps) > 1:
                m = self.mask(ps)
                self.coll[("all-reduce", m)] += nbytes
                self.bytes[m] += 2 * nbytes

    # ------------------------------------------------------------ replay
    def replayed(self, fn, args, kwargs):
        """``fn(*args, **kwargs)`` under :func:`repeatable`'s rule."""
        key = (fn, _signature(args), _signature(kwargs))
        rec = self._replays.get(key)
        if rec is None:
            before = (dict(self.flops), dict(self.bytes), dict(self.coll))
            live0, peak0 = self.live.copy(), self.peak.copy()
            self.peak[:] = self.live
            out = fn(*args, **kwargs)
            rise = self.peak - live0
            self.peak = np.maximum(peak0, self.peak)
            deltas = [{k: v - b.get(k, 0.0) for k, v in now.items()
                       if v != b.get(k, 0.0)}
                      for now, b in zip((self.flops, self.bytes, self.coll),
                                        before)]
            self._replays[key] = (deltas, rise, _template(out, {}))
            return out
        deltas, rise, form = rec
        for acc, d in zip((self.flops, self.bytes, self.coll), deltas):
            for k, v in d.items():
                acc[k] += v
        self.peak = np.maximum(self.peak, self.live + rise)
        return _fresh(form, {}, self)

    # ----------------------------------------------------------- results
    def result(self) -> "Cost":
        def spread(d):
            a = np.zeros(self.n)
            for m, v in d.items():
                a[self.positions(m)] += v
            return a
        coll = {k: spread({m: v for (kk, m), v in self.coll.items()
                           if kk == k}) for k in KINDS}
        return Cost(spread(self.flops), spread(self.bytes), coll,
                    self.peak.copy())


class _Link(torch.autograd.Function):
    """A collective's result block with autograd through it: the forward
    is the collective's own arithmetic (uncounted); the backward charges
    the receivers the reverse collective and returns gradients of the
    inputs' layouts (on meta tensors, empty ones; elsewhere the
    collective's own, recomputed under autograd, uncounted)."""

    @staticmethod
    def forward(ctx, counter, kind, cell, combine, dev, rank, *gb):
        ctx.counter, ctx.kind, ctx.cell = counter, kind, cell
        ctx.combine, ctx.dev, ctx.rank = combine, dev, rank
        # which inputs are one tensor, and what each needs
        ids = {}
        ctx.slots = [ids.setdefault(id(b), len(ids)) for b in gb]
        ctx.wants = [b.requires_grad for b in gb]
        ctx.masks = [_mask_of(b) for b in gb]
        ctx.like = [(b.shape, b.stride(), b.dtype) for b in gb]
        if all(b.device.type == "meta" for b in gb):
            # the backward needs only the layouts: nothing of the
            # collective (nor a closure over its sums) is kept alive
            ctx.combine = None
        else:
            ctx.combine = combine         # the gradients' values matter
            ctx.save_for_backward(*gb)
        with counter.paused():
            return combine(gb, dev, rank)

    @staticmethod
    def backward(ctx, grad):
        c = ctx.counter
        if ctx.combine is None:
            by = {}
            for i, w, (sh, st, dt) in zip(ctx.slots, ctx.wants, ctx.like):
                if w and i not in by:
                    by[i] = torch.empty_strided(sh, st, dtype=dt,
                                                device="meta")
        else:
            gb = ctx.saved_tensors
            leaves, order = {}, []
            for b, i, w in zip(gb, ctx.slots, ctx.wants):
                if i not in leaves:
                    leaves[i] = b.detach().requires_grad_(w)
                    order.append(i)
            with c.paused(), torch.enable_grad():
                out = ctx.combine([leaves[i] for i in ctx.slots], ctx.dev,
                                  ctx.rank)
                want = [i for i in order if leaves[i].requires_grad]
                got = torch.autograd.grad(out, [leaves[i] for i in want],
                                          grad, allow_unused=True)
            by = dict(zip(want, got))
        owners = ctx.cell[0]
        if owners:
            sh, _, dt = ctx.like[ctx.rank if ctx.rank < len(ctx.like) else 0]
            nb = math.prod(sh) * torch.empty((), dtype=dt).element_size()
            c.coll[(BACKWARD[ctx.kind], owners)] += nb
            c.bytes[owners] += nb + _nbytes(grad)
        grads, seen = [], set()
        for i, m in zip(ctx.slots, ctx.masks):
            g = None
            if i not in seen:
                seen.add(i)
                g = by.get(i)
                if g is not None:
                    c.hold(g, owners if m is None else m)
            grads.append(g)
        return (None,) * 6 + tuple(grads)


def _placed(x) -> bool:
    """Whether ``x`` is a placed value (``sharding.placement.Sharded``):
    its ``blocks`` the tensors, its ``shape``, ``spec`` and ``mesh`` the
    layout, and its type rebuilt from the four."""
    return all(hasattr(x, a) for a in ("shape", "spec", "mesh", "blocks"))


def _signature(x):
    """A hashable stand-in for ``x`` that depends only on shapes, dtypes
    and layouts (placed values), and on the value of anything else."""
    if _placed(x):
        return ("S", x.shape, x.spec, x.dtype,
                tuple(tuple(b.shape) for b in x.blocks))
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device, x.requires_grad)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return x


class _Like(tuple):
    """A tensor's place in a template: (its index, shape, stride, dtype,
    device, positions)."""


def _template(x, ids):
    """``x`` with each tensor replaced by a :class:`_Like` (the same index
    where ``x`` held the same tensor): no tensor is kept alive."""
    if isinstance(x, torch.Tensor):
        i = ids.setdefault(id(x), len(ids))
        return _Like((i, tuple(x.shape), x.stride(), x.dtype, x.device,
                      _mask_of(x)))
    if _placed(x):
        return type(x)(x.shape, x.spec, x.mesh,
                       [_template(b, ids) for b in x.blocks])
    if isinstance(x, dict):
        return {k: _template(v, ids) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_template(v, ids) for v in x)
    return x


def _fresh(x, made, counter):
    """A template's structure with a new empty tensor for each
    :class:`_Like` (one per index), held where its original was."""
    if isinstance(x, _Like):
        i, shape, stride, dtype, device, mask = x
        if i not in made:
            t = torch.empty_strided(shape, stride, dtype=dtype,
                                    device=device)
            if mask is not None:
                counter.hold(t, mask)
            made[i] = t
        return made[i]
    if _placed(x):
        return type(x)(x.shape, x.spec, x.mesh,
                       [_fresh(b, made, counter) for b in x.blocks])
    if isinstance(x, dict):
        return {k: _fresh(v, made, counter) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v, made, counter) for v in x)
    return x


def repeatable(fn):
    """``fn`` as it is; under a :class:`Counter`, counted at its first call
    and, at each later call whose inputs have the same shapes (and whose
    other arguments are equal), not run: its first call's counts and its
    rise of the live peak are added again, and it returns new empty
    outputs shaped as the first call's."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        c = active()
        if c is None:
            return fn(*args, **kwargs)
        return c.replayed(fn, args, kwargs)
    return wrapped


# ---------------------------------------------------------------- results
@dataclasses.dataclass
class Cost:
    """Per-position counts (``flops``, ``bytes``, ``collectives`` by kind:
    arrays over positions) and each device's peak live bytes (``peak``)."""
    flops: np.ndarray
    bytes: np.ndarray
    collectives: Dict[str, np.ndarray]
    peak: np.ndarray

    def total(self) -> np.ndarray:
        """Each position's collective bytes over every kind."""
        return sum(self.collectives.values())

    def per_chip(self) -> dict:
        """The largest count over positions, figure by figure: the busiest
        chip's (``flops``, ``bytes``, ``collectives`` by kind,
        ``collective_total``)."""
        return {"flops": float(self.flops.max()),
                "bytes": float(self.bytes.max()),
                "collectives": {k: float(v.max())
                                for k, v in self.collectives.items()
                                if v.max() > 0},
                "collective_total": float(self.total().max())}


def extrapolate(counts: Sequence[Cost], depths: Sequence[int],
                d: int) -> Cost:
    """Counts at ``depths`` (consecutive, rising) carried to depth ``d``:
    flops, collective bytes and the peak linearly from the last two (the
    flops and collectives grow by one layer's each layer; the peak, once
    the deepest phase holds it, by what a layer keeps), bytes through all
    three by a quadratic (the eager backward of a stacked (L, ...) leaf
    writes its whole gradient for each layer it feeds: L^2 bytes); one
    count is itself."""
    if len(counts) == 1:
        return counts[0]
    (a, b), (da, db) = counts[-2:], depths[-2:]
    t = (d - da) / (db - da)

    def lin(x, y):
        return x + (y - x) * t
    nb = lin(a.bytes, b.bytes)
    if len(counts) == 3:
        x, (d0, d1, d2) = counts[0].bytes, depths
        nb = (x * (d - d1) * (d - d2) / ((d0 - d1) * (d0 - d2))
              + a.bytes * (d - d0) * (d - d2) / ((d1 - d0) * (d1 - d2))
              + b.bytes * (d - d0) * (d - d1) / ((d2 - d0) * (d2 - d1)))
    return Cost(lin(a.flops, b.flops), nb,
                {k: lin(a.collectives[k], b.collectives[k]) for k in KINDS},
                lin(a.peak, b.peak))


def count(fn: Callable, *args, positions: int = 1,
          devices: Optional[Sequence[int]] = None,
          pause: Optional[Callable] = None, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`Cost`) under a new
    :class:`Counter` of ``positions`` (one: every op charged to it);
    inside ``pause()`` where it is given (a context that stops counters of
    the program's own, which a count must not move)."""
    counter = Counter(positions, devices)
    with pause() if pause else contextlib.nullcontext(), counter:
        with counter.at(counter.all) if positions == 1 else \
                contextlib.nullcontext():
            out = fn(*args, **kwargs)
    return out, counter.result()
