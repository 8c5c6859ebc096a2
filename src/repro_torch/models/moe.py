"""Mixture-of-Experts FFN in PyTorch: the reference's sort-based dispatch
with capacity drops (``repro/models/moe.py``), on the same rounding points.

Per dispatch chunk of T tokens (:func:`moe_ffn` chunks along the sequence,
as the reference does, and each chunk has its own capacity):

1. **Route** (:func:`route`): fp32 router logits of the fp32 input, softmax,
   the top-k experts by probability (on a tie the lower expert id, as
   ``lax.top_k``), gates renormalised by ``max(sum, 1e-9)``.
2. **Order**: the T*k (token, slot) replicas stably sorted by expert id;
   each replica's rank is its place among its expert's replicas, so an
   expert's replicas keep (token, slot) order.
3. **Capacity**: ``cap = max(128, min(ceil(T*k*cf/E/128)*128, T))``; a
   replica ranked at or past ``cap`` is dropped and its gate becomes 0.
4. **Expert products** over the padded (E, cap, d) buffer (slot (e, c)
   holds expert e's replica of rank c, zeros past its count), batched over
   the experts (``torch.bmm``) in the activation dtype with fp32
   accumulation; the SiLU gate (or the tanh GELU of an ungated MLP) in fp32.
5. **Combine**: each replica's row of the expert output times its gate in
   the activation dtype, summed over its k slots.

The reference's layout is kept: a decode step of 8 tokens computes E x 128
rows (its capacity floor), most of them zeros; computing only the kept rows
would give the same numbers.

:data:`stats` accumulates, on the device and with no host sync on the
step's path, the replicas dropped and the largest expert load of each call
(see :class:`MoEStats`); read it after a run. A training step's remat
recompute runs each layer again under :meth:`MoEStats.paused`, so a step
counts each layer's forward once.

Gradients flow as in the reference: through the router's gates (softmax,
the top-k values, the renormalisation) and the gathered rows; the sort
order and the capacity drops are integer choices and carry none.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .layers import Leaf

__all__ = ["CHUNK_TOKENS", "CAPACITY_FACTOR", "moe_param_shapes", "moe_logical",
           "capacity",
           "route", "Routing", "moe_ffn", "MoEStats", "stats"]

CHUNK_TOKENS = 65536   # dispatch chunk: bounds the live routing buffers
CAPACITY_FACTOR = 1.25
CAP_QUANTUM = 128      # capacity is a multiple of this, and at least it


class MoEStats:
    """Counters of the MoE calls since :meth:`reset`: on the host the calls
    and the replicas routed (T*k a call), on the device the replicas
    dropped and the largest expert load of any one call (the most replicas
    one expert was given, before the capacity cut). Nothing here waits for
    the device until :meth:`read`."""

    def __init__(self):
        self._paused = False
        self.reset()

    def reset(self) -> None:
        self.calls = self.replicas = 0
        self._dropped = self._max_load = None

    @contextlib.contextmanager
    def paused(self):
        """Count nothing inside (a remat recompute of a counted forward)."""
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    def add(self, counts: torch.Tensor, cap: int, replicas: int) -> None:
        """One dispatch chunk: its ``replicas`` (T*k) and per-expert loads
        ``counts`` at ``cap`` (nothing while :meth:`paused`)."""
        if self._paused:
            return
        dropped = (counts - cap).clamp(min=0).sum()
        load = counts.max()
        if self._dropped is None:
            self._dropped, self._max_load = dropped, load
        else:
            self._dropped = self._dropped + dropped
            self._max_load = torch.maximum(self._max_load, load)
        self.calls += 1
        self.replicas += replicas

    def read(self) -> dict:
        return {"calls": self.calls, "replicas": self.replicas,
                "dropped": 0 if self._dropped is None
                else int(self._dropped),
                "max_load": 0 if self._max_load is None
                else int(self._max_load)}


stats = MoEStats()


def moe_param_shapes(cfg) -> Dict[str, Leaf]:
    """The ``moe`` block's leaves, stacked over layers: the fp32 router
    (d, E) — fp32 in a bf16 model too — and the experts' wg / wu (E, d, f)
    and wd (E, f, d); no wg for an ungated MLP."""
    nl, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": Leaf((nl, d, e), d, dtype=torch.float32),
         "wg": Leaf((nl, e, d, f), d), "wu": Leaf((nl, e, d, f), d),
         "wd": Leaf((nl, e, f, d), f)}
    if not cfg.mlp_gated:
        del p["wg"]
    return p


def moe_logical(cfg) -> Dict[str, tuple]:
    """The logical axes of the ``moe`` leaves (the reference's): experts
    over the expert axis (``data`` by default), their hidden width over
    ``model``."""
    p = {"router": (None, "w_embed", None),
         "wg": (None, "experts", "w_embed", "ff"),
         "wu": (None, "experts", "w_embed", "ff"),
         "wd": (None, "experts", "ff", "w_embed")}
    if not cfg.mlp_gated:
        del p["wg"]
    return p


def capacity(t: int, k: int, e: int,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert for a chunk of ``t`` tokens: the reference's rule."""
    cap = int(math.ceil(t * k * capacity_factor / e / CAP_QUANTUM))
    return max(CAP_QUANTUM, min(cap * CAP_QUANTUM, t))


class Routing(NamedTuple):
    """One chunk's routing: per token its experts ``eidx`` (T, k) and
    renormalised ``gates`` (T, k) fp32; per replica (token-major, T*k) its
    ``rank`` among its expert's replicas and ``keep`` (rank < cap); the
    stable expert ``order`` of the replicas, each expert's ``counts`` (E,)
    and ``starts`` (E,) in that order; and ``cap``."""
    eidx: torch.Tensor
    gates: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    starts: torch.Tensor
    cap: int


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity_factor: float = CAPACITY_FACTOR) -> Routing:
    """Steps 1-3 of the module docstring for the flat tokens ``xf`` (T, d)
    and one layer's fp32 ``router`` (d, E)."""
    t = xf.shape[0]
    e = router.shape[1]
    probs = torch.softmax(xf.float() @ router, dim=-1)
    # a stable descending sort keeps the lower expert first on a tie
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = eidx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    # a scatter, not bincount (which reads the largest id on the host)
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    sorted_rank = (torch.arange(t * top_k, device=xf.device)
                   - starts[flat_e[order]])
    rank = torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)
    cap = capacity(t, top_k, e, capacity_factor)
    return Routing(eidx, gates, rank, rank < cap, order, counts, starts, cap)


def _moe_chunk(xf: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
               capacity_factor: float) -> torch.Tensor:
    """Dispatch, expert FFN and combine for one chunk of flat tokens
    (T, d) -> (T, d) in xf's dtype."""
    t, d = xf.shape
    k = cfg.top_k
    r = route(xf, p["router"], k, capacity_factor)
    stats.add(r.counts, r.cap, t * k)
    e, cap = r.counts.shape[0], r.cap
    # slot (e, c) holds the replica at sorted place starts[e] + c while c is
    # below the expert's count (and so below cap); zeros elsewhere
    c = torch.arange(cap, device=xf.device)
    src = (r.starts[:, None] + c).clamp(max=t * k - 1)
    filled = c < r.counts[:, None]
    buf = torch.where(filled[..., None], xf[r.order[src] // k],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    if cfg.mlp_gated:
        h = (F.silu(torch.bmm(buf, p["wg"]).float()).to(xf.dtype)
             * torch.bmm(buf, p["wu"]))
    else:    # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(buf, p["wu"]).float(),
                   approximate="tanh").to(xf.dtype)
    y_buf = torch.bmm(h, p["wd"])                      # (E, cap, d)
    rows = y_buf[r.eidx.reshape(-1), r.rank.clamp(max=cap - 1)]
    w = torch.where(r.keep, r.gates.reshape(-1),
                    torch.zeros((), device=xf.device)).to(xf.dtype)
    return (rows * w[:, None]).view(t, k, d).sum(dim=1)


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
            capacity_factor: float = CAPACITY_FACTOR,
            chunk_tokens: int = CHUNK_TOKENS) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): one layer's MoE FFN (``p``: the layer's
    router, wg, wu, wd). More than ``chunk_tokens`` tokens are dispatched in
    chunks along the sequence (``chunk_s = chunk_tokens // B``, halved
    until it divides S), each chunk with its own capacity, as the
    reference's ``moe_ffn``."""
    b, s, d = x.shape
    if b * s <= chunk_tokens:
        return _moe_chunk(x.reshape(b * s, d), p, cfg,
                          capacity_factor).view(b, s, d)
    chunk_s = max(1, chunk_tokens // b)
    while s % chunk_s:
        chunk_s //= 2
    out = [_moe_chunk(x[:, i:i + chunk_s].reshape(b * chunk_s, d), p, cfg,
                      capacity_factor).view(b, chunk_s, d)
           for i in range(0, s, chunk_s)]
    return torch.cat(out, dim=1)
