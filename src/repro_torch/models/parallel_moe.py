"""The MoE FFN over a device mesh (the ``moe`` family's sharded steps):
what GSPMD makes of the reference's ``moe_ffn`` under ``moe_logical``,
written out per position, with the one-device ``models.moe`` routing.

Capacity is global, as in the reference, which routes each chunk over the
whole (global) batch's tokens: ``cap = capacity(T_global, k, E)``, and a
replica's rank is its place among all of its expert's replicas in
token-major global order. The batch axes hold contiguous, ordered row
ranges, so each position routes its own tokens (``models.moe.route``: the
local ranks and per-expert counts), gathers the ``(dp, E)`` count matrix
over the batch axes and takes the exclusive prefix of the positions before
it: its global rank of a replica is that offset plus the local rank.

* **Expert parallelism** (the rules put the experts over the batch axes,
  ``E % dp == 0``): each position scatters its kept replicas into an
  ``(E, cap, d)`` buffer at their global ranks (zeros elsewhere); an
  ``all_to_all`` over the batch axes sends expert block ``o`` to position
  ``o``, which sums what it receives (the sources' slots are disjoint, so
  the sum is exact) into its ``(E/dp, cap, d)`` buffer, runs its experts
  with ``ff`` split over ``model`` and sums the ``wd`` partials over
  ``model``; the reverse ``all_to_all`` returns every expert's rows, and
  each position combines its replicas' rows with their gates (a dropped
  replica weighs 0).
* **No expert parallelism** (the experts find no axis; ``w_embed`` then
  takes the batch axes, so the expert weights are FSDP-sharded): the same
  exchange over the capacity slots instead, each position holding
  ``cap/dp`` slots of every expert, with the weights' ``w_embed``
  gathered.

:data:`models.moe.stats` counts the global routing once a chunk (the
remat recompute pauses it, as on one device).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..sharding.placement import (Sharded, all_gather, all_to_all, psum,
                                  smap)
from ..sharding.rules import logical_to_spec
from . import moe
from . import parallel as par

__all__ = ["expert_parallel", "routing", "moe_ffn"]


def expert_parallel(cfg, rules) -> bool:
    """Whether the rules put the experts over the batch axes (expert
    parallelism) — else they are whole and the capacity slots split.
    Raises ``NotImplementedError`` for a layout the FFN cannot run."""
    plan = par.Plan.of(rules)
    spec = logical_to_spec(rules, moe.moe_logical(cfg)["wu"],
                           (cfg.n_layers, cfg.n_experts, cfg.d_model,
                            cfg.d_ff))
    ax = spec.axes(1)
    if ax and ax != plan.dp:
        raise NotImplementedError(
            f"{cfg.name}: experts over {ax}, the batch over {plan.dp}: the "
            "sharded MoE FFN takes expert parallelism over the batch axes "
            "only")
    return bool(ax)


def routing(h: Sharded, router: Sharded, cfg, plan):
    """The global routing of the tokens ``h`` (B, S, d) (one dispatch
    chunk) with the gathered fp32 ``router`` (d, E). Returns
    (per-position (eidx (T_j, k), gates (T_j, k) fp32, global rank
    (T_j*k,), keep (T_j*k,), local sorted order, local counts (E,), local
    starts (E,), offsets (E,): the replicas of the positions before),
    the global counts (E,) on every position, cap)."""
    k, e = cfg.top_k, cfg.n_experts
    cap = moe.capacity(h.shape[0] * h.shape[1], k, e)

    def local(x, r):
        ro = moe.route(x.reshape(-1, x.shape[-1]), r, k)
        return ro.eidx, ro.gates, ro.rank, ro.order, ro.counts, ro.starts
    eidx, gates, rank, order, counts, starts = smap(local, h, router)
    allc = all_gather(smap(lambda c: c[None], counts), plan.dp, 0)

    def offsets(i, c):
        return c[:i].sum(0), c.sum(0)
    off, total = smap(offsets, allc, coord=plan.dp)

    def rank_of(ei, r, o):
        g = o[ei.reshape(-1)] + r
        return g, g < cap
    grank, keep = smap(rank_of, eidx, rank, off)
    return (eidx, gates, grank, keep, order, counts, starts, off), total, cap


def _chunk(h: Sharded, p: Dict[str, Sharded], cfg, plan, ep: bool
           ) -> Sharded:
    """Dispatch, the experts and combine for one chunk: h (B, S, d) over
    the batch axes -> (B, S, d) laid out as ``h``."""
    k, e, d = cfg.top_k, cfg.n_experts, cfg.d_model
    n = plan.n
    (eidx, gates, grank, keep, order, counts, starts, off), total, cap = \
        routing(h, par._fsdp(p["router"], 0), cfg, plan)
    moe.stats.add(total.blocks[0], cap, h.shape[0] * h.shape[1] * k)
    if not ep and cap % n:
        raise NotImplementedError(
            f"{cfg.name}: {e} experts do not split over the {n} batch "
            f"positions, and neither does the capacity {cap}")
    bd = 0 if ep else 1                      # the buffer dimension split

    def scatter(x, order, counts, starts, off):
        """(1, E, cap, d): the position's kept replicas at their global
        ranks, zeros elsewhere."""
        xf = x.reshape(-1, d)
        tk = xf.shape[0] * k
        lr = torch.arange(cap, device=x.device)[None, :] - off[:, None]
        filled = (lr >= 0) & (lr < counts[:, None])
        src = (starts[:, None] + lr).clamp(0, tk - 1)
        buf = torch.where(filled[..., None], xf[order[src] // k],
                          torch.zeros((), dtype=x.dtype, device=x.device))
        return buf[None]
    sent = all_to_all(smap(scatter, h, order, counts, starts, off), plan.dp,
                      1 + bd, 0)
    buf = smap(lambda b: b.sum(0), sent)     # (E/dp, cap, d) | (E, cap/dp, d)

    f_cols = par._ranges(cfg.d_ff, plan.m)
    wu = par._take(par._fsdp(p["wu"], 1), 2, f_cols, plan)
    wd = par._take(par._fsdp(p["wd"], 2), 1, f_cols, plan)
    ws = [wu] + ([par._take(par._fsdp(p["wg"], 1), 2, f_cols, plan)]
                 if cfg.mlp_gated else [])

    def experts(b, wu, wd, *wg):
        if cfg.mlp_gated:
            hid = (F.silu(torch.bmm(b, wg[0]).float()).to(b.dtype)
                   * torch.bmm(b, wu))
        else:   # jax.nn.gelu's default is the tanh approximation
            hid = F.gelu(torch.bmm(b, wu).float(),
                         approximate="tanh").to(b.dtype)
        return torch.bmm(hid, wd)
    y = psum(smap(experts, buf, wu, wd, *ws[1:]), plan.tp)
    back = all_to_all(smap(lambda y: y[None].expand(n, *y.shape), y),
                      plan.dp, 0, 1 + bd)

    def combine(x, yb, eidx, gates, grank, keep):
        rows = yb[0][eidx.reshape(-1), grank.clamp(max=cap - 1)]
        w = torch.where(keep, gates.reshape(-1),
                        torch.zeros((), device=x.device)).to(x.dtype)
        return (rows * w[:, None]).view(-1, k, d).sum(dim=1).view(x.shape)
    return smap(combine, h, back, eidx, gates, grank, keep, out=h.spec)


def moe_ffn(h: Sharded, p: Dict[str, Sharded], cfg, plan,
            chunk_tokens: int = moe.CHUNK_TOKENS) -> Sharded:
    """h (B, S, d) over the batch axes -> (B, S, d): one layer's MoE FFN
    (``p``: the layer's placed router, wg, wu, wd). More than
    ``chunk_tokens`` global tokens are dispatched in chunks along the
    sequence (``chunk_s = chunk_tokens // B``, halved until it divides S),
    each with its own global capacity, as the reference's ``moe_ffn``."""
    ep = bool(p["wu"].spec.axes(0))
    b, s, _ = h.shape
    if b * s <= chunk_tokens:
        return _chunk(h, p, cfg, plan, ep)
    chunk_s = max(1, chunk_tokens // b)
    while s % chunk_s:
        chunk_s //= 2
    parts = [_chunk(smap(lambda x: x[:, i:i + chunk_s], h, out=h.spec), p,
                    cfg, plan, ep) for i in range(0, s, chunk_s)]
    return smap(lambda *xs: torch.cat(xs, dim=1), *parts, out=h.spec)
