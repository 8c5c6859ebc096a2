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

The buffer ``(E, cap, d)`` is laid out as the reference's
``("experts", "moe_cap", None)`` resolves: the experts over their axes
``ex`` (the rules' ``experts``, a part of the batch axes) and the capacity
slots over the batch axes left ``cx``. The position at index ``o`` over
the batch axes holds expert block ``o_ex`` and slot block ``o_cx`` (its
indices over ``ex`` and ``cx``), and a replica of (expert e, global rank
r) goes to the position with ``o_ex = e // (E/|ex|)`` and ``o_cx = r //
(cap/|cx|)``:

* each position scatters its kept replicas into an ``(E, cap, d)`` buffer
  at their global ranks (zeros elsewhere), cut into the positions' blocks;
  one ``all_to_all`` over the batch axes sends each block to its position,
  which sums what it receives (the sources' slots are disjoint, so the sum
  is exact) into its ``(E/|ex|, cap/|cx|, d)`` buffer, runs its experts
  with ``ff`` split over ``model`` and sums the ``wd`` partials over
  ``model``; the reverse ``all_to_all`` returns every block, and each
  position combines its replicas' rows with their gates (a dropped replica
  weighs 0).
* **Expert parallelism** (``ex`` the batch axes, ``E % dp == 0``): the
  blocks are expert blocks. **No expert parallelism** (the experts find
  no axis; ``w_embed`` then takes the batch axes, so the expert weights
  are FSDP-sharded and gathered): the blocks are ``cap/dp`` slots of
  every expert. **Both** (a pod batch ``("pod", "data")`` with the
  experts over ``data``: qwen3_moe_235b on the (2, 16, 16) mesh): position
  (p, d) holds expert block d and slot block p, and the weights'
  ``w_embed`` is FSDP-sharded over ``pod``.

:data:`models.moe.stats` counts the global routing once a chunk (the
remat recompute pauses it, as on one device).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.placement import (Sharded, all_gather, all_to_all, psum,
                                  smap)
from ..sharding.rules import logical_to_spec
from . import moe
from . import parallel as par

__all__ = ["expert_parallel", "routing", "chunk_len", "moe_ffn"]


def expert_parallel(cfg, rules) -> bool:
    """Whether the rules put the experts over (a part of) the batch axes
    (expert parallelism) — else they are whole and the capacity slots
    split. Raises ``NotImplementedError`` for a layout the FFN cannot
    run (experts over an axis that does not split the batch)."""
    plan = par.Plan.of(rules)
    spec = logical_to_spec(rules, moe.moe_logical(cfg)["wu"],
                           (cfg.n_layers, cfg.n_experts, cfg.d_model,
                            cfg.d_ff))
    ax = spec.axes(1)
    if any(a not in plan.dp for a in ax):
        raise NotImplementedError(
            f"{cfg.name}: experts over {ax}, the batch over {plan.dp}: the "
            "sharded MoE FFN takes expert parallelism over the batch axes "
            "only")
    return bool(ax)


def _blocks(mesh, dp: Tuple[str, ...], ex: Tuple[str, ...]):
    """(the capacity axes ``cx``: ``dp`` less ``ex``; |ex|, |cx|; for each
    position index over ``dp`` (mesh order), its block's index in the
    expert-major grid of (expert block, slot block), or None where that
    is the position index itself)."""
    cx = tuple(a for a in dp if a not in ex)
    sizes = [mesh.shape[a] for a in dp]
    ne = int(np.prod([mesh.shape[a] for a in ex]))
    nc = int(np.prod([mesh.shape[a] for a in cx]))
    grid = []
    for o in range(ne * nc):
        c = dict(zip(dp, np.unravel_index(o, sizes)))
        e = int(np.ravel_multi_index([c[a] for a in ex],
                                     [mesh.shape[a] for a in ex])) if ex else 0
        k = int(np.ravel_multi_index([c[a] for a in cx],
                                     [mesh.shape[a] for a in cx])) if cx else 0
        grid.append(e * nc + k)
    return cx, ne, nc, (None if grid == list(range(ne * nc)) else grid)


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


def _chunk(h: Sharded, p: Dict[str, Sharded], cfg, plan,
           ex: Tuple[str, ...]) -> Sharded:
    """Dispatch, the experts and combine for one chunk: h (B, S, d) over
    the batch axes -> (B, S, d) laid out as ``h``; ``ex`` the experts'
    axes."""
    k, e, d = cfg.top_k, cfg.n_experts, cfg.d_model
    n = plan.n
    (eidx, gates, grank, keep, order, counts, starts, off), total, cap = \
        routing(h, par._fsdp(p["router"], 0), cfg, plan)
    moe.stats.add(total.blocks[0], cap, h.shape[0] * h.shape[1] * k)
    cx, ne, nc, grid = _blocks(h.mesh, plan.dp, ex)
    if cap % nc:
        raise NotImplementedError(
            f"{cfg.name}: {e} experts over {ex or 'no axis'}, and the "
            f"capacity {cap} does not split over the {nc} positions of "
            f"{cx}")
    el, cl = e // ne, cap // nc              # a position's block
    at = None if grid is None else torch.tensor(grid)
    inv = None if grid is None else torch.tensor(np.argsort(grid))

    def scatter(x, order, counts, starts, off):
        """(n, E/|ex|, cap/|cx|, d): the position's kept replicas at their
        global ranks, zeros elsewhere, block ``o`` the one position ``o``
        holds."""
        xf = x.reshape(-1, d)
        tk = xf.shape[0] * k
        lr = torch.arange(cap, device=x.device)[None, :] - off[:, None]
        filled = (lr >= 0) & (lr < counts[:, None])
        src = (starts[:, None] + lr).clamp(0, tk - 1)
        buf = torch.where(filled[..., None], xf[order[src] // k],
                          torch.zeros((), dtype=x.dtype, device=x.device))
        buf = buf.view(ne, el, nc, cl, d).transpose(1, 2).reshape(
            n, el, cl, d)
        return buf if at is None else buf[at.to(x.device)]
    sent = all_to_all(smap(scatter, h, order, counts, starts, off), plan.dp,
                      0, 0)
    buf = smap(lambda b: b.sum(0), sent)     # (E/|ex|, cap/|cx|, d)

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
                      plan.dp, 0, 0)

    def combine(x, yb, eidx, gates, grank, keep):
        """Every block back in its place of (E, cap, d), then each
        replica's row weighed by its gate."""
        if inv is not None:
            yb = yb[inv.to(x.device)]
        yb = yb.view(ne, nc, el, cl, d).transpose(1, 2).reshape(e, cap, d)
        rows = yb[eidx.reshape(-1), grank.clamp(max=cap - 1)]
        w = torch.where(keep, gates.reshape(-1),
                        torch.zeros((), device=x.device)).to(x.dtype)
        return (rows * w[:, None]).view(-1, k, d).sum(dim=1).view(x.shape)
    return smap(combine, h, back, eidx, gates, grank, keep, out=h.spec)


def chunk_len(b: int, s: int, chunk_tokens: int = moe.CHUNK_TOKENS) -> int:
    """The rows of a dispatch chunk of a (b, s) batch: ``s`` where the
    batch's tokens fit one chunk, else ``chunk_tokens // b`` halved until
    it divides ``s`` (the reference's ``moe_ffn``)."""
    if b * s <= chunk_tokens:
        return s
    chunk_s = max(1, chunk_tokens // b)
    while s % chunk_s:
        chunk_s //= 2
    return chunk_s


def moe_ffn(h: Sharded, p: Dict[str, Sharded], cfg, plan,
            chunk_tokens: int = moe.CHUNK_TOKENS) -> Sharded:
    """h (B, S, d) over the batch axes -> (B, S, d): one layer's MoE FFN
    (``p``: the layer's placed router, wg, wu, wd). More than
    ``chunk_tokens`` global tokens are dispatched in chunks along the
    sequence (``chunk_s = chunk_tokens // B``, halved until it divides S),
    each with its own global capacity, as the reference's ``moe_ffn``."""
    ex = p["wu"].spec.axes(0)
    b, s, _ = h.shape
    chunk_s = chunk_len(b, s, chunk_tokens)
    if chunk_s == s:
        return _chunk(h, p, cfg, plan, ex)
    parts = [_chunk(smap(lambda x: x[:, i:i + chunk_s], h, out=h.spec), p,
                    cfg, plan, ex) for i in range(0, s, chunk_s)]
    return smap(lambda *xs: torch.cat(xs, dim=1), *parts, out=h.spec)
