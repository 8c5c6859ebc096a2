"""The sharded prefill and decode step of every family (the reference's
``build_prefill_step`` / ``build_decode_step`` bodies under GSPMD),
written out per position. Their caches take the reference's layout
(``logical_to_spec`` of ``transformer.cache_logical``):

* The attention ring ``k`` / ``v`` (L, B, W, Hkv, Dh) splits its slots
  over ``model`` (``kv_seq`` resolves before ``kv``, which then finds
  ``model`` taken). Where the slots do not divide over ``model`` and the
  kv heads do, the rules lay it out by kv heads instead: each position
  holds its kv heads over every slot. ``abs_pos`` and ``pos`` are whole
  over ``model``.
* The SSM ``conv`` (L, B, K-1, C) splits its channels over ``model``;
  ``state`` (L, B, H, N, P) is whole.

**Prefill** runs the sharded forward (:func:`.parallel.forward`) and
collects each position's pieces: k and v of its own kv heads, its heads'
SSM state and conv input rows. The ring is built per position (the
one-device ``transformer._ring`` on its heads), then laid out by slots
with an ``all_to_all`` over ``model`` (a kv head that GQA gave several
positions is taken from the first), or by kv heads: gathered over
``model`` and cut at the kv-head split; the states are gathered over
``model``, and the conv rows are gathered and cut at the conv's channel
split. The last token's logits come laid out ``("batch", "vocab")``.

**Decode** keeps the cache in place, in its layout, and writes every
update after it is computed (positions that share a tensor write the same
values). Per layer and data row:

* Attention: each position projects its query heads and the whole new
  k / v; q is gathered over ``model``. The new token's slot (``pos % W``)
  is written by the one position that holds it; ``abs_pos`` and ``pos``
  are updated on every position. B8 (``kernels.attention.
  decode_attention``) runs on each position's slot range for all heads and
  returns its output and log-sum-exp; the partial softmaxes merge in fp32
  (:func:`merge_softmax`), and each position's rows of the merged output
  go through its ``wo`` rows, summed over ``model``.
* Attention on a ring laid out by kv heads: each position projects its
  query heads and its kv heads' new k / v, writes them into its block at
  the new token's slot, and runs B8 on its query heads over its kv heads
  across the whole ring (no merge: the heads are whole). Its output goes
  through its heads' ``wo`` rows, summed over ``model``. A position's
  query heads must read only its kv heads (GQA); they always do where the
  kv heads divide over ``model``, and a cell where they would not raises.
* SSM: :func:`.parallel_ssm.mixer_decode`.
* MoE: :func:`.parallel_moe.moe_ffn` at the step's token count.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..kernels import attention as katt
from ..sharding import constrain, use_rules
from ..sharding.placement import (Sharded, all_gather, all_to_all,
                                  relayout, smap, split, unique_blocks)
from ..sharding.rules import PartitionSpec, logical_to_spec, spec_tree
from . import attention as attn
from . import parallel as par
from . import parallel_ssm as pssm
from . import transformer as tf
from .layers import apply_rot, dense, rms_norm

__all__ = ["cache_specs", "prefill", "decode_step", "merge_softmax"]


def cache_specs(cfg, rules, batch: int, seq_len: int):
    """The cache's PartitionSpecs (the reference's ``_cache_shardings``)
    for ``batch`` rows of a ``seq_len`` context: the ring's slots over
    ``model``, or its kv heads where the slots do not divide."""
    return spec_tree(rules, tf.cache_logical(cfg),
                     tf.cache_shapes(cfg, batch, seq_len))


def _check_kv_heads(cfg, plan) -> None:
    """On a ring laid out by kv heads, each ``model`` position's query
    heads (``parallel._heads``) must read exactly its own kv heads; else
    ``NotImplementedError`` names the cell."""
    n = cfg.n_kv_heads // plan.m
    own = [list(range(j * n, (j + 1) * n)) for j in range(plan.m)]
    reads = par._heads(cfg, plan)[3]
    if own != [list(ids) for ids in reads]:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query heads over {cfg.n_kv_heads} "
            f"kv heads on {plan.m} model positions read kv heads {reads}, "
            f"not each position's own {own}")


def _first(ids_per_position: List[List[int]], n: int):
    """Where each of heads 0..n-1 first appears in the positions' head
    lists concatenated (None where that is 0..n-1 in order)."""
    flat = [h for ids in ids_per_position for h in ids]
    at = [flat.index(h) for h in range(n)]
    return None if at == list(range(len(flat))) else at


def _unique(ids: List[int]):
    """(a position's distinct kv heads in order, their local indices)."""
    seen = list(dict.fromkeys(ids))
    return seen, [ids.index(h) for h in seen]


def _attn_cache(kvs, rows: Sharded, cfg, plan, specs, seq_len_cache):
    """The ring of every layer from each position's local (k, v) pieces,
    laid out by ``specs`` (``rows``: a batch leaf, whole over
    ``model``)."""
    kv_ids = par._heads(cfg, plan)[3]
    uniq = [_unique(ids) for ids in kv_ids]

    def ring(j, *pieces):
        nl = len(pieces) // 2
        sel = uniq[j][1]
        idx = None if sel == list(range(len(kv_ids[j]))) else sel
        per = [{n: (t if idx is None else t[:, :, idx])
                for n, t in (("k", k), ("v", v))}
               for k, v in zip(pieces[:nl], pieces[nl:])]
        r = tf._ring(per, cfg, seq_len_cache)
        return r["k"], r["v"]
    pieces = [kv[0] for kv in kvs] + [kv[1] for kv in kvs]
    k, v = smap(ring, *pieces, coord=plan.tp)
    kspec = specs["k"]
    if plan.tp and kspec.axes(2) == plan.tp:
        k, v = (all_to_all(t, plan.tp, 2, 3) for t in (k, v))
    elif plan.m > 1:                     # whole over model, or by kv heads
        k, v = (all_gather(t, plan.tp, 3) for t in (k, v))
    else:
        uniq = [uniq[0]]
    at = _first([u[0] for u in uniq], cfg.n_kv_heads)
    if at is not None:
        k, v = (smap(lambda b: b[:, :, :, at], t) for t in (k, v))
    nl, w = len(kvs), k.blocks[0].shape[2]
    shape = (nl, rows.shape[0], w * (plan.m if kspec.axes(2) else 1),
             cfg.n_kv_heads, cfg.head_dim)
    if plan.tp and kspec.axes(3) == plan.tp:
        # each position keeps its kv heads (a copy: the gathered ring goes)
        whole = PartitionSpec(*kspec[:3])
        k, v = (smap(torch.Tensor.contiguous, split(
            Sharded(shape, whole, t.mesh, t.blocks), plan.tp, 3))
            for t in (k, v))
    out = {"k": Sharded(shape, kspec, k.mesh, k.blocks),
           "v": Sharded(shape, kspec, v.mesh, v.blocks)}
    s_tot = kvs[0][0].blocks[0].shape[1]
    wt = shape[2]

    def positions(row):
        """abs_pos and pos of the ring, as ``transformer._ring`` sets
        them (the same on every ``model`` position)."""
        slots = torch.arange(wt, dtype=torch.int32, device=row.device)
        if wt <= s_tot:
            r = (s_tot - wt) % wt
            ap = s_tot - wt + (slots - r) % wt
        else:
            ap = torch.where(slots < s_tot, slots, -1)
        bl = row.shape[0]
        return (ap.to(torch.int32).expand(nl, bl, wt).contiguous(),
                torch.full((nl, bl), s_tot, dtype=torch.int32,
                           device=row.device))
    out["abs_pos"], out["pos"] = smap(positions, rows,
                                      out=(specs["abs_pos"], specs["pos"]))
    return out


def _ssm_cache(scs, batch: int, cfg, plan, specs):
    """The SSM cache of every layer from each position's pieces."""
    di, n = cfg.d_inner, cfg.ssm_state
    heads = pssm.head_ranges(cfg, plan)
    conv_spec = specs["conv"]
    c = di + 2 * n
    cr = (par._ranges(c, plan.m) if plan.tp and conv_spec.axes(3)
          else [(0, c)] * plan.m)
    convs, states = [], []
    for sc in scs:
        nl = [(b - a) * cfg.ssm_head_dim for a, b in heads]
        xi = smap(lambda j, t: t[..., :nl[j]], sc["tail"], coord=plan.tp)
        xi = all_gather(xi, plan.tp, 2)                  # (B, K-1, d_inner)

        def cut(j, xi, t):
            full = torch.cat([xi, t[..., nl[j]:]], dim=-1)
            return full[..., cr[j][0]:cr[j][1]]
        convs.append(smap(cut, xi, sc["tail"], coord=plan.tp))
        states.append(all_gather(sc["state"], plan.tp, 1))
    conv = smap(lambda *t: torch.stack(t), *convs)
    state = smap(lambda *t: torch.stack(t), *states)
    nlay = len(scs)
    return {"conv": Sharded((nlay, batch, cfg.conv_width - 1, c), conv_spec,
                            conv.mesh, conv.blocks),
            "state": Sharded((nlay, batch, cfg.ssm_heads, n,
                              cfg.ssm_head_dim),
                             specs["state"], state.mesh, state.blocks)}


def _last_logits(logits: Sharded, cfg, rules) -> Sharded:
    """(B, 1, V) -> (B, V) laid out ``("batch", "vocab")``."""
    sp = tuple(logits.spec)
    last = smap(lambda t: t[:, 0], logits,
                out=sp[:1] + sp[2:] if len(sp) > 1 else sp)
    b = last.shape[0]
    return relayout(last, logical_to_spec(rules, ("batch", "vocab"),
                                          (b, cfg.vocab)))


@torch.no_grad()
def prefill(params, cfg, batch, rules, seq_len_cache=None):
    """The sharded prefill: (last-token fp32 logits (B, V), the cache
    laid out by :func:`cache_specs`) — the one-device
    ``transformer.prefill``'s values."""
    plan = par.Plan.of(rules)
    logits, caches = par.forward(params, cfg, batch, rules,
                                 collect_cache=True, logits_last_only=True)
    rows = next(iter(batch.values()))
    s_tot = rows.shape[1] + cfg.meta_tokens
    seq = max(seq_len_cache or s_tot, s_tot)
    specs = cache_specs(cfg, rules, rows.shape[0], seq)
    out = {}
    if cfg.has_attention:
        out["attn"] = _attn_cache([c["attn"] for c in caches], rows, cfg,
                                  plan, specs["attn"], seq_len_cache)
    if cfg.has_ssm:
        out["ssm"] = _ssm_cache([c["ssm"] for c in caches], rows.shape[0],
                                cfg, plan, specs["ssm"])
    del caches
    return _last_logits(logits, cfg, rules), out


# ---------------------------------------------------------------- decode
def merge_softmax(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over all slots from partial ones over disjoint slot
    ranges: ``outs`` (P, B, H, D) and their log-sum-exps ``lses`` (P, B,
    H) -> (B, H, D) fp32, ``sum_j e^(lse_j - M) out_j / sum_j e^(lse_j -
    M)`` with ``M = max_j lse_j``. A part with no live slot (lse -inf)
    weighs 0; where no part has one, every part weighs the same (each is
    then the average of its equal share of the slots, as the one-device
    softmax of equal fills)."""
    mx = lses.amax(0)
    empty = torch.isneginf(mx)
    wts = torch.exp(lses - torch.where(empty, torch.zeros_like(mx), mx))
    wts = torch.where(empty[None], torch.ones_like(wts), wts)
    num = (wts[..., None] * outs.float()).sum(0)
    return num / wts.sum(0)[..., None]


def _attention_decode(h: Sharded, p: Dict[str, Sharded], cfg, lc, rot,
                      plan) -> Sharded:
    """One token's attention against the layer's ring (its slots over
    ``model``, or its kv heads over ``model``), updating the ring in
    place."""
    q_cols, kv_cols, _, _ = par._heads(cfg, plan)
    hq, dh = cfg.n_heads, cfg.head_dim
    ring = lc["attn"]
    kc, vc, ap, pos = ring["k"], ring["v"], ring["abs_pos"], ring["pos"]
    heads = bool(plan.tp) and kc.spec.axes(2) == plan.tp
    if heads:
        _check_kv_heads(cfg, plan)
    wq = par._take(par._fsdp(p["wq"], 0), 1, q_cols, plan)
    if heads:                                 # each position's kv heads
        wk, wv = (par._take(par._fsdp(p[n], 0), 1, kv_cols, plan)
                  for n in ("wk", "wv"))
    else:                                     # every kv head
        wk, wv = relayout(p["wk"], ()), relayout(p["wv"], ())
    norms = [p[k] for k in ("qn", "kn") if cfg.qk_norm]

    def proj_q(j, x, w, cos, sin, *qk):
        # a position past the query heads (12 over 16) projects none
        q = dense(x, w).view(x.shape[0], 1, w.shape[1] // dh, dh)
        if qk:
            q = rms_norm(q, qk[0])
        return apply_rot(q, cos, sin)

    def proj_kv(x, wk, wv, cos, sin, *qk):
        k = dense(x, wk).view(x.shape[0], 1, -1, dh)
        if qk:
            k = rms_norm(k, qk[1])
        return apply_rot(k, cos, sin)[:, 0], dense(x, wv).view(
            x.shape[0], -1, dh)
    q = smap(proj_q, h, wq, *rot, *norms, coord=plan.tp)   # (B, 1, Hq_j, Dh)
    kn, vn = smap(proj_kv, h, wk, wv, *rot, *norms)
    by_slots = bool(plan.tp) and kc.spec.axes(1) == plan.tp
    w = kc.shape[1]
    wl = w // plan.m if by_slots else w

    def slot_rows(j, kb, vb, kn, vn, p):
        """The local slot of the new token (clamped) and the rows to
        write there: the new k / v where this position holds the slot,
        else what it holds."""
        s = (p.long() % w) - (j * wl if by_slots else 0)
        here = ((s >= 0) & (s < wl))[:, None, None]
        s = s.clamp(0, wl - 1)
        b = torch.arange(kb.shape[0], device=kb.device)
        return (s, torch.where(here, kn, kb[b, s]),
                torch.where(here, vn, vb[b, s]))
    s_loc, krow, vrow = smap(slot_rows, kc, vc, kn, vn, pos, coord=plan.tp)
    for p_, kb in unique_blocks(kc):
        b = torch.arange(kb.shape[0], device=kb.device)
        kb.index_put_((b, s_loc.blocks[p_]), krow.blocks[p_])
        vc.blocks[p_].index_put_((b, s_loc.blocks[p_]), vrow.blocks[p_])
    for p_, ab in unique_blocks(ap):
        pb = pos.blocks[p_]
        b = torch.arange(ab.shape[0], device=ab.device)
        ab.index_put_((b, (pb.long() % w)), pb)

    if heads:
        # the position's query heads over its kv heads, every slot: whole
        # softmaxes, no merge
        def local_heads(q, kb, vb, ab, p):
            return katt.decode_attention(q[:, 0], kb.transpose(1, 2),
                                         vb.transpose(1, 2), ab, p,
                                         cfg.window)
        o = smap(local_heads, q, kc, vc, ap, pos)         # (B, Hq_j, Dh)
        wo = par._take(par._fsdp(p["wo"], 1), 0, q_cols, plan)
        part = smap(lambda o, w: dense(o.reshape(o.shape[0], 1, -1), w),
                    o, wo)
    else:
        q = all_gather(q, plan.tp, 2)                     # (B, 1, Hq, Dh)

        def local(j, q, kb, vb, ab, p):
            lo = j * wl if by_slots else 0
            return katt.decode_attention(q[:, 0], kb.transpose(1, 2),
                                         vb.transpose(1, 2),
                                         ab[:, lo:lo + wl], p, cfg.window,
                                         return_lse=True)
        o, lse = smap(local, q, kc, vc, ap, pos, coord=plan.tp)
        o = all_gather(smap(lambda t: t[None], o), plan.tp, 0)
        lse = all_gather(smap(lambda t: t[None], lse), plan.tp, 0)
        merged = smap(lambda o, lse: merge_softmax(o, lse).to(
            o.dtype).reshape(o.shape[1], 1, hq * dh), o, lse)
        rows = par._ranges(hq * dh, plan.m)
        wo = par._take(par._fsdp(p["wo"], 1), 0, rows, plan)
        part = smap(lambda j, m, w: dense(m[..., rows[j][0]:rows[j][1]], w),
                    merged, wo, coord=plan.tp)
    for p_, pb in unique_blocks(pos):
        pb.add_(1)
    return par._reduced(part, h, plan)


def _write(dst: Sharded, new: Sharded) -> None:
    """Each distinct tensor of ``dst`` set to its first position's new
    value (positions sharing a tensor computed the same value)."""
    for p_, b in unique_blocks(dst):
        b.copy_(new.blocks[p_])


def _ssm_decode(h, p, cfg, lc, plan) -> Sharded:
    out, new = pssm.mixer_decode(h, p, cfg, plan, lc["ssm"])
    for k in ("conv", "state"):
        _write(lc["ssm"][k], new[k])
    return out


def _block_decode(x: Sharded, pl, cfg, lc, rot, plan) -> Sharded:
    h = smap(rms_norm, x, pl["ln1"], out=x.spec)
    if cfg.family == "ssm":
        x = par._add(x, _ssm_decode(h, pl["ssm"], cfg, lc, plan))
    elif cfg.family == "hybrid":
        a = _attention_decode(h, pl["attn"], cfg, lc, rot, plan)
        s = _ssm_decode(h, pl["ssm"], cfg, lc, plan)
        x = smap(lambda x, a, s: x + (a + s) / 2, x, a, s, out=x.spec)
    else:
        x = par._add(x, _attention_decode(h, pl["attn"], cfg, lc, rot,
                                          plan))
    if cfg.d_ff > 0:
        h = smap(rms_norm, x, pl["ln2"], out=x.spec)
        x = par._add(x, par._ffn(h, pl, cfg, plan, h))
    return x


@torch.no_grad()
def decode_step(params, cfg, batch, cache, rules):
    """One sharded decode step: batch {tokens (B,)} or {embeds (B, d)}
    over the batch axes, ``cache`` laid out by :func:`cache_specs` (as
    :func:`prefill` returns it) -> (fp32 logits (B, V) laid out
    ``("batch", "vocab")``, the same cache, updated in place)."""
    par.check_sharded(cfg, rules)
    plan = par.Plan.of(rules)
    with use_rules(rules):
        emb = None
        if cfg.frontend == "embed_stub":
            e = batch["embeds"]
            x = smap(lambda t: t[:, None, :].to(tf.dtype_of(cfg)), e,
                     out=e.spec)
        else:
            tok = batch["tokens"]
            x, emb = par._lookup(params, cfg, smap(
                lambda t: t[:, None], tok, out=tok.spec), plan)
        x = constrain(x, ("batch", None, None))
        rot = None
        if cfg.has_attention:
            # every layer's pos is the same: one table for the stack
            rot = smap(lambda q: attn.rot_tables(cfg, q[0][:, None]),
                       cache["attn"]["pos"])
        for i in range(cfg.n_layers):
            x = _block_decode(x, par._layer(params["blocks"], i), cfg,
                              par._layer(cache, i), rot, plan)
        x = smap(rms_norm, x, params["final_norm"], out=x.spec)
        logits = par._logits(x, params, emb, cfg, plan)
        return _last_logits(logits, cfg, rules), cache

