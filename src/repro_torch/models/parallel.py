"""The sharded forward and loss of every family: FSDP over the batch axes
and tensor parallelism over ``model``, written out explicitly under one
controller — what GSPMD makes of the reference's ``forward_train`` /
``loss_fn`` under its rule table.

Every value is a placed value (``sharding.placement.Sharded``): the
parameters as ``train.step.param_shardings`` lays them out, the batch
split over the batch axes. Per data row and per ``model`` position:

* **FSDP.** Each weight's ``w_embed`` dimension is gathered over the batch
  axes inside the block that remat checkpoints, so the backward gathers it
  again and only the shards stay alive between layers.
* **Attention.** Position ``j`` of ``model`` takes query heads ``[j*Hq/m,
  (j+1)*Hq/m)`` and the kv heads they read under GQA (``h // group``);
  the port's own ``attention.attention_full`` runs on the local slices of
  ``wq``, ``wk``, ``wv`` and ``wo`` with those head counts (the
  ``flash_attention`` kernel on the local heads), and the partial ``wo``
  products are summed over ``model``. A weight whose split does not fall
  on those heads (a kv dimension split inside a head, or one left whole)
  is gathered over ``model`` and sliced.
* **MLP.** The local ``ff`` slices of ``wg`` / ``wu`` / ``wd``, then a sum
  over ``model``.
* **The SSM mixer** (``ssm`` and ``hybrid``) splits its heads over
  ``model`` (:mod:`.parallel_ssm`); the **MoE FFN** dispatches over the
  batch axes with global capacity ranks (:mod:`.parallel_moe`). A
  ``hybrid`` block runs the attention and the split mixer on the same
  normed input and averages them; its ``meta`` rows go ahead of every row.
* **Vocab-parallel embedding and head** where the vocab splits over
  ``model``: each position looks up the tokens in its vocab range (zero
  elsewhere) and the rows are summed; the logits stay split, and the cross
  entropy's logsumexp takes a ``pmax`` and a ``psum`` of the exponentials,
  the target's logit from the position that holds it. With
  ``tie_embeddings`` the head is the embedding's transpose; where the
  vocab is whole, so is the head on each position.
* **The loss** is the batch's global masked mean: the masked NLL sum and
  the mask count summed over the batch axes, then divided.

* **Fewer query heads than ``model`` positions** (qwen2_vl_2b's 12 over
  16): the head ranges leave some positions empty. Such a position holds
  no query head and no kv column, launches no attention kernel and adds a
  zero partial to the ``wo`` sum (GSPMD replicates the heads instead).
* **Sequence sharding** (``MeshRules(seq_sharding=True)``), Megatron-style
  sequence parallelism: between blocks each ``model`` position holds its
  rows of the residual (``constrain(x, ("batch", "seq", None))`` splits
  them), and the norms and residual adds run on those rows. Before
  attention, the SSM mixer and the FFN the normed rows are gathered over
  ``model``; after each, the partial sums are reduce-scattered over
  ``model`` (in place of the ``psum``), so each position keeps its rows.
  Inside the blocks nothing changes: the head, ``ff`` and SSM-head splits
  run on whole sequences (B7 and B9 see the same shapes, the prefill's
  cache pieces are the same, the MoE routes whole gathered rows with the
  same global ranks and each position keeps its rows of the output). What
  remat keeps of a layer, its input, shrinks by the ``model`` extent.
  Where the rows (S, plus the ``meta`` rows) do not divide over
  ``model``, ``logical_to_spec`` leaves the residual whole and so does
  the step. A decode step's residual has no ``seq`` (one row).

``sharding.constrain`` is called where the reference calls it (the
embedded rows, each block's output, the MLP's hidden, the logits); the
layouts above are the ones the rules resolve, so each returns its value.
Under sequence sharding the port parts from GSPMD's layout in two places:

* the MLP's hidden keeps its ``ff`` split on whole rows (the rules would
  put it seq over ``model`` with ``ff`` whole, a needless ``(B, S, ff)``
  exchange before ``wd``), so that constraint is not applied;
* the head: a vocab-parallel head runs on the gathered rows and returns
  logits laid out ``("batch", None, "vocab")``, the vocab split over
  ``model`` (the rules' seq-split, whole-vocab logits would be a
  ``(B, S, V)`` exchange; :func:`_nll` takes the same global masked mean
  either way); a whole-vocab head runs on each position's rows and returns
  logits laid out as the rules say, ``("batch", "seq")``. A last-row-only
  forward (the prefill) gathers each position's last row, and one with
  ``meta`` rows gathers the rows, drops the ``meta`` rows and splits the
  rest again where they divide.

:func:`forward` also collects each layer's per-position cache pieces for
the sharded prefill (:mod:`.parallel_serve`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import constrain, use_rules
from ..sharding.placement import (Sharded, all_gather, pmax, psum,
                                  reduce_scatter, smap, split)
from . import attention as attn
from . import parallel_moe as pmoe
from . import parallel_ssm as pssm
from . import transformer as tf
from .layers import dense, rms_norm

__all__ = ["FAMILIES", "Plan", "check_sharded", "forward", "loss_fn"]

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


def check_sharded(cfg, rules=None) -> None:
    """Raise ``NotImplementedError`` for a config (or rules) the sharded
    steps do not cover; never run such a config unsharded."""
    tf.check_supported(cfg)
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: no sharded step for the "
                                  f"{cfg.family} family")
    if rules is not None and cfg.is_moe:
        pmoe.expert_parallel(cfg, rules)        # raises where it cannot


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mesh axes of the step: ``dp`` the batch axes, ``tp`` the model
    axis (empty where the mesh has none) and ``m`` its extent, ``n`` the
    batch axes' extent; ``seq`` whether the rules split the sequence over
    ``model``."""
    dp: Tuple[str, ...]
    tp: Tuple[str, ...]
    m: int
    n: int = 1
    seq: bool = False

    @classmethod
    def of(cls, rules) -> "Plan":
        names = rules.mesh.axis_names
        dp = tuple(a for a in rules.axis_for("batch") if a in names)
        tp = ("model",) if "model" in names else ()
        return cls(dp, tp, rules.extent(tp), rules.extent(dp),
                   bool(rules.seq_sharding and tp))


def _fsdp(w: Sharded, dim: int) -> Sharded:
    """``w`` gathered whole along its ``w_embed`` dimension ``dim``."""
    return all_gather(w, w.spec.axes(dim), dim)


def _ranges(n: int, m: int) -> List[Tuple[int, int]]:
    return [(j * n // m, (j + 1) * n // m) for j in range(m)]


def _take(w: Sharded, dim: int, cols, plan: Plan) -> Sharded:
    """Position ``j`` of ``model``'s part of ``w`` along ``dim``: ``cols[j]``
    a ``(lo, hi)`` range or a list of indices. A weight already split over
    ``model`` at those ranges is itself; otherwise it is gathered over
    what splits ``dim`` and each position takes its part."""
    have = w.spec.axes(dim)
    if have:
        n = w.shape[dim] // plan.m
        if have == plan.tp and all(c == (j * n, (j + 1) * n)
                                   for j, c in enumerate(cols)):
            return w
        w = all_gather(w, have, dim)

    def part(j, b):
        c = cols[j]
        if isinstance(c, tuple):
            return b.narrow(dim, c[0], c[1] - c[0])
        return b.index_select(dim, torch.tensor(c, device=b.device))
    return smap(part, w, coord=plan.tp)


def _heads(cfg, plan: Plan):
    """Per ``model`` position: its query head range, the kv columns it
    reads (a range where each kv head serves the same number of its query
    heads, else one kv head per query head), its local config and the kv
    head of each of its local kv heads. With fewer query heads than
    positions some ranges are empty: such a position reads no kv column
    and its local config has no head."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = hq // hkv
    q_cols, kv_cols, cfgs, kv_ids = [], [], [], []
    for h0, h1 in _ranges(hq, plan.m):
        kvs = [h // group for h in range(h0, h1)]
        ks = sorted(set(kvs))
        counts = {kvs.count(k) for k in ks}
        if not kvs:
            kv_cols.append((0, 0))
            kv_ids.append([])
        elif len(counts) == 1:
            kv_cols.append((ks[0] * dh, (ks[-1] + 1) * dh))
            kv_ids.append(ks)
        else:
            kv_cols.append([k * dh + i for k in kvs for i in range(dh)])
            kv_ids.append(kvs)
        q_cols.append((h0 * dh, h1 * dh))
        cfgs.append(dataclasses.replace(cfg, n_heads=h1 - h0,
                                        n_kv_heads=len(kv_ids[-1])))
    return q_cols, kv_cols, cfgs, kv_ids


def _reduced(partial: Sharded, like: Sharded, plan: Plan) -> Sharded:
    """The per-position partial sums (B, S, d) summed over ``model``, laid
    out as ``like``: replicated over ``model`` (a ``psum``), or where
    ``like``'s rows split over it each position keeping its rows (a
    ``reduce_scatter``)."""
    if plan.tp and like.spec.axes(1) == plan.tp:
        s = reduce_scatter(partial, plan.tp, 1)
    else:
        s = psum(partial, plan.tp)
    return Sharded(like.shape, like.spec, like.mesh, s.blocks)


def _rows(x: Sharded) -> Sharded:
    """``x`` (B, S, ...) with its rows whole: gathered over what splits
    them (sequence sharding), else ``x``."""
    return all_gather(x, x.spec.axes(1), 1)


def _attention(h: Sharded, p: Dict[str, Sharded], cfg, rot, plan: Plan,
               collect: bool = False, *, like: Sharded):
    """h (B, S, d) with whole rows -> (the attention output laid out as
    ``like``, and where ``collect`` each position's local (k, v) (B, S,
    local kv heads, Dh), else None). A position with no query head
    launches nothing and adds zeros."""
    q_cols, kv_cols, cfgs, _ = _heads(cfg, plan)
    wq = _take(_fsdp(p["wq"], 0), 1, q_cols, plan)
    wk = _take(_fsdp(p["wk"], 0), 1, kv_cols, plan)
    wv = _take(_fsdp(p["wv"], 0), 1, kv_cols, plan)
    wo = _take(_fsdp(p["wo"], 1), 0, q_cols, plan)
    norms = [p[k] for k in ("qn", "kn") if cfg.qk_norm]

    def local(j, x, wq, wk, wv, wo, cos, sin, *qk):
        if not cfgs[j].n_heads:
            none = x.new_zeros(x.shape[:2] + (0, cfg.head_dim))
            return ((torch.zeros_like(x), none, none) if collect
                    else torch.zeros_like(x))
        pl = {"wq": wq, "wk": wk, "wv": wv, "wo": wo,
              **dict(zip(("qn", "kn"), qk))}
        out, kv = attn.attention_full(x, pl, cfgs[j], (cos, sin))
        return (out, kv["k"], kv["v"]) if collect else out
    res = smap(local, h, wq, wk, wv, wo, *rot, *norms, coord=plan.tp)
    if collect:
        return _reduced(res[0], like, plan), res[1:]
    return _reduced(res, like, plan), None


def _mlp(h: Sharded, p: Dict[str, Sharded], cfg, plan: Plan,
         like: Sharded) -> Sharded:
    """h (B, S, d) with whole rows -> the MLP's output laid out as
    ``like``."""
    cols = _ranges(cfg.d_ff, plan.m)
    wu = _take(_fsdp(p["wu"], 0), 1, cols, plan)
    wd = _take(_fsdp(p["wd"], 1), 0, cols, plan)
    even = cfg.d_ff % plan.m == 0
    out = (tuple(h.spec) + (None,) * (2 - len(h.spec)) + plan.tp
           if even else None)
    names = ("wu", "wg") if cfg.mlp_gated else ("wu",)
    ws = [wu] + ([_take(_fsdp(p["wg"], 0), 1, cols, plan)]
                 if cfg.mlp_gated else [])
    hid = smap(lambda x, *w: tf.mlp_hidden(x, dict(zip(names, w)), cfg),
               h, *ws, out=out)
    if not plan.seq:        # seq-split, ff-whole: see the module docstring
        hid = constrain(hid, ("batch", "seq", "ff"))
    return _reduced(smap(dense, hid, wd), like, plan)


def _ffn(h: Sharded, pl, cfg, plan: Plan, like: Sharded) -> Sharded:
    """The block's feed-forward on ``h`` (whole rows), laid out as
    ``like`` (``h``, or its rows split): the sharded MoE FFN (whose output
    each position keeps its rows of) or the MLP."""
    if cfg.is_moe:
        return split(pmoe.moe_ffn(h, pl["moe"], cfg, plan),
                     like.spec.axes(1), 1)
    return _mlp(h, pl["mlp"], cfg, plan, like)


def _add(x: Sharded, y: Sharded) -> Sharded:
    return smap(torch.add, x, y, out=x.spec)


def _block(x: Sharded, pl: Dict[str, Any], cfg, rot, plan: Plan,
           collect: bool = False):
    """One block of the reference's ``_block_train`` over every position:
    attention, then the MLP or the MoE FFN (dense, moe, vlm, audio); the
    split SSM mixer alone (ssm); both mixers, averaged, then the MLP
    (hybrid). Each sublayer takes the normed rows gathered whole and
    returns its output laid out as ``x`` (each position's rows under
    sequence sharding). Returns (x, the layer's per-position cache pieces
    or None)."""
    h = smap(rms_norm, x, pl["ln1"], out=x.spec)
    hw = _rows(h)
    cache = {}
    if cfg.family == "ssm":
        s_out, cache["ssm"] = pssm.mixer(hw, pl["ssm"], cfg, plan, collect,
                                         like=h)
        x = _add(x, s_out)
    elif cfg.family == "hybrid":
        a_out, cache["attn"] = _attention(hw, pl["attn"], cfg, rot, plan,
                                          collect, like=h)
        s_out, cache["ssm"] = pssm.mixer(hw, pl["ssm"], cfg, plan, collect,
                                         like=h)
        # (a + s) / 2 in the activation dtype, as the reference's mix / 2
        x = smap(lambda x, a, s: x + (a + s) / 2, x, a_out, s_out,
                 out=x.spec)
    else:
        a_out, cache["attn"] = _attention(hw, pl["attn"], cfg, rot, plan,
                                          collect, like=h)
        x = _add(x, a_out)
    if cfg.d_ff > 0:
        h = smap(rms_norm, x, pl["ln2"], out=x.spec)
        x = _add(x, _ffn(_rows(h), pl, cfg, plan, h))
    return constrain(x, ("batch", "seq", None)), (cache if collect else None)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) placed leaves (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return smap(lambda b: b[i], tree, out=tuple(tree.spec)[1:])


def _lookup(params, cfg, tok: Sharded, plan: Plan):
    """(the token rows (B, S, d) over the batch axes, the gathered
    embedding) of token ids ``tok`` (B, S): vocab-parallel where the vocab
    splits over ``model``."""
    emb = _fsdp(params["embed"], 1)             # (V | V/m, d)
    vax = emb.spec.axes(0)
    if vax:
        n = cfg.vocab // plan.m

        def look(j, e, t):
            t = t.long() - j * n
            ok = (t >= 0) & (t < n)
            return torch.where(ok[..., None], e[t.clamp(0, n - 1)],
                               torch.zeros((), dtype=e.dtype,
                                           device=e.device))
        x = psum(smap(look, emb, tok, coord=vax), vax)
    else:
        x = smap(lambda e, t: e[t.long()], emb, tok)
    return Sharded(tok.shape + (cfg.d_model,), tok.spec, tok.mesh,
                   x.blocks), emb


def _embed(params, cfg, batch, plan: Plan):
    """(the rows (B, M+S, d) over the batch axes — the ``meta`` rows ahead
    of every row where the config has them —, the gathered embedding or
    None, the rotary tables of their positions, or None without
    attention)."""
    dt = tf.dtype_of(cfg)
    emb = None
    if cfg.frontend == "embed_stub":
        x = smap(lambda e: e.to(dt), batch["embeds"],
                 out=batch["embeds"].spec)
        rows = batch["embeds"]
    else:
        rows = batch["tokens"]
        x, emb = _lookup(params, cfg, rows, plan)
    if "positions" in batch:
        pos = batch["positions"]
    else:
        pos = smap(lambda r: torch.arange(
            r.shape[1], dtype=torch.int32, device=r.device)[None].expand(
                r.shape[0], r.shape[1]), rows, out=rows.spec)
    m = cfg.meta_tokens
    if m:
        def with_meta(x, meta, q):
            b = x.shape[0]
            rows = torch.cat([meta.to(x.dtype)[None].expand(
                b, m, x.shape[-1]), x], dim=1)
            mpos = torch.arange(m, dtype=torch.int32, device=x.device)
            mpos = mpos.expand(*q.shape[:-1], m)
            return rows, torch.cat([mpos, q + m], dim=-1)
        x, pos = smap(with_meta, x, params["meta"], pos,
                      out=(x.spec, pos.spec))
    rot = (smap(lambda q: attn.rot_tables(cfg, q), pos)
           if cfg.has_attention else None)
    return constrain(x, ("batch", "seq", None)), emb, rot


def _head(params, emb, cfg) -> Tuple[Sharded, Tuple[str, ...]]:
    """(the head (d, V | V/m) on every position, its vocab axes)."""
    if cfg.tie_embeddings:
        if emb is None:                             # an embed_stub frontend
            emb = _fsdp(params["embed"], 1)
        return smap(lambda e: e.t(), emb), emb.spec.axes(0)
    w = _fsdp(params["lm_head"], 0)                 # (d, V | V/m)
    return w, w.spec.axes(1)


def _logits(x: Sharded, params, emb, cfg, plan: Plan) -> Sharded:
    """fp32 logits of the normed rows ``x``: a vocab-parallel head on the
    whole rows, a whole-vocab head on ``x``'s rows as they lie (see the
    module docstring for the layouts)."""
    w, vax = _head(params, emb, cfg)
    if vax:
        x = _rows(x)
    out = tuple(x.spec) + (None,) * (x.blocks[0].dim() - 1 - len(x.spec)
                                     ) + vax
    logits = smap(tf.head_logits, x, w, out=out)
    if vax and plan.seq:    # vocab-split on whole rows, not seq-split
        return logits
    lg = ("batch",) + ("seq",) * (x.blocks[0].dim() - 2) + ("vocab",)
    return constrain(logits, lg)


def _last_row(x: Sharded) -> Sharded:
    """(B, 1, d): the last of ``x``'s rows, whole over ``model``; where
    the rows split, it lies on the last position, so each position's last
    row is gathered and the last of them kept."""
    ax = x.spec.axes(1)
    if ax:
        x = all_gather(smap(lambda b: b[:, -1:], x, out=x.spec), ax, 1)
    return smap(lambda b: b[:, -1:], x, out=x.spec)


def _nll(logits: Sharded, labels: Sharded, plan: Plan):
    """Per position: (the masked NLL sum, the mask count) of its data
    rows (and, where the logits' rows split, its rows of them), over the
    logits' vocab split."""
    labels = split(labels, logits.spec.axes(1), 1)
    vax = logits.spec.axes(2)
    if vax:
        n = logits.shape[2] // plan.m
        mx = pmax(smap(lambda lg: lg.detach().amax(-1), logits), vax)
        se = psum(smap(lambda lg, m: torch.exp(lg - m[..., None]).sum(-1),
                       logits, mx), vax)
        lse = smap(lambda m, s: m + torch.log(s), mx, se)

        def target(j, lg, lab):
            t = lab.long() - j * n
            ok = (t >= 0) & (t < n)
            got = lg.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
            return torch.where(ok, got, torch.zeros((), device=got.device))
        tgt = psum(smap(target, logits, labels, coord=vax), vax)
    else:
        lse = smap(lambda lg: torch.logsumexp(lg, dim=-1), logits)
        tgt = smap(lambda lg, lab: lg.gather(
            -1, lab.long().clamp(min=0)[..., None])[..., 0], logits, labels)
    mask = smap(lambda lab: (lab >= 0).float(), labels)
    nll = smap(lambda a, b, k: ((a - b) * k).sum(), lse, tgt, mask)
    return nll, smap(torch.sum, mask)


def forward(params, cfg, batch, rules, remat: bool = False,
            collect_cache: bool = False, logits_last_only: bool = False):
    """The sharded full-sequence forward (the reference's
    ``forward_train`` under GSPMD): (fp32 logits (B, S, V) — (B, 1, V)
    with ``logits_last_only`` — laid out ``("batch", "seq", "vocab")`` as
    the rules resolve it, or under sequence sharding as the module
    docstring says, and with ``collect_cache`` each layer's per-position
    cache pieces (:func:`_block`), else None). With ``remat`` each block
    runs under ``torch.utils.checkpoint`` (non-reentrant)."""
    check_sharded(cfg, rules)
    plan = Plan.of(rules)
    caches = [] if collect_cache else None
    with use_rules(rules):
        x, emb, rot = _embed(params, cfg, batch, plan)
        for i in range(cfg.n_layers):
            pl = _layer(params["blocks"], i)
            if remat:
                x, c = checkpoint(_block, x, pl, cfg, rot, plan,
                                  collect_cache, use_reentrant=False,
                                  context_fn=tf._recompute_contexts)
            else:
                x, c = _block(x, pl, cfg, rot, plan, collect_cache)
            if collect_cache:
                caches.append(c)
        x = smap(rms_norm, x, params["final_norm"], out=x.spec)
        m = cfg.meta_tokens
        if logits_last_only:
            x = _last_row(x)
        elif m:
            xw = _rows(x)
            x = constrain(smap(lambda b: b[:, m:], xw, out=xw.spec),
                          ("batch", "seq", None))
        return _logits(x, params, emb, cfg, plan), caches


def loss_fn(params, cfg, batch, rules, remat: bool = True) -> Sharded:
    """The masked next-token cross entropy of the batch (the reference's
    ``loss_fn`` under GSPMD): the global masked mean, replicated on every
    position (a :class:`Sharded` of spec ``()``)."""
    plan = Plan.of(rules)
    logits, _ = forward(params, cfg, batch, rules, remat=remat)
    with use_rules(rules):
        nll, cnt = _nll(logits, batch["labels"], plan)
        axes = plan.dp + logits.spec.axes(1)    # the rows' axes
        total, count = psum(nll, axes), psum(cnt, axes)
        return smap(lambda t, c: t / torch.clamp(c, min=1.0), total, count,
                    out=())
