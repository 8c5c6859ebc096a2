"""Step builders: the single-device train step (gradient accumulation over
microbatches, then one AdamW update) and the sharded steps over a device
mesh (the reference's ``build_train_step``, ``build_prefill_step`` and
``build_decode_step``), with the shapes and layouts of their inputs
(``input_specs``, ``param_shardings``, ``_opt_shardings``,
``_batch_spec``, ``_cache_shardings``).

The sharded steps cover every family (``models.parallel``,
``models.parallel_serve``), with or without sequence sharding
(``MeshRules(seq_sharding=True)``: the train step's and the prefill's
residual split over ``model`` by rows between blocks; a decode step has
one row and runs as without it), on the test meshes and the production
meshes (``launch.mesh.make_production_mesh``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ShapeConfig
from ..models import parallel
from ..models import parallel_serve as pserve
from ..models import transformer as tf
from ..sharding.placement import (NamedSharding, Sharded, all_gather,
                                  canonical_groups, place, smap, split,
                                  sum_replicas, unique_blocks)
from ..sharding.rules import MeshRules, PartitionSpec, logical_to_spec
from ..utils import cost
from ..utils.tree import leaves, paths, tree_map, unflatten
from . import optimizer as topt
from .optimizer import AdamWConfig, adamw_update

__all__ = ["input_specs", "value_and_grad", "train_step", "param_shardings",
           "sharded_value_and_grad", "sharded_adamw_init",
           "build_train_step", "build_prefill_step", "build_decode_step"]

Spec = Tuple[Tuple[int, ...], torch.dtype]


def input_specs(cfg, shape: ShapeConfig) -> Dict[str, Spec]:
    """{name: (shape, dtype)} of a batch of ``shape`` (the reference's
    ``input_specs``): a decode step's tokens (B,) int32 or embeds (B, d); a
    train or prefill batch's tokens (B, S) int32, or under an
    ``embed_stub`` frontend embeds (B, S, d) in the model's dtype with
    M-RoPE positions (B, 3, S) where the config has them; a train batch's
    labels (B, S) int32."""
    b, s = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, tf.dtype_of(cfg)
    stub = cfg.frontend == "embed_stub"
    if shape.kind == "decode":
        return ({"embeds": ((b, cfg.d_model), dt)} if stub
                else {"tokens": ((b,), i32)})
    if stub:
        batch = {"embeds": ((b, s, cfg.d_model), dt)}
        if cfg.mrope:
            batch["positions"] = ((b, 3, s), i32)
    else:
        batch = {"tokens": ((b, s), i32)}
    if shape.kind == "train":
        batch["labels"] = ((b, s), i32)
    return batch


def value_and_grad(params, cfg, batch, remat: bool = True
                   ) -> Tuple[torch.Tensor, list]:
    """(:func:`~..models.transformer.loss_fn`, its gradient for every leaf
    of ``params`` in :func:`~..utils.tree.leaves` order). The leaves require
    a gradient only inside this call."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = tf.loss_fn(params, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return loss.detach(), grads


def train_step(params, opt_state, batch, cfg,
               opt_cfg: AdamWConfig = AdamWConfig(), microbatches: int = 1,
               remat: bool = True, accum_dtype: Optional[str] = None
               ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` (leading axis the global batch):
    split it into ``microbatches``, sum each one's gradients cast to
    ``accum_dtype`` (default the model's) and divided by ``microbatches``,
    and its loss divided likewise, then one AdamW update of ``params`` and
    ``opt_state`` (in place). Returns (params, opt_state, {"loss",
    "grad_norm", "lr"})."""
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         "microbatches")
    mb = b // microbatches
    acc_dt = (tf.dtype_of(cfg) if accum_dtype is None
              else tf._DTYPES[accum_dtype])
    acc_loss, acc = None, None
    for i in range(microbatches):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, grads = value_and_grad(params, cfg, part, remat)
        # the first microbatch starts the sums (0 + x is x, and x / 1 is x)
        if acc is None:
            acc = [g.to(acc_dt) if microbatches == 1
                   else g.to(acc_dt) / microbatches for g in grads]
            acc_loss = loss.float() / microbatches
        else:
            for a, g in zip(acc, grads):
                a.copy_(a + g.to(acc_dt) / microbatches)
            acc_loss = acc_loss + loss.float() / microbatches
        del grads
    params, opt_state, metrics = adamw_update(unflatten(params, acc),
                                              opt_state, params, opt_cfg)
    metrics["loss"] = acc_loss
    return params, opt_state, metrics


# ---------------------------------------------------------------------------
# Layouts (nothing allocated)
# ---------------------------------------------------------------------------
def _batch_spec(rules: MeshRules, batch) -> Dict[str, NamedSharding]:
    """Each batch leaf split over the batch axes on its leading dimension."""
    out = {}
    for k, (shape, _) in batch.items():
        logical = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = NamedSharding(rules.mesh,
                               logical_to_spec(rules, logical, shape))
    return out


def param_shardings(cfg, rules: MeshRules):
    """(the parameters' (shape, dtype) pairs, their NamedShardings), as
    trees shaped as the parameters, without allocating."""
    dt = tf.dtype_of(cfg)
    shapes = tree_map(tf.param_shapes(cfg),
                      lambda leaf: (tuple(leaf.shape), leaf.dtype or dt))
    logical = tf.logical_axes(cfg)
    flat = dict(paths(shapes))

    def walk(lg, prefix):
        if isinstance(lg, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in lg.items()}
        shape = flat[prefix[:-1]][0]
        return NamedSharding(rules.mesh, logical_to_spec(rules, lg, shape))
    return shapes, walk(logical, "")


def _opt_shardings(rules: MeshRules, p_shapes, p_shardings):
    """AdamW's state: ``mu`` and ``nu`` (fp32) laid out as the parameters,
    ``step`` replicated."""
    f32 = tree_map(p_shapes, lambda sd: (sd[0], torch.float32))
    shapes = {"mu": f32, "nu": f32, "step": ((), torch.int32)}
    rep = NamedSharding(rules.mesh, PartitionSpec())
    return shapes, {"mu": p_shardings, "nu": p_shardings, "step": rep}


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------
def sharded_adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 moments laid out as ``params`` (a tree of placed values),
    step 0 replicated."""
    def zeros32(s):
        return smap(lambda b: torch.zeros(b.shape, dtype=torch.float32,
                                          device=b.device), s, out=s.spec)
    mesh = leaves(params)[0].mesh
    return {"mu": tree_map(params, zeros32), "nu": tree_map(params, zeros32),
            "step": place(torch.zeros((), dtype=torch.int32), mesh, ())}


def _distinct(tree):
    """Each distinct tensor of a tree of placed values once."""
    out = {}
    for s in leaves(tree):
        for _, b in unique_blocks(s):
            out[id(b)] = b
    return list(out.values())


@cost.repeatable
def sharded_value_and_grad(params, cfg, batch, rules: MeshRules,
                           remat: bool = True) -> Tuple[Sharded, Any]:
    """(the sharded :func:`~..models.parallel.loss_fn`, its gradient as a
    tree of placed values laid out as ``params``). One autograd graph
    spans every position; a parameter block held on several devices gets
    the sum of its replicas' gradients
    (:func:`~..sharding.placement.sum_replicas`). Under the dry run's
    counter a later microbatch of the same shapes is counted, not run
    (``utils.cost.repeatable``)."""
    ts = _distinct(params)
    for t in ts:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = parallel.loss_fn(params, cfg, batch, rules, remat=remat)
            grads = torch.autograd.grad(loss.blocks[0], ts,
                                        allow_unused=True)
    finally:
        for t in ts:
            t.requires_grad_(False)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g)
             for t, g in zip(ts, grads)}
    del grads
    gtree = tree_map(params, lambda s: sum_replicas(Sharded(
        s.shape, s.spec, s.mesh, [by_id[id(b)] for b in s.blocks])))
    return smap(torch.Tensor.detach, loss, out=()), gtree


@torch.no_grad()
def _sharded_adamw(grads, opt_state, params, cfg: AdamWConfig):
    """:func:`~.optimizer.adamw_update` over placed trees: the global norm
    counts each element once (each block once, however many positions
    hold it), and every distinct tensor is updated once by its own
    gradient with the global clip scale, a layer at a time as on one
    device."""
    step = smap(lambda t: t + 1, opt_state["step"], out=())
    mesh = step.mesh
    total = torch.zeros((), dtype=torch.float32, device=mesh.merge_device)
    for g in leaves(grads):
        for ps, b in canonical_groups(g):
            with cost.at(ps):           # the dry run's count: b's holders
                total = topt.add_squares(total, b)
    gnorm = torch.sqrt(total)
    gn = smap(lambda t: gnorm.to(t.device), step, out=())
    lr = smap(lambda t: topt.cosine_schedule(cfg, t), step, out=())
    scale = smap(lambda n: topt.clip_scale(cfg, n), gn, out=())
    cs = smap(lambda t: topt.bias_corrections(cfg, t), step, out=((), ()))
    for p_, g_, mu_, nu_ in zip(leaves(params), leaves(grads),
                                leaves(opt_state["mu"]),
                                leaves(opt_state["nu"])):
        for p, b in unique_blocks(p_):
            topt.update_leaf(b, g_.blocks[p], mu_.blocks[p], nu_.blocks[p],
                             scale.blocks[p], lr.blocks[p], cs[0].blocks[p],
                             cs[1].blocks[p], cfg)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gn, "lr": lr}


def _microbatch(leaf: Sharded, i: int, mb: int, microbatches: int
                ) -> Sharded:
    """Global rows ``[i*mb, (i+1)*mb)`` of a batch leaf, laid out as the
    leaf (split over the same axes)."""
    if microbatches == 1:
        return leaf
    axes = leaf.spec.axes(0)
    whole = all_gather(leaf, axes, 0)
    rows = smap(lambda b: b.narrow(0, i * mb, mb), whole, out=whole.spec)
    return split(rows, axes, 0)


def build_train_step(cfg, shape: ShapeConfig, rules: MeshRules,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     microbatches: int = 8, remat: bool = True,
                     accum_dtype: Optional[str] = None):
    """The sharded train step of ``cfg`` on ``rules.mesh``: FSDP + TP
    (``models.parallel``), gradient accumulation over ``microbatches``
    (each the global batch's next ``B / microbatches`` rows, its loss
    their global masked mean), then AdamW. Returns ``(step, in_specs,
    out_specs, shapes)``: ``step(params, opt_state, batch)`` over trees of
    placed values laid out by ``in_specs`` (``(param, opt, batch)``
    NamedShardings), returning ``(params, opt_state, {"loss",
    "grad_norm", "lr"})`` laid out by ``out_specs`` (parameters and
    moments updated in place); ``shapes`` the inputs' (shape, dtype)
    pairs. A family the step does not cover raises
    ``NotImplementedError``."""
    parallel.check_sharded(cfg, rules)
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatches} microbatches")
    mb = shape.global_batch // microbatches
    dp = rules.extent(parallel.Plan.of(rules).dp)
    if mb % dp:
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"the {dp} data positions")
    acc_dt = tf.dtype_of(cfg) if accum_dtype is None else tf._DTYPES[
        accum_dtype]

    def train_step(params, opt_state, batch):
        acc_loss, acc = None, None
        for i in range(microbatches):
            part = {k: _microbatch(v, i, mb, microbatches)
                    for k, v in batch.items()}
            loss, grads = sharded_value_and_grad(params, cfg, part, rules,
                                                 remat)
            # the first microbatch starts the sums (0 + x is x, x / 1 is x)
            if acc is None:
                acc = tree_map(grads, lambda g: smap(
                    lambda t: t.to(acc_dt) if microbatches == 1
                    else t.to(acc_dt) / microbatches, g, out=g.spec))
                acc_loss = smap(lambda t: t.float() / microbatches, loss,
                                out=())
            else:
                acc = unflatten(acc, [smap(
                    lambda a, t: a + t.to(acc_dt) / microbatches, a, g,
                    out=g.spec) for a, g in zip(leaves(acc), leaves(grads))])
                acc_loss = smap(lambda a, t: a + t.float() / microbatches,
                                acc_loss, loss, out=())
            del grads
        params, opt_state, metrics = _sharded_adamw(acc, opt_state, params,
                                                    opt_cfg)
        metrics["loss"] = acc_loss
        return params, opt_state, metrics

    p_shapes, p_sh = param_shardings(cfg, rules)
    o_shapes, o_sh = _opt_shardings(rules, p_shapes, p_sh)
    batch = input_specs(cfg, shape)
    b_sh = _batch_spec(rules, batch)
    rep = NamedSharding(rules.mesh, PartitionSpec())
    in_sh = (p_sh, o_sh, b_sh)
    out_sh = (p_sh, o_sh, {"loss": rep, "grad_norm": rep, "lr": rep})
    return train_step, in_sh, out_sh, (p_shapes, o_shapes, batch)


# ---------------------------------------------------------------------------
# The sharded prefill and decode steps
# ---------------------------------------------------------------------------
def _cache_shardings(cfg, shape: ShapeConfig, rules: MeshRules):
    """The decode cache's NamedShardings for ``shape`` (``logical_to_spec``
    of ``transformer.cache_logical`` over ``transformer.cache_shapes``)."""
    specs = pserve.cache_specs(cfg, rules, shape.global_batch,
                               shape.seq_len)
    return tree_map(specs, lambda sp: NamedSharding(rules.mesh, sp))


def _logits_sharding(cfg, shape: ShapeConfig, rules: MeshRules):
    return NamedSharding(rules.mesh, logical_to_spec(
        rules, ("batch", "vocab"), (shape.global_batch, cfg.vocab)))


def build_prefill_step(cfg, shape: ShapeConfig, rules: MeshRules):
    """The sharded prefill of ``cfg`` on ``rules.mesh``
    (``models.parallel_serve.prefill``, the cache ``shape.seq_len`` slots
    deep). Returns ``(prefill_step, in_specs, out_specs, shapes)``:
    ``prefill_step(params, batch)`` over placed trees laid out by
    ``in_specs`` (params, batch) returns (last-token logits, cache) laid
    out by ``out_specs``; ``shapes`` the inputs' (shape, dtype) pairs."""
    parallel.check_sharded(cfg, rules)

    def prefill_step(params, batch):
        return pserve.prefill(params, cfg, batch, rules,
                              seq_len_cache=shape.seq_len)

    p_shapes, p_sh = param_shardings(cfg, rules)
    batch = input_specs(cfg, shape)
    in_sh = (p_sh, _batch_spec(rules, batch))
    out_sh = (_logits_sharding(cfg, shape, rules),
              _cache_shardings(cfg, shape, rules))
    return prefill_step, in_sh, out_sh, (p_shapes, batch)


def build_decode_step(cfg, shape: ShapeConfig, rules: MeshRules):
    """One sharded decode step against a ``shape.seq_len``-deep cache
    (``models.parallel_serve.decode_step``). Returns ``(decode_fn,
    in_specs, out_specs, shapes)``: ``decode_fn(params, cache, batch)``
    returns (logits, cache), the cache updated in place in its layout."""
    parallel.check_sharded(cfg, rules)

    def decode_fn(params, cache, batch):
        return pserve.decode_step(params, cfg, batch, cache, rules)

    p_shapes, p_sh = param_shardings(cfg, rules)
    cache_sh = _cache_shardings(cfg, shape, rules)
    batch = input_specs(cfg, shape)
    in_sh = (p_sh, cache_sh, _batch_spec(rules, batch))
    out_sh = (_logits_sharding(cfg, shape, rules), cache_sh)
    cache = tf.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    return decode_fn, in_sh, out_sh, (p_shapes, cache, batch)
