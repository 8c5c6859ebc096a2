"""The single-device train step: gradient accumulation over microbatches,
then one AdamW update (the body of the reference's ``build_train_step``),
and the shapes of a train batch (its ``input_specs``).

The reference's shardings, its ``build_prefill_step`` and
``build_decode_step`` and the sharded step need a device mesh; they are
not part of this module.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import transformer as tf
from ..utils.tree import leaves, unflatten
from .optimizer import AdamWConfig, adamw_update

__all__ = ["input_specs", "value_and_grad", "train_step"]


def input_specs(cfg, batch: int, seq_len: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of a train batch: tokens (B, S) int32, or
    under an ``embed_stub`` frontend embeds (B, S, d) in the model's dtype
    with M-RoPE positions (B, 3, S) where the config has them; its labels
    (B, S) int32."""
    i32, b, s = torch.int32, batch, seq_len
    if cfg.frontend == "embed_stub":
        out = {"embeds": ((b, s, cfg.d_model), tf.dtype_of(cfg))}
        if cfg.mrope:
            out["positions"] = ((b, 3, s), i32)
    else:
        out = {"tokens": ((b, s), i32)}
    out["labels"] = ((b, s), i32)
    return out


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
