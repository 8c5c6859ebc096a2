"""AdamW with a cosine-with-warmup schedule: the port's own copy of the
reference's ``train/optimizer.py``.

The arithmetic is the reference's: fp32 moments ``mu`` and ``nu``, an int32
``step``, the update of each parameter computed in fp32 and cast back to the
parameter's dtype (no fp32 master copy), the gradients clipped by their
global norm. Parameters and moments are updated IN PLACE under
``torch.no_grad()`` (a 2.5 B-parameter model has no room for a second copy),
a layer of a stacked leaf at a time, so the fp32 temporaries hold one
layer; the norm and the clip scale are taken from the gradients before any
leaf changes. Every scalar stays a tensor on the parameters' device: a step
never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch

from ..utils.tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "add_squares", "clip_scale", "bias_corrections",
           "update_leaf"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an
    fp32 tensor: linear warm-up over ``warmup_steps``, then a cosine from
    ``lr`` to 0 at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 moments shaped as ``params`` on its devices, step 0."""
    def zeros32(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    dev = leaves(params)[0].device
    return {"mu": tree_map(params, zeros32), "nu": tree_map(params, zeros32),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _rows(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """A stacked leaf (three axes or more, the layer first) a layer at a
    time; any other leaf whole."""
    return iter(t.unbind(0)) if t.dim() >= 3 else iter((t,))


def add_squares(total: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``total`` plus the fp32 sum of squares of ``g``, a layer at a time."""
    for r in _rows(g):
        total = total + torch.sum(r.float() ** 2).to(total.device)
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their fp32 sums of squares."""
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves(tree)[0].device)
    for g in leaves(tree):
        total = add_squares(total, g)
    return torch.sqrt(total)


def clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """The factor that clips the gradients to ``grad_clip`` by their norm."""
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    """(1 - b1^step, 1 - b2^step) in fp32."""
    return (1.0 - cfg.b1 ** step.to(torch.float32),
            1.0 - cfg.b2 ** step.to(torch.float32))


@torch.no_grad()
def update_leaf(p_, g_, mu_, nu_, scale, lr, c1, c2, cfg: AdamWConfig
                ) -> None:
    """One AdamW step of the leaf ``p_`` (and its moments) by ``g_``, in
    place, a layer at a time: the clipped fp32 gradient, the moments, the
    bias-corrected step with decoupled weight decay, cast back."""
    b1, b2 = cfg.b1, cfg.b2
    for p, g, mu, nu in zip(_rows(p_), _rows(g_), _rows(mu_), _rows(nu_)):
        g32 = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g32)
        nu.copy_(b2 * nu + (1 - b2) * g32 * g32)
        mhat = mu / c1
        nhat = nu / c2
        delta = (mhat / (torch.sqrt(nhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        p.copy_((p.float() - lr * delta).to(p.dtype))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step of ``params`` by ``grads`` (trees of the same shape),
    in place. Returns (params, opt_state, {"grad_norm", "lr"}): the same
    trees, updated, and the step's fp32 metrics."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    c1, c2 = bias_corrections(cfg, step)
    for p_, g_, mu_, nu_ in zip(leaves(params), leaves(grads),
                                leaves(opt_state["mu"]),
                                leaves(opt_state["nu"])):
        update_leaf(p_, g_, mu_, nu_, scale, lr, c1, c2, cfg)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
