"""Carry the reference's parameters into the port.

:func:`params_from_reference` takes the JAX ``init_params`` pytree as numpy
arrays (stacked leading layer axis, dense weights (in, out)) and returns the
port's parameter dict. The port keeps the same layout — its ``dense`` is
``x @ w`` with ``w`` (in, out) — so no weight is transposed: the carry
checks the tree against the port's, converts each leaf (bf16 by its bits),
checks its dtype against the port's leaf (the SSM's fp32 leaves and the MoE
router, fp32 in a bf16 model) and places it on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import transformer as tf

__all__ = ["params_from_reference"]


def _to_torch(a, device) -> torch.Tensor:
    """A numpy array (fp32, int, or ml_dtypes bf16) -> a tensor on device."""
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _shapes(tree) -> Dict[str, Any]:
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def _want(tree) -> Dict[str, Any]:
    return {k: (_want(v) if isinstance(v, dict) else tuple(v[0]))
            for k, v in tree.items()}


def params_from_reference(cfg, params_np, device="cuda") -> Dict[str, Any]:
    """The reference's ``init_params(cfg, key)`` pytree (numpy leaves) ->
    the port's parameters for ``cfg``, computing the same function. Raises
    on a family the port lacks and on any leaf the port's tree does not
    have, or has with another shape or dtype."""
    leaves = tf.param_shapes(cfg)
    want = _want(leaves)
    got = _shapes(params_np)
    if got != want:
        raise ValueError(f"{cfg.name}: the reference's parameter tree "
                         f"{got} is not the port's {want}")
    dtype = tf.dtype_of(cfg)

    def carry(tree, spec, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = carry(v, spec[k], f"{path}{k}/")
                continue
            t = _to_torch(v, device)
            if t.dtype != (spec[k].dtype or dtype):
                raise ValueError(f"{cfg.name}: leaf {path}{k} is {t.dtype}, "
                                 f"the port's is {spec[k].dtype or dtype}")
            out[k] = t
        return out

    return carry(params_np, leaves, "")
