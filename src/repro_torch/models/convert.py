"""Carry the reference's parameters into the port.

:func:`params_from_reference` takes the JAX ``init_params`` pytree as numpy
arrays (stacked leading layer axis, dense weights (in, out)) and returns the
port's parameter dict. The port keeps the same layout — its ``dense`` is
``x @ w`` with ``w`` (in, out) — so no weight is transposed: the carry
checks the tree against the port's, converts each leaf (bf16 by its bits)
and places it on ``device``.
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
    have, or has with another shape."""
    want = _want(tf.param_shapes(cfg))
    got = _shapes(params_np)
    if got != want:
        raise ValueError(f"{cfg.name}: the reference's parameter tree "
                         f"{got} is not the port's {want}")

    def carry(tree):
        return {k: (carry(v) if isinstance(v, dict) else _to_torch(v, device))
                for k, v in tree.items()}

    return carry(params_np)
