"""Roofline terms of a dry-run cell, at the constants of the card the port
runs on (the port's counterpart of the reference's ``utils/roofline.py``).

Terms, in seconds, of one step of a cell::

    compute_s    = flops          / (chips * PEAK_FLOPS)
    memory_s     = bytes_accessed / (chips * HBM_BW)
    collective_s = coll_bytes     / (chips * LINK_BW)

``launch.dryrun`` passes per-chip counts (``utils.cost``) with ``chips=1``.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "roofline_terms",
           "model_flops"]

# NVIDIA H100 80GB HBM3 (SXM, 700 W), the data sheet's figures:
PEAK_FLOPS = 989e12     # bf16 dense tensor-core operations/s
HBM_BW = 3.35e12        # bytes/s of HBM3
# NVLink 4, per direction (900 GB/s both ways). Not measured: the machine
# this port runs on has one card, so no link between cards was timed.
LINK_BW = 450e9


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int) -> Dict[str, float]:
    """The three terms, the ``dominant`` one, ``bound_s`` (the largest)
    and ``compute_fraction`` (compute_s over bound_s)."""
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * LINK_BW)
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "compute_fraction": compute_s / total if total > 0 else 0.0,
    }


def model_flops(cfg, shape, per_step_tokens: Optional[int] = None) -> float:
    """MODEL_FLOPS: 6 N D for a train step (N the active parameters, D the
    tokens), 2 N D for a prefill, 2 N B for a decode step (one token a
    sequence). ``per_step_tokens`` is the reference's unused argument."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
