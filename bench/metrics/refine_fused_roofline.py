"""Kernels (``kernels/refine.py`` ``refine_fused``, B2, ``csrc/refine.cu``):
the least time the card's memory bandwidth allows for a batch's work,
over the CUDA-event time of its fused launches, in %. The work is counted
from the store and the windows alone (``harness/roofline.py``); a batch
that escalates counts its work once against all its launches. Over the
instrumented stretch's batches that launched it."""

from bench.harness.roofline import refine_bytes


def read(rec):
    ms = rec.kernel_ms.get("refine_fused", {}) if rec.on_card else {}
    pick = [b for b in rec.stretch if b in ms]
    if not pick or not rec.peaks or "windows" not in rec.pool:
        return None
    nbytes = sum(refine_bytes(rec.grid,
                              rec.pool["windows"][rec.batches[b]["rows"]],
                              rec.batches[b]["relation"],
                              rec.batches[b]["hits"]) for b in pick)
    secs = sum(ms[b] for b in pick) * 1e-3
    return 100.0 * nbytes / rec.peaks["hbm_bytes_per_s"] / secs
