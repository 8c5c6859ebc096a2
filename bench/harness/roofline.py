"""Work counts for rooflines, from the store and the queries alone.

:func:`refine_bytes` is the least traffic of one window batch through the
fused refine (B2), whatever implements it: the 16-byte MBR and 4-byte id of
each distinct record whose MBR meets a probe window of the batch, those
records' vertices at 8 bytes each, 16 bytes a window read and 4 bytes a
hit written. Nothing here reads the program's walk, slots or model.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..reference import geometry as geo

PEAKS = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> Optional[dict]:
    """The data sheet's peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def refine_bytes(grid, windows: np.ndarray, relation: str, hits: int) -> int:
    pad = geo.parse(relation)[2]
    recs = [grid.candidates(np.array([w[0] - pad, w[1] - pad, w[2] + pad,
                                      w[3] + pad])) for w in windows]
    rec = np.unique(np.concatenate(recs)) if recs else np.zeros(0, np.int64)
    verts = int(grid.store.nv[rec].astype(np.int64).sum())
    return 20 * rec.shape[0] + 8 * verts + 16 * len(windows) + 4 * int(hits)
