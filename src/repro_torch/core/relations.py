"""First-class spatial relations for the GLIN query engine.

The paper's central claim (§VI, §VIII) is that ONE interval-probe mechanism
answers many spatial relationships exactly, provided each relation brings two
things: an *exact predicate* for the refinement step and a *window-augmentation
rule* for the probe key. This module makes that pairing explicit: a
:class:`Relation` bundles

* ``predicate``      — the exact-shape check on the fp64 host path
  (array-namespace generic numpy);
* ``code``           — the device predicate code (``geometry.PRED_*``): the
  batched torch fp32 predicate and the CUDA kernels' switch select the same
  rule by it (``device_predicate`` resolves the torch callable);
* ``augment``        — whether the probe key ``Zmin_Q`` must be lowered by the
  piecewise function (Alg 2 / Lemma 2). Relations whose hits can have
  ``Zmin_GM < Zmin_Q`` (anything that admits geometries *overlapping* the
  window) need it; relations whose hits start inside the window do not;
* ``mbr_prefilter``  — a conservative record-MBR test (never drops a true hit)
  used by both the host refinement loop and the batched device kernel;
* ``probe_pad``      — margin added to every window side before the probe and
  the leaf-MBR pruning (``dwithin`` hits can lie entirely outside the window,
  up to the query distance away; the L∞ expansion is a conservative superset
  of the Euclidean dilation, so probing stays lossless);
* ``device_native``  — whether the batched device path evaluates it directly;
* ``complement_of``  — relations answered as the complement of another
  (``disjoint`` = live records minus ``intersects``); these are host-finished;
* ``parametric``/``bind`` — template relations instantiated per parameter by
  name (``dwithin:0.05``); bound relations are cached by their full name.

Every query layer — host ``GLIN.query``, the ``core.device`` batch path, the
kernels and the ``SpatialIndex`` facade — dispatches through this registry, so
adding a relation is one ``register_relation`` call, not five string
branches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import geometry as geom

__all__ = ["Relation", "RELATIONS", "register_relation", "get_relation",
           "relation_names", "check_registry"]

# predicate(window(4,), verts(N,V,2), nverts(N,), kinds(N,), xp) -> (N,) bool
Predicate = Callable[..., np.ndarray]
# prefilter(rec_mbr(...,4), window(...,4), xp) -> bool mask (broadcasting)
MbrPrefilter = Callable[..., np.ndarray]


def _pad_window(window, pad: float, xp=np):
    """Window expanded by ``pad`` on every side (L∞ dilation). The single
    source of the expansion used by probing, leaf pruning and the dwithin
    MBR prefilter."""
    if not pad:
        return window
    if isinstance(window, torch.Tensor):
        delta = torch.tensor([-pad, -pad, pad, pad], dtype=window.dtype,
                             device=window.device)
    else:
        delta = xp.asarray([-pad, -pad, pad, pad], dtype=window.dtype)
    return window + delta


@dataclasses.dataclass(frozen=True)
class Relation:
    """A spatial relationship between a rectangular query window and the
    stored geometries, with everything the probe + refine pipeline needs."""

    name: str
    predicate: Predicate
    augment: bool                 # probe key needs piecewise augmentation
    mbr_prefilter: MbrPrefilter
    device_native: bool = True    # batched device path evaluates it directly
    complement_of: Optional[str] = None
    probe_pad: float = 0.0        # widen the probe / leaf-prune window
    prefilter_kind: str = "intersects"  # static shape of mbr_prefilter for
                                  # fused kernels: "intersects" (record MBR
                                  # meets the PROBE window — covers dwithin,
                                  # whose prefilter pads by the same amount),
                                  # "contains" (record MBR covers the raw
                                  # window, e.g. within), or "custom"
                                  # (kernel unusable; torch prefilter only)
    parametric: bool = False      # template: requires "name:<param>" lookup
    bind: Optional[Callable[[float, str], "Relation"]] = None
    doc: str = ""
    code: int = -1                # device predicate code (geometry.PRED_*);
                                  # -1: no device predicate
    dist: float = 0.0             # PRED_DWITHIN distance parameter

    @property
    def device_predicate(self):
        """Batched torch fp32 predicate ``(rect, verts, nverts, kinds)``."""
        return geom.device_predicate(self.code, self.dist)

    def base_name(self) -> str:
        """Relation whose candidate interval is actually probed."""
        return self.complement_of if self.complement_of else self.name

    @property
    def is_complement(self) -> bool:
        """True when hits are ``live \\ base`` — the execution pipeline
        queries :meth:`base_name` and the shared complement-finish stage
        subtracts the base hits from the frozen live-id set."""
        return self.complement_of is not None

    def probe_window(self, window, xp=np):
        """The window used for probing and MBR-level pruning: the query
        window itself, expanded by ``probe_pad`` on every side for relations
        whose hits may lie outside it (numpy arrays or torch tensors)."""
        return _pad_window(window, self.probe_pad, xp=xp)


RELATIONS: Dict[str, Relation] = {}
_BOUND: Dict[str, Relation] = {}   # "name:param" -> bound Relation cache


def register_relation(rel: Relation, replace: bool = False) -> Relation:
    """Add ``rel`` to the registry. Duplicate names raise (a silent overwrite
    would re-route every query layer at a distance) unless ``replace=True``
    is passed explicitly."""
    if rel.name in RELATIONS and not replace:
        raise ValueError(
            f"relation {rel.name!r} is already registered; pass replace=True "
            "to overwrite it deliberately")
    if rel.complement_of is not None:
        base = RELATIONS.get(rel.complement_of)
        if base is None:
            raise ValueError(f"complement_of {rel.complement_of!r} is unknown "
                             "(register the base relation first)")
        if base.complement_of is not None:
            raise ValueError(
                f"complement_of {rel.complement_of!r} is itself a complement; "
                "chain complements are not supported")
    if rel.parametric and rel.bind is None:
        raise ValueError(f"parametric relation {rel.name!r} needs a bind "
                         "factory")
    RELATIONS[rel.name] = rel
    _BOUND.clear()   # bound relations may shadow a replaced template
    return rel


def get_relation(name: str) -> Relation:
    rel = RELATIONS.get(name) or _BOUND.get(name)
    if rel is None and ":" in name:
        base, _, arg = name.partition(":")
        tmpl = RELATIONS.get(base)
        if tmpl is not None and tmpl.parametric:
            try:
                param = float(arg)
            except ValueError:
                raise ValueError(
                    f"bad parameter {arg!r} in relation {name!r}") from None
            rel = _BOUND.setdefault(name, tmpl.bind(param, name))
    if rel is None:
        raise ValueError(
            f"unknown relation {name!r}; registered: {sorted(RELATIONS)}")
    if rel.parametric:
        raise ValueError(
            f"relation {name!r} requires a parameter: query it as "
            f"'{name}:<value>' (e.g. '{name}:0.05')")
    return rel


def relation_names(device_native: Optional[bool] = None) -> Tuple[str, ...]:
    names = (n for n, r in RELATIONS.items()
             if device_native is None or r.device_native == device_native)
    return tuple(sorted(names))


def check_registry() -> Tuple[str, ...]:
    """Validate registry invariants (used by the self-check test and safe to
    call at any time): complements resolve to registered, non-complement,
    device-native bases; parametric templates carry a bind factory; bound
    cache entries agree with their template family. Returns the names."""
    for name, rel in RELATIONS.items():
        if rel.name != name:
            raise AssertionError(f"registry key {name!r} != Relation.name "
                                 f"{rel.name!r}")
        if rel.complement_of is not None:
            base = RELATIONS.get(rel.complement_of)
            if base is None:
                raise AssertionError(f"{name!r}: complement base "
                                     f"{rel.complement_of!r} not registered")
            if base.complement_of is not None:
                raise AssertionError(f"{name!r}: complement of a complement")
            # (a host-only base is fine: the planner routes such relations
            # to the host backend)
        if rel.parametric and rel.bind is None:
            raise AssertionError(f"{name!r}: parametric without bind")
        if rel.probe_pad < 0:
            raise AssertionError(f"{name!r}: negative probe_pad")
        if rel.prefilter_kind not in ("intersects", "contains", "custom"):
            raise AssertionError(f"{name!r}: unknown prefilter_kind "
                                 f"{rel.prefilter_kind!r}")
        if (rel.device_native and rel.complement_of is None
                and not rel.parametric and rel.code < 0):
            raise AssertionError(f"{name!r}: device-native without a device "
                                 "predicate code")
    for name, rel in _BOUND.items():
        family = name.partition(":")[0]
        if family not in RELATIONS or not RELATIONS[family].parametric:
            raise AssertionError(f"bound relation {name!r} has no parametric "
                                 "template")
        if rel.parametric:
            raise AssertionError(f"bound relation {name!r} is still "
                                 "parametric")
    return relation_names()


# ---------------------------------------------------------------------------
# Built-in relations. Window W is the query rectangle, G a stored geometry.
# ---------------------------------------------------------------------------
def _pf_intersects(rec_mbr, window, xp=np):
    return geom.mbr_intersects(rec_mbr, window, xp=xp)


def _pf_rec_mbr_covers_window(rec_mbr, window, xp=np):
    return geom.mbr_contains(rec_mbr, window, xp=xp)


register_relation(Relation(
    name="intersects",
    code=geom.PRED_INTERSECTS,
    predicate=geom.rect_intersects_geoms,
    augment=True,   # hits may start before W: Zmin_GM < Zmin_Q (Lemma 2)
    mbr_prefilter=_pf_intersects,
    doc="W and G share at least one point (the paper's Intersects).",
))

register_relation(Relation(
    name="contains",
    code=geom.PRED_CONTAINS,
    predicate=geom.rect_contains_geoms_proper,
    augment=False,  # MBR(G) inside W implies Zmin_GM in [Zmin_Q, Zmax_Q]
    mbr_prefilter=_pf_intersects,
    doc="G lies in W and touches W's interior (GEOS-style proper Contains).",
))

register_relation(Relation(
    name="covers",
    code=geom.PRED_COVERS,
    predicate=lambda rect, verts, nverts, kinds, xp=np:
        geom.rect_covers_geoms(rect, verts, nverts, xp=xp),
    augment=False,
    mbr_prefilter=_pf_intersects,
    doc="Every point of G lies in closed W (boundary-inclusive Contains; "
        "the paper's closed-window Contains).",
))

register_relation(Relation(
    name="within",
    code=geom.PRED_WITHIN,
    predicate=geom.geoms_cover_rect,
    augment=True,   # covering geometries start before W: Zmin_GM <= Zmin_Q
    mbr_prefilter=_pf_rec_mbr_covers_window,
    prefilter_kind="contains",
    doc="W lies entirely inside G (window within geometry; exact for simple "
        "polygons, convex or concave).",
))

register_relation(Relation(
    name="disjoint",
    predicate=geom.rect_disjoint_geoms,
    augment=False,
    mbr_prefilter=_pf_intersects,   # prefilter of the base relation
    device_native=False,
    complement_of="intersects",
    doc="W and G share no point: complement of Intersects over live records.",
))

register_relation(Relation(
    name="touches",
    code=geom.PRED_TOUCHES,
    predicate=geom.rect_touches_geoms,
    augment=True,   # touching geometries overlap W's boundary: Zmin may precede
    mbr_prefilter=_pf_intersects,
    doc="W and G share points but their interiors are disjoint (DE-9IM "
        "Touches: boundary contact only).",
))

register_relation(Relation(
    name="crosses",
    code=geom.PRED_CROSSES,
    predicate=geom.rect_crosses_geoms,
    augment=True,
    mbr_prefilter=_pf_intersects,
    doc="G's interior passes through W's interior and exits W (DE-9IM "
        "Crosses; polylines only — area/area crosses is undefined and "
        "returns False for polygons).",
))


def _bind_dwithin(dist: float, name: str) -> Relation:
    """Instantiate ``dwithin:<d>``: Euclidean distance(W, G) <= d."""
    if not (math.isfinite(dist) and dist >= 0.0):
        raise ValueError(
            f"dwithin distance must be finite and >= 0, got {dist!r}")

    def pred(rect, verts, nverts, kinds, xp=np):
        return geom.rect_dwithin_geoms(rect, verts, nverts, kinds, dist,
                                       xp=xp)

    def prefilter(rec_mbr, window, xp=np):
        return geom.mbr_intersects(rec_mbr, _pad_window(window, dist, xp=xp),
                                   xp=xp)

    return dataclasses.replace(
        RELATIONS["dwithin"], name=name, predicate=pred,
        mbr_prefilter=prefilter, probe_pad=dist, parametric=False, bind=None,
        code=geom.PRED_DWITHIN, dist=dist,
        doc=f"Euclidean distance between W and G is at most {dist!r} "
            "(distance-buffered Intersects).")


register_relation(Relation(
    name="dwithin",
    predicate=lambda rect, verts, nverts, kinds, xp=np:
        geom.rect_dwithin_geoms(rect, verts, nverts, kinds, 0.0, xp=xp),
    augment=True,   # buffered hits may start before the expanded window
    mbr_prefilter=_pf_intersects,
    parametric=True,
    bind=_bind_dwithin,
    doc="Euclidean distance between W and G is at most d; parametric — "
        "query as 'dwithin:<d>' (the ROADMAP's knn-radius relation).",
))
