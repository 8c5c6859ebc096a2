"""Logical-axis sharding rules: the port's own copy of the reference's
``sharding/rules.py``.

Weights and activations carry *logical* axis names; a rule table maps them
to mesh axes per mesh flavour:

    batch   -> ('pod', 'data')   data parallel (pod folds into DP by default)
    fsdp    -> ('pod', 'data')   parameter/optimizer sharding (ZeRO-3 style)
    heads   -> 'model'           tensor parallel attention
    kv      -> 'model'           TP for KV projections (replicated if indivisible)
    ff      -> 'model'           TP for MLP hidden
    vocab   -> 'model'           TP for embedding/LM head
    experts -> 'data'            expert parallel (falls back per-arch)
    seq     -> None | 'model'    sequence parallel (optional)

:func:`logical_to_spec` resolves a tuple of logical names into a
:class:`PartitionSpec`, with the reference's two quiet rules: an axis whose
dimension its mesh extent does not divide is replicated, and a mesh axis
already used by an earlier dimension is not used again. A rule table reads
only ``mesh.axis_names`` and ``mesh.shape``, so any object with those two
serves it (the port's ``core.distributed.Mesh``, or a stand-in with no
devices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

from ..utils.tree import paths

__all__ = ["PartitionSpec", "MeshRules", "logical_to_spec", "spec_tree",
           "shape_of"]


class PartitionSpec(tuple):
    """A layout: one entry per leading dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of axis names (the dimension
    split over their product, the first the major); trailing dimensions
    past the entries are replicated. A tuple, so it compares equal to the
    reference's ``PartitionSpec`` taken as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes splitting dimension ``dim``, major first."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Rule table bound to a concrete mesh."""

    mesh: Any
    seq_sharding: bool = False     # sequence parallelism for the residual
    expert_axis: str = "data"

    def axis_for(self, logical: Optional[str]):
        has_pod = "pod" in self.mesh.axis_names
        dp = ("pod", "data") if has_pod else ("data",)
        table = {
            None: None,
            "batch": dp,
            "fsdp": dp,
            "w_embed": dp,
            "heads": ("model",),
            "kv": ("model",),
            "kv_seq": ("model",),
            "ff": ("model",),
            "vocab": ("model",),
            "experts": (self.expert_axis,) if self.expert_axis else None,
            "moe_cap": dp,
            "seq": ("model",) if self.seq_sharding else None,
            "stage": ("pod",) if has_pod else None,
        }
        return table.get(logical, None)

    def extent(self, axes) -> int:
        if axes is None:
            return 1
        return int(math.prod(self.mesh.shape[a] for a in axes))


def logical_to_spec(rules: MeshRules, logical: Tuple[Optional[str], ...],
                    shape: Tuple[int, ...]) -> PartitionSpec:
    """Logical axes + concrete shape -> PartitionSpec with divisibility
    checks."""
    assert len(logical) == len(shape), (logical, shape)
    used = set()
    out = []
    for name, dim in zip(logical, shape):
        axes = rules.axis_for(name)
        if axes is None:
            out.append(None)
            continue
        axes = tuple(a for a in axes if a not in used)
        ext = rules.extent(axes)
        if ext <= 1 or dim % ext != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_tree(rules: MeshRules, logical_tree, shape_tree):
    """Parallel nested dicts of logical-axis tuples and shapes -> the same
    tree of PartitionSpecs. A shape is a tuple of ints, or a ``(shape,
    dtype)`` pair, or anything with a ``.shape``."""
    flat_shapes = {k: shape_of(v) for k, v in paths(shape_tree)}

    def walk(lg, prefix):
        if isinstance(lg, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in lg.items()}
        return logical_to_spec(rules, lg, flat_shapes[prefix[:-1]])

    return walk(logical_tree, "")


def shape_of(leaf) -> Tuple[int, ...]:
    """The shape of a leaf: a tensor (or anything with ``.shape``), a
    ``(shape, dtype)`` pair, or a shape."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if (len(leaf) == 2 and isinstance(leaf[0], (tuple, list))
            and not isinstance(leaf[1], int)):
        return tuple(leaf[0])
    return tuple(leaf)

