"""Sharding: logical-axis rules, placed values and their collectives, and
the activation-constraint context.

Model code calls ``constrain(x, logical_axes)``; outside ``use_rules`` that
is the identity (every single-device caller), and inside
``use_rules(rules)`` a placed value (:class:`~.placement.Sharded`) comes
back laid out as :func:`~.rules.logical_to_spec` resolves the names: the
value itself where it already is, otherwise a gather or a slice — the
explicit counterpart of the reference's ``with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from .placement import (NamedSharding, Sharded, all_gather, all_to_all,
                        gather, gather_tree, place, place_tree, pmax,
                        ppermute, psum, reduce_scatter, relayout, smap)
from .rules import MeshRules, PartitionSpec, logical_to_spec, spec_tree

__all__ = ["MeshRules", "PartitionSpec", "logical_to_spec", "spec_tree",
           "use_rules", "constrain", "current_rules", "Sharded",
           "NamedSharding", "place", "gather", "place_tree", "gather_tree",
           "smap", "psum", "pmax", "all_gather", "all_to_all",
           "reduce_scatter", "ppermute", "relayout"]

_STATE = threading.local()


def current_rules() -> Optional[MeshRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def constrain(x, logical: Tuple[Optional[str], ...]):
    """``x`` laid out by the logical axes under the current rules (see the
    module docstring); ``x`` itself outside ``use_rules``, where it is not
    a placed value, or where it is a per-position value (no layout)."""
    rules = current_rules()
    if rules is None or not isinstance(x, Sharded) or x.spec is None:
        return x
    return relayout(x, logical_to_spec(rules, logical, x.shape))
