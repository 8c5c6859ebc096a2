"""Test mesh construction for the sharded backend.

A FUNCTION, not a module-level constant: importing this module touches no
device. The mesh is a grid of torch devices under one controller
(``core.distributed.Mesh``).
"""
from __future__ import annotations

from ..core.distributed import make_mesh

__all__ = ["make_test_mesh"]


def make_test_mesh(shape=(4, 2), axes=("data", "model"), devices=None):
    """Small mesh for the sharded tests: ``devices`` as
    ``core.distributed.make_mesh`` takes them (``["cpu"] * 8`` on the CPU,
    ``["cuda:0"] * 8`` to put every position on one card; None: the first
    ``prod(shape)`` cards)."""
    return make_mesh(shape, axes, devices)
