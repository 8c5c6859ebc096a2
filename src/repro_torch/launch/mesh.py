"""Mesh construction for the sharded backend: the production meshes
(single-pod 16 x 16, multi-pod 2 x 16 x 16) and small test meshes.

FUNCTIONS, not module-level constants: importing this module touches no
device. A mesh is a grid of torch devices under one controller
(``core.distributed.Mesh``).
"""
from __future__ import annotations

from ..core.distributed import make_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """The reference's production mesh: (16, 16) over ``("data",
    "model")``, or with ``multi_pod`` (2, 16, 16) over ``("pod", "data",
    "model")``. ``devices`` as ``core.distributed.make_mesh`` takes them
    (``["cpu"] * 256`` to lay the mesh out on the CPU); None takes the
    first 256 (512) cards and raises where there are fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_test_mesh(shape=(4, 2), axes=("data", "model"), devices=None):
    """Small mesh for the sharded tests: ``devices`` as
    ``core.distributed.make_mesh`` takes them (``["cpu"] * 8`` on the CPU,
    ``["cuda:0"] * 8`` to put every position on one card; None: the first
    ``prod(shape)`` cards)."""
    return make_mesh(shape, axes, devices)
