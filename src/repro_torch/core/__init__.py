"""GLIN core — the paper's contribution (learned index for complex geometries).

Public API: build a :class:`SpatialIndex` and call :meth:`SpatialIndex.query`.
The mutable host :class:`GLIN`, the flattened :class:`GLINSnapshot` and the
``snapshot_from_host`` / ``batch_query`` device functions remain available as
the low-level layer the facade is built on.
"""
from .datasets import GeometrySet, generate, make_query_windows
from .index import GLIN, GLINConfig, QueryStats
from .model import GLINModelConfig
from .piecewise import PiecewiseFunction
from .relations import Relation, get_relation, register_relation, relation_names
from .device import GLINSnapshot, snapshot_from_host, batch_query
from .engine import (EngineConfig, QueryBatch, QueryPlan, QueryResult,
                     SpatialIndex)
from .exec import PIPELINE_STAGES, ExecutionPlan, OverflowLadder, StageStats
from .distributed import Mesh, make_mesh

__all__ = [
    "GeometrySet", "generate", "make_query_windows",
    "GLIN", "GLINConfig", "QueryStats", "GLINModelConfig",
    "PiecewiseFunction", "GLINSnapshot", "snapshot_from_host", "batch_query",
    "Relation", "get_relation", "register_relation", "relation_names",
    "EngineConfig", "QueryBatch", "QueryPlan", "QueryResult", "SpatialIndex",
    "PIPELINE_STAGES", "ExecutionPlan", "OverflowLadder", "StageStats",
    "Mesh", "make_mesh",
]
