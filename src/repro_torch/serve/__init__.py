"""Serving tier: the GLIN spatial-query server (replica router, admission
control, adaptive micro-batching). The LM slot-serving demo lives in
``repro_torch.launch.serve``."""
from .server import Rejected, ServerConfig, SpatialQueryServer

__all__ = ["Rejected", "ServerConfig", "SpatialQueryServer"]
