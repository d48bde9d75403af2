"""Serving layer of the port: the batched fixed-shape engine."""
from .ann_engine import (BatchedANNEngine, EngineConfig, batched_search,
                         resolve_backend)

__all__ = ["BatchedANNEngine", "EngineConfig", "batched_search",
           "resolve_backend"]
