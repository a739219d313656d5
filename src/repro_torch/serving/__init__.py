"""Serving engine, tiered cluster and samplers of the port."""

from repro_torch.serving.engine import (
    EngineConfig,
    Request,
    ServingEngine,
    TieredServingCluster,
)

__all__ = ["EngineConfig", "Request", "ServingEngine", "TieredServingCluster"]
