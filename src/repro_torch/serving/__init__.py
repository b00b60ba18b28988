"""Batched serving of the aggregated global model."""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
