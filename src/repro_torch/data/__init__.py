"""Deterministic synthetic-token data pipeline (``pipeline``)."""
from .pipeline import DataConfig, PrefetchingLoader, SyntheticTokenPipeline

__all__ = ["DataConfig", "PrefetchingLoader", "SyntheticTokenPipeline"]
