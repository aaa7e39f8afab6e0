"""The train half's synthetic data (``pipeline.py``)."""
from repro_torch.data.pipeline import QueryPipeline, TokenPipeline

__all__ = ["QueryPipeline", "TokenPipeline"]
