"""Configuration dataclasses of the port (``PIRConfig``, ``MeshConfig``)."""
from repro_torch.config.base import MeshConfig, PIRConfig

__all__ = ["MeshConfig", "PIRConfig"]
