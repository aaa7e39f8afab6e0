"""Configuration dataclasses of the port: ``PIRConfig`` and ``MeshConfig``,
and the model side (``ModelConfig``, ``ShapeConfig``)."""
from repro_torch.config.base import (
    AttentionKind,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PIRConfig,
    ShapeConfig,
    SSMConfig,
)

__all__ = [
    "AttentionKind",
    "MeshConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "PIRConfig",
    "ShapeConfig",
    "SSMConfig",
]
