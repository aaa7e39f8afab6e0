"""Configuration dataclasses of the port: ``PIRConfig`` and ``MeshConfig``,
the model side (``ModelConfig``, ``ShapeConfig``) and the train half
(``OptimizerConfig``, ``RunConfig``)."""
from repro_torch.config.base import (
    AttentionKind,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    PIRConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
)

__all__ = [
    "AttentionKind",
    "MeshConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "PIRConfig",
    "RunConfig",
    "ShapeConfig",
    "SSMConfig",
]
