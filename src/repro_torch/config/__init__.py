"""Configuration dataclasses of the port (only ``PIRConfig`` so far)."""
from repro_torch.config.base import PIRConfig

__all__ = ["PIRConfig"]
