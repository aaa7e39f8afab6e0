"""The train half's checkpoints (``manager.py``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
