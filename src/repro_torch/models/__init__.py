"""The LM side of the port: the dense decoder-only transformer
(``transformer.py``), its primitives (``layers.py``) and the family
dispatch (``registry.py``)."""
from repro_torch.models.registry import FAMILIES, build_model, input_specs

__all__ = ["FAMILIES", "build_model", "input_specs"]
