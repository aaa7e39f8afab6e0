"""The LM side of the port: the decoder-only transformer, dense or MoE
(``transformer.py``), its primitives (``layers.py``), the MoE FFN
(``moe.py``) and the family dispatch (``registry.py``)."""
from repro_torch.models.registry import FAMILIES, build_model, input_specs

__all__ = ["FAMILIES", "build_model", "input_specs"]
