"""The LM side of the port: the decoder-only transformer, dense, MoE or
VLM (``transformer.py``), the audio family's encoder-decoder
(``encdec.py``), their primitives (``layers.py``), the MoE FFN
(``moe.py``) and the family dispatch (``registry.py``)."""
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import FAMILIES, build_model, input_specs

__all__ = ["FAMILIES", "EncDecLM", "build_model", "input_specs"]
