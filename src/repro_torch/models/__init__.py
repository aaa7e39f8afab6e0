"""The LM side of the port: the decoder-only transformer, dense, MoE or
VLM (``transformer.py``), the audio family's encoder-decoder
(``encdec.py``), the SSM family's xLSTM (``xlstm.py``, its mixers in
``ssm.py``), the hybrid family's Zamba2 (``hybrid.py``, its Mamba2 mixer
in ``ssm.py``), their primitives (``layers.py``), the MoE FFN (``moe.py``)
and the family dispatch (``registry.py``)."""
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import Zamba2Model
from repro_torch.models.registry import FAMILIES, build_model, input_specs
from repro_torch.models.xlstm import XLSTMModel

__all__ = ["FAMILIES", "EncDecLM", "XLSTMModel", "Zamba2Model",
           "build_model", "input_specs"]
