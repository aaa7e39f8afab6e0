"""Model zoo dispatch: ``ModelConfig.family`` -> model — the port of
``repro/models/registry.py`` for every family: dense, MoE, VLM, audio,
SSM and hybrid.

A model is an ``nn.Module`` holding its weights (``init_params(generator)``
draws them); its entry points are ``forward``, ``loss``, ``prefill``,
``decode`` and ``init_cache`` (``models/transformer.py``'s
``TransformerLM`` for the decoder-only families, ``models/encdec.py``'s
``EncDecLM`` for audio, ``models/xlstm.py``'s ``XLSTMModel`` for the SSM
family, ``models/hybrid.py``'s ``Zamba2Model`` for the hybrid family).
``input_specs`` gives the step inputs' shapes and dtypes; there is no
mesh, so no PartitionSpecs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import Zamba2Model
from repro_torch.models.transformer import PORTED_FAMILIES, TransformerLM
from repro_torch.models.xlstm import XLSTMModel

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
#: every family the port serves: TransformerLM's, the encoder-decoder's, the
#: xLSTM's and the hybrid's
SERVED = PORTED_FAMILIES + ("audio", "ssm", "hybrid")

#: the model class of each family outside TransformerLM's
_MODELS = {"audio": EncDecLM, "ssm": XLSTMModel, "hybrid": Zamba2Model}


class InputSpec(NamedTuple):
    """Shape and dtype of one step input (``jax.ShapeDtypeStruct``'s
    counterpart)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in SERVED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
            f"serves {SERVED}")


def build_model(cfg: ModelConfig, *, device: Device = None,
                remat: str = "block"
                ) -> Union[TransformerLM, EncDecLM, XLSTMModel, Zamba2Model]:
    """The model for ``cfg`` with its weights allocated on ``device``
    (``None`` means the CUDA card; no card raises) and not yet drawn.
    ``remat`` is the reference's: ``"block"`` recomputes each layer in the
    backward pass of ``loss``, ``"none"`` keeps its activations."""
    _check_family(cfg)
    model = _MODELS.get(cfg.family, TransformerLM)
    return model(cfg, device=resolve_device(device), remat=remat)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, InputSpec]:
    """The step inputs: ``tokens`` ``[B, S]`` int32, or ``[B, 1]`` for a
    ``decode`` shape. A VLM's other shapes split the S positions: the
    client's patch embeddings ``prefix_embeds`` ``[B, P, d]`` in the
    config's dtype (P = ``n_frontend_tokens``) and ``tokens`` ``[B, S -
    P]``. An audio model's take ``tokens`` ``[B, S]`` and the client's
    frame embeddings ``frame_embeds`` ``[B, encoder_len, d]`` in the
    config's dtype."""
    _check_family(cfg)
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": InputSpec((b, 1), torch.int32)}
    tokens = InputSpec((b, shape.seq_len), torch.int32)
    if cfg.family == "audio":
        return {"tokens": tokens,
                "frame_embeds": InputSpec((b, cfg.encoder_len, cfg.d_model),
                                          cfg.torch_dtype)}
    if cfg.family != "vlm":
        return {"tokens": tokens}
    n_front = cfg.n_frontend_tokens
    if shape.seq_len <= n_front:
        raise ValueError(
            f"{shape.name}: {shape.seq_len} positions cannot hold "
            f"{cfg.name}'s {n_front} prefix rows and a text token")
    return {"tokens": InputSpec((b, shape.seq_len - n_front), torch.int32),
            "prefix_embeds": InputSpec((b, n_front, cfg.d_model),
                                       cfg.torch_dtype)}
