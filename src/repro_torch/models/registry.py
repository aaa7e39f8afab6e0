"""Model zoo dispatch: ``ModelConfig.family`` -> model — the port of
``repro/models/registry.py`` for the dense and MoE families.

A model is an ``nn.Module`` holding its weights (``init_params(generator)``
draws them); its entry points are ``forward``, ``loss``, ``prefill``,
``decode`` and ``init_cache`` (``models/transformer.py``). ``input_specs`` gives the step
inputs' shapes and dtypes; there is no mesh, so no PartitionSpecs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.models.transformer import PORTED_FAMILIES, TransformerLM

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


class InputSpec(NamedTuple):
    """Shape and dtype of one step input (``jax.ShapeDtypeStruct``'s
    counterpart)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
            f"serves {PORTED_FAMILIES}")


def build_model(cfg: ModelConfig, *, device: Device = None,
                remat: str = "block") -> TransformerLM:
    """The model for ``cfg`` with its weights allocated on ``device``
    (``None`` means the CUDA card; no card raises) and not yet drawn.
    ``remat`` is the reference's: ``"block"`` recomputes each layer in the
    backward pass of ``loss``, ``"none"`` keeps its activations."""
    _check_family(cfg)
    return TransformerLM(cfg, device=resolve_device(device), remat=remat)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, InputSpec]:
    """The step inputs: ``tokens`` ``[B, S]`` int32, or ``[B, 1]`` for a
    ``decode`` shape."""
    _check_family(cfg)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    return {"tokens": InputSpec((shape.global_batch, seq), torch.int32)}
