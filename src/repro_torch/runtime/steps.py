"""Serve step builder: prefill and decode for one model and input shape —
the port of ``repro/runtime/steps.py``'s ``ServeStep`` / ``make_serve_step``.

Stated deviation: the reference takes a ``RunConfig`` and a mesh, lowers
``jax.jit``s with explicit NamedShardings (parameters, cache, batch and
logits laid out over ``data`` / ``model``) and donates the cache to decode.
The port takes the two parts of the run it reads, the ``ModelConfig`` and
the ``ShapeConfig``, and runs both steps on one ``device`` (``None`` means
the CUDA card), the weights held by
``ServeStep.model`` (draw them with ``model.init_params(generator)``), and
decode updates the cache in place. ``capacity`` is the prefill cache's row
count (default the prompt length, as the reference's); give it room for
the tokens to decode with ``decode_write=True``.

Not ported yet: the train half (``TrainStep``, ``make_train_step``, FSDP;
``steps.py:159-281``) and ``PIRStep`` (``:340``), whose role
``core.server.PIRServer`` plays.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.engine.backend import Device
from repro_torch.models import build_model, input_specs
from repro_torch.models.registry import InputSpec
from repro_torch.models.transformer import TransformerLM


class ServeStep(NamedTuple):
    prefill: Callable          # batch {"tokens": [B, S]} -> (logits, cache)
    decode: Callable           # (cache, tokens [B, 1]) -> (logits, cache')
    model: TransformerLM
    device: torch.device
    input_structs: Dict[str, InputSpec]


def make_serve_step(model_cfg: ModelConfig, shape: ShapeConfig, *,
                    device: Device = None, decode_write: bool = False,
                    capacity: Optional[int] = None) -> ServeStep:
    model = build_model(model_cfg, device=device)
    structs = input_specs(model_cfg, shape)

    def prefill(batch):
        extra = sorted(set(batch) - {"tokens"})
        if extra:
            raise NotImplementedError(
                f"step inputs {extra} belong to families not ported yet")
        return model.prefill(batch["tokens"], capacity=capacity)

    def decode(cache, tokens):
        return model.decode(cache, tokens, write=decode_write)

    return ServeStep(prefill=prefill, decode=decode, model=model,
                     device=model.device, input_structs=structs)
