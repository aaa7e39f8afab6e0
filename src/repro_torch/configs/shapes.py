"""Input-shape presets (identical for every LM-family arch), as
``repro/configs/shapes.py``.

``decode_*`` / ``long_*`` run the serve step's decode (one new token
against a KV cache of ``seq_len``); ``prefill_*`` its prefill pass.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# Smoke-scale shapes (reduced configs, one CPU device).
SMOKE_TRAIN = ShapeConfig(name="smoke_train", seq_len=32, global_batch=2, kind="train")
SMOKE_PREFILL = ShapeConfig(name="smoke_prefill", seq_len=32, global_batch=2, kind="prefill")
SMOKE_DECODE = ShapeConfig(name="smoke_decode", seq_len=32, global_batch=2, kind="decode")


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
