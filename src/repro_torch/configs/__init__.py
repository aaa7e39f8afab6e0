"""Named configurations of the port: the PIR databases (``configs.pir``)
and the architectures, resolved by name as ``repro/configs/__init__.py``
does (``--arch <id>``).

Each architecture module defines FULL (the published configuration) and
SMOKE (a reduced same-family configuration runnable on one CPU device).
The port serves every family of the reference: dense, MoE, VLM, audio,
SSM and hybrid. ``NOT_PORTED`` is empty; an architecture a later
reference adds goes there, and naming it raises ``NotImplementedError``
that says so, never a silent fallback. ``LONG_CONTEXT_ARCHS`` and
``cell_is_skipped`` are the reference's shape-grid rule: only the archs
whose decode state does not grow with length run ``long_500k``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import ModelConfig
from repro_torch.configs import (
    deepseek_v3_671b,
    granite_3_2b,
    grok_1_314b,
    llava_next_34b,
    qwen3_4b,
    stablelm_3b,
    starcoder2_3b,
    whisper_small,
    xlstm_350m,
    zamba2_7b,
)
from repro_torch.configs.shapes import SHAPES, get_shape

_MODULES = {
    "granite-3-2b": granite_3_2b,
    "qwen3-4b": qwen3_4b,
    "starcoder2-3b": starcoder2_3b,
    "stablelm-3b": stablelm_3b,
    "grok-1-314b": grok_1_314b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "llava-next-34b": llava_next_34b,
    "whisper-small": whisper_small,
    "xlstm-350m": xlstm_350m,
    "zamba2-7b": zamba2_7b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.FULL for k, m in _MODULES.items()}
SMOKES: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}

#: the reference's architectures whose configs and models are not ported
#: yet, by family (none: every family is)
NOT_PORTED: Dict[str, str] = {}

#: pure full-attention archs skip long_500k (sub-quadratic required); the
#: SSM and hybrid archs run it
LONG_CONTEXT_ARCHS = ("xlstm-350m", "zamba2-7b")


def get_arch(name: str, *, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} (family {NOT_PORTED[name]!r}) is not ported yet; "
            f"the port serves the dense, moe, vlm, audio, ssm and hybrid "
            f"families: {sorted(ARCHS)}")
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def cell_is_skipped(arch: str, shape_name: str) -> bool:
    """True when an (arch x shape) cell is excluded by the assignment
    rules: ``long_500k`` for every arch outside ``LONG_CONTEXT_ARCHS``."""
    return shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS


__all__ = ["ARCHS", "SMOKES", "NOT_PORTED", "SHAPES", "LONG_CONTEXT_ARCHS",
           "get_arch", "get_shape", "cell_is_skipped"]
