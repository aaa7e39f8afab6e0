"""int8 gradient compression with error feedback — the port of
``repro/optim/compression.py``.

Each leaf's gradient (plus the carried residual) is quantized to int8 at
the scale max|g| / 127, and the quantization residual is carried to the
next step (EF-SGD). A leaf is the reference's (``optimizer.leaf_groups``):
a layer parameter's scale is the max over all L layers of its stack, the
dense ``layers.{i}`` (``dense_layers/``) or the MoE trunk's
``moe_layers.{j}`` (``moe_layers/``: an expert weight's over all L·E
experts), so the port's per-layer tensors quantize exactly as the
reference's stacked leaf. The
returned scales are keyed by parameter name (a leaf's members share its
0-d scale), so ``dequantize(q[name], scales[name])`` holds per tensor.

Not ported: ``compressed_psum``, the int8 all-reduce over a mesh axis
(several cards: ROADMAP A6b); the reference's train step does not call it
either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim.optimizer import Tensors, leaf_groups

F32 = torch.float32


def ef_init(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def _scale(maxabs: torch.Tensor) -> torch.Tensor:
    return maxabs / 127.0 + 1e-12


def _quantize_at(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> (int8, scale). scale = maxabs / 127."""
    gf = g.to(F32)
    scale = _scale(torch.max(torch.abs(gf)))
    return _quantize_at(gf, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


@torch.no_grad()
def compress_with_feedback(grads: Tensors, ef_state: Tensors
                           ) -> Tuple[Tensors, Dict[str, torch.Tensor],
                                      Tensors]:
    """Returns (int8 tensors, scales, new ef_state), each keyed by
    parameter name; one scale per leaf of the reference."""
    q, scales, new_ef = {}, {}, {}
    for names in leaf_groups(grads).values():
        gf = {n: grads[n].to(F32) + ef_state[n] for n in names}
        scale = _scale(torch.stack([torch.max(torch.abs(gf[n]))
                                    for n in names]).max())
        for n in names:
            q[n] = _quantize_at(gf[n], scale)
            scales[n] = scale
            new_ef[n] = gf[n] - dequantize(q[n], scale)
    return q, scales, new_ef
