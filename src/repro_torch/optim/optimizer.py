"""Optimizers: AdamW and Adafactor as plain functions on tensors — the
port of ``repro/optim/optimizer.py``.

Parameters, gradients and AdamW's moments are dicts of tensors keyed by
the model's parameter names (``TransformerLM.named_parameters()``:
``embed``, ``layers.{i}.attn.wq``, ...). State is float32 on the
parameters' device. ``opt_update`` writes the new parameters into the
given tensors and updates the state's tensors in place (the reference
donates both to its jitted step); it returns the dict it was given.

**Leaves.** The reference stacks each layer parameter of the L layers
into one ``[L, ...]`` leaf; the port keeps one tensor per layer.
``leaf_groups`` maps the port's names onto the reference's leaves
(``layers.{i}.attn.wq`` for every i is the leaf ``dense_layers/attn/wq``),
and every statistic the reference takes over a whole leaf is taken over
that group: Adafactor factors the stacked ``[L, ...]`` tensor (a norm
scale ``[L, d]`` into ``vr [L]`` and ``vc [d]``, a weight ``[L, din,
dout]`` per layer) and clips its update by the rms over all L layers; the
gradient compression's int8 scale is the max over the group
(``compression.py``). AdamW is elementwise, apart from the global norm,
and keeps one moment tensor per parameter; Adafactor's ``vr`` / ``vc`` /
``v`` are keyed by leaf, stacked as the reference's (``None`` where the
reference holds ``()``).

Schedules, bias corrections and Adafactor's decay are float32 tensor
computations on the device, as in the reference. Not ported:
``spec_for_state`` (state PartitionSpecs: mesh layout, no one-card
counterpart).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig

F32 = torch.float32

Tensors = Dict[str, torch.Tensor]

#: the reference's leaf of the stacked dense layers
STACKED = "dense_layers/"

_LAYER = re.compile(r"layers\.(\d+)\.(.+)")


class AdamWState(NamedTuple):
    step: torch.Tensor        # [] int32
    m: Tensors
    v: Tensors
    master: Tensors           # float32 master weights


class AdafactorState(NamedTuple):
    step: torch.Tensor        # [] int32
    vr: Dict[str, Optional[torch.Tensor]]   # row second moment, by leaf
    vc: Dict[str, Optional[torch.Tensor]]   # column second moment, by leaf
    v: Dict[str, Optional[torch.Tensor]]    # full second moment, rank < 2


def leaf_groups(names: Iterable[str]) -> Dict[str, List[str]]:
    """The reference's leaf path (``dense_layers/attn/wq``, ``embed``) ->
    the port's parameter names that make it up, layers in order."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.fullmatch(name)
        if m:
            key = STACKED + m.group(2).replace(".", "/")
            groups.setdefault(key, []).append((int(m.group(1)), name))
        else:
            groups.setdefault(name.replace(".", "/"), []).append((0, name))
    return {k: [n for _, n in sorted(v)] for k, v in groups.items()}


def stack_leaf(tensors: Tensors, key: str, names: List[str]) -> torch.Tensor:
    """The reference's leaf ``key`` built from the port's tensors: the
    layers stacked on a leading axis, any other leaf as it is."""
    if key.startswith(STACKED):
        return torch.stack([tensors[n] for n in names])
    return tensors[names[0]]


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% (float32, on step's device)."""
    s = step.to(F32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in grads.values()))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(F32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global norm), in float32
    and back to its dtype. Returns (clipped, global norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: _clipped(g, scale) for k, g in grads.items()}, gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _step0(params: Tensors) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@torch.no_grad()
def adamw_init(params: Tensors) -> AdamWState:
    return AdamWState(
        step=_step0(params),
        m={k: torch.zeros(p.shape, dtype=F32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=F32, device=p.device)
           for k, p in params.items()},
        master={k: p.detach().to(F32, copy=True) for k, p in params.items()})


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Tensors, state: AdamWState,
                 params: Tensors) -> Tuple[Tensors, AdamWState, dict]:
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(F32))
    bc2 = 1.0 - torch.pow(b2, step.to(F32))
    for k, p in params.items():
        gf = _clipped(grads[k], scale).to(F32)
        m, v, master = state.m[k], state.v[k], state.master[k]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master.copy_(master - lr * (update + cfg.weight_decay * master))
        p.copy_(master)
    return params, state._replace(step=step), {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum, no master copy)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2


def _leaf_shape(key: str, names: List[str], params: Tensors):
    shape = tuple(params[names[0]].shape)
    return (len(names),) + shape if key.startswith(STACKED) else shape


@torch.no_grad()
def adafactor_init(params: Tensors) -> AdafactorState:
    vr, vc, v = {}, {}, {}
    dev = next(iter(params.values())).device
    zeros = lambda shape: torch.zeros(shape, dtype=F32, device=dev)
    for key, names in leaf_groups(params).items():
        shape = _leaf_shape(key, names, params)
        factored = _factored(shape)
        vr[key] = zeros(shape[:-1]) if factored else None
        vc[key] = zeros(shape[:-2] + shape[-1:]) if factored else None
        v[key] = None if factored else zeros(shape)
    return AdafactorState(step=_step0(params), vr=vr, vc=vc, v=v)


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads: Tensors,
                     state: AdafactorState, params: Tensors
                     ) -> Tuple[Tensors, AdafactorState, dict]:
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step.to(F32) + 1.0) ** -0.8
    eps = 1e-30
    for key, names in leaf_groups(params).items():
        gf = stack_leaf({n: _clipped(grads[n], scale) for n in names}, key,
                        names).to(F32)
        g2 = gf * gf + eps
        if _factored(gf.shape):
            vr, vc = state.vr[key], state.vc[key]
            vr.copy_(decay * vr + (1 - decay) * torch.mean(g2, dim=-1))
            vc.copy_(decay * vc + (1 - decay) * torch.mean(g2, dim=-2))
            row = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                   min=eps)
            precond = gf / (torch.sqrt(row)[..., None]
                            * torch.sqrt(vc)[..., None, :] + 1e-9)
        else:
            v = state.v[key]
            v.copy_(decay * v + (1 - decay) * g2)
            precond = gf / (torch.sqrt(v) + 1e-9)
        # relative update clipping (Adafactor's d = 1.0), over the leaf
        rms = torch.sqrt(torch.mean(precond * precond) + eps)
        precond = precond / torch.clamp(rms, min=1.0)
        pf = stack_leaf(params, key, names).to(F32)
        p_new = pf - lr * precond - lr * cfg.weight_decay * pf
        if key.startswith(STACKED):
            for i, n in enumerate(names):
                params[n].copy_(p_new[i])
        else:
            params[names[0]].copy_(p_new)
    return params, state._replace(step=step), {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Uniform facade
# ---------------------------------------------------------------------------

def opt_init(cfg: OptimizerConfig, params: Tensors):
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def opt_update(cfg: OptimizerConfig, grads: Tensors, state,
               params: Tensors):
    """One update: (params, state, {"lr", "grad_norm"}), the parameters'
    tensors written in place."""
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, state, params)
    return adafactor_update(cfg, grads, state, params)
