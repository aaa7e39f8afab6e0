"""Optimizers: AdamW and Adafactor as plain functions on tensors — the
port of ``repro/optim/optimizer.py``.

Parameters, gradients and AdamW's moments are dicts of tensors keyed by
the model's parameter names (``TransformerLM.named_parameters()``:
``embed``, ``layers.{i}.attn.wq``, ``moe_layers.{j}.ffn.gate``, ...).
State is float32 on the parameters' device. ``opt_update`` writes the new
parameters into the given tensors and updates the state's tensors in
place (the reference donates both to its jitted step); it returns the
dict it was given.

**Leaves.** The reference stacks each layer parameter of a layer stack
into one ``[L, ...]`` leaf; the port keeps one tensor per layer.
``leaf_groups`` maps the port's names onto the reference's leaves: the
dense stack ``layers.{i}.<path>`` onto ``dense_layers/<path>``, the MoE
trunk ``moe_layers.{j}.<path>`` onto ``moe_layers/<path>`` (an expert
weight ``[E, d, f]`` a layer onto ``[L, E, d, f]``), the
encoder-decoder's ``enc_layers.{i}.<path>`` and
``dec_layers.{i}.<path>`` onto ``enc_layers/<path>`` and
``dec_layers/<path>``, the hybrid's ``mamba_layers.{i}.<path>`` onto
``mamba_layers/<path>`` (its float32 ``a_log`` ``[H]`` a layer onto ``[L,
H]``, which Adafactor factors as the reference does), and every other
parameter (``embed``, ``pos_dec``, ``enc_norm.scale``, ``mtp.proj``,
``mtp.layer.attn.wq``, the hybrid's one ``shared.attn.wq``,
the xLSTM's unstacked ``blocks.{i}.mix.w_in``, which the reference keeps
in a list: ``blocks/{i}/mix/w_in``) onto its own unstacked leaf. Every statistic the reference takes over a
whole leaf is taken over that group: Adafactor factors the stacked
tensor over its last two axes (a norm scale ``[L, d]`` into ``vr [L]``
and ``vc [d]``, an expert weight into ``vr [L, E, d]`` and ``vc [L, E,
f]``) and clips its update by the rms over the whole leaf (all L layers,
all L·E experts); the gradient compression's int8 scale is the max over
the group (``compression.py``). AdamW is elementwise, apart from the
global norm, and keeps one moment tensor per parameter; Adafactor's
``vr`` / ``vc`` / ``v`` are keyed by leaf, stacked as the reference's
(``None`` where the reference holds ``()``).

**Adafactor one slice at a time.** A factored leaf's moments and
preconditioner at one index of its leading axes (all but the last two:
one layer's weight, one expert of one layer) depend on that slice alone;
only the rms clip spans the leaf. So ``adafactor_update`` takes a leaf in
two passes over its slices: the first updates ``vr`` / ``vc`` and sums
the squared preconditioned update, the second recomputes each slice's
update and writes its parameters. Its float32 temporaries are one
slice's (0.8 GB for an expert of grok-1, where its whole leaf at one
layer is 6.4 GB a copy). The sum over slices orders the rms's additions
otherwise than one mean over the leaf: the same value to float32
rounding.

Schedules, bias corrections and Adafactor's decay are float32 tensor
computations on the device, as in the reference. Not ported:
``spec_for_state`` (state PartitionSpecs: mesh layout, no one-card
counterpart).
"""
from __future__ import annotations

import itertools
import math
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig

F32 = torch.float32

Tensors = Dict[str, torch.Tensor]

#: the port's layer stacks -> the reference's stacked leaves
#: (``TransformerLM``'s, ``EncDecLM``'s and ``Zamba2Model``'s)
STACKS = {"layers": "dense_layers", "moe_layers": "moe_layers",
          "enc_layers": "enc_layers", "dec_layers": "dec_layers",
          "mamba_layers": "mamba_layers"}

_LAYER = re.compile(rf"({'|'.join(STACKS)})\.(\d+)\.(.+)")

# Adafactor's floor under the squared gradient and the moments
_EPS = 1e-30


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
    """The reference's leaf path (``dense_layers/attn/wq``,
    ``moe_layers/ffn/gate``, ``embed``, ``mtp/proj``) -> the port's
    parameter names that make it up, each stack's layers in order."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.fullmatch(name)
        if m:
            key = f"{STACKS[m.group(1)]}/{m.group(3).replace('.', '/')}"
            groups.setdefault(key, []).append((int(m.group(2)), name))
        else:
            groups.setdefault(name.replace(".", "/"), []).append((0, name))
    return {k: [n for _, n in sorted(v)] for k, v in groups.items()}


def is_stacked(key: str) -> bool:
    """Whether the reference's leaf ``key`` stacks a layer parameter on a
    leading ``[L, ...]`` axis."""
    return key.split("/", 1)[0] in STACKS.values()


def stack_leaf(tensors: Tensors, key: str, names: List[str]) -> torch.Tensor:
    """The reference's leaf ``key`` built from the port's tensors: the
    layers stacked on a leading axis, any other leaf as it is."""
    if is_stacked(key):
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


def _leaf_shape(key: str, names: List[str], tensors: Tensors) -> tuple:
    shape = tuple(tensors[names[0]].shape)
    return (len(names),) + shape if is_stacked(key) else shape


def _slice(tensors: Tensors, key: str, names: List[str], idx: tuple
           ) -> torch.Tensor:
    """The leaf's slice at ``idx``, an index of its leading axes (all but
    the last two): a view of one layer's tensor, or for ``idx == ()`` the
    whole leaf (``stack_leaf``)."""
    if not idx:
        return stack_leaf(tensors, key, names)
    if is_stacked(key):
        return tensors[names[idx[0]]][idx[1:]]
    return tensors[names[0]][idx]


def _write(tensors: Tensors, key: str, names: List[str], idx: tuple,
           value: torch.Tensor) -> None:
    """Write ``value`` into the leaf's slice at ``idx`` (in place; cast to
    the tensors' dtype)."""
    if not idx and is_stacked(key):
        for n, v in zip(names, value):
            tensors[n].copy_(v)
    else:
        _slice(tensors, key, names, idx).copy_(value)


def _precond(state: AdafactorState, key: str, idx: tuple, g: torch.Tensor,
             scale: torch.Tensor, decay: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """The preconditioned update of the leaf's slice at ``idx`` from its
    gradient ``g`` (clipped by ``scale``, in its dtype, as the reference
    clips); with ``decay``, the slice's squared gradient is first folded
    into the second moments (in place)."""
    gf = _clipped(g, scale).to(F32)
    v = state.v[key]
    if v is not None:                   # rank 1: the full second moment
        if decay is not None:
            v.copy_(decay * v + (1 - decay) * (gf * gf + _EPS))
        return gf / (torch.sqrt(v) + 1e-9)
    vr, vc = state.vr[key][idx], state.vc[key][idx]
    if decay is not None:
        g2 = gf * gf + _EPS
        vr.copy_(decay * vr + (1 - decay) * torch.mean(g2, dim=-1))
        vc.copy_(decay * vc + (1 - decay) * torch.mean(g2, dim=-2))
        del g2
    row = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=_EPS)
    return gf / (torch.sqrt(row)[..., None] * torch.sqrt(vc)[..., None, :]
                 + 1e-9)


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
    for key, names in leaf_groups(params).items():
        shape = _leaf_shape(key, names, params)
        index = list(itertools.product(*map(range, shape[:-2])))
        # pass 1: the moments, and the squared update summed over the leaf
        sq = torch.zeros((), dtype=F32, device=gnorm.device)
        for idx in index:
            sq += torch.sum(torch.square(_precond(
                state, key, idx, _slice(grads, key, names, idx), scale,
                decay)))
        # relative update clipping (Adafactor's d = 1.0), over the leaf
        rms = torch.sqrt(sq / math.prod(shape) + _EPS)
        clip = torch.clamp(rms, min=1.0)
        # pass 2: each slice's update again, clipped, into the parameters
        for idx in index:
            precond = _precond(state, key, idx,
                               _slice(grads, key, names, idx), scale) / clip
            pf = _slice(params, key, names, idx).to(F32)
            _write(params, key, names, idx,
                   pf - lr * precond - lr * cfg.weight_decay * pf)
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
