"""Step builders — the port of ``repro/runtime/steps.py``'s ``TrainStep`` /
``make_train_step`` and ``ServeStep`` / ``make_serve_step``, on one device.

**Train step** (``make_train_step(run, device=)``): microbatches (the
batch arrives pre-split ``[micro, B/micro, ...]``, as the reference's,
every input of ``input_specs`` so: a microbatch takes its slice of each)
whose
gradients are accumulated in float32 (with one microbatch they stay in the
parameter dtype), then the EF-int8 compression hook when
``run.optimizer.compress_grads``, then ``optim.opt_update`` (global-norm
clip + AdamW or Adafactor). ``step(params, opt_state, ef, batch)``
returns ``(params, opt_state, ef, metrics)``. Stated deviations: there
are no shardings and no donation, so ``params`` are the model's own
parameter tensors (``init_state`` returns them) and the update writes
them, and the optimizer state, in place. The step is therefore also
given as its two halves: ``grads(params, batch) -> (loss, grads)``,
which writes nothing and may be retried, and ``apply(params, opt_state,
ef, grads)``, which writes and may not (``TrainLoop`` retries the first
and runs its poison policy between the two, where the reference retries
and discards a functional step). Not ported:
``_named``, ``_filter_axes``, ``_fix_divisibility`` and ``_apply_fsdp``
(mesh layout; FSDP over several cards is ROADMAP A6b).

**Serve step.** Stated deviation: the reference takes a ``RunConfig`` and a mesh, lowers
``jax.jit``s with explicit NamedShardings (parameters, cache, batch and
logits laid out over ``data`` / ``model``) and donates the cache to decode.
The port takes the two parts of the run it reads, the ``ModelConfig`` and
the ``ShapeConfig``, and runs both steps on one ``device`` (``None`` means
the CUDA card), the weights held by
``ServeStep.model`` (draw them with ``model.init_params(generator)``), and
decode updates the cache in place. Both steps take a batch of the inputs
``input_specs`` names (a VLM's ``prefix_embeds`` or an audio model's
``frame_embeds`` beside ``tokens``),
passed to the model as keywords as the reference passes them; each
refuses a batch that lacks one of them, holds one of another shape, or
holds any other input. ``capacity`` is the prefill cache's row
count (default the prompt length, as the reference's); give it room for
the tokens to decode with ``decode_write=True``. An SSM model's state
does not grow with length: it ignores both ``capacity`` and
``decode_write``. A hybrid model's Mamba states do not grow and always
advance; ``capacity`` and ``decode_write`` apply to its shared block's
KV caches.

Not ported: ``PIRStep`` (``steps.py:340``), whose role
``core.server.PIRServer`` plays.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.engine.backend import Device
from repro_torch.models import build_model, input_specs
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import Zamba2Model
from repro_torch.models.registry import InputSpec
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm import XLSTMModel
from repro_torch.optim import compression
from repro_torch.optim.optimizer import opt_init, opt_update

F32 = torch.float32


def _check_inputs(batch, structs) -> None:
    """Raise for a batch that is not the one ``structs`` names: an input
    it does not name (``NotImplementedError``: another family's, such as
    a VLM's ``prefix_embeds`` handed to an audio step), or one it names
    that is missing or of another shape (``ValueError``)."""
    extra = sorted(set(batch) - set(structs))
    if extra:
        raise NotImplementedError(
            f"step inputs {extra} are not this family's: the step takes "
            f"{sorted(structs)} and nothing else")
    for name, spec in structs.items():
        if name not in batch:
            raise ValueError(f"the batch lacks {name!r}; the step takes "
                             f"{sorted(structs)}")
        shape = tuple(np.shape(batch[name]))
        if shape != spec.shape:
            raise ValueError(f"{name} of shape {shape}; the step takes "
                             f"{spec.shape}")


class TrainStep(NamedTuple):
    step: Callable            # (params, opt_state, ef, batch) -> (...)
    grads: Callable           # (params, batch) -> (loss, grads)
    apply: Callable           # (params, opt_state, ef, grads) -> (...)
    init_state: Callable      # (generator) -> (params, opt_state, ef)
    model: Union[TransformerLM, EncDecLM, XLSTMModel, Zamba2Model]
    device: torch.device
    input_structs: Dict[str, InputSpec]


def make_train_step(run: RunConfig, *, device: Device = None) -> TrainStep:
    """The train step of ``run`` on ``device`` (``None`` means the CUDA
    card; no card raises). Its model is built with ``run.remat`` and
    records gradients; ``init_state(generator)`` draws its weights (a
    ``None`` generator keeps the weights already loaded) and returns
    ``(params, opt_state, ef)``: the model's parameters by name, the
    optimizer state and the error-feedback buffers (``None`` without
    compression). The loss is the model's own (``TransformerLM.loss``:
    with the MoE family its aux term and DeepSeek-V3's MTP head;
    ``EncDecLM.loss`` for audio, from the batch's ``frame_embeds``;
    ``XLSTMModel.loss`` for the SSM family and ``Zamba2Model.loss`` for
    the hybrid, from ``tokens`` alone); with
    microbatches each one is a pass of its own, whose MoE dispatch and
    aux loss see that microbatch alone, as the reference's scan."""
    model = build_model(run.model, device=device, remat=run.remat)
    model.requires_grad_(True)
    dev = model.device
    structs = input_specs(run.model, run.shape)
    n_micro = run.microbatches
    if n_micro > 1:         # the microbatch axis leads
        structs = {k: InputSpec((n_micro, s.shape[0] // n_micro)
                                + s.shape[1:], s.dtype)
                   for k, s in structs.items()}
    named = dict(model.named_parameters())
    names, plist = list(named), list(named.values())
    compress = run.optimizer.compress_grads

    def grads_of(inputs):
        if n_micro == 1:
            loss, _ = model.loss(**inputs)
            grads = torch.autograd.grad(loss, plist)
            return loss.detach(), dict(zip(names, grads))
        loss_acc = torch.zeros((), dtype=F32, device=dev)
        acc = {n: torch.zeros(p.shape, dtype=F32, device=dev)
               for n, p in named.items()}
        for i in range(n_micro):
            loss, _ = model.loss(**{k: v[i] for k, v in inputs.items()})
            grads = torch.autograd.grad(loss, plist)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    acc[n].add_(g / n_micro)
                loss_acc += loss.detach() / n_micro
            del grads
        return loss_acc, acc

    def grads(params, batch):
        """The loss and the gradients at ``params``; writes nothing."""
        if params.keys() != named.keys() or any(
                params[n] is not p for n, p in named.items()):
            raise ValueError("params must be the train step's own model "
                             "parameters (as init_state returns them)")
        _check_inputs(batch, structs)
        return grads_of({name: torch.as_tensor(batch[name], device=dev)
                         for name in structs})

    def apply(params, opt_state, ef, grads):
        """The update, params and opt_state written in place: (params,
        opt_state, ef, {"lr", "grad_norm"})."""
        if compress:
            # the EF-int8 hook: the numerical twin of the reference's
            # compressed cross-pod all-reduce
            q, s, ef = compression.compress_with_feedback(grads, ef)
            grads = {n: compression.dequantize(q[n], s[n]) for n in q}
        params, opt_state, om = opt_update(run.optimizer, grads, opt_state,
                                           params)
        return params, opt_state, ef, om

    def step(params, opt_state, ef, batch):
        loss, g = grads(params, batch)
        params, opt_state, ef, om = apply(params, opt_state, ef, g)
        return params, opt_state, ef, {"loss": loss, **om}

    def init_state(generator: Optional[torch.Generator] = None):
        if generator is not None:
            model.init_params(generator)
        opt_state = opt_init(run.optimizer, named)
        ef = compression.ef_init(named) if compress else None
        return named, opt_state, ef

    return TrainStep(step=step, grads=grads, apply=apply,
                     init_state=init_state, model=model,
                     device=dev, input_structs=structs)


class ServeStep(NamedTuple):
    prefill: Callable          # batch {"tokens": [B, S]} -> (logits, cache)
    decode: Callable           # (cache, tokens [B, 1]) -> (logits, cache')
    model: Union[TransformerLM, EncDecLM, XLSTMModel, Zamba2Model]
    device: torch.device
    input_structs: Dict[str, InputSpec]


def make_serve_step(model_cfg: ModelConfig, shape: ShapeConfig, *,
                    device: Device = None, decode_write: bool = False,
                    capacity: Optional[int] = None) -> ServeStep:
    model = build_model(model_cfg, device=device)
    structs = input_specs(model_cfg, shape)

    def prefill(batch):
        _check_inputs(batch, structs)
        return model.prefill(capacity=capacity, **batch)

    def decode(cache, tokens):
        return model.decode(cache, tokens, write=decode_write)

    return ServeStep(prefill=prefill, decode=decode, model=model,
                     device=model.device, input_structs=structs)
