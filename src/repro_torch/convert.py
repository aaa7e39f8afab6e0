"""Carry state from the reference into the port.

Tests feed identical inputs to both packages: the reference's keys
(``cw_final`` included, for the additive scheme) and database leave JAX
as numpy ``uint32`` arrays, and its byte view as ``int8``; these functions
turn them into the port's tensors with the same bits. A model's parameter
tree leaves as numpy (bf16 as ``ml_dtypes.bfloat16``) and becomes the
port's module state; an optimizer state (``AdamWState`` /
``AdafactorState``, numpy leaves) becomes the port's, laid out as
``optim/optimizer.py`` keeps it. Nothing here imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dpf import DPFKey
from repro_torch.crypto.packing import words_to_tensor


def keys_from_reference(*, party: int, log_n: int, root_seed: np.ndarray,
                        cw_seed: np.ndarray, cw_t: np.ndarray,
                        cw_final: Optional[np.ndarray] = None,
                        rounds: int = 12) -> DPFKey:
    """A port key (on the CPU) from numpy copies of a reference
    ``DPFKey``'s fields (batched or not: leading axes are kept)."""
    conv = lambda a: words_to_tensor(np.asarray(a, np.uint32))
    return DPFKey(party=int(party), log_n=int(log_n),
                  root_seed=conv(root_seed), cw_seed=conv(cw_seed),
                  cw_t=conv(cw_t),
                  cw_final=None if cw_final is None else conv(cw_final),
                  rounds=int(rounds))


def database_from_reference(db_words: np.ndarray) -> torch.Tensor:
    """The reference's ``[N, W]`` uint32 database as the port's int32
    words tensor (on the CPU)."""
    return words_to_tensor(np.asarray(db_words, np.uint32))


def bytes_from_reference(db_bytes: np.ndarray) -> torch.Tensor:
    """The reference's int8 byte view (``words_to_bytes_i8``, ``[N, L]``)
    or uint8 shares as the port's tensor of the same dtype (on the CPU)."""
    arr = np.ascontiguousarray(db_bytes)
    if arr.dtype not in (np.int8, np.uint8):
        raise TypeError(f"expected int8 or uint8 bytes, got {arr.dtype}")
    return torch.from_numpy(arr.copy())


def tensor_from_reference(arr) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor with the same bits;
    bf16 (numpy's ``bfloat16`` extension dtype) is carried through int16."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


#: the reference's layer stacks (``[L, ...]`` leaves) -> the port's
#: ``nn.ModuleList`` names
_STACKS = {"dense_layers": "layers", "moe_layers": "moe_layers",
           "enc_layers": "enc_layers", "dec_layers": "dec_layers",
           "mamba_layers": "mamba_layers"}


def model_params_from_reference(params_np: Mapping, cfg
                                ) -> Dict[str, torch.Tensor]:
    """A reference model's parameter tree as the port model's state dict
    (``load_state_dict``), same bits, on the CPU. Each layer stack,
    stacked ``[L, ...]`` by ``vmap``, is unstacked onto the port's
    modules: ``TransformerLM``'s ``dense_layers[i]`` -> ``layers.{i}.*``
    and ``moe_layers[j]`` -> ``moe_layers.{j}.*`` (the experts kept ``[E,
    d, f]``, the shared ones under ``ffn.shared``), ``EncDecLM``'s
    ``enc_layers[i]`` -> ``enc_layers.{i}.*`` and ``dec_layers[i]`` ->
    ``dec_layers.{i}.*``, ``Zamba2Model``'s ``mamba_layers[i]`` ->
    ``mamba_layers.{i}.*``. Every other leaf keeps its path, dotted:
    ``embed``, ``final_norm``, ``unembed``, ``mtp.*``, ``pos_dec``,
    ``enc_norm.scale``, the hybrid's ``shared.attn.wq``, and an item of
    a list by its index (``XLSTMModel``'s ``blocks[i]/mix/w_in`` ->
    ``blocks.{i}.mix.w_in``).
    ``cfg`` is the model's config (unused: the tree names every leaf)."""
    t = tensor_from_reference
    state = {}
    for key, tree in params_np.items():
        if key not in _STACKS:
            for path, arr in leaf_paths({key: tree}):
                state[path.replace("/", ".")] = t(arr)
            continue
        for path, arr in leaf_paths(tree):
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                state[f"{_STACKS[key]}.{i}.{path.replace('/', '.')}"] = \
                    t(arr[i])
    return state


def leaf_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``a/b/c`` path, leaf) of a nested mapping, a list's items named by
    their index (``blocks/0/mix/w_in``); ``()`` leaves (the reference's
    empty subtrees) come out as ``None``."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list)):
            yield from leaf_paths(v, path)
        else:
            yield path, (None if isinstance(v, tuple) and not v else v)


def opt_state_from_reference(state, cfg):
    """A reference optimizer state with numpy leaves (``AdamWState(step,
    m, v, master)`` or ``AdafactorState(step, vr, vc, v)``, by field
    names) as the port's, on the CPU: AdamW's trees unstacked to the
    port's parameter names, Adafactor's kept stacked per leaf path
    (``dense_layers/attn/wq``, ``moe_layers/ffn/gate``, ``mtp/proj``,
    ``enc_layers/attn/wq``, ``dec_layers/cross_attn/wk``,
    ``blocks/0/mix/w_in``, ``mamba_layers/mix/a_log``, ``shared/mlp/up``;
    ``None`` for ``()``): the keys of
    ``optimizer.leaf_groups``."""
    from repro_torch.optim.optimizer import AdafactorState, AdamWState
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32)
    if hasattr(state, "master"):
        return AdamWState(
            step=step, m=model_params_from_reference(state.m, cfg),
            v=model_params_from_reference(state.v, cfg),
            master=model_params_from_reference(state.master, cfg))
    conv = lambda tree: {
        k: None if a is None else tensor_from_reference(a)
        for k, a in leaf_paths(tree)}
    return AdafactorState(step=step, vr=conv(state.vr), vc=conv(state.vc),
                          v=conv(state.v))
