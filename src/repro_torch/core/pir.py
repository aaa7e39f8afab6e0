"""Client + reference-server PIR primitives (port of ``repro/core/pir.py``).

Client:  ``query_gen`` (key generation through the protocol registry) and
         ``reconstruct_xor`` (r1 XOR r2, Algorithm 1 ⑦).
Server:  ``dpxor`` — the plain select-XOR scan the ``torch`` plans use;
         the served form runs through ``core/protocol.py`` and the kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core import dpf
from repro_torch.kernels.dpxor import dpxor_plain, xor_fold

__all__ = ["Query", "dpxor", "make_database", "query_gen",
           "reconstruct_xor", "xor_fold"]


def make_database(rng: np.random.Generator, n_items: int,
                  item_bytes: int = 32) -> np.ndarray:
    """Random DB of ``n_items`` records of ``item_bytes`` bytes, as
    ``[N, item_bytes // 4]`` uint32 words on the host — the same draw as
    the reference (``pir.py:55``), so one seed gives one database."""
    if item_bytes % 4:
        raise ValueError("item_bytes must be a multiple of 4")
    return rng.integers(0, 1 << 32, size=(n_items, item_bytes // 4),
                        dtype=np.uint32)


@dataclass
class Query:
    """A client query: one key per party."""
    index: int
    keys: Tuple[dpf.DPFKey, ...]


def query_gen(rng: np.random.Generator, index: int, cfg: PIRConfig) -> Query:
    """GENERATEANDSENDKEYS (Algorithm 1 ①-②) via the config's protocol."""
    from repro_torch.core import protocol as protocol_mod
    proto = protocol_mod.for_config(cfg)
    return Query(index=index, keys=proto.query_gen(rng, index, cfg))


def reconstruct_xor(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """D[i] = r1 XOR r2 (Algorithm 1, client ⑦)."""
    return r0 ^ r1


def dpxor(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Select-XOR scan r = XOR of D[j] with bits[j] != 0 (Algorithm 1 ④-⑤).

    ``bits`` is ``[R]`` or ``[Q, R]`` of 0/1; returns ``[W]`` or ``[Q, W]``.
    The dpXOR kernel's plain version (``kernels/dpxor.dpxor_plain``).
    """
    if bits.dim() == 1:
        return dpxor_plain(db_words, bits[None])[0]
    return dpxor_plain(db_words, bits)
