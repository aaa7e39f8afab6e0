"""Client + reference-server PIR primitives (port of ``repro/core/pir.py``).

Client:  ``query_gen`` (key generation through the protocol registry),
         ``batch_queries`` (one stacked key batch per party),
         ``reconstruct_xor`` (r1 XOR r2, Algorithm 1 ⑦) and
         ``reconstruct_additive`` ((r1 + r2) mod 256).
Server:  ``dpxor`` — the plain select-XOR scan — and
         ``answer_additive_matmul`` — the plain int8 GEMM — that the
         ``torch`` plans use; the reference's single-shard answer paths
         ``answer_xor`` / ``answer_xor_batch`` (Eval, then one dpXOR launch)
         and ``answer_additive_batch`` (Z_256 shares, then one int8 GEMM
         launch), and the paper's Table 1 phase split, ``phase_eval_bits``
         and ``phase_dpxor``. These follow the database's device: a CUDA
         tensor launches the kernel through ``kernels/ops.py``, a CPU
         tensor takes its plain version. The served form runs through
         ``core/protocol.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core import dpf
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.db.spec import row_checksum
from repro_torch.kernels.dpxor import dpxor_plain, xor_fold
from repro_torch.kernels.pir_matmul import pir_gemm_plain

__all__ = ["Query", "answer_additive_batch", "answer_additive_matmul",
           "answer_xor", "answer_xor_batch", "batch_queries", "db_as_bytes",
           "dpxor", "make_database", "phase_dpxor", "phase_eval_bits",
           "query_gen", "reconstruct_additive", "reconstruct_xor",
           "xor_fold"]


def make_database(rng: np.random.Generator, n_items: int,
                  item_bytes: int = 32, *, checksum: bool = False
                  ) -> np.ndarray:
    """Random DB of ``n_items`` records of ``item_bytes`` bytes, as
    ``[N, item_bytes // 4]`` uint32 words on the host — the same draw as
    the reference (``pir.py:42``), so one seed gives one database.
    ``checksum=True`` appends the verified-reconstruction column (one u32
    ``row_checksum`` per row): the stored layout a checksummed config
    serves, for oracles that build answers at the stored width."""
    if item_bytes % 4:
        raise ValueError("item_bytes must be a multiple of 4")
    words = rng.integers(0, 1 << 32, size=(n_items, item_bytes // 4),
                         dtype=np.uint32)
    if checksum:
        words = np.concatenate([words, row_checksum(words)[:, None]], axis=1)
    return words


def db_as_bytes(db_words: np.ndarray) -> np.ndarray:
    """``[N, W]`` uint32 -> ``[N, 4W]`` uint8 on the host (little-endian),
    as ``pir.py:64-73`` upstream. A parity helper for the tests' oracles:
    served code reads the device-resident ``Database.view("bytes")``."""
    return np_words_to_bytes(np.asarray(db_words))


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


def batch_queries(rng: np.random.Generator, indices: Sequence[int],
                  cfg: PIRConfig) -> Tuple[dpf.DPFKey, ...]:
    """One stacked key batch per party for ``indices`` (``pir.py:102``
    upstream): the same rng draws, and so the same keys, as one
    ``query_gen`` per index in order."""
    from repro_torch.core import protocol as protocol_mod
    return protocol_mod.for_config(cfg).query_gen_batch(
        rng, [int(i) for i in indices], cfg)


def reconstruct_xor(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """D[i] = r1 XOR r2 (Algorithm 1, client ⑦)."""
    return r0 ^ r1


def reconstruct_additive(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """D[i] bytes = (r0 + r1) mod 256 of the int32 partial sums, uint8."""
    return ((r0.to(torch.int32) + r1.to(torch.int32)) % 256).to(torch.uint8)


def answer_additive_matmul(db_bytes_i8: torch.Tensor,
                           shares_u8: torch.Tensor) -> torch.Tensor:
    """Batched additive answers as one int8 GEMM (``pir.py:157-169``).

    ``shares_u8 [Q, N]`` Z_256 shares, ``db_bytes_i8 [N, L]`` the int8 byte
    view -> ``[Q, L]`` int32 partial results, wrapping as XLA's int32 dot
    does; only their value mod 256 matters. The pir_gemm kernel's plain
    version (``kernels/pir_matmul.pir_gemm_plain``).
    """
    return pir_gemm_plain(shares_u8, db_bytes_i8)


def dpxor(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Select-XOR scan r = XOR of D[j] with bits[j] != 0 (Algorithm 1 ④-⑤).

    ``bits`` is ``[R]`` or ``[Q, R]`` of 0/1; returns ``[W]`` or ``[Q, W]``.
    The dpXOR kernel's plain version (``kernels/dpxor.dpxor_plain``).
    """
    if bits.dim() == 1:
        return dpxor_plain(db_words, bits[None])[0]
    return dpxor_plain(db_words, bits)


# ---------------------------------------------------------------------------
# Reference answer paths (one shard, the whole database)
# ---------------------------------------------------------------------------

def _one_query(key: dpf.DPFKey) -> dpf.DPFKey:
    """An unbatched key, or a batch of one, as a batch of one."""
    if key.root_seed.dim() == 1:
        return dpf.map_keys(key, lambda x: x[None])
    if dpf.n_queries_of(key) != 1:
        raise ValueError(f"one query expected, got a batch of "
                         f"{dpf.n_queries_of(key)}")
    return key


def answer_xor(db_words: torch.Tensor, key: dpf.DPFKey) -> torch.Tensor:
    """One query's answer share ``[W]``: Eval, then dpXOR (``pir.py:144``
    upstream). ``key`` is unbatched or a batch of one."""
    return answer_xor_batch(db_words, _one_query(key))[0]


def answer_xor_batch(db_words: torch.Tensor, keys: dpf.DPFKey
                     ) -> torch.Tensor:
    """``[Q, W]`` answer shares of a key batch (``pir.py:152``): every
    query's selection bits, then one dpXOR launch for all Q. A database of
    N rows takes the first N of the ``2^ceil(log2 N)`` leaves."""
    n = db_words.shape[0]
    keys = keys.to(db_words.device)
    bits = phase_eval_bits(keys, (n - 1).bit_length())
    return phase_dpxor(db_words, bits[:, :n])


def answer_additive_batch(db_bytes_i8: torch.Tensor, keys: dpf.DPFKey
                          ) -> torch.Tensor:
    """``[Q, L]`` int32 partial sums of a key batch (``pir.py:172``): the
    Z_256 shares of the first N leaves, then one int8 GEMM launch. They
    wrap mod 2^32 as the reference's int32 dot does; only their value mod
    256 matters."""
    from repro_torch.kernels import ops
    n = db_bytes_i8.shape[0]
    keys = keys.to(db_bytes_i8.device)
    shares = dpf.eval_bytes_batch(keys, 0, (n - 1).bit_length())
    return ops.pir_gemm(shares[:, :n].contiguous(), db_bytes_i8)


def phase_eval_bits(keys: dpf.DPFKey, log_n: int) -> torch.Tensor:
    """Phase ② of the paper's Table 1: DPF evaluation alone, the
    ``[Q, 2^log_n]`` selection bits written out (``pir.py:186``)."""
    return dpf.eval_bits_batch(keys, 0, log_n)


def phase_dpxor(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Phases ④-⑤: dpXOR alone over precomputed ``[Q, N]`` selection bits,
    one launch for all Q (``pir.py:192``)."""
    from repro_torch.kernels import ops
    return ops.dpxor(db_words, bits.contiguous())
