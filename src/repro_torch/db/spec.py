"""``DatabaseSpec``: shape math for one PIR database (``repro/db/spec.py``).

Three views are served: ``words`` (u32 words, the XOR scans' operand),
``bytes`` (int8 bytes, little-endian, the additive GEMM's operand) and
``bytes32`` (the same byte values widened to int32, the LWE GEMM's
operand). A view name is protocol metadata (``PIRProtocol.db_view``).
``DatabaseSpec`` is the one place a view is derived from word rows: on
their device (``words_to_view_device``: ``bytes`` an alias of the words'
storage, ``bytes32`` a widened copy), on the host (``pack_host``) and on
the meta device for the dry run (``view_struct``).

Verified reconstruction adds an optional per-row checksum column: with
``checksum=True`` every stored record carries one more u32 word
(``row_checksum`` of its payload words) after the payload, so all three
views widen by 4 bytes per record while ``item_bytes`` stays the logical
payload width the client sees. ``verify_records`` checks and strips that
column at reconstruction and raises :class:`IntegrityError` on a mismatch.
The checksum guards against corruption (a flipped answer share, bit rot);
it is not a MAC, and a server that knows the scheme can forge it. The
host functions are numpy copies of the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.crypto.packing import (np_bytes_to_words, np_words_to_bytes,
                                        words_to_bytes_i32)

#: registered database views: name -> dtype of its ``[N, cols]`` tensor
VIEWS = {
    "words": np.dtype(np.uint32),   # [N, stored_words] — XOR schemes
    "bytes": np.dtype(np.int8),     # [N, stored_bytes] — additive GEMM
    "bytes32": np.dtype(np.int32),  # [N, stored_bytes] — LWE GEMM
    # bytes32 holds the byte values 0..255 widened to int32: the LWE
    # contraction is mod-2^32 arithmetic, and the int8 view's negatives
    # (byte >= 128 -> byte - 256) would shift it by 256·k, not 0 mod q.
}

#: the torch dtype each view's device tensor has (u32 words in int32)
TORCH_VIEWS = {"words": torch.int32, "bytes": torch.int8,
               "bytes32": torch.int32}


class IntegrityError(RuntimeError):
    """A reconstructed record failed verification.

    Raised instead of returning a silently wrong record: when the stored
    per-row checksum disagrees with the reconstructed payload (a corrupted
    answer share) or, for the LWE scheme, when the recovered noise exceeds
    the validated bound (answers that do not match the hint or epoch).
    ``bad_queries`` holds the batch indices of the offending queries, so
    that a router can resubmit exactly those.
    """

    def __init__(self, msg: str, bad_queries=()):
        super().__init__(msg)
        self.bad_queries = tuple(int(i) for i in bad_queries)


def row_checksum(words: np.ndarray) -> np.ndarray:
    """Per-row u32 mixing checksum over payload words: ``[..., W] -> [...]``.

    A murmur3-finalizer avalanche per word, folded left to right with a
    position-dependent multiply-add, so permuting a row's words changes
    the sum (``repro/db/spec.py:63``). The reference computes it in uint64
    with masks; here uint32 arithmetic wraps mod 2^32 to the same values,
    one contiguous column at a time and without the uint64 copies:
    O(rows · W) host work, done once per database at construction.
    """
    w = np.asarray(words, dtype=np.uint32)
    if w.ndim < 1 or w.shape[-1] == 0:
        raise ValueError(f"need at least one payload word, got shape {w.shape}")
    cols = np.ascontiguousarray(np.moveaxis(w, -1, 0))
    h = np.full(w.shape[:-1], 0x9E3779B9, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for k in range(w.shape[-1]):
            x = cols[k] * np.uint32(0x85EBCA6B)
            x ^= x >> np.uint32(13)
            x *= np.uint32(0xC2B2AE35)
            x ^= x >> np.uint32(16)
            h = (h ^ x) * np.uint32(0x9E3779B1) + np.uint32(k)
    return np.asarray(h, dtype=np.uint32)


def verify_records(rec: np.ndarray, item_bytes: int) -> np.ndarray:
    """Check and strip the checksum column of reconstructed records.

    Takes either form a protocol reconstructs into, at stored width:

    * words ``[Q, item_bytes // 4 + 1]`` uint32 (the XOR schemes);
    * bytes ``[Q, item_bytes + 4]`` integer bytes 0..255 (additive, LWE),
      the checksum word little-endian in the last 4 bytes.

    Returns the payload (the same form, checksum column stripped) or raises
    :class:`IntegrityError` naming the offending batch indices.
    """
    arr = np.asarray(rec)
    if arr.ndim != 2:
        raise ValueError(f"records must be 2-D, got shape {arr.shape}")
    n_words = item_bytes // 4
    if arr.shape[1] == n_words + 1 and arr.dtype == np.uint32:
        payload_words, stored = arr[:, :n_words], arr[:, n_words]
        payload = payload_words
    elif arr.shape[1] == item_bytes + 4:
        b = (arr.astype(np.int64) & 0xFF).astype(np.uint8)
        payload_words = np_bytes_to_words(b[:, :item_bytes])
        stored = np_bytes_to_words(b[:, item_bytes:])[:, 0]
        payload = arr[:, :item_bytes]
    else:
        raise ValueError(
            f"records must be [Q, {n_words + 1}] u32 words or "
            f"[Q, {item_bytes + 4}] bytes (stored width with the checksum), "
            f"got {arr.shape} {arr.dtype}")
    bad = np.nonzero(row_checksum(payload_words) != stored)[0]
    if bad.size:
        raise IntegrityError(
            f"checksum mismatch on {bad.size}/{arr.shape[0]} reconstructed "
            f"record(s) (batch indices {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}): corrupted answer share",
            bad_queries=bad)
    return payload


@dataclass(frozen=True)
class DatabaseSpec:
    """Shape math for one PIR database (N records x L bytes).

    ``item_bytes`` is the logical payload width; with ``checksum=True``
    each stored record carries one more u32 ``row_checksum`` word after the
    payload (``stored_bytes = item_bytes + 4``), and every view is at the
    stored width.
    """

    n_items: int
    item_bytes: int = 32
    checksum: bool = False

    def __post_init__(self):
        if self.n_items <= 0 or self.n_items & (self.n_items - 1):
            raise ValueError(
                f"n_items must be a power of two (GGM tree domain), "
                f"got {self.n_items}")
        if self.item_bytes % 4:
            raise ValueError(
                f"item_bytes must be a multiple of 4 (u32 words), "
                f"got {self.item_bytes}")

    @classmethod
    def from_config(cls, cfg: PIRConfig) -> "DatabaseSpec":
        return cls(n_items=cfg.n_items, item_bytes=cfg.item_bytes,
                   checksum=cfg.checksum)

    @property
    def item_words(self) -> int:
        return self.item_bytes // 4

    @property
    def stored_bytes(self) -> int:
        """Bytes per stored record (the payload and the checksum word)."""
        return self.item_bytes + (4 if self.checksum else 0)

    @property
    def stored_words(self) -> int:
        return self.item_words + (1 if self.checksum else 0)

    @property
    def log_n(self) -> int:
        return (self.n_items - 1).bit_length()

    @property
    def db_bytes(self) -> int:
        return self.n_items * self.item_bytes

    def rows_per_shard(self, n_shards: int) -> int:
        """Rows held by one DB shard; validates the paper's linear layout
        (shard d holds rows [d·B_d, (d+1)·B_d), B_d a power of two)."""
        n_shards = max(n_shards, 1)
        if self.n_items % n_shards:
            raise ValueError(
                f"{self.n_items} rows not divisible by {n_shards} shards")
        rows = self.n_items // n_shards
        if rows & (rows - 1):
            raise ValueError(
                f"per-shard row count must be a power of two, got {rows}")
        return rows

    def view_dtype(self, view: str) -> np.dtype:
        if view not in VIEWS:
            raise KeyError(f"unknown db view {view!r}; known: {sorted(VIEWS)}")
        return VIEWS[view]

    def view_shape(self, view: str) -> Tuple[int, int]:
        self.view_dtype(view)
        cols = self.stored_words if view == "words" else self.stored_bytes
        return (self.n_items, cols)

    def view_struct(self, view: str) -> torch.Tensor:
        """A meta tensor of one view's shape and torch dtype, the dry run's
        stand-in for the device view (the reference's
        ``jax.ShapeDtypeStruct``); it holds no storage."""
        self.view_dtype(view)
        return torch.empty(self.view_shape(view), dtype=TORCH_VIEWS[view],
                           device="meta")

    def words_to_bytes_host(self, words: np.ndarray) -> np.ndarray:
        """``[..., W]`` u32 -> ``[..., 4W]`` u8 on the host (little-endian)."""
        return np_words_to_bytes(np.asarray(words))

    def bytes_to_words_host(self, b: np.ndarray) -> np.ndarray:
        """``[..., 4W]`` u8 -> ``[..., W]`` u32 on the host (little-endian)."""
        return np_bytes_to_words(np.asarray(b, np.uint8))

    def words_to_bytes_device(self, words: torch.Tensor) -> torch.Tensor:
        """``[..., W]`` int32 words -> ``[..., 4W]`` int8 bytes on their
        device: a view of the same storage (``.view(torch.int8)``; the card
        is little-endian), never a copy."""
        return words.view(torch.int8)

    def words_to_view_device(self, view: str, words: torch.Tensor
                             ) -> torch.Tensor:
        """Any registered view of word rows, on their device: ``words``
        itself, the ``bytes`` alias of its storage, or ``bytes32``, the
        byte values widened to int32 (a new tensor, 4x the words)."""
        if view == "words":
            return words
        if view == "bytes":
            return self.words_to_bytes_device(words)
        if view == "bytes32":
            return words_to_bytes_i32(words)
        raise KeyError(f"unknown db view {view!r}; known: {sorted(VIEWS)}")

    def pack_host(self, words: np.ndarray, view: str) -> np.ndarray:
        """Host-side packing of word rows into any registered view (test
        oracles, tuner inputs)."""
        if view == "words":
            return np.asarray(words, np.uint32)
        if view == "bytes":
            return self.words_to_bytes_host(words).view(np.int8)
        if view == "bytes32":
            return self.words_to_bytes_host(words).astype(np.int32)
        raise KeyError(f"unknown db view {view!r}; known: {sorted(VIEWS)}")

    def validate_words(self, db_words: np.ndarray) -> np.ndarray:
        arr = np.asarray(db_words)
        if arr.shape != self.view_shape("words") or arr.dtype != np.uint32:
            raise ValueError(
                f"db_words must be {self.view_shape('words')} uint32, got "
                f"{arr.shape} {arr.dtype}")
        return arr

    def attach_checksums(self, words: np.ndarray) -> np.ndarray:
        """Widen payload word rows to the stored width: ``[R, W] -> [R,
        W + 1]``. Rows that already carry the column, or a spec without
        checksums, pass through (idempotent)."""
        arr = np.asarray(words, dtype=np.uint32)
        if not self.checksum or (arr.ndim == 2
                                 and arr.shape[1] == self.stored_words):
            return arr
        if arr.ndim != 2 or arr.shape[1] != self.item_words:
            raise ValueError(
                f"payload rows must be [R, {self.item_words}] u32, got "
                f"{arr.shape}")
        col = row_checksum(arr)[:, None]
        return np.concatenate([arr, col], axis=1)

    def coerce_rows_to_words(self, values) -> np.ndarray:
        """Update payloads as ``[R, item_words]`` u32 rows (``spec.py:281``
        upstream): the word form passes through, the byte form ``[R,
        item_bytes]`` u8 is packed little-endian on the host (O(R))."""
        arr = np.asarray(values)
        if arr.ndim != 2:
            raise ValueError(f"row values must be 2-D, got shape {arr.shape}")
        if arr.shape[1] == self.item_bytes and arr.dtype == np.uint8:
            return self.bytes_to_words_host(arr)
        if arr.shape[1] == self.item_words:
            return arr.astype(np.uint32, copy=False)
        raise ValueError(
            f"row values must be [R, {self.item_words}] u32 words or "
            f"[R, {self.item_bytes}] u8 bytes, got {arr.shape} {arr.dtype}")

    def verify_stored_rows(self, rows: np.ndarray) -> np.ndarray:
        """Check stored-width word rows against their checksum column and
        return the payload (``[R, W + 1] -> [R, W]``); the identity without
        checksums. Raises :class:`IntegrityError` on a mismatch."""
        arr = np.asarray(rows, dtype=np.uint32)
        if not self.checksum:
            return arr
        return verify_records(arr, self.item_bytes)
