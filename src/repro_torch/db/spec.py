"""``DatabaseSpec``: shape math for one PIR database (``repro/db/spec.py``).

Three views are served: ``words`` (u32 words, the XOR scans' operand),
``bytes`` (int8 bytes, little-endian, the additive GEMM's operand) and
``bytes32`` (the same byte values widened to int32, the LWE GEMM's
operand). A view name is protocol metadata (``PIRProtocol.db_view``). Not
ported yet: the checksum column of verified reconstruction
(``row_checksum``, ``verify_records``); ``IntegrityError`` is here for the
LWE noise check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.config import PIRConfig

#: registered database views: name -> dtype of its ``[N, cols]`` tensor
VIEWS = {
    "words": np.dtype(np.uint32),   # [N, item_words] — XOR schemes
    "bytes": np.dtype(np.int8),     # [N, item_bytes] — additive GEMM
    "bytes32": np.dtype(np.int32),  # [N, item_bytes] — LWE GEMM
    # bytes32 holds the byte values 0..255 widened to int32: the LWE
    # contraction is mod-2^32 arithmetic, and the int8 view's negatives
    # (byte >= 128 -> byte - 256) would shift it by 256·k, not 0 mod q.
}


class IntegrityError(RuntimeError):
    """A reconstructed record failed verification.

    Raised instead of returning a silently wrong record; for the LWE
    scheme, when the recovered noise exceeds the validated bound (answers
    that do not match the hint or epoch). The reference's ``bad_queries``
    (batch indices for a router to resubmit) comes with the row checksum
    of verified reconstruction.
    """


@dataclass(frozen=True)
class DatabaseSpec:
    """Shape math for one PIR database (N records x L bytes)."""

    n_items: int
    item_bytes: int = 32

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
        if cfg.checksum:
            raise ValueError("checksummed databases are not ported yet")
        return cls(n_items=cfg.n_items, item_bytes=cfg.item_bytes)

    @property
    def item_words(self) -> int:
        return self.item_bytes // 4

    def view_dtype(self, view: str) -> np.dtype:
        if view not in VIEWS:
            raise KeyError(f"unknown db view {view!r}; known: {sorted(VIEWS)}")
        return VIEWS[view]

    def view_shape(self, view: str) -> Tuple[int, int]:
        self.view_dtype(view)
        cols = self.item_words if view == "words" else self.item_bytes
        return (self.n_items, cols)

    def validate_words(self, db_words: np.ndarray) -> np.ndarray:
        arr = np.asarray(db_words)
        if arr.shape != self.view_shape("words") or arr.dtype != np.uint32:
            raise ValueError(
                f"db_words must be {self.view_shape('words')} uint32, got "
                f"{arr.shape} {arr.dtype}")
        return arr
