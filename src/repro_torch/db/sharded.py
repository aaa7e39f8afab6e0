"""``Database``: the device-resident PIR database of one device.

Single-device counterpart of ``repro/db/sharded.py ShardedDatabase``: it
owns the ``words`` view, resident once on the device as a row-major
``[R, W]`` int32 tensor (each record contiguous; the kernels read it as
stored, with no per-batch transpose), and the epoch tag that answers are
stamped with. With ``cfg.checksum`` the rows are stored with their checksum
word, attached once on the host at construction, so every view is at the
stored width (``W = item_words + 1``). The ``bytes`` view is not a second
copy: it is the same memory reinterpreted as ``[R, 4W]`` int8
(``words.view(torch.int8)``), whose byte order is little-endian on the
host and on the card, as the reference's ``words_to_bytes_i8`` packs it.
The ``bytes32`` view (the LWE GEMM's operand, 4x the records) is a real
copy, so it is built on the device the first time it is asked for and
kept for the epoch.

Hints (single-server preprocessing, ``H = A^T.D`` for ``lwe-simple-1``) are
registered by name with a builder and built lazily per epoch, as upstream
(``repro/db/sharded.py:244-270``). All parties of a deployment share one
``Database``: the contents are public in the PIR model. Online updates
(``stage`` / ``publish``) are not ported yet, so the epoch stays 0.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.crypto.packing import words_to_bytes_i32, words_to_tensor
from repro_torch.db.spec import DatabaseSpec
from repro_torch.engine.backend import Device, resolve_device


class Database:
    """The PIR database on one device (``device=None`` means CUDA)."""

    def __init__(self, db_words: np.ndarray, cfg: PIRConfig,
                 device: Device = None):
        self.spec = DatabaseSpec.from_config(cfg)
        self.device = resolve_device(device)
        # payload rows take their checksum column here, once (rows already
        # at the stored width pass through)
        host = self.spec.validate_words(self.spec.attach_checksums(db_words))
        self._words = words_to_tensor(host, self.device)
        self._epoch = 0
        self._lock = threading.RLock()
        self._bytes32: Optional[torch.Tensor] = None
        self._hint_builders: Dict[str, Callable] = {}
        self._hints: Dict[str, torch.Tensor] = {}
        #: hint builds so far (tests assert one per epoch)
        self.n_hint_builds = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def resident_bytes(self) -> int:
        """Device bytes the database holds: the words once (the ``bytes``
        view aliases them), plus the ``bytes32`` view once it exists."""
        views = [self._words] + ([] if self._bytes32 is None
                                 else [self._bytes32])
        return sum(t.numel() * t.element_size() for t in views)

    def view(self, name: str = "words") -> torch.Tensor:
        """The device tensor of one view at the current epoch; ``KeyError``
        for a view the spec does not know."""
        self.spec.view_dtype(name)
        if name == "bytes":
            return self._words.view(torch.int8)
        if name == "bytes32":
            with self._lock:
                if self._bytes32 is None:
                    self._bytes32 = words_to_bytes_i32(self._words)
                return self._bytes32
        return self._words

    def snapshot(self, views: Sequence[str] = ("words",)
                 ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """``(epoch, {view: tensor})`` read together, for one dispatch."""
        with self._lock:
            return self._epoch, {v: self.view(v) for v in views}

    # -- hints (single-server preprocessing) ----------------------------

    def register_hint(self, name: str, build: Callable,
                      delta: Optional[Callable] = None) -> None:
        """Register a per-epoch hint: ``build(words) -> hint``. ``delta``
        (the exact update on ``publish``) is accepted for the reference's
        signature; it has nothing to do until updates are ported.
        Re-registering a name replaces the builder and keeps a built hint."""
        with self._lock:
            self._hint_builders[name] = build

    def hint(self, name: str, *, epoch: Optional[int] = None
             ) -> torch.Tensor:
        """The device-resident hint of one epoch, built on first use;
        ``KeyError`` for an unregistered name or an epoch not resident."""
        with self._lock:
            if name not in self._hint_builders:
                raise KeyError(f"unknown hint {name!r}; registered: "
                               f"{sorted(self._hint_builders)}")
            if epoch is not None and epoch != self._epoch:
                raise KeyError(f"epoch {epoch} is not resident (current="
                               f"{self._epoch})")
            if name not in self._hints:
                self._hints[name] = self._hint_builders[name](self._words)
                self.n_hint_builds += 1
            return self._hints[name]
