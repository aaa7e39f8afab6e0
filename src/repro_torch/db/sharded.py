"""``Database``: the device-resident PIR database of one device.

Single-device counterpart of ``repro/db/sharded.py ShardedDatabase``: it
owns the ``words`` view, resident once on the device as a row-major
``[R, W]`` int32 tensor (each 32-byte record contiguous; the kernels read
it as stored, with no per-batch transpose), and the epoch tag that answers
are stamped with. The ``bytes`` view is not a second copy: it is the same
memory reinterpreted as ``[R, 4W]`` int8 (``words.view(torch.int8)``),
whose byte order is little-endian on the host and on the card, as the
reference's ``words_to_bytes_i8`` packs it. All parties of a deployment
share one ``Database``: the contents are public in the PIR model. Online
updates (``stage`` / ``publish``) are not ported yet, so the epoch stays 0.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.crypto.packing import words_to_tensor
from repro_torch.db.spec import DatabaseSpec
from repro_torch.engine.backend import Device, resolve_device


class Database:
    """The PIR database on one device (``device=None`` means CUDA)."""

    def __init__(self, db_words: np.ndarray, cfg: PIRConfig,
                 device: Device = None):
        self.spec = DatabaseSpec.from_config(cfg)
        self.device = resolve_device(device)
        self._words = words_to_tensor(self.spec.validate_words(db_words),
                                      self.device)
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def resident_bytes(self) -> int:
        """Device bytes the database holds: the words once (the ``bytes``
        view aliases them)."""
        return self._words.numel() * self._words.element_size()

    def view(self, name: str = "words") -> torch.Tensor:
        """The device tensor of one view at the current epoch; ``KeyError``
        for a view the spec does not know."""
        self.spec.view_dtype(name)
        if name == "bytes":
            return self._words.view(torch.int8)
        return self._words

    def snapshot(self, views: Sequence[str] = ("words",)
                 ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """``(epoch, {view: tensor})`` read together, for one dispatch."""
        return self._epoch, {v: self.view(v) for v in views}
