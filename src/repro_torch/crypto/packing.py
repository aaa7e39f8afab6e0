"""u32 word packing between numpy and the port's int32 tensors.

The reference stores records as ``uint32`` words; the port keeps the same
bits in ``int32`` tensors (see the package docstring). These are the only
conversions the database spec needs.
"""
from __future__ import annotations

import numpy as np
import torch


def words_to_tensor(words: np.ndarray, device=None) -> torch.Tensor:
    """``[..., W] uint32`` numpy -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    if not arr.flags.writeable:       # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> ``uint32`` numpy array with the same bits (host copy)."""
    return t.detach().to("cpu", torch.int32).contiguous().numpy().view(np.uint32)


def np_words_to_bytes(w: np.ndarray) -> np.ndarray:
    """``[..., W] uint32 -> [..., 4W] uint8``, little-endian on any host."""
    le = np.ascontiguousarray(w, dtype="<u4")
    return le.view(np.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))
