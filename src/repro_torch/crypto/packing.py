"""u32 word and byte packing between numpy and the port's tensors.

The reference stores records as ``uint32`` words; the port keeps the same
bits in ``int32`` tensors (see the package docstring). Byte forms are
little-endian, as upstream (``crypto/packing.py``): byte ``4w + k`` of a
record is bits ``8k .. 8k+7`` of its word ``w``.
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


def records_to_host(rec) -> np.ndarray:
    """Reconstructed records as numpy: an int32 words tensor as uint32
    words, a byte tensor as its bytes; numpy records pass through."""
    if isinstance(rec, np.ndarray):
        return rec
    if rec.dtype == torch.int32:
        return tensor_to_words(rec)
    return rec.detach().cpu().numpy()


def np_words_to_bytes(w: np.ndarray) -> np.ndarray:
    """``[..., W] uint32 -> [..., 4W] uint8``, little-endian on any host."""
    le = np.ascontiguousarray(w, dtype="<u4")
    return le.view(np.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` int32 words -> ``[..., 4k]`` uint8 (little-endian).

    A parity helper: served code reads ``Database.view("bytes")``, an alias
    of the resident words, and never copies bytes out this way."""
    sh = torch.arange(0, 32, 8, dtype=torch.int32, device=w.device)
    b = (w.to(torch.int32)[..., None] >> sh) & 0xFF
    return b.to(torch.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """``[..., 4k]`` bytes -> ``[..., k]`` int32 words (little-endian), the
    inverse of :func:`words_to_bytes` (``packing.py:13`` upstream). uint8
    and int8 bytes both pack by their bits."""
    if b.shape[-1] % 4:
        raise ValueError(f"byte length {b.shape[-1]} not a multiple of 4")
    b = (b.to(torch.int32) & 0xFF).reshape(b.shape[:-1]
                                           + (b.shape[-1] // 4, 4))
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            | (b[..., 3] << 24))


def pack_bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """``[..., 32k]`` bits in {0, 1} -> ``[..., k]`` int32 words: bit ``j``
    of word ``w`` is bit ``32w + j`` (``packing.py:29`` upstream)."""
    n = bits.shape[-1]
    if n % 32:
        raise ValueError(f"bit length {n} not a multiple of 32")
    bits = bits.to(torch.int32).reshape(bits.shape[:-1] + (n // 32, 32))
    out = bits[..., 0].clone()
    for j in range(1, 32):
        out |= bits[..., j] << j
    return out


def unpack_words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` int32 words -> ``[..., 32k]`` int32 bits in {0, 1}
    (``packing.py:39`` upstream). ``>>`` on int32 is arithmetic, so each
    shifted word is masked to its low bit."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> sh) & 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))


def words_to_bytes_i8(w: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` words -> ``[..., 4k]`` int8: the same bytes read as int8
    (the additive GEMM's operand), by reinterpretation. A parity helper,
    as :func:`words_to_bytes`."""
    return words_to_bytes(w).view(torch.int8)


def words_to_bytes_i32(w: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` words -> ``[..., 4k]`` int32 byte values 0..255, widened
    (not reinterpreted): the LWE GEMM's operand (``Database.view("bytes32")``).
    The mod-2^32 contraction needs the true byte magnitudes; the int8
    view's negatives for bytes >= 128 would offset it by 256 per byte."""
    return words_to_bytes(w).to(torch.int32)


def np_bytes_to_words(b: np.ndarray) -> np.ndarray:
    """``[..., 4k] uint8 -> [..., k] uint32`` on the host, little-endian
    (verified reconstruction reads a byte record's payload and checksum
    words this way)."""
    b = np.asarray(b, np.uint8)
    if b.shape[-1] % 4:
        raise ValueError(f"byte length {b.shape[-1]} not a multiple of 4")
    le = np.ascontiguousarray(b).view("<u4")
    return le.astype(np.uint32).reshape(b.shape[:-1] + (b.shape[-1] // 4,))
