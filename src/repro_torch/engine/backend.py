"""Device resolution, backend probe and legal-tile arithmetic.

Port of ``repro/engine/backend.py``. The reference probes JAX's default
backend (overridable by ``REPRO_FORCE_BACKEND``); the port reads the
backend off the tensors and devices it is given and has no environment
override, so a test forcing one package never flips the other.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is available: the port never falls back to the
    CPU on its own. Pass ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def backend_of(dev: torch.device) -> str:
    """``"cuda"`` or ``"cpu"``: the backend plans are selected for."""
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev.type


def legal_tile(dim: int, requested: int, *, pow2: bool = False) -> int:
    """Largest legal tile for a dimension: the biggest divisor of ``dim``
    that is <= ``requested`` (and a power of two when ``pow2``)."""
    if dim <= 0:
        raise ValueError(f"dimension must be positive, got {dim}")
    if requested <= 0:
        raise ValueError(f"requested tile must be positive, got {requested}")
    cap = min(requested, dim)
    if pow2:
        # largest power of two that divides dim, capped at floor_pow2(cap)
        return min(dim & -dim, 1 << (cap.bit_length() - 1))
    if dim % cap == 0:
        return cap
    best = 1
    d = 1
    while d * d <= dim:
        if dim % d == 0:
            if d <= cap:
                best = max(best, d)
            if dim // d <= cap:
                best = max(best, dim // d)
        d += 1
    return best
