"""Achieved-vs-peak bandwidth: what the engine reads of
``repro/analysis/roofline.py`` (lines 25-60).

``PEAK_BYTES_PER_S["cuda"]`` is the NVIDIA H100 SXM data sheet's HBM3
rate, 3.35 TB/s: a published peak, not a measurement of any card (a card
set below its 700 W power limit reaches less). ``"cpu"`` keeps the
reference's deliberately generous 1e11 B/s, so that the tuner's
bandwidth-floor pruning (``engine/tuner.py``) never drops a plan on a CPU
that a real machine might still win with. The reference's TPU constants
and its HLO-based three-term model have no counterpart here.

``PEAK_BF16_FLOPS_PER_S["cuda"]`` is the same data sheet's dense bf16
tensor-core rate (989 TFLOP/s, without sparsity, at 700 W): the
denominator of a training run's model-FLOPs share.
"""
from __future__ import annotations

#: peak memory bandwidth per backend, bytes/s
PEAK_BYTES_PER_S = {
    "cuda": 3.35e12,      # H100 SXM data sheet, HBM3
    "cpu": 1.0e11,        # generous on purpose (see module docstring)
}


#: peak dense bf16 matrix rate per backend, FLOP/s (data sheet, not
#: measured; no CPU figure)
PEAK_BF16_FLOPS_PER_S = {
    "cuda": 989e12,       # H100 SXM data sheet, bf16 tensor cores, dense
}


def peak_bytes_per_s(backend: str) -> float:
    """Peak memory bandwidth for ``backend`` ("cuda" or "cpu")."""
    return PEAK_BYTES_PER_S.get(backend, PEAK_BYTES_PER_S["cpu"])


def achieved_fraction(bytes_touched: float, wall_s: float, *,
                      backend: str) -> float:
    """``bytes_touched / wall_s / peak``: the fraction of the backend's
    peak bandwidth a measured run reached over its modeled bytes."""
    if wall_s <= 0:
        return 0.0
    return bytes_touched / wall_s / peak_bytes_per_s(backend)
