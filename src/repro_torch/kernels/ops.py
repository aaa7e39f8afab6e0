"""Public entry points for the port's kernels (``repro/kernels/ops.py``).

Row-major DB everywhere: the kernels read ``[R, W]`` words or ``[R, L]``
bytes as stored, so there is no per-batch transpose (the reference
transposes to ``[W, R]`` at ``ops.py:64``). Each entry point launches its
CUDA kernel for CUDA tensors and takes the plain version for CPU tensors;
``counts()`` reads the per-kernel launch and plain-call counters and
``reset_counts()`` zeroes them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.engine.backend import legal_tile
from repro_torch.kernels import build, dpxor as _dpxor, fused_scan as _fused
from repro_torch.kernels import lwe_matmul as _lwe, pir_matmul as _gemm
from repro_torch.kernels.dpxor import dpxor
from repro_torch.kernels.fused_scan import fused_scan_xor
from repro_torch.kernels.lwe_matmul import lwe_gemm
from repro_torch.kernels.pir_matmul import pir_gemm

#: fused expand + select-add over the int8 byte view: only an alias of
#: ``fused_scan.fused_scan_add`` under the reference's entry-point name
#: (``ops.py:120-137``; no DMA tile arguments), the one name ops exports
fused_scan_bytes = _fused.fused_scan_add

__all__ = ["COUNTS", "counts", "dpxor", "fused_scan_bytes", "fused_scan_xor",
           "fused_tile", "lwe_gemm", "pir_gemm", "reset_counts"]

#: kernel name -> its counter (``build.KernelCount``)
COUNTS: Dict[str, build.KernelCount] = {
    "dpxor": _dpxor.count,
    "fused_scan_xor": _fused.count,
    "pir_gemm": _gemm.count,
    "fused_scan_add": _fused.count_add,
    "lwe_gemm": _lwe.count,
}


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain_calls": n}}``."""
    return {k: {"launches": c.launches, "plain_calls": c.plain_calls}
            for k, c in COUNTS.items()}


def reset_counts():
    for c in COUNTS.values():
        c.reset()


def fused_tile(rows: int, tile_r: int, clog: int) -> tuple[int, int]:
    """Legalize a (tile_r, chunk_log) request for a shard of ``rows`` rows.

    The reference rule (``ops.py:81-90``): tile_r becomes the largest power
    of two dividing ``rows`` (capped at the request) and chunk_log clamps so
    a tile holds whole chunks. The CUDA kernels have no tile, but the clamp
    fixes how many levels they expand, so it is kept for parity.
    """
    tile = legal_tile(rows, tile_r, pow2=True)
    return tile, min(clog, tile.bit_length() - 1)
