"""Public entry points for the port's kernels (``repro/kernels/ops.py``).

Row-major DB everywhere: the kernels read ``[R, W]`` words or ``[R, L]``
bytes as stored, so there is no per-batch transpose (the reference
transposes to ``[W, R]`` at ``ops.py:64``). Each entry point launches its
CUDA kernel for CUDA tensors and takes the plain version for CPU tensors;
``counts()`` reads the per-kernel launch and plain-call counters and
``reset_counts()`` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.engine.backend import legal_tile
from repro_torch.kernels import build, dpxor as _dpxor, fused_scan as _fused
from repro_torch.kernels import ggm_expand as _ggm
from repro_torch.kernels import lwe_matmul as _lwe, pir_matmul as _gemm
from repro_torch.kernels.dpxor import dpxor
from repro_torch.kernels.fused_scan import fused_scan_xor
from repro_torch.kernels.ggm_expand import ggm_expand
from repro_torch.kernels.lwe_matmul import lwe_gemm
from repro_torch.kernels.pir_matmul import pir_gemm

#: fused expand + select-add over the int8 byte view: only an alias of
#: ``fused_scan.fused_scan_add`` under the reference's entry-point name
#: (``ops.py:120-137``; no DMA tile arguments), the one name ops exports
fused_scan_bytes = _fused.fused_scan_add

__all__ = ["COUNTS", "counts", "dpxor", "fused_scan_bytes", "fused_scan_xor",
           "fused_tile", "ggm_eval_leaves", "ggm_expand", "lwe_gemm",
           "pir_gemm", "reset_counts"]

#: kernel name -> its counter (``build.KernelCount``)
COUNTS: Dict[str, build.KernelCount] = {
    "dpxor": _dpxor.count,
    "fused_scan_xor": _fused.count,
    "pir_gemm": _gemm.count,
    "fused_scan_add": _fused.count_add,
    "lwe_gemm": _lwe.count,
    "ggm_expand": _ggm.count,
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


def ggm_eval_leaves(key_root: torch.Tensor, key_t0, cw_seed: torch.Tensor,
                    cw_t: torch.Tensor, log_n: int, *, rounds: int = 12,
                    tile: int = _ggm.DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-domain GGM leaf expansion, one ``ggm_expand`` launch per level
    (``ops.py:171-187`` upstream).

    ``key_root [4]``, ``key_t0`` (the party: the root's control bit),
    ``cw_seed [log_n, 4]``, ``cw_t [log_n, 2]`` -> ``(seeds [2^log_n, 4],
    t [2^log_n])`` on ``key_root``'s device.
    """
    seeds = key_root.reshape(1, 4)
    t = torch.full((1,), int(key_t0), dtype=torch.int32,
                   device=key_root.device)
    for level in range(log_n):
        seeds, t = ggm_expand(seeds, t, cw_seed[level], cw_t[level],
                              rounds=rounds, tile=tile)
    return seeds, t
