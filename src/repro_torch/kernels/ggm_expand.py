"""One corrected GGM level: the CUDA kernel, its op, and its plain version.

Port of ``repro/kernels/ggm_expand.py`` (``_ggm_expand_kernel``): ``n``
parent seeds and their control bits -> ``2n`` children and bits, leaf-major
with children interleaved (child ``2j`` is node j's left child, ``2j + 1``
its right), the BGI corrections applied masked by the parent's t. This is
the contract of the reference's ``ops.ggm_expand``; its Pallas kernel takes
seeds word-transposed (``[4, n]``, nodes on the TPU's lanes) and the
wrapper interleaves afterwards, while the CUDA kernel reads and writes the
leaf-major layout directly — see ``csrc/ggm_expand.cu`` for the design and
its bound.

``ggm_expand`` dispatches on the tensors' device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes ``ggm_expand_plain``. ``count``
tallies both.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.crypto.chacha import ggm_double
from repro_torch.engine.backend import legal_tile
from repro_torch.kernels import build

count = build.KernelCount()

#: threads per block of one launch at most (the kernel's __launch_bounds__)
MAX_BLOCK = 1024

#: the block size a caller gets without asking (``tile=``)
DEFAULT_BLOCK = 256


def block_for(n: int, tile: int) -> int:
    """The launch's threads per block: ``tile`` legalized to the largest
    divisor of ``n`` that is <= min(tile, 1024)."""
    return legal_tile(n, min(tile, MAX_BLOCK))


def ggm_expand_plain(seeds: torch.Tensor, t: torch.Tensor,
                     cw_seed: torch.Tensor, cw_t: torch.Tensor, *,
                     rounds: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch level: ``ggm_double`` plus the corrections (the
    arithmetic of ``core.dpf._expand_level`` at one query, with the mask
    ``0 - t`` as in the kernel) -> ``(children [2n, 4], t [2n])``."""
    n = seeds.shape[0]
    s_l, t_l, s_r, t_r = ggm_double(seeds, rounds=rounds)
    cw = -t[:, None] & cw_seed[None, :]
    children = torch.stack([s_l ^ cw, s_r ^ cw], dim=1).reshape(2 * n, 4)
    t_out = torch.stack([t_l ^ (t & cw_t[0]), t_r ^ (t & cw_t[1])],
                        dim=1).reshape(2 * n)
    return children, t_out


def _check_operands(seeds, t, cw_seed, cw_t):
    for name, x in (("seeds", seeds), ("t", t), ("cw_seed", cw_seed),
                    ("cw_t", cw_t)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (u32 words), got "
                            f"{x.dtype}")
    n = seeds.shape[0] if seeds.dim() else -1
    if (seeds.dim() != 2 or tuple(seeds.shape) != (n, 4)
            or tuple(t.shape) != (n,) or tuple(cw_seed.shape) != (4,)
            or tuple(cw_t.shape) != (2,)):
        raise ValueError(
            f"ggm_expand takes seeds [n, 4], t [n], cw_seed [4], cw_t [2]; "
            f"got {tuple(seeds.shape)}, {tuple(t.shape)}, "
            f"{tuple(cw_seed.shape)}, {tuple(cw_t.shape)}")


@torch.library.custom_op("repro_torch::ggm_expand", mutates_args=(),
                         device_types="cuda")
def _ggm_expand_op(seeds: torch.Tensor, t: torch.Tensor,
                   cw_seed: torch.Tensor, cw_t: torch.Tensor, rounds: int,
                   tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    build.require_cuda_words("seeds", seeds, 2)            # uint4 loads
    build.require_cuda_words("t", t, 1, align=4)
    build.require_cuda_words("cw_seed", cw_seed, 1, align=4)
    build.require_cuda_words("cw_t", cw_t, 1, align=4)
    _check_operands(seeds, t, cw_seed, cw_t)
    if len({x.device for x in (seeds, t, cw_seed, cw_t)}) != 1:
        raise ValueError("ggm_expand operands are on different devices")
    if rounds <= 0 or rounds % 2:
        raise ValueError(f"rounds must be positive and even, got {rounds}")
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    n = seeds.shape[0]
    children = torch.empty((2 * n, 4), dtype=torch.int32, device=seeds.device)
    t_out = torch.empty((2 * n,), dtype=torch.int32, device=seeds.device)
    if n == 0:
        return children, t_out
    lib = build.library("ggm_expand")
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    err = lib.repro_ggm_expand(p(seeds), p(t), p(cw_seed), p(cw_t),
                               p(children), p(t_out), n, block_for(n, tile),
                               rounds,
                               ctypes.c_void_p(build.stream_of(seeds)))
    build.check(lib, err, "ggm_expand")
    count.launches += 1
    return children, t_out


@_ggm_expand_op.register_fake
def _ggm_expand_fake(seeds, t, cw_seed, cw_t, rounds, tile):
    """The outputs' shapes and dtypes, for meta and fake tensors."""
    n = seeds.shape[0]
    return (seeds.new_empty((2 * n, 4), dtype=torch.int32),
            seeds.new_empty((2 * n,), dtype=torch.int32))


def ggm_expand(seeds: torch.Tensor, t: torch.Tensor, cw_seed: torch.Tensor,
               cw_t: torch.Tensor, *, rounds: int = 12,
               tile: int = DEFAULT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """One corrected GGM level, leaf-major: ``[n, 4]`` -> ``([2n, 4], [2n])``.

    Args:
      seeds:   ``[n, 4]`` int32 node seeds (u32 bit patterns).
      t:       ``[n]`` node control bits.
      cw_seed: ``[4]`` the level's seed correction word.
      cw_t:    ``[2]`` the level's (tL, tR) control corrections.
      tile:    threads per block on the card, legalized by ``block_for``.
    CUDA tensors launch the kernel, CPU tensors take the plain version.
    """
    if seeds.device.type == "cpu":
        _check_operands(seeds, t, cw_seed, cw_t)
        count.plain_calls += 1
        return ggm_expand_plain(seeds, t, cw_seed, cw_t, rounds=rounds)
    return torch.ops.repro_torch.ggm_expand(
        seeds.contiguous(), t.contiguous(), cw_seed.contiguous(),
        cw_t.contiguous(), rounds, tile)
