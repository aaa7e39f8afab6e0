"""Wrapping int32 GEMM of the LWE scheme: the CUDA kernel, its op, and its
plain version.

Port of ``repro/kernels/pir_matmul.py`` ``_matmul_kernel`` as reached
through ``lwe_matmul``: ``a[M, K] i32 x b[K, P] i32 -> [M, P] i32``, with
the sum taken modulo 2^32, which is the Z_q contraction of
``lwe-simple-1`` (q = 2^32). The served answer is ``ct[Q, N] x
bytes32[N, L]``; the same op computes the client's ``A.S^T`` and the hint
``(D^T.A)^T`` (``core/lwe.py``), since CUDA PyTorch has no integer matmul.

The Pallas kernel carries each output block across a sequential R axis.
On the GPU blocks run in parallel, so K is split and the blocks' partials
meet in the zeroed output through ``atomicAdd``; see
``csrc/lwe_gemm.cu`` for the design and its bound.

``lwe_gemm`` dispatches on the tensors' device: CUDA launches the kernel
(or raises), CPU takes ``lwe_gemm_plain``; ``count`` tallies both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pir_matmul import wrap_int32

count = build.KernelCount()

#: products per step of the plain version (bounds its [m, k, P] temporary)
_PLAIN_ELEMS = 1 << 24

_LOW32 = 0xFFFFFFFF


def instance(m: int, p: int = 32) -> str:
    """The template instance ``csrc/lwe_gemm.cu`` launches for ``m`` rows
    of ``a`` and ``p`` columns of ``b``, as the stem of its mangled name.
    BM is the least power of two >= m up to 32, 32 past 40; 32 < m <= 40
    takes one 40-row tile (``lwe_gemm_tall_kernel<40>``), and 33 to 40
    columns a block that holds all of them (``lwe_gemm_wide_kernel<BM,
    RW>``, RW = 4 or 8 remainder columns beside the first 32, BM at most
    32)."""
    bm = next(b for b in (1, 2, 4, 8, 16, 32) if m <= b or b == 32)
    if 32 < p <= 40:
        return build.mangled("lwe_gemm_wide_kernel", bm, 4 if p <= 36 else 8)
    if 32 < m <= 40:
        return build.mangled("lwe_gemm_tall_kernel", 40)
    return build.mangled("lwe_gemm_kernel", bm)


def _check_shapes(a: torch.Tensor, b: torch.Tensor):
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"lwe_gemm takes int32 operands, got {a.dtype} x "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"reduction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def lwe_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch wrapping GEMM: ``[M, K] x [K, P] -> [M, P]`` int32,
    modulo 2^32.

    Each product of two int32 values is exact in int64 (|x| <= 2^62) and is
    masked to its low 32 bits (0 .. 2^32 - 1) at once; a block sums at most
    ``_PLAIN_ELEMS`` of them (< 2^56) and the running sum is masked again,
    so no int64 sum ever overflows: nothing relies on int64 wraparound.
    Blocks of rows and of K keep the ``[m, k, P]`` temporary bounded.
    (CUDA PyTorch has no integer matmul, so broadcast products are used on
    either device.)
    """
    _check_shapes(a, b)
    m, k = a.shape
    p = b.shape[1]
    acc = torch.zeros((m, p), dtype=torch.int64, device=a.device)
    m_step = max(1, min(m, _PLAIN_ELEMS // max(p, 1)))
    k_step = max(1, _PLAIN_ELEMS // max(m_step * p, 1))
    for m_lo in range(0, m, m_step):
        rows = slice(m_lo, m_lo + m_step)
        for k_lo in range(0, k, k_step):
            x = a[rows, k_lo:k_lo + k_step].to(torch.int64)
            y = b[k_lo:k_lo + k_step].to(torch.int64)
            part = ((x[:, :, None] * y[None]) & _LOW32).sum(dim=1)
            acc[rows] = (acc[rows] + part) & _LOW32
    return wrap_int32(acc)


@torch.library.custom_op("repro_torch::lwe_gemm", mutates_args=(),
                         device_types="cuda")
def _lwe_gemm_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    build.require_cuda_words("a", a, 2)             # 16-byte row loads
    build.require_cuda_words("b", b, 2, align=4)
    _check_shapes(a, b)
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}")
    m, k = a.shape
    p = b.shape[1]
    if k % 4:
        raise ValueError(f"lwe_gemm kernel needs K % 4 == 0, got K={k}")
    out = torch.zeros((m, p), dtype=torch.int32, device=a.device)
    if m == 0 or k == 0 or p == 0:
        return out
    lib = build.library("lwe_gemm")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.repro_lwe_gemm(ptr(a), ptr(b), ptr(out), m, k, p,
                             build.n_sms(a),
                             ctypes.c_void_p(build.stream_of(a)))
    build.check(lib, err, "lwe_gemm")
    count.launches += 1
    return out


@_lwe_gemm_op.register_fake
def _lwe_gemm_fake(a, b):
    """The output's shape and dtype, for meta and fake tensors."""
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


def lwe_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LWE contraction: ``[M, K] i32 x [K, P] i32 -> [M, P] i32`` modulo
    2^32. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if b.device.type == "cpu" and a.device.type == "cpu":
        count.plain_calls += 1
        return lwe_gemm_plain(a, b)
    return torch.ops.repro_torch.lwe_gemm(a.contiguous(), b.contiguous())
