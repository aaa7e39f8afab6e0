"""Batched additive-PIR int8 GEMM: the CUDA kernel, its op, and its plain
version.

Port of ``repro/kernels/pir_matmul.py`` (``_matmul_kernel`` reached
through ``pir_matmul``): ``shares[Q, R] i8 x db[R, L] i8 -> [Q, L] i32``,
the answer step of ``additive-dpf-2``. Only the value mod 256 of an answer
matters, and int32 accumulation wraps mod 2^32, so the result is the
wrapped int32 product, bit for bit.

The Pallas kernel tiles (Q, L, R) and carries each output block across a
sequential R axis in VMEM. On the GPU blocks run in parallel, so the sum
is split over R instead: each block folds its rows to a ``[Q, L]`` partial
and adds it to the zeroed output with ``atomicAdd`` — see
``csrc/pir_gemm.cu`` for the design and its bound. Any record width that
is a multiple of 4 bytes is taken: 4, 8, 16 and 32 bytes on fixed-width
instances, others (36-byte checksummed records, 128-byte records) on a
word-column path.

``pir_gemm`` dispatches on the tensors' device: CUDA launches the kernel
(or raises), CPU takes ``pir_gemm_plain``; ``count`` tallies both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

count = build.KernelCount()

#: products per step of the plain version (bounds its [Q, rows, L] temporary)
_PLAIN_ELEMS = 1 << 24

#: record widths (bytes) with a fixed-width instance (``pir_gemm_kernel<L,
#: QB>``; the fused add kernel has exact instances at the same widths)
VECTOR_BYTES = (4, 8, 16, 32)


def instance(cols: int, queries: int) -> str:
    """The template instance ``csrc/pir_gemm.cu`` launches for a ``[R,
    cols]`` byte DB aligned as an allocation is and ``queries`` queries, as
    the stem of its mangled name."""
    qb = build.query_block(queries)
    if cols in VECTOR_BYTES:
        return build.mangled("pir_gemm_kernel", cols, qb)
    return build.mangled("pir_gemm_any_kernel", qb)


def wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), exactly."""
    return (((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def as_int8(t: torch.Tensor) -> torch.Tensor:
    """``uint8`` -> ``int8`` by reinterpretation (``view``), never by value;
    int8 passes through."""
    if t.dtype == torch.uint8:
        return t.view(torch.int8)
    if t.dtype != torch.int8:
        raise TypeError(f"expected int8 or uint8, got {t.dtype}")
    return t


def pir_gemm_plain(shares: torch.Tensor, db_bytes: torch.Tensor
                   ) -> torch.Tensor:
    """Plain PyTorch int8 GEMM: ``[Q, R] x [R, L] -> [Q, L]`` int32.

    Both operands are read as signed int8 (``uint8`` shares are
    reinterpreted, as the reference's ``astype(int8)`` does). Products
    accumulate in int64, in row blocks so the temporary stays bounded, and
    wrap to int32 at the end: equal to XLA's wrapping int32 dot bit for
    bit. (torch's CPU ``int8 @ int8`` returns int8 and wraps each sum, and
    CUDA has no integer matmul, so neither is used.)
    """
    shares, db_bytes = as_int8(shares), as_int8(db_bytes)
    q, r = shares.shape
    if db_bytes.dim() != 2 or db_bytes.shape[0] != r:
        raise ValueError(f"reduction mismatch {tuple(shares.shape)} x "
                         f"{tuple(db_bytes.shape)}")
    l = db_bytes.shape[1]
    acc = torch.zeros((q, l), dtype=torch.int64, device=db_bytes.device)
    step = max(1, _PLAIN_ELEMS // max(q * l, 1))
    for lo in range(0, r, step):
        s = shares[:, lo:lo + step].to(torch.int64)
        d = db_bytes[lo:lo + step].to(torch.int64)
        acc += (s[:, :, None] * d[None]).sum(dim=1)
    return wrap_int32(acc)


@torch.library.custom_op("repro_torch::pir_gemm", mutates_args=(),
                         device_types="cuda")
def _pir_gemm_op(shares: torch.Tensor, db_bytes: torch.Tensor
                 ) -> torch.Tensor:
    build.require_cuda_bytes("shares", shares)
    build.require_cuda_bytes("db_bytes", db_bytes)
    q, r = shares.shape
    r2, l = db_bytes.shape
    if r != r2 or shares.device != db_bytes.device:
        raise ValueError(f"shares {tuple(shares.shape)} on {shares.device} "
                         f"does not match db {tuple(db_bytes.shape)} on "
                         f"{db_bytes.device}")
    if l % 4:
        raise ValueError(f"pir_gemm kernel reads whole 4-byte words; got "
                         f"records of {l} bytes")
    if r % 4:
        raise ValueError(f"pir_gemm kernel needs rows % 4 == 0, got {r}")
    out = torch.zeros((q, l), dtype=torch.int32, device=db_bytes.device)
    if q == 0 or r == 0:
        return out
    lib = build.library("pir_gemm")
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.repro_pir_gemm(p(shares), p(db_bytes), p(out), r, l, q,
                             build.n_sms(db_bytes),
                             ctypes.c_void_p(build.stream_of(db_bytes)))
    build.check(lib, err, "pir_gemm")
    count.launches += 1
    return out


@_pir_gemm_op.register_fake
def _pir_gemm_fake(shares, db_bytes):
    """The output's shape and dtype, for meta and fake tensors."""
    return db_bytes.new_empty((shares.shape[0], db_bytes.shape[1]),
                              dtype=torch.int32)


def pir_gemm(shares: torch.Tensor, db_bytes: torch.Tensor) -> torch.Tensor:
    """Additive-PIR contraction: ``[Q, R] i8 x [R, L] i8 -> [Q, L] i32``.

    ``shares`` may be ``uint8`` Z_256 shares; they are reinterpreted as
    int8. CUDA tensors launch the kernel; CPU tensors take the plain
    version.
    """
    shares, db_bytes = as_int8(shares), as_int8(db_bytes)
    if db_bytes.device.type == "cpu":
        count.plain_calls += 1
        return pir_gemm_plain(shares, db_bytes)
    return torch.ops.repro_torch.pir_gemm(shares.contiguous(), db_bytes)
