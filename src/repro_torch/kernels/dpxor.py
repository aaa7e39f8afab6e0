"""dpXOR select-XOR scan: the CUDA kernel, its op, and its plain version.

Port of ``repro/kernels/dpxor.py`` (``_dpxor_kernel``), the paper's
Algorithm 1 ④-⑤: ``out[q] = XOR of db[j] over rows j with bits[q, j] = 1``,
with selection bits turned into word masks ``0 - b``.

The Pallas kernel takes the DB word-transposed (``[W, R]``) so the long
row axis fills the TPU's lanes, and carries an accumulator across a
sequential grid. On the GPU the DB stays row-major ``[R, W]`` (one 32-byte
record per row, read in 16-byte loads), blocks run in parallel and combine
with ``atomicXor`` — see ``csrc/dpxor.cu`` for the design and its bound.
The kernel takes any record width: 1, 2, 4, 8 and 16 words on
vector-load instances, other widths (36-byte records with a checksum
column, 128-byte records) and operands only 4-byte aligned (a row slice)
on a word-by-word path that the kernel picks from the operand's address.

``dpxor`` dispatches on the tensors' device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``dpxor_plain``. ``count`` tallies
both, so a run can show which one served it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

count = build.KernelCount()

#: rows per step of the plain version (bounds its [Q, rows, W] temporary)
_PLAIN_ELEMS = 1 << 24

#: record widths (words) with a vector-load instance (``dpxor_kernel<W, QB>``)
VECTOR_WIDTHS = (1, 2, 4, 8, 16)


def instance(words: int, queries: int) -> str:
    """The template instance ``csrc/dpxor.cu`` launches for a ``[R, words]``
    DB aligned as an allocation is and ``queries`` queries, as the stem of
    its mangled name (``build.registers`` reads its ptxas report)."""
    qb = build.query_block(queries)
    if words in VECTOR_WIDTHS:
        return build.mangled("dpxor_kernel", words, qb)
    return build.mangled("dpxor_any_kernel", qb)


def xor_fold(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """XOR-reduce ``dim`` away by repeated halving (torch has no XOR sum)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        y = x[:half] ^ x[half:2 * half]
        if n % 2:
            y[0] ^= x[-1]
        x = y
    return x[0]


def dpxor_plain(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch select-XOR: ``[R, W]`` x ``[Q, R]`` -> ``[Q, W]``.

    The same arithmetic as the kernel (mask ``0 - bits``, AND, XOR-fold),
    in row blocks so the masked temporary stays bounded.
    """
    r, w = db_words.shape
    q = bits.shape[0]
    if bits.shape[1] != r:
        raise ValueError(f"bits {tuple(bits.shape)} mismatch with db "
                         f"{tuple(db_words.shape)}")
    out = torch.zeros((q, w), dtype=torch.int32, device=db_words.device)
    step = max(1, _PLAIN_ELEMS // max(q * w, 1))
    for lo in range(0, r, step):
        mask = -bits[:, lo:lo + step].to(torch.int32)              # 0 - b
        masked = mask[:, :, None] & db_words[None, lo:lo + step, :]
        out ^= xor_fold(masked, 1)
    return out


@torch.library.custom_op("repro_torch::dpxor", mutates_args=(),
                         device_types="cuda")
def _dpxor_op(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    # read word by word (the vector loads are taken only where the DB's
    # address allows them), so 4-byte alignment is all either needs
    build.require_cuda_words("db_words", db_words, 2, align=4)
    build.require_cuda_words("bits", bits, 2, align=4)
    r, w = db_words.shape
    q = bits.shape[0]
    if bits.shape[1] != r or bits.device != db_words.device:
        raise ValueError(f"bits {tuple(bits.shape)} on {bits.device} does not "
                         f"match db {tuple(db_words.shape)} on {db_words.device}")
    out = torch.zeros((q, w), dtype=torch.int32, device=db_words.device)
    if q == 0 or r == 0:
        return out
    lib = build.library("dpxor")
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.repro_dpxor(p(db_words), p(bits), p(out), r, w, q,
                          build.n_sms(db_words),
                          ctypes.c_void_p(build.stream_of(db_words)))
    build.check(lib, err, "dpxor")
    count.launches += 1
    return out


@_dpxor_op.register_fake
def _dpxor_fake(db_words, bits):
    """The output's shape and dtype, for meta and fake tensors (the dry
    run, ``analysis/op_cost.py``); never runs the kernel."""
    return db_words.new_empty((bits.shape[0], db_words.shape[1]),
                              dtype=torch.int32)


def dpxor(db_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Select-XOR scan, row-major DB: ``[R, W]`` x ``[Q, R]`` -> ``[Q, W]``.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if db_words.device.type == "cpu":
        count.plain_calls += 1
        return dpxor_plain(db_words, bits)
    return torch.ops.repro_torch.dpxor(db_words, bits)
