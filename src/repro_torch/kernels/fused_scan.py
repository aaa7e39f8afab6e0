"""Fused GGM-expand + scan: the CUDA kernels, their ops, and their plain
versions.

Port of ``repro/kernels/fused_scan.py``: ``_fused_xor_kernel`` (select-XOR
over the words view) and ``_fused_add_kernel`` (select-add of Z_256 shares
over the int8 byte view), with ``_expand_tile``, ``_interleave`` and
``ggm_expand.py _chacha_rows``. Inputs are per-chunk GGM subtree roots
(``dpf.eval_roots_batch``) and the last ``clog`` levels of correction
words; a kernel expands each chunk's ``2^clog`` leaves and folds the DB
rows at once, so neither selection bits nor shares reach memory.

The Pallas kernel streams ``[W, tile_r]`` DB tiles through rotating VMEM
buffers and expands each tile breadth-first. On the GPU, at rows of up to
32 words (the XOR kernel) or 64 bytes (the add kernel), one thread owns one
(query, chunk root) and walks its subtree depth-first with ChaCha's state
in registers — see ``csrc/fused_scan_xor.cu`` and ``csrc/fused_scan_add.cu``
for the designs and their bounds. There is no DMA tile, so the reference's
``tile_r``/``depth`` do not reach the kernel; ``ops.fused_tile`` still
legalizes ``chunk_log`` against ``tile_r`` exactly as the reference does.
Both kernels take any record width (a multiple of 4 bytes): the widths of
their exact instances (the XOR kernel's up to 128 bytes) read rows in
vector loads. Past 32 words the XOR kernel takes its wide instance: a block
owns a run of rows, its threads expand the run's leaves once (breadth-first
together, then depth-first each) into bit words in shared memory, and then
read every row once across its whole width, neighbouring threads on
neighbouring 16-byte words. The add kernel reads one group of at most 64
bytes, and wider rows split each chunk's subtree over P lanes of 32
columns each that trade their leaves' shares, so every leaf is expanded
once (up to 1024 bytes).

``fused_scan_xor`` and ``fused_scan_add`` dispatch on the tensors' device:
CUDA launches the kernel (or raises), CPU takes the plain version;
``count`` and ``count_add`` tally.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.crypto.chacha import chacha_block, prg_bits
from repro_torch.kernels import build
from repro_torch.kernels.dpxor import xor_fold
from repro_torch.kernels.pir_matmul import VECTOR_BYTES, pir_gemm_plain, \
    wrap_int32

count = build.KernelCount()
count_add = build.KernelCount()

#: leaves per step of the plain version (bounds its expansion temporaries)
_PLAIN_LEAVES = 1 << 24
#: ... and int32 elements of its masked rows (512 MiB): at 5,120-byte
#: records a block of 2^24 leaves would mask 86 GB
_PLAIN_MASKED = 1 << 27

#: record widths (words) with an exact instance of the XOR kernel
#: (``fused_scan_xor_kernel<W, true>``, vector row loads)
XOR_VECTOR_WIDTHS = (1, 2, 4, 8, 16, 32)

#: accumulators per thread of the column-group instances: words of the XOR
#: kernel, bytes of the add kernel (``csrc/fused_scan_*.cu``); records wider
#: than the last add group take the add kernel's split instance
XOR_GROUPS = (8, 16, 32)
ADD_GROUPS = (16, 48, 64)

#: queries per thread of the XOR kernel's wide instances
#: (``fused_scan_xor_wide_kernel<QB, vec>``, records wider than 32 words):
#: the least that holds the batch; past 8, up to four threads of 8 share
#: each column of a block's group of 32 queries
XOR_WIDE_QUERY_BLOCKS = (1, 2, 4, 8)


def instance_xor(words: int, align: int = 16, queries: int = 32) -> str:
    """The template instance ``csrc/fused_scan_xor.cu`` launches for a
    batch of ``queries`` over records of ``words`` words in a DB whose base
    is ``align``-byte aligned (16: an allocation; 4: a row slice of
    odd-word records), as the stem of its mangled name. Up to 32 words:
    the exact one (``<W, true>``) where the base is aligned for its vector
    loads (``common.cuh row_align``), else the column group that holds
    them (``<G, false>``). Past 32 words: the wide one for the batch's
    query block, with 16-byte loads where ``words % 4 == 0`` and the base
    is 16-byte aligned (``<QB, true>``), word loads otherwise."""
    if words > XOR_GROUPS[-1]:
        qb = next((b for b in XOR_WIDE_QUERY_BLOCKS if queries <= b),
                  XOR_WIDE_QUERY_BLOCKS[-1])
        return build.mangled("fused_scan_xor_wide_kernel", qb,
                             words % 4 == 0 and align % 16 == 0)
    row_align = 16 if words % 4 == 0 else 8 if words % 2 == 0 else 4
    if words in XOR_VECTOR_WIDTHS and align % row_align == 0:
        return build.mangled("fused_scan_xor_kernel", words, True)
    g = next(g for g in XOR_GROUPS if words <= g)
    return build.mangled("fused_scan_xor_kernel", g, False)


def wide_geometry(words: int, queries: int, chunks: int, clog: int,
                  align: int = 16) -> dict:
    """The grid the XOR kernel's wide instance (records wider than 32
    words) takes on the current card for a batch of ``queries`` over
    ``chunks`` chunks of ``2^clog`` rows: ``blocks`` (row runs x query
    groups of 32), ``threads`` per block, ``split`` (levels from a chunk
    root down to a block's subtrees) and ``span`` (subtrees per block),
    and ``atomics_max``, the most global atomicXors one launch issues (one
    per nonzero word of each row run's partial answer). Needs the card:
    the grid follows the instance's occupancy."""
    if words <= XOR_GROUPS[-1]:
        raise ValueError(f"records of {words} words take no wide instance")
    lib = build.library("fused_scan_xor")
    geo = (ctypes.c_longlong * 4)()
    build.check(lib, lib.repro_fused_scan_xor_wide_geometry(
        words, queries, chunks, clog, int(align % 16 == 0), geo),
        "fused_scan_xor_wide_geometry")
    blocks, threads, split, span = (int(v) for v in geo)
    groups = -(-queries // 32)
    return {"blocks": blocks, "threads": threads, "split": split,
            "span": span, "atomics_max": blocks // groups * queries * words}


def instance_add(cols: int) -> str:
    """The template instance ``csrc/fused_scan_add.cu`` launches for
    records of ``cols`` bytes in a DB aligned as an allocation is: the
    exact one (``<L, true>``), the one group that holds them (``<G,
    false>``), or past 64 bytes the split instance, with 16-byte row loads
    where ``cols % 16 == 0`` (``<true>``) and word loads otherwise."""
    if cols in VECTOR_BYTES:
        return build.mangled("fused_scan_add_kernel", cols, True)
    if cols <= ADD_GROUPS[-1]:
        g = next(g for g in ADD_GROUPS if cols <= g)
        return build.mangled("fused_scan_add_kernel", g, False)
    return build.mangled("fused_scan_add_split_kernel", cols % 16 == 0)


def _interleave(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``[Q, m, ...]`` x2 -> ``[Q, 2m, ...]``, children in leaf order."""
    q, m = left.shape[:2]
    return torch.stack([left, right], dim=2).reshape(
        (q, 2 * m) + tuple(left.shape[2:]))


def _expand(seeds, t, cw_seed_lv, cw_t_lv, rounds):
    """Breadth-expand ``clog`` corrected levels: ``[Q, m, 4]`` roots ->
    leaf seeds ``[Q, m << clog, 4]`` and bits ``[Q, m << clog]``
    (``_expand_tile`` semantics: corrections masked by ``0 - t``)."""
    for lvl in range(cw_seed_lv.shape[1]):
        out = chacha_block(seeds, counter=0, rounds=rounds)          # [Q, m, 16]
        cw = -t[..., None] & cw_seed_lv[:, lvl][:, None, :]          # [Q, m, 4]
        t_l = (out[..., 8] & 1) ^ (t & cw_t_lv[:, lvl, 0:1])
        t_r = (out[..., 9] & 1) ^ (t & cw_t_lv[:, lvl, 1:2])
        seeds = _interleave(out[..., 0:4] ^ cw, out[..., 4:8] ^ cw)
        t = _interleave(t_l, t_r)
    return seeds, t


def fused_scan_xor_plain(db_words, roots, t_roots, cw_seed_lv, cw_t_lv, *,
                         rounds: int = 12) -> torch.Tensor:
    """Plain PyTorch expand + mask + fold, the kernel's exact function.

    ``db_words [R, W]``, ``roots [Q, C, 4]``, ``t_roots [Q, C]``,
    ``cw_seed_lv [Q, clog, 4]``, ``cw_t_lv [Q, clog, 2]`` -> ``[Q, W]``.
    Chunks are processed in blocks so the temporaries stay bounded.
    """
    r, w = db_words.shape
    q, c = t_roots.shape
    clog = cw_seed_lv.shape[1]
    if c << clog != r:
        raise ValueError(f"{c} chunk roots x 2^{clog} leaves != rows {r}")
    out = torch.zeros((q, w), dtype=torch.int32, device=db_words.device)
    # bounded by the leaves expanded and by the masked rows [Q, leaves, W]
    leaves = max(q, 1) << clog
    step = max(1, min(_PLAIN_LEAVES // leaves,
                      _PLAIN_MASKED // (leaves * max(w, 1))))
    for lo in range(0, c, step):
        _, bits = _expand(roots[:, lo:lo + step], t_roots[:, lo:lo + step],
                          cw_seed_lv, cw_t_lv, rounds)
        rows = db_words[lo << clog:(lo + bits.shape[1] // (1 << clog)) << clog]
        out ^= xor_fold(-bits[:, :, None] & rows[None], 1)
    return out


def _check_chunking(rows: int, roots, t_roots, cw_seed_lv, cw_t_lv):
    q, c = t_roots.shape
    clog = cw_seed_lv.shape[1]
    if (tuple(roots.shape) != (q, c, 4)
            or tuple(cw_seed_lv.shape) != (q, clog, 4)
            or tuple(cw_t_lv.shape) != (q, clog, 2)):
        raise ValueError(
            f"operand shapes disagree: roots {tuple(roots.shape)}, t_roots "
            f"{tuple(t_roots.shape)}, cw_seed_lv {tuple(cw_seed_lv.shape)}, "
            f"cw_t_lv {tuple(cw_t_lv.shape)}")
    if c << clog != rows:
        raise ValueError(f"{c} chunk roots x 2^{clog} leaves != rows {rows}")


@torch.library.custom_op("repro_torch::fused_scan_xor", mutates_args=(),
                         device_types="cuda")
def _fused_scan_xor_op(db_words: torch.Tensor, roots: torch.Tensor,
                       t_roots: torch.Tensor, cw_seed_lv: torch.Tensor,
                       cw_t_lv: torch.Tensor, rounds: int) -> torch.Tensor:
    build.require_cuda_words("db_words", db_words, 2, align=4)
    build.require_cuda_words("roots", roots, 3)           # uint4 loads
    # read word by word: a level slice of one query's key is contiguous but
    # only 8-byte aligned when it starts at an odd level
    build.require_cuda_words("t_roots", t_roots, 2, align=4)
    build.require_cuda_words("cw_seed_lv", cw_seed_lv, 3, align=4)
    build.require_cuda_words("cw_t_lv", cw_t_lv, 3, align=4)
    r, w = db_words.shape
    q, c = t_roots.shape
    clog = cw_seed_lv.shape[1]
    _check_chunking(r, roots, t_roots, cw_seed_lv, cw_t_lv)
    if len({t.device for t in (db_words, roots, t_roots, cw_seed_lv,
                               cw_t_lv)}) != 1:
        raise ValueError("fused_scan_xor operands are on different devices")
    if clog > 24:
        raise ValueError(f"chunk_log {clog} exceeds the kernel's stack (24)")
    if rounds <= 0 or rounds % 2:
        raise ValueError(f"rounds must be positive and even, got {rounds}")
    out = torch.zeros((q, w), dtype=torch.int32, device=db_words.device)
    if q == 0 or r == 0:
        return out
    lib = build.library("fused_scan_xor")
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.repro_fused_scan_xor(
        p(db_words), p(roots), p(t_roots), p(cw_seed_lv), p(cw_t_lv), p(out),
        r, w, q, c, clog, rounds, ctypes.c_void_p(build.stream_of(db_words)))
    build.check(lib, err, "fused_scan_xor")
    count.launches += 1
    return out


@_fused_scan_xor_op.register_fake
def _fused_scan_xor_fake(db_words, roots, t_roots, cw_seed_lv, cw_t_lv,
                         rounds):
    """The output's shape and dtype, for meta and fake tensors."""
    return db_words.new_empty((t_roots.shape[0], db_words.shape[1]),
                              dtype=torch.int32)


def fused_scan_xor(db_words, roots, t_roots, cw_seed_lv, cw_t_lv, *,
                   rounds: int = 12) -> torch.Tensor:
    """Fused expand + XOR scan, row-major DB.

    Args:
      db_words:   ``[R, W]`` row-major DB shard.
      roots:      ``[Q, C, 4]`` chunk-root seeds (``dpf.eval_roots_batch``).
      t_roots:    ``[Q, C]`` chunk-root control bits.
      cw_seed_lv: ``[Q, clog, 4]`` the last clog levels of ``cw_seed``.
      cw_t_lv:    ``[Q, clog, 2]`` the same levels of ``cw_t``.
    Returns ``[Q, W]``, equal to the materialized bits + dpXOR path. CUDA
    tensors launch the kernel, CPU tensors take the plain version.
    """
    if db_words.device.type == "cpu":
        count.plain_calls += 1
        return fused_scan_xor_plain(db_words, roots, t_roots, cw_seed_lv,
                                    cw_t_lv, rounds=rounds)
    return torch.ops.repro_torch.fused_scan_xor(
        db_words, roots.contiguous(), t_roots.contiguous(),
        cw_seed_lv.contiguous(), cw_t_lv.contiguous(), rounds)


def fused_scan_add_plain(db_bytes, roots, t_roots, cw_seed_lv, cw_t_lv,
                         cw_final, *, party: int, rounds: int = 12
                         ) -> torch.Tensor:
    """Plain PyTorch expand + share conversion + select-add, the kernel's
    exact function (``_fused_add_kernel``).

    ``db_bytes [R, L]`` int8, ``cw_final [Q]`` (payload correction words),
    other operands as :func:`fused_scan_xor_plain` -> ``[Q, L]`` int32.
    Per leaf: word 0 of the leaf seed's ChaCha block at counter 1, the
    Z_256 share ``((conv & 0xFF) + t * (cwf & 0xFF)) & 0xFF`` (negated mod
    256 for party 1), read as int8 and multiplied into the row. Chunks run
    in blocks; partial sums accumulate in int64 and wrap to int32 at the
    end, which equals the int32 GEMM bit for bit.
    """
    r, l = db_bytes.shape
    q, c = t_roots.shape
    clog = cw_seed_lv.shape[1]
    _check_chunking(r, roots, t_roots, cw_seed_lv, cw_t_lv)
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    cwf = cw_final.reshape(q, 1) & 0xFF
    acc = torch.zeros((q, l), dtype=torch.int64, device=db_bytes.device)
    step = max(1, _PLAIN_LEAVES // (max(q, 1) << clog))
    for lo in range(0, c, step):
        seeds, t = _expand(roots[:, lo:lo + step], t_roots[:, lo:lo + step],
                           cw_seed_lv, cw_t_lv, rounds)
        conv = prg_bits(seeds, 1, rounds=rounds)[..., 0] & 0xFF
        share = (conv + t * cwf) & 0xFF
        if party == 1:
            share = (256 - share) & 0xFF
        rows = db_bytes[lo << clog:(lo << clog) + share.shape[1]]
        acc += pir_gemm_plain(share.to(torch.uint8), rows).to(torch.int64)
    return wrap_int32(acc)


@torch.library.custom_op("repro_torch::fused_scan_add", mutates_args=(),
                         device_types="cuda")
def _fused_scan_add_op(db_bytes: torch.Tensor, roots: torch.Tensor,
                       t_roots: torch.Tensor, cw_seed_lv: torch.Tensor,
                       cw_t_lv: torch.Tensor, cw_final: torch.Tensor,
                       party: int, rounds: int) -> torch.Tensor:
    build.require_cuda_bytes("db_bytes", db_bytes)
    build.require_cuda_words("roots", roots, 3)           # uint4 loads
    build.require_cuda_words("t_roots", t_roots, 2, align=4)
    build.require_cuda_words("cw_seed_lv", cw_seed_lv, 3, align=4)
    build.require_cuda_words("cw_t_lv", cw_t_lv, 3, align=4)
    build.require_cuda_words("cw_final", cw_final, 1, align=4)
    r, l = db_bytes.shape
    q, c = t_roots.shape
    clog = cw_seed_lv.shape[1]
    _check_chunking(r, roots, t_roots, cw_seed_lv, cw_t_lv)
    if tuple(cw_final.shape) != (q,):
        raise ValueError(f"cw_final {tuple(cw_final.shape)} is not [{q}]")
    if len({t.device for t in (db_bytes, roots, t_roots, cw_seed_lv,
                               cw_t_lv, cw_final)}) != 1:
        raise ValueError("fused_scan_add operands are on different devices")
    if l % 4:
        raise ValueError(f"fused_scan_add kernel reads whole 4-byte words; "
                         f"got records of {l} bytes")
    if clog > 24:
        raise ValueError(f"chunk_log {clog} exceeds the kernel's stack (24)")
    if rounds <= 0 or rounds % 2:
        raise ValueError(f"rounds must be positive and even, got {rounds}")
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    out = torch.zeros((q, l), dtype=torch.int32, device=db_bytes.device)
    if q == 0 or r == 0:
        return out
    lib = build.library("fused_scan_add")
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.repro_fused_scan_add(
        p(db_bytes), p(roots), p(t_roots), p(cw_seed_lv), p(cw_t_lv),
        p(cw_final), p(out), r, l, q, c, clog, rounds, party,
        ctypes.c_void_p(build.stream_of(db_bytes)))
    build.check(lib, err, "fused_scan_add")
    count_add.launches += 1
    return out


@_fused_scan_add_op.register_fake
def _fused_scan_add_fake(db_bytes, roots, t_roots, cw_seed_lv, cw_t_lv,
                         cw_final, party, rounds):
    """The output's shape and dtype, for meta and fake tensors."""
    return db_bytes.new_empty((t_roots.shape[0], db_bytes.shape[1]),
                              dtype=torch.int32)


def fused_scan_add(db_bytes, roots, t_roots, cw_seed_lv, cw_t_lv, cw_final,
                   *, party: int, rounds: int = 12) -> torch.Tensor:
    """Fused expand + select-add over the int8 byte view, row-major DB.

    Args:
      db_bytes:   ``[R, L]`` int8 DB shard (``Database.view("bytes")``).
      roots, t_roots, cw_seed_lv, cw_t_lv: as :func:`fused_scan_xor`.
      cw_final:   ``[Q]`` payload correction words (word 0 of each key's).
      party:      0 or 1 (party 1 negates its shares mod 256).
    Returns ``[Q, L]`` int32, equal to ``eval_bytes_batch`` + the int8
    GEMM. CUDA tensors launch the kernel, CPU tensors take the plain
    version.
    """
    if db_bytes.device.type == "cpu":
        count_add.plain_calls += 1
        return fused_scan_add_plain(db_bytes, roots, t_roots, cw_seed_lv,
                                    cw_t_lv, cw_final, party=party,
                                    rounds=rounds)
    return torch.ops.repro_torch.fused_scan_add(
        db_bytes, roots.contiguous(), t_roots.contiguous(),
        cw_seed_lv.contiguous(), cw_t_lv.contiguous(), cw_final.contiguous(),
        party, rounds)
