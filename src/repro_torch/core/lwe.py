"""LWE machinery of the single-server ``lwe-simple-1`` scheme.

Port of ``repro/core/lwe.py`` (which imports JAX, so the numpy pieces are
copied here, not imported). Everything lives in Z_q with q = 2^32:

  client secret   s  in Z_q^n
  public matrix   A  in Z_q^{N x n}   -- regenerated from ``a_seed``; never
                                         shipped
  query           ct = A.s + e + Delta * onehot(alpha)   in Z_q^N
  server answer   ans = ct^T . D     (D = byte matrix [N, L], 0..255)
  server hint     H  = A^T . D       in Z_q^{n x L}
  reconstruct     m = round((ans - s^T.H) / Delta) mod p

with p = 256 and Delta = q / p = 2^24. ``LWEParams.validate`` asserts the
tail bound TAIL * sigma * (p - 1) * sqrt(N) < q / (2p), so a parameter row
that cannot decode a DB size raises. The parameters are the reference's
demonstration-grade table, not a security review.

Where the reference computes on the host in numpy uint64, the port
computes on the device in int32 with the same bits: the client's A.S and
the hint A^T.D are wrapping int32 products through ``ops.lwe_gemm`` (the
int32 GEMM kernel on the card; CUDA PyTorch has no integer matmul), and
adds wrap mod 2^32 as the reference's ``& 0xFFFFFFFF`` does. Decoding
stays on the host in numpy uint64, as upstream.

A is drawn exactly as the reference's single ``rng.integers(0, 2**32,
size=(N, n), dtype=np.uint64)`` call draws it: that call takes one 32-bit
output of PCG64 per entry, two per 64-bit step, so rows ``[r0, r1)`` are a
fresh generator advanced by ``r0 * n / 2`` steps. ``matrix_a_device``
draws row chunks that way on several host threads and copies each chunk
to the device as int32, so the host never holds the whole matrix; a row
block of a database sharded over a mesh draws only its own rows.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.backend import Device, resolve_device

LWE_Q = 1 << 32          # ciphertext modulus: native 32-bit wraparound
LWE_P = 256              # plaintext modulus: one DB byte per slot
TAIL = 8.0               # subgaussian tail factor for the noise bound

_MASK = np.uint64(0xFFFFFFFF)

#: rows of A drawn per host task (64 MiB of uint32 at n = 1024)
A_CHUNK_ROWS = 1 << 14


# ---------------------------------------------------------------------------
# Parameters (``lwe.py:67-141`` upstream, same values)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LWEParams:
    """One LWE parameter set; all correctness conditions are methods.

    n        secret dimension (hint rows)
    sigma    Gaussian error stddev (rounded to integers at sample time)
    p        plaintext modulus; must divide q so Delta = q/p is exact
    a_seed   PRG seed both sides use to regenerate A (never shipped)
    """
    n: int
    sigma: float
    p: int = LWE_P
    a_seed: int = 0x1317

    @property
    def q(self) -> int:
        return LWE_Q

    @property
    def delta(self) -> int:
        """Plaintext scale Delta = q/p."""
        return LWE_Q // self.p

    @property
    def noise_budget(self) -> int:
        """Decoding succeeds iff |accumulated noise| < q/(2p) = Delta/2."""
        return LWE_Q // (2 * self.p)

    def noise_bound(self, n_items: int) -> float:
        """Tail bound on |e^T.d|: TAIL * sigma * (p-1) * sqrt(N)."""
        return TAIL * self.sigma * (self.p - 1) * float(np.sqrt(n_items))

    def validate(self, n_items: int) -> "LWEParams":
        """Raise unless this parameter set decodes a DB of ``n_items`` rows."""
        if LWE_Q % self.p:
            raise ValueError(f"p={self.p} must divide q=2^32 for exact Delta")
        if self.n < 1 or self.sigma <= 0:
            raise ValueError(f"degenerate LWE parameters: n={self.n}, "
                             f"sigma={self.sigma}")
        bound = self.noise_bound(n_items)
        if bound >= self.noise_budget:
            raise ValueError(
                f"LWE noise bound {bound:.3g} >= budget q/(2p)="
                f"{self.noise_budget} for N={n_items}: parameters "
                f"(n={self.n}, sigma={self.sigma}, p={self.p}) cannot "
                f"guarantee exact reconstruction at this DB size")
        return self


#: (max_items, params): the first row whose max_items covers the DB wins
PARAM_TABLE: Tuple[Tuple[int, LWEParams], ...] = (
    (1 << 16, LWEParams(n=128, sigma=6.4)),
    (1 << 20, LWEParams(n=512, sigma=3.2)),
    (1 << 25, LWEParams(n=1024, sigma=0.5)),
)


def params_for(n_items: int) -> LWEParams:
    """Select + validate the parameter row covering a DB of ``n_items``."""
    for max_items, params in PARAM_TABLE:
        if n_items <= max_items:
            return params.validate(n_items)
    raise ValueError(
        f"no LWE parameter set covers N={n_items} "
        f"(table max {PARAM_TABLE[-1][0]}); extend PARAM_TABLE with a "
        f"row that passes LWEParams.validate({n_items})")


# ---------------------------------------------------------------------------
# Public matrix A (seeded; regenerated, never shipped)
# ---------------------------------------------------------------------------

def matrix_a_rows(a_seed: int, n: int, r0: int, r1: int) -> np.ndarray:
    """Rows ``[r0, r1)`` of A as ``[r1 - r0, n]`` uint32, equal to the
    same rows of the reference's one-call draw (``r0 * n`` must be even:
    a chunk starts on a whole 64-bit PCG64 step)."""
    if (r0 * n) % 2:
        raise ValueError(f"row {r0} x n={n} starts inside a 64-bit step")
    bits = np.random.PCG64(a_seed)
    bits.advance(r0 * n // 2)
    return np.random.Generator(bits).integers(
        0, LWE_Q, size=(r1 - r0, n), dtype=np.uint32)


def matrix_a(params: LWEParams, n_items: int) -> np.ndarray:
    """A in Z_q^{N x n} as host uint64 (values < 2^32), drawn in one call
    exactly as the reference. For tests and the ``hint_np`` oracle; served
    code uses :func:`matrix_a_device`."""
    rng = np.random.default_rng(params.a_seed)
    return rng.integers(0, LWE_Q, size=(n_items, params.n), dtype=np.uint64)


_A_CACHE: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_A_CACHE_SIZE = 8
_A_LOCK = threading.Lock()


def matrix_a_device(params: LWEParams, n_items: int,
                    device: Device = None, *,
                    rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A as an int32 ``[N, n]`` tensor on ``device`` (same bits as
    :func:`matrix_a`), drawn in row chunks of ``A_CHUNK_ROWS`` on up to one
    host thread per core and copied chunk by chunk. With ``rows=(r0, r1)``
    only those rows, ``[r1 - r0, n]``: a database's row block on a mesh
    draws its own rows, never the whole matrix; where the whole matrix is
    already cached on the device (the client's rank), the block is a view
    of it.

    Cached per (seed, n, N, rows, device), as the reference caches per
    (seed, n, N): the client's encryption and the hint builder share it.
    """
    # the device a tensor lands on ("cuda" -> "cuda:0"), so that every
    # caller's spelling of one card finds the same copy
    dev = torch.empty(0, device=resolve_device(device)).device
    r0, r1 = (0, n_items) if rows is None else rows
    if not 0 <= r0 < r1 <= n_items:
        raise ValueError(f"rows {rows} outside [0, {n_items})")
    whole = (params.a_seed, params.n, n_items, (0, n_items), str(dev))
    key = whole[:3] + ((r0, r1), str(dev))
    with _A_LOCK:
        for k in (key, whole):
            if k in _A_CACHE:
                _A_CACHE.move_to_end(k)
                a = _A_CACHE[k]
                return a if k == key else a[r0:r1]
        n = params.n
        out = torch.empty((r1 - r0, n), dtype=torch.int32, device=dev)
        step = A_CHUNK_ROWS + (A_CHUNK_ROWS * n) % 2     # whole 64-bit steps
        starts = range(r0, r1, step)

        def fill(c0: int):
            c1 = min(c0 + step, r1)
            chunk = matrix_a_rows(params.a_seed, n, c0, c1)
            out[c0 - r0:c1 - r0].copy_(torch.from_numpy(chunk.view(np.int32)))

        workers = max(1, min(len(starts), os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(fill, starts))
        _A_CACHE[key] = out
        while len(_A_CACHE) > _A_CACHE_SIZE:
            _A_CACHE.popitem(last=False)
        return out


def clear_matrix_cache():
    """Drop every cached device copy of A (frees its device memory)."""
    with _A_LOCK:
        _A_CACHE.clear()


# ---------------------------------------------------------------------------
# Ciphertexts + client state
# ---------------------------------------------------------------------------

@dataclass
class LWECiphertext:
    """LWE query ciphertexts: ``ct`` is int32 ``[N]`` or ``[Q, N]`` (Z_q
    elements with their u32 bits); ``log_n`` and ``n`` as upstream."""
    ct: torch.Tensor
    log_n: int
    n: int

    def map(self, fn) -> "LWECiphertext":
        return LWECiphertext(ct=fn(self.ct), log_n=self.log_n, n=self.n)

    def to(self, device, non_blocking: bool = False) -> "LWECiphertext":
        return self.map(lambda x: x.to(device, non_blocking=non_blocking))


@dataclass
class LWEClientState:
    """Per-query client secret; stays on the client, never serialized."""
    s: np.ndarray          # [n] uint64 (values < 2^32)
    index: int


def stack_ciphertexts(cts: Sequence[LWECiphertext]) -> LWECiphertext:
    """``[N]`` ciphertexts -> one ``[Q, N]`` batch."""
    first = cts[0]
    return LWECiphertext(ct=torch.stack([c.ct for c in cts]),
                         log_n=first.log_n, n=first.n)


# ---------------------------------------------------------------------------
# Client: encrypt (draws on the host, A.S on the device) / decode (host)
# ---------------------------------------------------------------------------

def sample_batch(rng: np.random.Generator, indices: Sequence[int],
                 n_items: int, params: LWEParams
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The client's random draws for a batch: secrets ``[Q, n]`` uint64 and
    rounded noise ``[Q, N]`` int32. Per query, ``s`` (n integers) and then
    ``e`` are drawn, in the reference's ``encrypt`` order."""
    q = len(indices)
    for index in indices:
        if not 0 <= int(index) < n_items:
            raise ValueError(f"index {index} out of range for N={n_items}")
    s = np.empty((q, params.n), np.uint64)
    e = np.empty((q, n_items), np.int32)
    for i in range(q):
        s[i] = rng.integers(0, LWE_Q, size=params.n, dtype=np.uint64)
        e[i] = np.rint(rng.normal(0.0, params.sigma, size=n_items))
    return s, e


def encrypt_with(s: np.ndarray, e: np.ndarray, indices: Sequence[int],
                 n_items: int, params: LWEParams, device: Device = None
                 ) -> LWECiphertext:
    """ct = A.s + e + Delta * onehot(index) mod 2^32 for drawn ``(s, e)``,
    computed on ``device``: A.S^T is one wrapping int32 product through
    ``ops.lwe_gemm``, and the adds wrap in int32."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    a = matrix_a_device(params, n_items, dev)                 # [N, n]
    s_t = torch.from_numpy(np.ascontiguousarray(
        s.T.astype(np.uint32)).view(np.int32)).to(dev)        # [n, Q]
    ct = ops.lwe_gemm(a, s_t).t().contiguous()                # [Q, N]
    ct += torch.from_numpy(e).to(dev)
    rows = torch.arange(len(indices), device=dev)
    cols = torch.as_tensor([int(i) for i in indices], device=dev)
    ct[rows, cols] += params.delta
    return LWECiphertext(ct=ct, log_n=(n_items - 1).bit_length(), n=params.n)


def encrypt(rng: np.random.Generator, index: int, n_items: int,
            params: LWEParams, device: Device = None
            ) -> Tuple[LWECiphertext, LWEClientState]:
    """ct = A.s + e + Delta * onehot(index) mod 2^32 with fresh ``(s, e)``
    for one query (``lwe.py:197`` upstream): :func:`encrypt_batch` of
    ``[index]``, so the same draws, and A.s in one ``lwe_gemm`` launch on
    the card. ``ct`` is ``[N]``."""
    ct, states = encrypt_batch(rng, [index], n_items, params, device)
    return ct.map(lambda x: x[0]), states[0]


def encrypt_batch(rng: np.random.Generator, indices: Sequence[int],
                  n_items: int, params: LWEParams, device: Device = None
                  ) -> Tuple[LWECiphertext, List[LWEClientState]]:
    """Batched ``encrypt`` (``lwe.py:197`` upstream): ``[Q, N]`` ciphertexts
    and one client state per query, with the rng drawn as a loop of the
    reference's ``encrypt`` draws it, so a seeded run gives the same
    ciphertexts."""
    s, e = sample_batch(rng, indices, n_items, params)
    ct = encrypt_with(s, e, indices, n_items, params, device)
    return ct, [LWEClientState(s=s[i], index=int(idx))
                for i, idx in enumerate(indices)]


def decode(answers_i32: np.ndarray, secrets: np.ndarray, hint: np.ndarray,
           params: LWEParams) -> Tuple[np.ndarray, np.ndarray]:
    """Modulus-switching reconstruction for a batch of queries (host).

    answers_i32: [Q, L] int32 server answers (ct^T.D mod q)
    secrets:     [Q, n] uint64 client secrets
    hint:        [n, L] hint matrix H = A^T.D mod q (uint64 values < 2^32)

    Returns (records [Q, L] uint8, noise [Q, L] int64), the noise being the
    recovered centered error e^T.D.
    """
    ans = np.asarray(answers_i32).view(np.uint32).astype(np.uint64)
    noisy = (ans - (secrets.astype(np.uint64) @ hint)) & _MASK
    delta = np.uint64(params.delta)
    m = (((noisy + delta // np.uint64(2)) // delta) % np.uint64(params.p))
    # centered residual noise: noisy - Delta*m, wrapped into (-q/2, q/2]
    err = (noisy - delta * m) & _MASK
    err = err.astype(np.int64)
    err[err >= LWE_Q // 2] -= LWE_Q
    return m.astype(np.uint8), err


# ---------------------------------------------------------------------------
# Server: hint oracle + device builder
# ---------------------------------------------------------------------------

def hint_np(params: LWEParams, db_bytes_u8: np.ndarray) -> np.ndarray:
    """Numpy hint oracle: H = A^T.D mod q as uint64 (values < 2^32)."""
    a = matrix_a(params, len(db_bytes_u8))
    return (a.T @ db_bytes_u8.astype(np.uint64)) & _MASK


def hint_build_fn(params: LWEParams, n_items: int):
    """Device hint builder: words ``[N, W]`` int32 -> H ``[n, L]`` int32.

    H = A^T.D is computed as (D^T.A)^T, so the product has the answer's
    shape family (small M, long K) and A is read as stored (``[N, n]``
    row-major); A comes from :func:`matrix_a_device` on the words' device.

    ``row0`` is the global row of ``words[0]``: a row block of a database
    sharded over a mesh passes its first row and gets its block's partial
    ``A_block^T.D_block`` (rows of A drawn for the block alone), which the
    database sums over the blocks; 0, the whole database, off a mesh.
    """
    def build(words: torch.Tensor, row0: int = 0) -> torch.Tensor:
        from repro_torch.crypto.packing import words_to_bytes_i32
        from repro_torch.kernels import ops
        a = matrix_a_device(params, n_items, words.device,
                            rows=(row0, row0 + words.shape[0]))  # [B, n]
        d_t = words_to_bytes_i32(words).t().contiguous()      # [L, B]
        return ops.lwe_gemm(d_t, a).t().contiguous()          # [n, L]

    return build


def hint_delta_operands(params: LWEParams, n_items: int, rows,
                        old_words: torch.Tensor, new_words: torch.Tensor,
                        row0: int = 0, n_rows: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two operands of a hint delta's int32 GEMM: ``Delta^T [L, R4]``
    (the byte changes of the published rows, zero rows up to R4, the next
    multiple of 4, which the kernel needs for K) and ``A[rows] [R4, n]``
    (zero rows past R), on the words' device. ``rows`` are global; their
    rows of A come from the block ``[row0, row0 + n_rows)`` that holds
    them (the whole of A off a mesh)."""
    from repro_torch.crypto.packing import words_to_bytes_i32
    dev = new_words.device
    n_rows = n_items - row0 if n_rows is None else n_rows
    a = matrix_a_device(params, n_items, dev,
                        rows=(row0, row0 + n_rows))              # [B, n]
    d = words_to_bytes_i32(new_words) - words_to_bytes_i32(old_words)
    r = d.shape[0]
    r4 = -(-r // 4) * 4
    d_t = torch.zeros((d.shape[1], r4), dtype=torch.int32, device=dev)
    d_t[:, :r] = d.t()
    a_rows = torch.zeros((r4, a.shape[1]), dtype=torch.int32, device=dev)
    a_rows[:r] = a[torch.as_tensor(np.asarray(rows, np.int64) - row0,
                                   device=dev)]
    return d_t, a_rows


def hint_delta_fn(params: LWEParams, n_items: int):
    """Device hint delta (``lwe.py:264-286`` upstream): ``H += A[rows]^T.
    (D_new - D_old)`` mod q, into a new tensor (the retired epoch keeps its
    hint: a batch tagged with it decodes with it).

    Exact: int32 wraparound keeps every term in Z_q, so the result equals
    a full rebuild byte for byte. ``rows`` must be deduplicated: a repeated
    row would subtract its old value twice. In the hint's transposed form
    the update is ``Delta^T . A[rows]`` (``[L, R] x [R, n]``), one call of
    the int32 GEMM, whose kernel needs K = R to be a multiple of 4: Delta
    takes zero rows up to R4, paired with zero rows of A, which add
    nothing (:func:`hint_delta_operands`). On a mesh, ``row0`` and
    ``n_rows`` name the row block that holds ``rows`` (global indices),
    whose rows of A are the only ones drawn.
    """
    def delta(hint: torch.Tensor, rows, old_words: torch.Tensor,
              new_words: torch.Tensor, row0: int = 0,
              n_rows: Optional[int] = None) -> torch.Tensor:
        from repro_torch.kernels import ops
        d_t, a_rows = hint_delta_operands(params, n_items, rows, old_words,
                                          new_words, row0, n_rows)
        return hint + ops.lwe_gemm(d_t, a_rows).t()              # [n, L]

    return delta
