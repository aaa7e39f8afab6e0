"""ChaCha ARX PRG in PyTorch, bit-identical to ``repro/crypto/chacha.py``.

A GGM seed is 128 bits, ``[..., 4]`` words. One ChaCha block keyed by the
seed (both key halves) yields 512 bits; the DPF consumes

  out[0:4] -> left child seed      out[4:8] -> right child seed
  out[8]&1 -> left control bit     out[9]&1 -> right control bit
  out[10:] -> payload-conversion words (additive modes)

The counter and nonce words are ``[counter, 0x5049522D, 0x494D5049,
0x52212121]`` as in the reference, so keystreams match word for word.

Words are ``int32`` tensors holding the u32 bit pattern: torch's CPU
``uint32`` has no add, shift or compare. int32 add, xor and left shift
wrap exactly as u32 does; right shifts are arithmetic, so they are masked.

The block is written in the SIMD form (rows a, b, c, d of four words;
the diagonal round rotates rows b, c, d by 1, 2, 3 lanes), which runs the
reference's quarter rounds in the same order on four columns at once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# "expa nd 3 2-by te k" — the standard ChaCha constants.
SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)

#: counter/nonce words after the block counter (``chacha.py:89`` upstream)
NONCE = np.array([0x5049522D, 0x494D5049, 0x52212121], dtype=np.uint32)

PRG_ROUNDS = {"chacha8": 8, "chacha12": 12, "chacha20": 20}


def _rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | ((x >> (32 - n)) & ((1 << n) - 1))


def _quarter(a, b, c, d):
    a = a + b
    d = _rotl32(d ^ a, 16)
    c = c + d
    b = _rotl32(b ^ c, 12)
    a = a + b
    d = _rotl32(d ^ a, 8)
    c = c + d
    b = _rotl32(b ^ c, 7)
    return a, b, c, d


@functools.lru_cache(maxsize=64)
def _const_rows(device: torch.device, counter: int):
    """The constant and counter/nonce rows as int32 tensors on ``device``,
    made once per (device, counter) so a block issues no host copy."""
    words = lambda v: torch.from_numpy(
        np.asarray(v, np.uint32).view(np.int32)).to(device)
    return words(SIGMA), words(np.concatenate([[counter], NONCE]))


def chacha_block(key4: torch.Tensor, *, counter: int = 0,
                 rounds: int = 12) -> torch.Tensor:
    """ChaCha block keyed by a 128-bit seed: ``[..., 4]`` -> ``[..., 16]``.

    ``key4`` is int32 (u32 bit patterns); the result is too.
    """
    if rounds % 2:
        raise ValueError("rounds must be even")
    key4 = key4.to(torch.int32)
    const, ctr = _const_rows(key4.device, counter & 0xFFFFFFFF)
    const, ctr = const.expand(key4.shape), ctr.expand(key4.shape)
    a, b, c, d = const, key4, key4, ctr
    for _ in range(rounds // 2):
        a, b, c, d = _quarter(a, b, c, d)                 # column round
        b, c, d = (b.roll(-1, -1), c.roll(-2, -1), d.roll(-3, -1))
        a, b, c, d = _quarter(a, b, c, d)                 # diagonal round
        b, c, d = (b.roll(1, -1), c.roll(2, -1), d.roll(3, -1))
    return torch.cat([a + const, b + key4, c + key4, d + ctr], dim=-1)


def ggm_double(seeds: torch.Tensor, *, rounds: int = 12):
    """GGM node doubling: ``[..., 4] -> (sL, tL, sR, tR)``.

    Child seeds are ``[..., 4]`` and control bits ``[...]`` (int32 in {0, 1}).
    """
    blk = chacha_block(seeds, counter=0, rounds=rounds)
    return blk[..., 0:4], blk[..., 8] & 1, blk[..., 4:8], blk[..., 9] & 1


def prg_bits(seeds: torch.Tensor, n_words: int, *,
             rounds: int = 12) -> torch.Tensor:
    """Payload-conversion PRG: each seed -> ``n_words`` words (counter >= 1)."""
    outs = []
    for i in range(0, n_words, 16):
        blk = chacha_block(seeds, counter=1 + i // 16, rounds=rounds)
        outs.append(blk[..., :min(16, n_words - i)])
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# The same PRG on numpy u32 arrays, for the client's keygen on the host
# ---------------------------------------------------------------------------
#
# Keygen runs one tiny block per level for each query. In torch each of its
# few thousand elementwise calls costs several microseconds of dispatch and
# gives up the interpreter lock, so client threads keying at once convoy on
# that lock with each other and with the serving threads. numpy's calls on
# arrays this small cost about a microsecond and keep the lock.

_ROW_SHIFT = [np.array([(i + k) % 4 for i in range(4)]) for k in range(4)]


def _rotl32_np(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter_np(a, b, c, d):
    a = a + b
    d = _rotl32_np(d ^ a, 16)
    c = c + d
    b = _rotl32_np(b ^ c, 12)
    a = a + b
    d = _rotl32_np(d ^ a, 8)
    c = c + d
    b = _rotl32_np(b ^ c, 7)
    return a, b, c, d


def chacha_block_np(key4: np.ndarray, *, counter: int = 0,
                    rounds: int = 12) -> np.ndarray:
    """:func:`chacha_block` on u32 arrays: ``[..., 4] -> [..., 16]``."""
    if rounds % 2:
        raise ValueError("rounds must be even")
    key4 = np.asarray(key4, np.uint32)
    const = np.broadcast_to(SIGMA, key4.shape)
    ctr = np.broadcast_to(np.concatenate(
        [np.array([counter & 0xFFFFFFFF], np.uint32), NONCE]), key4.shape)
    a, b, c, d = const, key4, key4, ctr
    s1, s2, s3 = _ROW_SHIFT[1], _ROW_SHIFT[2], _ROW_SHIFT[3]
    for _ in range(rounds // 2):
        a, b, c, d = _quarter_np(a, b, c, d)              # column round
        b, c, d = b[..., s1], c[..., s2], d[..., s3]
        a, b, c, d = _quarter_np(a, b, c, d)              # diagonal round
        b, c, d = b[..., s3], c[..., s2], d[..., s1]
    return np.concatenate([a + const, b + key4, c + key4, d + ctr], axis=-1)


def ggm_double_np(seeds: np.ndarray, *, rounds: int = 12):
    """:func:`ggm_double` on u32 arrays."""
    blk = chacha_block_np(seeds, counter=0, rounds=rounds)
    return blk[..., 0:4], blk[..., 8] & 1, blk[..., 4:8], blk[..., 9] & 1


def prg_bits_np(seeds: np.ndarray, n_words: int, *,
                rounds: int = 12) -> np.ndarray:
    """:func:`prg_bits` on u32 arrays."""
    outs = []
    for i in range(0, n_words, 16):
        blk = chacha_block_np(seeds, counter=1 + i // 16, rounds=rounds)
        outs.append(blk[..., :min(16, n_words - i)])
    return np.concatenate(outs, axis=-1)
