"""Two-party GGM-tree DPF, the port of ``repro/core/dpf.py``.

Same construction (Gilboa–Ishai with Boyle–Gilboa–Ishai correction words,
ChaCha as the length-doubling PRG) and the same outputs bit for bit. The
reference ``vmap``s one-key functions over a query batch; here the batch is
an explicit leading ``Q`` axis on every key tensor, so the server-side
evaluators take *batched* keys (``stack_keys``).

Output modes:

bits   leaf control bits t(j), t0(j) XOR t1(j) = 1{j == alpha}: the
       selection vector of the dpXOR scan (``xor-dpf-2``, ``xor-dpf-k``).
bytes  additive shares over Z_256, y0(j) + y1(j) = 1{j == alpha} mod 256:
       the int8 GEMM's operand (``additive-dpf-2``; keys made with
       ``payload=[1]``). Shares are ``uint8``; the GEMM reads them as int8
       through ``.view(torch.int8)``, never by value conversion.
words  additive shares over Z_2^32 of a ``[W]`` payload,
       y0(j) + y1(j) = beta * 1{j == alpha} (``leaf_words``; keys made with
       ``payload=beta``).

All words are int32 tensors holding u32 bits (package docstring).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.crypto.chacha import (ggm_double, ggm_double_np, prg_bits,
                                      prg_bits_np)


@dataclass
class DPFKey:
    """One party's DPF key, or a batch of them (leading ``Q`` axis).

    Attributes:
      party:     0 or 1.
      log_n:     tree depth = log2(domain size).
      root_seed: ``[..., 4]`` 128-bit root seed.
      cw_seed:   ``[..., log_n, 4]`` per-level seed correction words.
      cw_t:      ``[..., log_n, 2]`` per-level (tL, tR) control corrections.
      cw_final:  ``[..., W]`` payload correction (None in bit mode).
      rounds:    PRG rounds.
    """
    party: int
    log_n: int
    root_seed: torch.Tensor
    cw_seed: torch.Tensor
    cw_t: torch.Tensor
    cw_final: Optional[torch.Tensor] = None
    rounds: int = 12

    def to(self, device, non_blocking: bool = False) -> "DPFKey":
        return map_keys(self, lambda x: x.to(device,
                                             non_blocking=non_blocking))


def map_keys(keys: DPFKey, fn) -> DPFKey:
    """Apply ``fn`` to every key tensor (``cw_final`` stays None if so)."""
    return replace(keys, root_seed=fn(keys.root_seed),
                   cw_seed=fn(keys.cw_seed), cw_t=fn(keys.cw_t),
                   cw_final=None if keys.cw_final is None
                   else fn(keys.cw_final))


# ---------------------------------------------------------------------------
# Key generation (client side; paper Algorithm 1, GENERATEANDSENDKEYS)
# ---------------------------------------------------------------------------

def draw_roots(rng: np.random.Generator) -> np.ndarray:
    """One index's two 4-word root seeds, ``[2, 4]`` uint32, drawn as the
    reference's ``gen_keys`` draws them (``dpf.py:92-95``)."""
    return np.stack([rng.integers(0, 1 << 32, size=4, dtype=np.uint32)
                     for _ in range(2)])


def gen_keys_batch(rng: np.random.Generator, alphas: Sequence[int],
                   log_n: int, *, payload=None, rounds: int = 12
                   ) -> Tuple[DPFKey, DPFKey]:
    """Key pairs for many indices at once: batched ``(k0, k1)``.

    Draws from ``rng`` exactly as the reference's ``gen_keys`` does, one
    index after another (two 4-word root seeds each), so the keys equal
    ``stack_keys`` of per-index ``gen_keys`` calls on the same generator.
    The level loop then runs once for the whole batch (``keys_from_roots``).
    ``payload`` (``[W]`` u32, the same for every index) adds ``cw_final``.
    """
    alphas = [int(a) for a in alphas]
    check_alphas(alphas, log_n)
    roots = np.empty((len(alphas), 2, 4), np.uint32)
    for i in range(len(alphas)):
        roots[i] = draw_roots(rng)
    return keys_from_roots(roots, alphas, log_n, payload=payload,
                           rounds=rounds)


def check_alphas(alphas: Sequence[int], log_n: int):
    for a in alphas:
        if not (0 <= a < (1 << log_n)):
            raise ValueError(f"alpha={a} out of domain 2^{log_n}")


def keys_from_roots(roots: np.ndarray, alphas: Sequence[int], log_n: int, *,
                    payload=None, rounds: int = 12
                    ) -> Tuple[DPFKey, DPFKey]:
    """Gen for a batch whose root seeds are already drawn: ``roots [Q, 2,
    4]`` uint32 (parties 0 and 1 per index) -> batched ``(k0, k1)``.

    The level loop of the reference's ``gen_keys`` (``dpf.py:96-120``) on a
    leading Q axis. With ``payload`` (``[W]`` u32, the reference's ``beta``)
    it adds ``cw_final`` as ``dpf.py:122-131`` does, from ``prg_bits_np`` of
    each party's final seed, in u32 wraparound and negated where party 1's
    final t is 1. That draws nothing more from any generator.
    """
    alphas = [int(a) for a in alphas]
    check_alphas(alphas, log_n)
    q = len(alphas)
    # the level loop runs in numpy on the host (``chacha.ggm_double_np``):
    # u32 words, and the key tensors are made from the results at the end
    s = np.ascontiguousarray(roots, np.uint32).reshape(q, 2, 4)  # [Q, 2, 4]
    root = s.copy()
    t = np.tile(np.array([0, 1], np.uint32), (q, 1))             # [Q, 2]
    alpha = np.asarray(alphas, np.int64)
    cw_seeds, cw_ts = [], []
    for level in range(log_n):
        bit = ((alpha >> (log_n - 1 - level)) & 1).astype(np.uint32)  # [Q]
        s_l, t_l, s_r, t_r = ggm_double_np(s, rounds=rounds)
        right = bit.astype(bool)
        s_cw = np.where(right[:, None], s_l[:, 0] ^ s_l[:, 1],
                        s_r[:, 0] ^ s_r[:, 1])                     # [Q, 4]
        t_cw_l = t_l[:, 0] ^ t_l[:, 1] ^ bit ^ np.uint32(1)
        t_cw_r = t_r[:, 0] ^ t_r[:, 1] ^ bit
        cw_seeds.append(s_cw)
        cw_ts.append(np.stack([t_cw_l, t_cw_r], axis=-1))
        keep_s = np.where(right[:, None, None], s_r, s_l)         # [Q, 2, 4]
        keep_t = np.where(right[:, None], t_r, t_l)              # [Q, 2]
        keep_t_cw = np.where(right, t_cw_r, t_cw_l)              # [Q]
        s = keep_s ^ (t[..., None] * s_cw[:, None, :])
        t = keep_t ^ (t & keep_t_cw[:, None])
    words = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, np.uint32).view(np.int32))
    cw_seed = words(np.stack(cw_seeds, axis=1) if log_n
                    else np.zeros((q, 0, 4), np.uint32))
    cw_t = words(np.stack(cw_ts, axis=1) if log_n
                 else np.zeros((q, 0, 2), np.uint32))
    cw_final = None
    if payload is not None:
        beta = np.asarray(payload, dtype=np.uint32)
        conv = prg_bits_np(s, int(beta.shape[-1]), rounds=rounds)  # [Q, 2, W]
        diff = beta - conv[:, 0] + conv[:, 1]                      # u32 wrap
        cw_final = words(np.where(t[:, 1:2] == 1, np.uint32(0) - diff, diff))
    root = words(root)
    return tuple(DPFKey(party=b, log_n=log_n, root_seed=root[:, b].clone(),
                        cw_seed=cw_seed, cw_t=cw_t, cw_final=cw_final,
                        rounds=rounds)
                 for b in (0, 1))


def gen_keys(rng: np.random.Generator, alpha: int, log_n: int, *,
             payload=None, rounds: int = 12) -> Tuple[DPFKey, DPFKey]:
    """Gen(1^λ, α, β) -> (k0, k1) for one index (unbatched keys)."""
    return tuple(key_at(k, 0) for k in
                 gen_keys_batch(rng, [alpha], log_n, payload=payload,
                                rounds=rounds))


# ---------------------------------------------------------------------------
# Evaluation (server side; paper Algorithm 1, EVALUATEDPF — on the device)
# ---------------------------------------------------------------------------

def _expand_level(seeds, t_bits, cw_seed_l, cw_t_l, rounds):
    """One breadth-first level for a batch: [Q, m, 4] -> [Q, 2m, 4].

    Children are interleaved so leaf j sits at index j.
    """
    s_l, t_l, s_r, t_r = ggm_double(seeds, rounds=rounds)
    mask = t_bits[..., None] * cw_seed_l[:, None, :]
    s_l = s_l ^ mask
    s_r = s_r ^ mask
    t_l = t_l ^ (t_bits & cw_t_l[:, 0:1])
    t_r = t_r ^ (t_bits & cw_t_l[:, 1:2])
    q, m = t_bits.shape
    seeds2 = torch.stack([s_l, s_r], dim=2).reshape(q, 2 * m, 4)
    t2 = torch.stack([t_l, t_r], dim=2).reshape(q, 2 * m)
    return seeds2, t2


def eval_to_depth(keys: DPFKey, start_block: int, log_range: int,
                  stop_log: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk roots of a leaf range, for a batch of keys.

    Leaves ``[start_block * 2^log_range, (start_block+1) * 2^log_range)``:
    descend ``log_n - log_range`` levels along the bits of ``start_block``
    (MSB first), then expand breadth-first, stopping ``stop_log`` levels
    above the leaves. Returns the corrected subtree roots of the range's
    ``2^(log_range - stop_log)`` chunks: seeds ``[Q, C, 4]``, t ``[Q, C]``.
    """
    if log_range > keys.log_n:
        raise ValueError("log_range exceeds domain")
    if not (0 <= stop_log <= log_range):
        raise ValueError(f"stop_log={stop_log} outside [0, {log_range}]")
    depth = keys.log_n - log_range
    seeds = keys.root_seed
    t = torch.full(seeds.shape[:1], keys.party, dtype=torch.int32,
                   device=seeds.device)
    for level in range(depth):
        bit = (int(start_block) >> (depth - 1 - level)) & 1
        s_l, t_l, s_r, t_r = ggm_double(seeds, rounds=keys.rounds)
        s_cw = keys.cw_seed[:, level]
        t_cw = keys.cw_t[:, level]
        if bit:
            seeds, t = s_r ^ (t[:, None] * s_cw), t_r ^ (t & t_cw[:, 1])
        else:
            seeds, t = s_l ^ (t[:, None] * s_cw), t_l ^ (t & t_cw[:, 0])
    seeds, t = seeds[:, None, :], t[:, None]
    for level in range(depth, keys.log_n - stop_log):
        seeds, t = _expand_level(seeds, t, keys.cw_seed[:, level],
                                 keys.cw_t[:, level], keys.rounds)
    return seeds, t


def eval_range(keys: DPFKey, start_block: int, log_range: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All leaves of a range: seeds ``[Q, 2^log_range, 4]``, t ``[Q, ...]``."""
    return eval_to_depth(keys, start_block, log_range, 0)


def eval_all(keys: DPFKey) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-domain evaluation (``dpf.py:207`` upstream), the plain descent:
    seeds ``[Q, 2^log_n, 4]`` and t ``[Q, 2^log_n]`` of a batch, or
    ``[2^log_n, 4]`` and ``[2^log_n]`` of one unbatched key."""
    if keys.root_seed.dim() == 1:
        seeds, t = eval_range(map_keys(keys, lambda x: x[None]), 0,
                              keys.log_n)
        return seeds[0], t[0]
    return eval_range(keys, 0, keys.log_n)


def eval_roots_batch(keys: DPFKey, start_block: int, log_range: int,
                     stop_log: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk roots for the fused kernel (the reference's vmapped
    ``eval_to_depth``): seeds ``[Q, C, 4]``, t ``[Q, C]``."""
    return eval_to_depth(keys, start_block, log_range, stop_log)


def eval_bits_batch(keys: DPFKey, start_block: int, log_range: int
                    ) -> torch.Tensor:
    """Selection bits of a leaf range: ``[Q, 2^log_range]`` int32."""
    return eval_range(keys, start_block, log_range)[1]


def leaf_bits(t_bits: torch.Tensor) -> torch.Tensor:
    """Selection bits of the dpXOR scan from leaf control bits (the paper's
    Eval(k, j) values), int32 (``dpf.py:271`` upstream)."""
    return t_bits.to(torch.int32)


def leaf_words(keys: DPFKey, seeds: torch.Tensor, t_bits: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """Additive payload shares over Z_2^32 (``dpf.py:276`` upstream):
    ``y_b(j) = (-1)^b (convert(s_j) + t_j cw_final)`` mod 2^32, so the two
    parties' shares sum to ``beta * 1{j == alpha}``.

    ``seeds [..., n, 4]``, ``t_bits [..., n]`` of one key or of a batch
    (``cw_final [W]`` or ``[Q, W]``) -> ``[..., n, n_words]`` int32 words;
    the conversion words are ``prg_bits`` of each leaf seed. int32 adds
    and negation wrap mod 2^32, as u32 arithmetic does.
    """
    if keys.cw_final is None:
        raise ValueError("key was generated without a payload")
    conv = prg_bits(seeds, n_words, rounds=keys.rounds)
    share = conv + t_bits[..., None] * keys.cw_final[..., None, :n_words]
    if keys.party == 1:
        share = (~share) + 1                  # negate mod 2^32
    return share


def leaf_bytes(keys: DPFKey, seeds: torch.Tensor, t_bits: torch.Tensor
               ) -> torch.Tensor:
    """Additive Z_256 shares of a batch's leaves (``dpf.py:293-307``
    upstream): ``seeds [Q, n, 4]``, ``t_bits [Q, n]`` -> ``[Q, n]`` uint8.

    Word 0 of each leaf seed's conversion block (ChaCha counter 1), masked
    to a byte, plus ``t * (cw_final[0] & 0xFF)``, mod 256; party 1 negates
    mod 256. Keys must carry ``cw_final`` (``payload=[1]``).
    """
    if keys.cw_final is None:
        raise ValueError("key was generated without a payload")
    conv = prg_bits(seeds, 1, rounds=keys.rounds)[..., 0] & 0xFF
    share = (conv + t_bits * (keys.cw_final[..., 0:1] & 0xFF)) & 0xFF
    if keys.party == 1:
        share = (256 - share) & 0xFF
    return share.to(torch.uint8)


def eval_bytes_batch(keys: DPFKey, start_block: int, log_range: int
                     ) -> torch.Tensor:
    """Z_256 additive shares of a leaf range: ``[Q, 2^log_range]`` uint8
    (``dpf.py:356-363`` upstream)."""
    seeds, t = eval_range(keys, start_block, log_range)
    return leaf_bytes(keys, seeds, t)


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def stack_keys(keys: Sequence[DPFKey]) -> DPFKey:
    """Stack same-shape unbatched keys into one batch (leading ``Q``)."""
    k0 = keys[0]
    for k in keys[1:]:
        if (k.party, k.log_n, k.rounds) != (k0.party, k0.log_n, k0.rounds):
            raise ValueError("cannot stack keys of different party/log_n/rounds")
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    return replace(k0, root_seed=stack([k.root_seed for k in keys]),
                   cw_seed=stack([k.cw_seed for k in keys]),
                   cw_t=stack([k.cw_t for k in keys]),
                   cw_final=stack([k.cw_final for k in keys]))


def key_at(keys: DPFKey, i: int) -> DPFKey:
    """Query ``i`` of a batch, as an unbatched key."""
    return map_keys(keys, lambda x: x[i])


def n_queries_of(keys: DPFKey) -> int:
    """Leading (query) axis length of a batch of keys."""
    return int(keys.root_seed.shape[0])


def pad_keys(keys: DPFKey, n_total: int) -> DPFKey:
    """Pad a batch to ``n_total`` queries by replicating the last key.

    Every pad slot is a valid key (``dpf.py:333`` upstream), so the serve
    step evaluates it like any other query and the caller drops its answer.
    """
    q = n_queries_of(keys)
    if n_total < q:
        raise ValueError(f"cannot pad {q} queries down to {n_total}")
    if n_total == q:
        return keys

    def pad(x):
        tail = x[-1:].expand((n_total - q,) + tuple(x.shape[1:]))
        return torch.cat([x, tail], dim=0)

    return map_keys(keys, pad)
