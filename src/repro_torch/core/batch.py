"""Batch PIR cuckoo layer — m records per round for ~one bucketed scan.

The port's own numpy copy of ``repro/core/batch.py`` (the port imports
nothing of ``repro``); every function returns what the reference's does.
One change: ``CuckooLayout.build`` gathers the slot-ordered row ids once
(the reference regathers them once per bucket, O(N·B): minutes at 2^25
rows) and sorts the bucket ids with a radix sort, which gives the same
stable order.

The paper's throughput thesis is that PIR QPS is bounded by DB streaming
bandwidth; batching is the protocol-plane lever that multiplies *records*
per streamed byte (DESIGN.md §14). The classic construction (Angel et al.
style) splits one retrieval round in two:

Server side (public, query-independent)
    Every record is replicated into ALL of its ``n_hashes`` candidate
    buckets (simple hashing), so whichever bucket the client later picks
    for an index, that bucket's sub-database contains the record. With
    B = c·m buckets each holds ~``n_hashes``·N/B rows.

Client side (per batch, private)
    The m requested indices are *cuckoo hashed* into distinct buckets
    (per-bucket capacity 1, random-walk eviction): index i may only land
    in one of its candidate buckets h_0(i)..h_{H-1}(i), and no bucket
    takes two. Every bucket then receives exactly ONE inner-protocol
    query — a real one for its assigned index's slot, a *dummy* (random
    in-bucket slot) for unassigned buckets — so the per-round traffic is
    a constant B queries regardless of which indices were requested:
    bucket occupancy leaks nothing (the uniform-padding invariant the
    conformance tests pin).

Amortization: one round scans B · capacity ≈ 2·``n_hashes``·N rows (the
power-of-two capacity rounding costs up to 2×) and serves m records —
records per scanned row improve by ~m·B/(B·capacity)·N = m/4 at the
defaults, an *algorithmic* factor on top of whatever kernel serves each
bucket (the inner protocol + engine-tuned plan apply per bucket shape
unchanged).

``CuckooParams.validate`` enforces the analytic failure-probability bound
the same way ``LWEParams.validate`` enforces the noise bound: parameters
that cannot guarantee insertion success with overwhelming probability
raise instead of failing probabilistically at query time. Residual
failures (the bound is O(1/B), not zero) surface as :class:`CuckooFailure`
and the session layer retries the batch split in half — correctness is
never staked on the bound.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import PIRConfig

#: d-ary cuckoo hashing load threshold: below it a valid assignment exists
#: w.h.p. and random-walk insertion succeeds with failure prob O(1/B).
#: alpha*_3 ~= 0.9179 for 3 hash functions; we enforce a margin under it
#: (the bound degrades steeply as alpha -> alpha*).
ALPHA_MAX = 0.8

#: random-walk insertion: eviction steps per item before declaring failure
#: (O(log B) suffices below threshold; the generous constant keeps the
#: residual failure probability at the analytic O(1/B) order).
_WALK_STEPS_PER_ITEM = 64


class CuckooFailure(RuntimeError):
    """Cuckoo insertion exceeded its eviction budget for one batch.

    Probability is bounded by ``CuckooParams.failure_bound`` (O(1/B) below
    the load threshold); the session layer (``runtime/batch.py``) recovers
    by splitting the batch — never by weakening privacy.
    """

    def __init__(self, msg: str, index: Optional[int] = None):
        super().__init__(msg)
        self.index = index

    def __reduce__(self):
        # pickled whole: a mesh's first rank broadcasts a failed plan
        return type(self), (str(self), self.index)


@dataclass(frozen=True)
class CuckooParams:
    """Batch-PIR cuckoo parameters; correctness conditions are methods.

    m         batch size: requested indices per round (capacity of one
              cuckoo assignment).
    c         bucket expansion: B = max(ceil(c·m), 2) buckets. The default
              2.0 keeps B a power of two for power-of-two m, which halves
              the per-bucket capacity rounding waste.
    n_hashes  candidate buckets per index (the paper-standard 3).
    seed      domain-separation seed for the bucket hash family; public
              (the layout is server-side data placement, not key material).
    """
    m: int
    c: float = 2.0
    n_hashes: int = 3
    seed: int = 0x5EEDBA11

    @classmethod
    def from_config(cls, cfg: PIRConfig) -> "CuckooParams":
        return cls(m=cfg.batch_m, c=cfg.cuckoo_c,
                   n_hashes=cfg.cuckoo_hashes, seed=cfg.cuckoo_seed)

    @property
    def n_buckets(self) -> int:
        """B = ceil(c·m), floored at 2 (a 1-bucket table cannot pad)."""
        return max(int(math.ceil(self.c * self.m)), 2)

    @property
    def load_factor(self) -> float:
        """alpha = m / B — the axis the cuckoo threshold bounds."""
        return self.m / self.n_buckets

    def failure_bound(self) -> float:
        """Analytic order bound on one batch's insertion failure.

        Below the load threshold, random-walk d-ary cuckoo insertion of m
        items into B capacity-1 buckets fails with probability O(1/B)
        (the constant absorbed here is 1 — demonstration-grade like the
        LWE table, and the session's split-retry removes any correctness
        stake). Reported, and monotonicity-checked by the property tests.
        """
        return min(1.0, 1.0 / self.n_buckets)

    def validate(self) -> "CuckooParams":
        """Raise unless these parameters guarantee assignable batches.

        Mirrors ``LWEParams.validate``: the checkable inequality is the
        load margin alpha <= ALPHA_MAX < alpha*_3 — past the threshold a
        valid assignment stops existing w.h.p. and no amount of eviction
        walking recovers it, so such configs must fail at construction,
        not probabilistically at query time.
        """
        if self.m < 1:
            raise ValueError(
                f"batch size m must be >= 1, got {self.m} — set "
                f"PIRConfig.batch_m for the BatchPIR composite")
        if self.n_hashes < 2:
            raise ValueError(
                f"cuckoo hashing needs >= 2 hash functions, got "
                f"{self.n_hashes} (one choice cannot evict)")
        if self.c <= 0:
            raise ValueError(f"bucket expansion c must be > 0, got {self.c}")
        if self.load_factor > ALPHA_MAX:
            raise ValueError(
                f"cuckoo load factor m/B = {self.m}/{self.n_buckets} = "
                f"{self.load_factor:.3f} > {ALPHA_MAX} (margin under the "
                f"3-ary threshold ~0.918): insertion failure is no longer "
                f"O(1/B) — raise c (need c >= {1 / ALPHA_MAX:.2f})")
        return self


def bucket_hashes(indices, params: CuckooParams) -> np.ndarray:
    """Candidate buckets of each index: [...,] -> [..., n_hashes] int64.

    A murmur3-finalizer avalanche over (seed, hash id, index) mod B —
    deterministic, vectorized host math (the ``row_checksum`` idiom), and
    shared verbatim by the server layout and the client assignment, which
    is what makes the bucketed sub-databases queryable at all.
    """
    idx = np.asarray(indices, dtype=np.uint64)
    out = np.empty(idx.shape + (params.n_hashes,), dtype=np.int64)
    for j in range(params.n_hashes):
        salt = (params.seed + j * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = idx ^ np.uint64(salt)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        out[..., j] = (x % np.uint64(params.n_buckets)).astype(np.int64)
    return out


@dataclass(frozen=True)
class CuckooLayout:
    """Server-side bucketed placement of one N-record database.

    Public, query-independent data placement: record i occupies one slot
    in EACH of its distinct candidate buckets. ``capacity`` is the
    power-of-two bucket height (max bucket load rounded up — the GGM tree
    domain of the inner per-bucket protocol), with unoccupied slots held
    as zero pad rows.

    bucket_rows  per bucket, the global row ids in slot order.
    slot_of      [N, n_hashes] int32 — the slot of record i inside bucket
                 ``hashes[i, j]`` (duplicate candidate buckets repeat the
                 first occurrence's slot, so lookup by (i, any j) works).
    """
    n_items: int
    params: CuckooParams
    capacity: int
    hashes: np.ndarray = field(repr=False)        # [N, H] candidate buckets
    slot_of: np.ndarray = field(repr=False)       # [N, H] in-bucket slots
    bucket_rows: Tuple[np.ndarray, ...] = field(repr=False)

    @property
    def n_buckets(self) -> int:
        return self.params.n_buckets

    @property
    def loads(self) -> np.ndarray:
        return np.array([len(r) for r in self.bucket_rows])

    @classmethod
    def build(cls, n_items: int, params: CuckooParams) -> "CuckooLayout":
        params.validate()
        cand = bucket_hashes(np.arange(n_items), params)       # [N, H]
        n, h = cand.shape
        # first-occurrence mask: an index whose hashes collide on one
        # bucket occupies that bucket's slot once, not twice
        first = np.ones((n, h), dtype=bool)
        for j in range(1, h):
            first[:, j] = np.all(cand[:, j:j + 1] != cand[:, :j], axis=1)
        flat = np.flatnonzero(first)         # (row, hash) pairs, row-major
        rows_i = flat // h
        b_flat = cand.ravel()[flat]
        # slot = rank within bucket, records in ascending row-id order
        # (rows_i is already sorted; a stable sort by bucket keeps it). A
        # stable sort's permutation is unique: on 16-bit keys numpy's
        # stable sort is a radix sort, O(N) instead of O(N log N)
        keys = (b_flat.astype(np.uint16) if params.n_buckets <= 1 << 16
                else b_flat)
        order = np.argsort(keys, kind="stable")
        loads = np.bincount(b_flat, minlength=params.n_buckets)
        group_start = np.cumsum(loads) - loads
        slot_flat = np.empty(len(order), dtype=np.int64)
        slot_flat[order] = np.arange(len(order)) - np.repeat(group_start,
                                                             loads)
        slot_of = np.full((n, h), -1, dtype=np.int32)
        slot_of.ravel()[flat] = slot_flat
        # duplicate candidates inherit the first occurrence's slot
        for j in range(1, h):
            for jj in range(j):
                dup = (~first[:, j]) & (cand[:, j] == cand[:, jj])
                slot_of[dup, j] = slot_of[dup, jj]
        cap = 1 << max(int(loads.max()) - 1, 1).bit_length()
        rows_sorted = rows_i[order]          # gathered once, not per bucket
        bucket_rows = tuple(
            rows_sorted[group_start[b]:group_start[b] + loads[b]]
            for b in range(params.n_buckets))
        return cls(n_items=n_items, params=params, capacity=cap,
                   hashes=cand, slot_of=slot_of, bucket_rows=bucket_rows)

    def slot(self, index: int, bucket: int) -> int:
        """The slot of record ``index`` inside one of its candidate
        buckets (KeyError if the bucket is not a candidate)."""
        for j in range(self.params.n_hashes):
            if self.hashes[index, j] == bucket:
                return int(self.slot_of[index, j])
        raise KeyError(
            f"bucket {bucket} is not a candidate of index {index} "
            f"(candidates: {self.hashes[index].tolist()})")

    def occurrences(self, index: int) -> List[Tuple[int, int]]:
        """All (bucket, slot) placements of one record (deduplicated) —
        the write fan-out an online update of that record must cover."""
        seen: Dict[int, int] = {}
        for j in range(self.params.n_hashes):
            b = int(self.hashes[index, j])
            if b not in seen:
                seen[b] = int(self.slot_of[index, j])
        return sorted(seen.items())


def cuckoo_assign(indices: Sequence[int], layout: CuckooLayout,
                  rng: np.random.Generator) -> Dict[int, int]:
    """Assign each (unique) index to one distinct bucket: {bucket: index}.

    Random-walk insertion with per-bucket capacity 1: an index lands in a
    free candidate bucket if one exists, otherwise it evicts a random
    occupant and the walk continues with the evictee. Deterministic given
    ``rng``. Raises :class:`CuckooFailure` after the eviction budget —
    probability O(1/B) under ``validate()``-checked parameters.
    """
    idx = [int(i) for i in indices]
    if len(set(idx)) != len(idx):
        raise ValueError("cuckoo_assign needs unique indices "
                         "(deduplicate the batch first)")
    if len(idx) > layout.params.m:
        raise ValueError(
            f"batch of {len(idx)} exceeds m={layout.params.m}")
    table: Dict[int, int] = {}
    budget = _WALK_STEPS_PER_ITEM * max(len(idx), 1)
    for start in idx:
        cur = start
        for _ in range(budget):
            cands = [b for b, _ in layout.occurrences(cur)]
            free = [b for b in cands if b not in table]
            if free:
                table[int(rng.choice(free))] = cur
                break
            victim_bucket = int(rng.choice(cands))
            cur, table[victim_bucket] = table[victim_bucket], cur
        else:
            raise CuckooFailure(
                f"cuckoo insertion of index {cur} exceeded {budget} "
                f"evictions (batch of {len(idx)} into "
                f"{layout.n_buckets} buckets; analytic bound "
                f"{layout.params.failure_bound():.3g}) — split the batch",
                index=cur)
    return table


@dataclass
class RoundPlan:
    """One planned batch round: B real-or-dummy per-bucket inner queries.

    The client-side artifact the session dispatches: every bucket carries
    exactly one inner-protocol query per party (``keys[b]`` is the
    k-tuple), real for buckets the cuckoo assignment filled, dummy
    (uniformly random in-bucket slot) elsewhere. The *structure* is
    query-independent — ``len(slots) == n_buckets`` always — which is the
    no-occupancy-leak invariant tests assert.

    request_indices  the caller's batch, original order, duplicates kept.
    bucket_of        unique requested index -> assigned bucket.
    slots / real     per bucket: queried in-bucket slot, real-vs-dummy.
    keys             per bucket: the k per-party inner key pytrees.
    """
    request_indices: List[int]
    bucket_of: Dict[int, int]
    slots: List[int]
    real: List[bool]
    keys: List[Tuple]

    @property
    def n_buckets(self) -> int:
        return len(self.slots)

    def party_keys(self, party: int) -> List:
        """Per-bucket key pytrees of one party (collation order)."""
        return [k[party] for k in self.keys]


def plan_round(rng: np.random.Generator, indices: Sequence[int],
               layout: CuckooLayout, inner_cfg: PIRConfig,
               proto) -> RoundPlan:
    """Cuckoo-place a batch and generate its B per-bucket inner queries.

    Dummy queries run the *identical* keygen as real ones (a DPF key for a
    uniformly random slot of the bucket) — by DPF key pseudorandomness a
    server cannot distinguish which buckets carry real queries, so padding
    hides occupancy, not just count. Raises :class:`CuckooFailure` (see
    ``cuckoo_assign``) without consuming protocol keygen entropy.
    """
    request = [int(i) for i in indices]
    unique = list(dict.fromkeys(request))
    assign = cuckoo_assign(unique, layout, rng)
    bucket_of = {i: b for b, i in assign.items()}
    slots: List[int] = []
    real: List[bool] = []
    keys: List[Tuple] = []
    for b in range(layout.n_buckets):
        if b in assign:
            slots.append(layout.slot(assign[b], b))
            real.append(True)
        else:
            slots.append(int(rng.integers(layout.capacity)))
            real.append(False)
        keys.append(proto.query_gen(rng, slots[-1], inner_cfg))
    return RoundPlan(request_indices=request, bucket_of=bucket_of,
                     slots=slots, real=real, keys=keys)


def reassemble(plan: RoundPlan, bucket_records) -> np.ndarray:
    """Reorder per-bucket reconstructions into the request order.

    ``bucket_records``: per bucket, this round's reconstructed record
    (indexable by bucket id — list or [B, ...] array). Duplicated request
    indices fan out from their single assigned bucket; dummy buckets'
    records are discarded here.
    """
    rows = [np.asarray(bucket_records[plan.bucket_of[i]])
            for i in plan.request_indices]
    return np.stack(rows) if rows else np.empty((0,))
