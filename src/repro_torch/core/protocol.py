"""The protocol plane of the port: PIR schemes + execution plans.

Port of ``repro/core/protocol.py``:

``PIRProtocol``   what the parties compute — key generation, the per-shard
                  answer, and client reconstruction; a registry maps names
                  to instances. Registered: ``xor-dpf-2`` (the paper's
                  scheme), ``additive-dpf-2`` (Z_256 shares, one int8 GEMM
                  per batch), ``xor-dpf-k`` (k servers, XOR shares) and
                  ``lwe-simple-1`` (one server, LWE ciphertexts, one int32
                  GEMM per batch and a per-epoch hint).
``ExecutionPlan`` how one answer step runs — which expansion (materialized
                  selection bits or shares, chunked expand+scan, or a
                  fused CUDA kernel) and which scan (plain PyTorch or a
                  CUDA kernel: dpXOR for XOR schemes, the int8 GEMM for
                  the additive one, the int32 GEMM for LWE).

Plan names map to the reference's: ``scan="jnp"`` -> ``"torch"``,
``scan="pallas"`` -> ``"cuda"``, ``expand="fused-pallas"`` ->
``"fused-cuda"``. The reference's GEMM/DMA tile fields are left out: the
port's kernels take no tiles (``tile_r`` stays, because it legalizes the
fused kernels' ``chunk_log`` as in the reference).

On a mesh (``launch/mesh.py``) each rank answers its DB shard's partial
shares and ``PIRProtocol.reduce`` combines them over the shard axis's
process group: an XOR all-reduce for the XOR schemes (``plan.collective``:
all_gather + fold, or a butterfly of paired exchanges), an int32 SUM
all-reduce, wrapping mod 2^32, for the additive and LWE ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import PIRConfig
from repro_torch.core import dpf, lwe, pir
from repro_torch.crypto.chacha import PRG_ROUNDS
from repro_torch.crypto.packing import records_to_host
from repro_torch.db.spec import IntegrityError, verify_records
from repro_torch.kernels.dpxor import xor_fold
from repro_torch.launch.mesh import all_reduce_sum, on_transport

#: the reference's GEMM reduction tile default (``engine/kernels.py:153``),
#: pinned on additive and LWE plans; it legalizes chunk_log to 10 at 2^25
#: rows
GEMM_TILE_R_DEFAULT = 1024

#: share kinds whose answer is a GEMM (int8, int32): pinned tile, and the
#: LWE one materializes at every bucket
_GEMM_KINDS = ("additive", "lwe")


# ---------------------------------------------------------------------------
# Execution plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExecutionPlan:
    """How one answer step executes.

    expand     "materialize": selection bits (or shares) are written out,
               then scanned.
               "fused": chunked expand+scan in plain PyTorch; bits exist
               one chunk at a time (XOR schemes; the additive scheme
               materializes, as upstream).
               "fused-cuda": a fused kernel (``kernels/fused_scan.py``)
               expands each chunk's leaves from precomputed chunk roots and
               folds the DB rows in one launch.
    scan       "torch": the plain select-XOR / int8 GEMM of ``core/pir.py``.
               "cuda": the dpXOR kernel (``kernels/dpxor.py``) or the int8
               GEMM kernel (``kernels/pir_matmul.py``).
    chunk_log  log2 leaves per chunk (fused expansions).
    collective "gather" | "butterfly": the XOR all-reduce over the DB-shard
               axis of a mesh (additive and LWE schemes sum and ignore it).
    tile_r     the reference's row tile; legalizes ``chunk_log`` for the
               fused kernel (``ops.fused_tile``).
    provenance "heuristic" (``plan_for``), "forced" (a ``path=`` string),
               "tuned" (the engine's plan cache, measured by its tuner) or
               "warm" (a cache entry seeded by ``engine.record_plans``).
    """
    expand: str = "materialize"
    scan: str = "torch"
    chunk_log: int = 12
    collective: str = "gather"
    tile_r: int = 2048
    provenance: str = field(default="heuristic", compare=False)

    @property
    def name(self) -> str:
        return f"{self.expand}/{self.scan}"

    def describe(self) -> Dict[str, object]:
        """Reporting form (the dry run's records), under the reference's
        keys (``protocol.py:125`` upstream) for the fields the port has.
        The reference's ``tile_q``, ``tile_l`` and ``depth`` tile its
        Pallas kernels; the port has none of them, and they are left
        out."""
        return {"name": self.name, "expand": self.expand, "scan": self.scan,
                "chunk_log": self.chunk_log, "collective": self.collective,
                "tile_r": self.tile_r, "provenance": self.provenance}


#: the XOR all-reduces over the DB-shard axis (``ExecutionPlan.collective``)
COLLECTIVES = ("gather", "butterfly")

#: ``path=`` strings -> plans (the reference's legacy server API, with the
#: Pallas names replaced by their CUDA counterparts)
PATH_PLANS: Dict[str, ExecutionPlan] = {
    "baseline": ExecutionPlan(expand="materialize", scan="torch"),
    "fused": ExecutionPlan(expand="fused", scan="torch"),
    "cuda": ExecutionPlan(expand="materialize", scan="cuda"),
    "fused-cuda": ExecutionPlan(expand="fused-cuda", scan="cuda"),
}


def plan_for(cfg: PIRConfig, n_queries: int, *, backend: str,
             chunk_log: int = 12) -> ExecutionPlan:
    """Pick the kernel path per (db size, batch bucket, backend).

    Counterpart of ``repro/engine/tuner.py heuristic_plan`` (lines 50-86),
    with two stated deviations on the card. The reference heuristic picks
    the jnp-chunked ``fused`` expand for XOR batches past one query on a
    large DB, and that path runs no kernel; only its measured tuner picks
    the ``fused-pallas`` megakernel. For the additive scheme it picks
    ``materialize`` at every batch, which at 2^25 rows and 32 queries would
    hold 16 GiB of leaf seeds per party before the ChaCha temporaries. This
    rule is the engine's cache-miss fallback (``resolve_plan`` with
    ``path=None`` reaches it through ``engine.resolve``; the engine's tuner
    is the route past it), so on ``backend="cuda"`` it picks the kernels
    directly, for every scheme:

      * ``materialize`` + the scan kernel (dpXOR, or the int8 GEMM) when
        ``n_queries <= 1`` or the DB has at most ``2^chunk_log`` rows;
      * ``fused-cuda`` (the fused expand+scan kernel) otherwise.

    On ``backend="cpu"`` it keeps the reference rule with plain PyTorch in
    the role of jnp: ``materialize/torch`` for the additive scheme and for
    those same cases, else ``fused/torch``. ``lwe-simple-1`` has no
    expansion, so it takes ``materialize`` at every bucket on both
    backends, as the reference does (``tuner.py:77-81``). Additive and LWE
    plans pin ``tile_r`` to ``GEMM_TILE_R_DEFAULT`` as the reference does.
    """
    kind = get(cfg.protocol).share_kind
    small_or_single = cfg.n_items <= (1 << chunk_log) or n_queries <= 1
    if backend == "cuda":
        expand = ("materialize" if small_or_single or kind == "lwe"
                  else "fused-cuda")
        plan = ExecutionPlan(expand=expand, scan="cuda", chunk_log=chunk_log)
    elif backend == "cpu":
        expand = ("materialize" if small_or_single or kind in _GEMM_KINDS
                  else "fused")
        plan = ExecutionPlan(expand=expand, scan="torch", chunk_log=chunk_log)
    else:
        raise ValueError(
            f"unknown backend {backend!r}; expected 'cuda' or 'cpu'")
    return pin_tile(plan, cfg)


def resolve_plan(path: Optional[str], cfg: PIRConfig, n_queries: int, *,
                 backend: str, chunk_log: int = 12, device=None,
                 collective: str = "gather") -> ExecutionPlan:
    """A plan from a ``path`` string, or through the engine when path is
    None/"auto": the tuned plan on a plan-cache hit for ``device`` (or, if
    not given, the backend's current card), ``plan_for`` on a miss. GEMM
    schemes pin the GEMM tile on forced plans too. ``collective`` is
    passed through to the plan (``protocol.py:144`` upstream)."""
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}; expected one "
                         f"of {COLLECTIVES}")
    if path is None or path == "auto":
        from repro_torch import engine
        plan = engine.resolve(cfg, n_queries, backend=backend, device=device,
                              chunk_log=chunk_log)
        return replace(plan, collective=collective)
    if path not in PATH_PLANS:
        raise ValueError(f"unknown path {path!r}; "
                         f"expected one of {sorted(PATH_PLANS)} or 'auto'")
    return pin_tile(replace(PATH_PLANS[path], chunk_log=chunk_log,
                            collective=collective, provenance="forced"), cfg)


def pin_tile(plan: ExecutionPlan, cfg: PIRConfig) -> ExecutionPlan:
    """Additive and LWE schemes run on the reference's GEMM tile
    (``protocol.py:164-166`` upstream), heuristic or forced."""
    if get(cfg.protocol).share_kind in _GEMM_KINDS:
        return replace(plan, tile_r=GEMM_TILE_R_DEFAULT)
    return plan


# ---------------------------------------------------------------------------
# Protocol interface + registry
# ---------------------------------------------------------------------------

class PIRProtocol:
    """One PIR scheme: what each of the n parties computes."""

    name: str = ""
    share_kind: str = "xor"            # xor | additive | lwe
    db_view: str = "words"             # the database view it scans
    needs_hint: bool = False           # per-query client state + epoch hint
    key_components: int = 1           # GGM trees a query's key holds, at most

    # -- client side ----------------------------------------------------
    def n_parties(self, cfg: PIRConfig) -> int:
        raise NotImplementedError

    def query_gen(self, rng: np.random.Generator, index: int,
                  cfg: PIRConfig) -> Tuple[dpf.DPFKey, ...]:
        """One unbatched key per party for one index."""
        raise NotImplementedError

    def query_gen_batch(self, rng: np.random.Generator,
                        indices: Sequence[int], cfg: PIRConfig
                        ) -> Tuple[dpf.DPFKey, ...]:
        """One batched key per party; the same rng draws as one
        ``query_gen`` per index, in order."""
        raise NotImplementedError

    def query_gen_full(self, rng: np.random.Generator, index: int,
                       cfg: PIRConfig):
        """Gen with client state, ``(keys, state)``: the DPF schemes keep
        none (``protocol.py:230`` upstream); a hint scheme returns the
        per-query secret its reconstruction needs."""
        return self.query_gen(rng, index, cfg), None

    def reconstruct(self, answers):
        """Combine all parties' answer shares into the records."""
        raise NotImplementedError

    def reconstruct_with(self, answers, states, *, cfg=None, hint=None):
        """Reconstruction with per-query client state and the epoch's hint
        (``protocol.py:244-261`` upstream): schemes without client state
        ignore both and combine the shares. With ``cfg.checksum`` the
        records go through :meth:`verify_reconstruction`, so a corrupted
        share raises ``IntegrityError`` instead of decoding to garbage."""
        rec = self.reconstruct(answers)
        if cfg is not None and cfg.checksum:
            rec = self.verify_reconstruction(rec, cfg)
        return rec

    def verify_reconstruction(self, rec, cfg: PIRConfig) -> np.ndarray:
        """Check stored-width records against their checksum column and
        strip it: the logical payload as numpy (``[Q, W]`` uint32 words for
        the XOR schemes, ``[Q, L]`` uint8 bytes for the byte schemes). The
        check runs on the reconstructed records, not on the shares, so it
        holds for every share algebra. Raises ``IntegrityError`` naming the
        offending batch indices."""
        return verify_records(records_to_host(rec), cfg.item_bytes)

    def record_struct(self, cfg: PIRConfig) -> Tuple[Tuple[int, ...], type]:
        """(shape tail, dtype) of one record as the client receives it, at
        the logical width (a checksum column is verified and stripped):
        XOR schemes return u32 words, additive and LWE schemes bytes."""
        if self.share_kind in _GEMM_KINDS:
            return (cfg.item_bytes,), np.uint8
        return (cfg.item_bytes // 4,), np.uint32

    # -- server side ----------------------------------------------------
    def key_specs(self, cfg: PIRConfig, n_queries: int, *, party: int = 0):
        """A batch of ``n_queries`` keys of ``party`` as meta tensors of the
        real keys' shapes, with the party, ``log_n`` and rounds they carry
        (``protocol.py:282`` upstream: ShapeDtypeStructs): the dry run's
        and the key broadcast's stand-in."""
        raise NotImplementedError

    def answer_local(self, db_local: torch.Tensor, keys_local,
                     start_block: int, log_local: int,
                     plan: ExecutionPlan) -> torch.Tensor:
        """One shard's answer shares ``[Q, cols]`` for a batch of keys; the
        shard holds leaves ``[start_block * 2^log_local, ...)``."""
        raise NotImplementedError

    def reduce(self, partial_res: torch.Tensor, axis, n_shards: int,
               plan: ExecutionPlan) -> torch.Tensor:
        """The cross-shard reduction of the ``[Q, cols]`` partial answers
        over the DB-shard axis. The reference takes the mesh axis's name;
        the port takes that axis's process group (``Mesh.group``) in the
        same position. Every rank of the group gets the reduced answer."""
        raise NotImplementedError

    def expand_local(self, keys_local, start_block: int, log_local: int,
                     plan: ExecutionPlan) -> torch.Tensor:
        """The first half of a ``materialize`` answer: the ``[Q, rows]``
        per-row operand of the scan (selection bits, Z_256 shares or the
        ciphertext slice) for the shard's leaves."""
        raise NotImplementedError

    def scan_local(self, db_local: torch.Tensor, selection: torch.Tensor,
                   plan: ExecutionPlan) -> torch.Tensor:
        """The second half of a ``materialize`` answer: ``[Q, rows]`` from
        :meth:`expand_local` against the shard -> ``[Q, cols]``."""
        raise NotImplementedError

    # -- hint lifecycle (hint protocols only) ---------------------------
    def hint_builder(self, cfg: PIRConfig):
        """``words [N, W] -> hint``, a full rebuild on the device; with
        ``row0=`` a row block's partial, which a database sharded over a
        mesh sums over its blocks."""
        raise NotImplementedError(f"{self.name} has no hint")

    def hint_delta(self, cfg: PIRConfig):
        """``(hint, rows, old_words, new_words) -> new hint``, exact; None
        where the hint can only be rebuilt (``protocol.py:310`` upstream).
        On a mesh it also takes ``row0=`` / ``n_rows=``, the block that
        holds ``rows``."""
        return None

    # -- batching -------------------------------------------------------
    def pad(self, keys, n_total: int):
        return dpf.pad_keys(keys, n_total)

    def n_queries(self, keys) -> int:
        return dpf.n_queries_of(keys)


_REGISTRY: Dict[str, PIRProtocol] = {}


def register(proto: PIRProtocol) -> PIRProtocol:
    if not proto.name:
        raise ValueError("protocol must carry a name")
    _REGISTRY[proto.name] = proto
    return proto


def get(name: str) -> PIRProtocol:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown protocol {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> Tuple[str, ...]:
    """The registered protocol names, sorted."""
    return tuple(sorted(_REGISTRY))


def for_config(cfg: PIRConfig) -> PIRProtocol:
    return get(cfg.protocol)


# ---------------------------------------------------------------------------
# xor-dpf-2: the paper's two-server scheme
# ---------------------------------------------------------------------------

def _xor_scan(db_local: torch.Tensor, bits: torch.Tensor,
              plan: ExecutionPlan) -> torch.Tensor:
    """``[R, W]`` db x ``[Q, R]`` bits -> ``[Q, W]``: plain or the kernel."""
    if plan.scan == "cuda":
        from repro_torch.kernels import ops
        return ops.dpxor(db_local, bits)
    return pir.dpxor(db_local, bits)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """``[G, ...]``: every rank's ``x`` over ``group``, in group rank order."""
    def gather(t):
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)
    return on_transport(gather, x, group)


def xor_allreduce_gather(partial_res: torch.Tensor, axis) -> torch.Tensor:
    """XOR all-reduce over the process group ``axis``: all_gather, then a
    local fold (the paper's host aggregation; ``protocol.py:360``
    upstream)."""
    return xor_fold(all_gather_stack(partial_res, axis), 0)


def xor_allreduce_butterfly(partial_res: torch.Tensor, axis, size: int
                            ) -> torch.Tensor:
    """XOR all-reduce by recursive doubling over the process group
    ``axis`` of ``size`` ranks: in the round of shift ``s`` (1, 2, 4, ...),
    group rank ``i`` exchanges with ``i ^ s`` (one ``batch_isend_irecv``
    pair) and XORs what it receives; log2(size) rounds move the same bytes
    as the gather (``protocol.py:366`` upstream). A size that is not a
    power of two raises ``ValueError``: the reference's permutation would
    leave the axis there."""
    if size < 1 or size & (size - 1):
        raise ValueError(f"the butterfly needs a power-of-two axis, got "
                         f"{size}")
    if size == 1:
        return partial_res

    def butterfly(x):
        me = dist.get_group_rank(axis, dist.get_rank())
        x = x.contiguous()
        shift = 1
        while shift < size:
            peer = dist.get_global_rank(axis, me ^ shift)
            got = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer, group=axis),
                    dist.P2POp(dist.irecv, got, peer, group=axis)]):
                req.wait()
            x = x ^ got
            shift <<= 1
        return x
    return on_transport(butterfly, partial_res, axis)


def _xor_reduce(partial_res: torch.Tensor, axis, n_shards: int,
                plan: ExecutionPlan) -> torch.Tensor:
    if plan.collective == "butterfly":
        return xor_allreduce_butterfly(partial_res, axis, n_shards)
    return xor_allreduce_gather(partial_res, axis)


def _dpf_key_specs(cfg: PIRConfig, n_queries: int, *, party: int,
                   with_payload: bool,
                   components: Optional[int] = None) -> dpf.DPFKey:
    """A batched ``DPFKey`` of meta int32 tensors, optionally with a
    component axis (``protocol.py:388`` upstream)."""
    log_n = cfg.log_n
    lead = (n_queries,) if components is None else (n_queries, components)
    mk = lambda *s: torch.empty(lead + s, dtype=torch.int32, device="meta")
    return dpf.DPFKey(party=party, log_n=log_n, root_seed=mk(4),
                      cw_seed=mk(log_n, 4), cw_t=mk(log_n, 2),
                      cw_final=mk(1) if with_payload else None,
                      rounds=PRG_ROUNDS.get(cfg.prf, 12))


class _XorProtocol(PIRProtocol):
    """XOR share algebra: reconstruction is the XOR of all answers."""

    share_kind = "xor"

    def reduce(self, partial_res, axis, n_shards, plan):
        return _xor_reduce(partial_res, axis, n_shards, plan)

    def scan_local(self, db_local, selection, plan):
        return _xor_scan(db_local, selection, plan)

    def reconstruct(self, answers):
        out = answers[0]
        for a in answers[1:]:
            out = out ^ a
        return out


class XorDpf2(_XorProtocol):
    """Two-server XOR PIR over one GGM DPF pair (paper §2.3, Algorithm 1)."""

    name = "xor-dpf-2"

    def n_parties(self, cfg: PIRConfig) -> int:
        return 2

    def query_gen(self, rng, index, cfg):
        return dpf.gen_keys(rng, index, cfg.log_n, rounds=PRG_ROUNDS[cfg.prf])

    def query_gen_batch(self, rng, indices, cfg):
        return dpf.gen_keys_batch(rng, indices, cfg.log_n,
                                  rounds=PRG_ROUNDS[cfg.prf])

    def key_specs(self, cfg, n_queries, *, party=0):
        return _dpf_key_specs(cfg, n_queries, party=party, with_payload=False)

    def expand_local(self, keys_local, start_block, log_local, plan):
        return dpf.eval_bits_batch(keys_local, start_block, log_local)

    def answer_local(self, db_local, keys_local, start_block, log_local,
                     plan):
        if plan.expand == "materialize":
            return self.scan_local(db_local, self.expand_local(
                keys_local, start_block, log_local, plan), plan)
        if plan.expand == "fused":
            return _fused_xor_answer(db_local, keys_local, start_block,
                                     log_local, plan)
        if plan.expand == "fused-cuda":
            return _fused_cuda_xor_answer(db_local, keys_local, start_block,
                                          log_local, plan)
        raise ValueError(f"unknown expand {plan.expand!r}")


def _fused_xor_answer(db_local, keys_local, start_block, log_local, plan,
                      bits_fn=dpf.eval_bits_batch):
    """Chunked expand+scan: per chunk, descend to its subtree and fold its
    rows at once, so selection bits exist one chunk at a time. ``bits_fn``
    maps (keys, block, log_range) to ``[Q, 2^log_range]`` bits."""
    rows_local, words = db_local.shape
    n_chunks = max(1, rows_local >> plan.chunk_log)
    clog = min(plan.chunk_log, log_local)
    db_c = db_local.reshape(n_chunks, rows_local // n_chunks, words)
    acc = torch.zeros((dpf.n_queries_of(keys_local), words),
                      dtype=torch.int32, device=db_local.device)
    for c in range(n_chunks):
        bits = bits_fn(keys_local, start_block * n_chunks + c, clog)
        acc ^= pir.dpxor(db_c[c], bits)
    return acc


def _fused_cuda_inputs(keys_local: dpf.DPFKey, start_block: int,
                       log_local: int, rows_local: int, plan: ExecutionPlan):
    """Marshal batched keys into the fused kernel's chunk-root form
    (``protocol.py:493-512`` upstream).

    Legalizes chunk_log exactly as the reference (``ops.fused_tile``),
    descends every key once to the chunk-root level, and slices the last
    ``clog`` levels of correction words the kernel expands.
    """
    from repro_torch.kernels import ops
    _, clog = ops.fused_tile(rows_local, plan.tile_r,
                             min(plan.chunk_log, log_local))
    roots, t_roots = dpf.eval_roots_batch(keys_local, start_block,
                                          log_local, clog)
    lvl0 = keys_local.log_n - clog
    return (roots, t_roots, keys_local.cw_seed[:, lvl0:, :],
            keys_local.cw_t[:, lvl0:, :])


def _fused_cuda_xor_answer(db_local, keys_local, start_block, log_local,
                           plan):
    """Fused-kernel XOR answer: expand in the kernel, one DB pass."""
    from repro_torch.kernels import ops
    roots, t_roots, cw_s, cw_t = _fused_cuda_inputs(
        keys_local, start_block, log_local, db_local.shape[0], plan)
    return ops.fused_scan_xor(db_local, roots, t_roots, cw_s, cw_t,
                              rounds=keys_local.rounds)


register(XorDpf2())


# ---------------------------------------------------------------------------
# additive-dpf-2: Z_256 shares -> one int8 GEMM per batch (beyond-paper)
# ---------------------------------------------------------------------------

#: the additive scheme's DPF payload: beta = 1, so shares sum to e_alpha
PAYLOAD_ONE = np.array([1], np.uint32)


class AdditiveDpf2(PIRProtocol):
    """Two-server additive PIR: Z_256 byte shares, batched-query GEMM.

    A batch of Q queries against one DB shard is one int8 product
    ``shares[Q, R] x db[R, L]``: the DB is read once per batch. Answers are
    int32 byte columns; only their value mod 256 matters, and int32
    wraparound keeps it. The int8 byte view comes from the database plane
    (``db_view = "bytes"``, an alias of the resident words).
    """

    name = "additive-dpf-2"
    share_kind = "additive"
    db_view = "bytes"

    def n_parties(self, cfg: PIRConfig) -> int:
        return 2

    def query_gen(self, rng, index, cfg):
        return dpf.gen_keys(rng, index, cfg.log_n, payload=PAYLOAD_ONE,
                            rounds=PRG_ROUNDS[cfg.prf])

    def query_gen_batch(self, rng, indices, cfg):
        return dpf.gen_keys_batch(rng, indices, cfg.log_n,
                                  payload=PAYLOAD_ONE,
                                  rounds=PRG_ROUNDS[cfg.prf])

    def key_specs(self, cfg, n_queries, *, party=0):
        return _dpf_key_specs(cfg, n_queries, party=party, with_payload=True)

    def reduce(self, partial_res, axis, n_shards, plan):
        # int32 wraps mod 2^32 as the reference's psum: shares keep their
        # value mod 256
        return all_reduce_sum(partial_res, axis)

    def expand_local(self, keys_local, start_block, log_local, plan):
        return dpf.eval_bytes_batch(keys_local, start_block, log_local)

    def scan_local(self, db_local, selection, plan):
        if plan.scan == "cuda":
            from repro_torch.kernels import ops
            return ops.pir_gemm(selection.view(torch.int8), db_local)
        return pir.answer_additive_matmul(db_local, selection)

    def answer_local(self, db_local, keys_local, start_block, log_local,
                     plan):
        # db_local is the int8 byte view [rows_local, item_bytes]
        if plan.expand == "fused-cuda":
            return _fused_cuda_add_answer(db_local, keys_local, start_block,
                                          log_local, plan)
        if plan.expand not in ("materialize", "fused"):
            raise ValueError(f"unknown expand {plan.expand!r}")
        return self.scan_local(db_local, self.expand_local(
            keys_local, start_block, log_local, plan), plan)

    def reconstruct(self, answers):
        return pir.reconstruct_additive(*answers)


def _fused_cuda_add_answer(db_local, keys_local, start_block, log_local,
                           plan):
    """Fused-kernel additive answer: in-kernel share conversion +
    select-add, equal to the materialized int8 GEMM bit for bit."""
    from repro_torch.kernels import ops
    roots, t_roots, cw_s, cw_t = _fused_cuda_inputs(
        keys_local, start_block, log_local, db_local.shape[0], plan)
    return ops.fused_scan_bytes(db_local, roots, t_roots, cw_s, cw_t,
                                keys_local.cw_final[:, 0],
                                party=keys_local.party,
                                rounds=keys_local.rounds)


register(AdditiveDpf2())


# ---------------------------------------------------------------------------
# xor-dpf-k: k >= 2 servers, k-of-k XOR shares (beyond-paper)
# ---------------------------------------------------------------------------

class XorDpfK(_XorProtocol):
    """k-server XOR PIR: one DPF pair blinded by a ring of shared masks.

    For each query: draw mask seeds s_0..s_{k-1}; party i holds plain
    (correction-free) GGM trees for s_i and s_{(i+1) mod k}, and parties 0
    and 1 also hold the real DPF pair (d_0, d_1). Each seed is held by
    exactly two parties, so the XOR of all k selection vectors is
    Eval(d_0) ^ Eval(d_1) = e_alpha, while each party alone sees a DPF key
    and fresh random seeds. k = 2 degenerates to the two-server scheme.

    A party's key is a ``DPFKey`` with a component axis after the query
    axis (``[Q, C, ...]``; C = 3 for parties 0 and 1, 2 for the rest, all
    components carrying the party's id); each component is evaluated and
    the selection bits are XOR-folded over C.
    """

    name = "xor-dpf-k"
    key_components = 3

    def n_parties(self, cfg: PIRConfig) -> int:
        if cfg.n_servers < 2:
            raise ValueError(f"xor-dpf-k needs n_servers >= 2, "
                             f"got {cfg.n_servers}")
        return cfg.n_servers

    def query_gen(self, rng, index, cfg):
        return tuple(dpf.key_at(k, 0)
                     for k in self.query_gen_batch(rng, [index], cfg))

    def query_gen_batch(self, rng, indices, cfg):
        """Per index, the DPF pair's two roots and then k mask seeds are
        drawn, in that order (``protocol.py:655-657`` upstream)."""
        k = self.n_parties(cfg)
        alphas = [int(a) for a in indices]
        dpf.check_alphas(alphas, cfg.log_n)
        q = len(alphas)
        roots = np.empty((q, 2, 4), np.uint32)
        seeds = np.empty((q, k, 4), np.uint32)
        for i in range(q):
            roots[i] = dpf.draw_roots(rng)
            for j in range(k):
                seeds[i, j] = rng.integers(0, 1 << 32, size=4,
                                           dtype=np.uint32)
        pair = dpf.keys_from_roots(roots, alphas, cfg.log_n,
                                   rounds=PRG_ROUNDS[cfg.prf])
        seeds_t = torch.from_numpy(seeds.view(np.int32))
        keys = []
        for i in range(k):
            masks = seeds_t[:, [i, (i + 1) % k]]                 # [Q, 2, 4]
            zero = torch.zeros((q, 2) + tuple(pair[0].cw_seed.shape[1:]),
                               dtype=torch.int32)
            zero_t = torch.zeros((q, 2) + tuple(pair[0].cw_t.shape[1:]),
                                 dtype=torch.int32)
            root, cw_s, cw_t = masks, zero, zero_t
            if i < 2:
                d = pair[i]
                root = torch.cat([d.root_seed[:, None], masks], dim=1)
                cw_s = torch.cat([d.cw_seed[:, None], zero], dim=1)
                cw_t = torch.cat([d.cw_t[:, None], zero_t], dim=1)
            keys.append(dpf.DPFKey(party=i, log_n=cfg.log_n,
                                   root_seed=root.contiguous(),
                                   cw_seed=cw_s.contiguous(),
                                   cw_t=cw_t.contiguous(),
                                   rounds=PRG_ROUNDS[cfg.prf]))
        return tuple(keys)

    def key_specs(self, cfg, n_queries, *, party=0):
        """``[Q, C, ...]``: C = 3 components for parties 0 and 1 (the DPF
        key and two masks), 2 for the rest."""
        return _dpf_key_specs(cfg, n_queries, party=party,
                              with_payload=False,
                              components=3 if party < 2 else 2)

    def expand_local(self, keys_local, start_block, log_local, plan):
        return _component_bits_batch(keys_local, start_block, log_local)

    def answer_local(self, db_local, keys_local, start_block, log_local,
                     plan):
        if plan.expand == "materialize":
            return self.scan_local(db_local, self.expand_local(
                keys_local, start_block, log_local, plan), plan)
        if plan.expand == "fused":
            return _fused_xor_answer(db_local, keys_local, start_block,
                                     log_local, plan, _component_bits_batch)
        if plan.expand == "fused-cuda":
            return _fused_cuda_xor_k_answer(db_local, keys_local,
                                            start_block, log_local, plan)
        raise ValueError(f"unknown expand {plan.expand!r}")


def _flatten_components(keys: dpf.DPFKey) -> dpf.DPFKey:
    """``[Q, C, ...]`` component keys -> ``[Q*C, ...]`` pseudo-queries."""
    return dpf.map_keys(keys, lambda x: x.reshape((-1,) + x.shape[2:]))


def replace_party(key: dpf.DPFKey, party: int) -> dpf.DPFKey:
    """The key with its party id rewritten (``protocol.py:699`` upstream);
    the tensors are shared. The id enters no mask evaluation (with zero
    correction words the initial t bit multiplies nothing), but the
    components of one party's keys must agree on it to stack."""
    return replace(key, party=party)


def _component_bits(key: dpf.DPFKey, block: int, log_range: int
                    ) -> torch.Tensor:
    """One query's ``[C, ...]`` component keys -> ``[2^log_range]``
    selection bits, XOR-folded over the components: the batch form at
    Q = 1."""
    return _component_bits_batch(dpf.map_keys(key, lambda x: x[None]),
                                 block, log_range)[0]


def _component_bits_batch(keys: dpf.DPFKey, start_block: int,
                          log_range: int) -> torch.Tensor:
    """``[Q, C, ...]`` component keys -> ``[Q, 2^log_range]`` selection
    bits, XOR-folded over the components (``protocol.py:712-726``
    upstream): the Q * C components evaluated as one flat batch."""
    q, c = keys.root_seed.shape[:2]
    bits = dpf.eval_bits_batch(_flatten_components(keys), start_block,
                               log_range)
    return xor_fold(bits.reshape(q, c, -1), 1)


def _fused_cuda_xor_k_answer(db_local, keys_local, start_block, log_local,
                             plan):
    """Fused-kernel answer for component keys: AND distributes over XOR,
    so the kernel runs on the Q*C flattened pseudo-queries and the answers
    XOR-fold over the component axis."""
    q, c = keys_local.root_seed.shape[:2]
    ans = _fused_cuda_xor_answer(db_local, _flatten_components(keys_local),
                                 start_block, log_local, plan)
    return xor_fold(ans.reshape(q, c, -1), 1)


register(XorDpfK())


# ---------------------------------------------------------------------------
# lwe-simple-1: single-server SimplePIR-style LWE PIR (beyond-paper)
# ---------------------------------------------------------------------------

class LweSimple1(PIRProtocol):
    """Single-server LWE PIR: encrypted one-hot query, int32 GEMM answer.

    The scheme with no non-collusion assumption: privacy rests on LWE
    hardness. The price is a preprocessed hint ``H = A^T.DB`` that the
    client needs to reconstruct, built per epoch by the database
    (``Database.register_hint``). The server's answer is
    ``ct[Q, N] x bytes32[N, L] -> int32 [Q, L]``, wrapping mod 2^32 = mod q,
    through the int32 GEMM kernel on the card (``ops.lwe_gemm``).

    Keys are ``lwe.LWECiphertext``; the client computes ``A.s`` on a device
    (``device=None`` means CUDA), so the query generators take ``device=``.
    """

    name = "lwe-simple-1"
    share_kind = "lwe"
    db_view = "bytes32"
    needs_hint = True

    def _params(self, cfg: PIRConfig) -> lwe.LWEParams:
        return lwe.params_for(cfg.n_items)

    # -- client side ----------------------------------------------------
    def n_parties(self, cfg: PIRConfig) -> int:
        return 1

    def query_gen_batch_full(self, rng, indices, cfg, *, device=None):
        """``((ct [Q, N],), states)``: the rng drawn as a loop of
        :meth:`query_gen_full` would draw it."""
        ct, states = lwe.encrypt_batch(rng, list(indices), cfg.n_items,
                                       self._params(cfg), device)
        return (ct,), states

    def query_gen_full(self, rng, index, cfg, *, device=None):
        """``((ct [N],), state)`` for one index."""
        (ct,), states = self.query_gen_batch_full(rng, [index], cfg,
                                                  device=device)
        return (ct.map(lambda x: x[0]),), states[0]

    def query_gen(self, rng, index, cfg, *, device=None):
        """Keys without the secret; reconstruction needs
        :meth:`query_gen_full`."""
        return self.query_gen_full(rng, index, cfg, device=device)[0]

    def query_gen_batch(self, rng, indices, cfg, *, device=None):
        return self.query_gen_batch_full(rng, indices, cfg,
                                         device=device)[0]

    def reconstruct(self, answers):
        raise NotImplementedError(
            "lwe-simple-1 reconstruction needs per-query client state and "
            "the epoch hint: use reconstruct_with(answers, states, cfg=..., "
            "hint=...) — sessions route this via SingleServerPIR")

    def reconstruct_with(self, answers, states, *, cfg=None, hint=None):
        """Records ``[Q, L]`` uint8 from the answers, the client states and
        the epoch's hint (``[n, L]`` int32 bits), decoded on the host.

        Raises ``IntegrityError`` when the recovered noise reaches the
        analytic tail bound ``validate`` enforces: honest noise sits ~TAIL
        sigmas inside it, while a wrong hint or epoch makes the residual
        near-uniform in the Delta window (``protocol.py:808-823``
        upstream). A corruption that shifts an answer by a multiple of
        Delta decodes to a clean plaintext shift the noise check cannot
        see; with ``cfg.checksum`` the row checksum, run after the noise
        check, catches it, and the records come back at the logical width.
        """
        if cfg is None or hint is None or any(s is None for s in states):
            raise ValueError("lwe-simple-1 reconstruct_with needs cfg=, "
                             "hint= and one client state per query")
        params = self._params(cfg)
        ans = answers[0]
        if isinstance(ans, torch.Tensor):
            ans = ans.cpu().numpy()
        secrets = np.stack([s.s for s in states])
        hint_u64 = np.asarray(hint, np.int32).view(np.uint32).astype(
            np.uint64)
        records, err = lwe.decode(np.asarray(ans, np.int32), secrets,
                                  hint_u64, params)
        max_err = int(np.abs(err).max()) if err.size else 0
        bound = params.noise_bound(cfg.n_items)
        if max_err >= bound:
            raise IntegrityError(
                f"LWE noise overflow: recovered |e^T.D| = {max_err} >= "
                f"tail bound {bound:.4g} (budget q/(2p) = "
                f"{params.noise_budget}); the answers do not match this "
                f"hint/epoch — reconstruction is not trustworthy")
        if cfg.checksum:
            records = self.verify_reconstruction(records, cfg)
        return records

    # -- server side ----------------------------------------------------
    def key_specs(self, cfg, n_queries, *, party=0):
        return lwe.LWECiphertext(
            ct=torch.empty((n_queries, cfg.n_items), dtype=torch.int32,
                           device="meta"),
            log_n=cfg.log_n, n=self._params(cfg).n)

    def reduce(self, partial_res, axis, n_shards, plan):
        return all_reduce_sum(partial_res, axis)  # wraps mod q = 2^32

    def answer_local(self, db_local, keys_local, start_block, log_local,
                     plan):
        """``[Q, rows]`` ciphertext slice of this shard x the int32 byte
        view ``[rows, L]``; ``plan.scan`` picks the kernel or the plain
        version (there is no expansion, so ``plan.expand`` is not read)."""
        rows_local = db_local.shape[0]
        start = start_block * rows_local
        return self.scan_local(
            db_local, keys_local.ct[:, start:start + rows_local], plan)

    def expand_local(self, keys_local, start_block, log_local, plan):
        rows = 1 << log_local
        return keys_local.ct[:, start_block * rows:(start_block + 1) * rows]

    def scan_local(self, db_local, selection, plan):
        if plan.scan == "cuda":
            from repro_torch.kernels import ops
            return ops.lwe_gemm(selection, db_local)
        from repro_torch.kernels.lwe_matmul import lwe_gemm_plain
        return lwe_gemm_plain(selection, db_local)

    # -- hint lifecycle: a row block's offset passes through to A -------
    def hint_builder(self, cfg: PIRConfig):
        return lwe.hint_build_fn(self._params(cfg), cfg.n_items)

    def hint_delta(self, cfg: PIRConfig):
        return lwe.hint_delta_fn(self._params(cfg), cfg.n_items)

    # -- batching: LWECiphertext is not a DPFKey ------------------------
    def pad(self, keys, n_total: int):
        """Pad to ``n_total`` queries by repeating the last ciphertext."""
        q = self.n_queries(keys)
        if n_total < q:
            raise ValueError(f"cannot pad {q} queries down to {n_total}")
        if n_total == q:
            return keys
        return keys.map(lambda x: torch.cat(
            [x, x[-1:].expand(n_total - q, *x.shape[1:])], dim=0))

    def n_queries(self, keys) -> int:
        return int(keys.ct.shape[0])


register(LweSimple1())
