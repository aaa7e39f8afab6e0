"""The protocol plane of the port: PIR schemes + execution plans.

Port of the main-path part of ``repro/core/protocol.py``:

``PIRProtocol``   what the parties compute — key generation, the per-shard
                  answer, and client reconstruction; a registry maps names
                  to instances. Registered so far: ``xor-dpf-2``.
``ExecutionPlan`` how one answer step runs — which expansion (materialized
                  selection bits, chunked expand+scan, or the fused CUDA
                  kernel) and which scan (plain PyTorch or the CUDA dpXOR).

Plan names map to the reference's: ``scan="jnp"`` -> ``"torch"``,
``scan="pallas"`` -> ``"cuda"``, ``expand="fused-pallas"`` ->
``"fused-cuda"``. The reference's collective and GEMM/DMA tile fields are
left out: this slice runs on one device and has no GEMM, and the CUDA
kernels take no DMA tile (``tile_r`` stays, because it legalizes the fused
kernel's ``chunk_log`` as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core import dpf, pir
from repro_torch.crypto.chacha import PRG_ROUNDS


# ---------------------------------------------------------------------------
# Execution plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExecutionPlan:
    """How one answer step executes.

    expand     "materialize": selection bits are written out, then scanned.
               "fused": chunked expand+scan in plain PyTorch; bits exist
               one chunk at a time.
               "fused-cuda": the fused kernel (``kernels/fused_scan.py``)
               expands each chunk's leaves from precomputed chunk roots and
               folds the DB rows in one launch.
    scan       "torch": the plain select-XOR of ``core/pir.py``.
               "cuda": the dpXOR kernel (``kernels/dpxor.py``).
    chunk_log  log2 leaves per chunk (fused expansions).
    tile_r     the reference's row tile; legalizes ``chunk_log`` for the
               fused kernel (``ops.fused_tile``).
    provenance "heuristic" (``plan_for``) or "forced" (a ``path=`` string).
    """
    expand: str = "materialize"
    scan: str = "torch"
    chunk_log: int = 12
    tile_r: int = 2048
    provenance: str = field(default="heuristic", compare=False)

    @property
    def name(self) -> str:
        return f"{self.expand}/{self.scan}"


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
    with one stated deviation on the card. The reference heuristic picks
    the fused jnp-chunked expand for XOR batches past one query on a large
    DB, and that path runs no kernel; only its measured tuner picks the
    ``fused-pallas`` megakernel. The port has no tuner yet, so on
    ``backend="cuda"`` it picks the kernels directly:

      * ``materialize`` + the dpXOR kernel when ``n_queries <= 1`` or the
        DB has at most ``2^chunk_log`` rows;
      * ``fused-cuda`` (the fused expand+scan kernel) otherwise.

    On ``backend="cpu"`` it keeps the reference rule with plain PyTorch in
    the role of jnp: ``materialize/torch`` for those same cases, else
    ``fused/torch``.
    """
    get(cfg.protocol)                       # only registered schemes
    small_or_single = cfg.n_items <= (1 << chunk_log) or n_queries <= 1
    if backend == "cuda":
        expand = "materialize" if small_or_single else "fused-cuda"
        return ExecutionPlan(expand=expand, scan="cuda", chunk_log=chunk_log)
    if backend == "cpu":
        expand = "materialize" if small_or_single else "fused"
        return ExecutionPlan(expand=expand, scan="torch", chunk_log=chunk_log)
    raise ValueError(f"unknown backend {backend!r}; expected 'cuda' or 'cpu'")


def resolve_plan(path: Optional[str], cfg: PIRConfig, n_queries: int, *,
                 backend: str, chunk_log: int = 12) -> ExecutionPlan:
    """A plan from a ``path`` string, or ``plan_for`` when path is
    None/"auto"."""
    if path is None or path == "auto":
        return plan_for(cfg, n_queries, backend=backend, chunk_log=chunk_log)
    if path not in PATH_PLANS:
        raise ValueError(f"unknown path {path!r}; "
                         f"expected one of {sorted(PATH_PLANS)} or 'auto'")
    return replace(PATH_PLANS[path], chunk_log=chunk_log,
                   provenance="forced")


# ---------------------------------------------------------------------------
# Protocol interface + registry
# ---------------------------------------------------------------------------

class PIRProtocol:
    """One PIR scheme: what each of the n parties computes."""

    name: str = ""
    share_kind: str = "xor"            # xor | additive | lwe
    db_view: str = "words"             # the database view it scans

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

    def reconstruct(self, answers):
        """Combine all parties' answer shares into the records."""
        raise NotImplementedError

    def record_struct(self, cfg: PIRConfig) -> Tuple[Tuple[int, ...], type]:
        """(shape tail, dtype) of one reconstructed record."""
        return (cfg.item_bytes // 4,), np.uint32

    # -- server side ----------------------------------------------------
    def answer_local(self, db_local: torch.Tensor, keys_local,
                     start_block: int, log_local: int,
                     plan: ExecutionPlan) -> torch.Tensor:
        """One shard's answers ``[Q, W]`` for a batch of keys; the shard
        holds leaves ``[start_block * 2^log_local, ...)``."""
        raise NotImplementedError

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


class _XorProtocol(PIRProtocol):
    """XOR share algebra: reconstruction is the XOR of all answers."""

    share_kind = "xor"

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

    def answer_local(self, db_local, keys_local, start_block, log_local,
                     plan):
        if plan.expand == "materialize":
            bits = dpf.eval_bits_batch(keys_local, start_block, log_local)
            return _xor_scan(db_local, bits, plan)
        if plan.expand == "fused":
            return _fused_xor_answer(db_local, keys_local, start_block,
                                     log_local, plan)
        if plan.expand == "fused-cuda":
            return _fused_cuda_xor_answer(db_local, keys_local, start_block,
                                          log_local, plan)
        raise ValueError(f"unknown expand {plan.expand!r}")


def _fused_xor_answer(db_local, keys_local, start_block, log_local, plan):
    """Chunked expand+scan: per chunk, descend to its subtree and fold its
    rows at once, so selection bits exist one chunk at a time."""
    rows_local, words = db_local.shape
    n_chunks = max(1, rows_local >> plan.chunk_log)
    clog = min(plan.chunk_log, log_local)
    db_c = db_local.reshape(n_chunks, rows_local // n_chunks, words)
    acc = torch.zeros((dpf.n_queries_of(keys_local), words),
                      dtype=torch.int32, device=db_local.device)
    for c in range(n_chunks):
        bits = dpf.eval_bits_batch(keys_local, start_block * n_chunks + c,
                                   clog)
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
