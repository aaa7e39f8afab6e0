"""Kernel registry: descriptors over the ways an answer step can run.

Port of ``repro/engine/kernels.py``. Each :class:`KernelDescriptor` names
one plan the port can run — the materialized select-XOR scan (plain or the
dpXOR kernel), the chunked plain expand+scan, the fused expand+scan kernel,
the int8 GEMM (plain or kernel), the fused expand+select-add kernel, the
LWE int32 GEMM (plain or kernel) — and the standalone GGM level expansion,
and declares:

  * its **tunable space**, already legal for the concrete shape: the fused
    kernels take the reference's ``chunk_log`` and row-tile ladders,
    legalized by ``ops.fused_tile`` (a tile holds whole chunks) and capped
    at the kernels' 24-level stack; ``ggm-expand`` takes threads per block.
    The GEMM and dpXOR kernels have no tunables.
  * a **feasibility model against the card**, not the TPU's VMEM. Plain
    PyTorch work is held to the device memory it needs at once (the peak of
    the leaf expansion's ChaCha temporaries, below), compared with the free
    device memory less a margin (:func:`memory_budget`; no budget on the
    CPU). CUDA kernels are held to their launch limits: threads per block
    <= 1024 and ptxas's registers x threads <= 65,536, read for the
    template instance the shape's record width and batch select, and the
    fused kernels' clog <= 24. Every kernel takes any record width of whole
    4-byte words. Infeasible candidates are pruned without running.
  * a **bytes model** (the memory-roofline numerator reported next to a
    plan) and a **host-op model** (eager PyTorch ops one step runs); the
    tuner prunes a candidate whose floor from either already exceeds the
    best time measured.

Serve descriptors (``serve=True``) emit ``ExecutionPlan`` candidates;
``ggm-expand`` is tuned standalone (``tuner.tune_standalone``).

**The memory model**, derived from ``crypto/chacha.py`` and
``core/dpf.py``: ``chacha_block`` on a batch of seeds holds at its peak the
four 16-byte state rows, their four feed-forward sums and the 64-byte
concatenation, 192 B per seed; with the parent's seed and t alive, one
breadth-first level holds 212 B per parent, 106 B per child
(``_LEVEL_PEAK``), more than the 180 B its outputs and corrections take
afterwards. ``eval_bits_batch`` to R leaves therefore peaks at 106 B per
leaf and query; ``eval_bytes_batch`` runs one more block per leaf with the
leaf seeds alive, 212 B per leaf and query. The plain scans hold bounded
row blocks (``_PLAIN_ELEMS`` elements).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.engine.backend import legal_tile

U32_BYTES = 4

#: bytes per parent node at the peak of one breadth-first GGM level
#: (module docstring): 16 seed + 4 t + 192 ChaCha temporaries
_LEVEL_PEAK = 212

#: bytes per leaf at the peak of the additive leaf conversion (one more
#: ChaCha block per leaf, the leaf seeds and t alive)
_CONVERT_PEAK = 212

#: elements per row block of the plain scans and GEMMs (their
#: ``_PLAIN_ELEMS``); a block holds about three such temporaries
_PLAIN_ELEMS = 1 << 24

#: eager PyTorch ops of one ChaCha block at the fewest rounds a PRF uses
#: (chacha8): 27 per round (two quarter-round sets of 24 ops and 6 rolls
#: per double round) plus the 8 of set-up and feed-forward
_CHACHA_OPS = 8 + 27 * 8

#: eager ops of one GGM level: a block plus the corrections and interleave
_LEVEL_OPS = _CHACHA_OPS + 6

#: launch limits of the card (every NVIDIA GPU since compute capability 2)
MAX_THREADS_PER_BLOCK = 1024
REGISTERS_PER_SM = 65536

#: the serve kernels' threads per block (``kThreads`` in ``csrc/*.cu``)
SERVE_KERNEL_THREADS = 256

#: the fused kernels' depth-first stack (``kMaxClog`` in ``csrc/``)
FUSED_MAX_CLOG = 24

#: device memory the tuner never plans for: the larger of 2 GiB and a
#: tenth of the card, for the caching allocator's fragmentation and the
#: memory model's slack
MEMORY_MARGIN_MIN = 2 << 30
MEMORY_MARGIN_FRACTION = 0.10


def memory_budget(device) -> Optional[int]:
    """Device bytes a candidate's plain PyTorch temporaries may take: the
    free memory ``cudaMemGetInfo`` reports plus what PyTorch's allocator
    holds unused, less the margin. None (no budget) off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + cached - max(MEMORY_MARGIN_MIN,
                                   MEMORY_MARGIN_FRACTION * total))


@dataclass(frozen=True)
class ProblemShape:
    """The concrete shapes one plan candidate must serve.

    bucket      Q: padded query-batch size
    rows        R: DB rows (the port holds the whole DB on one device)
    item_bytes  L: record bytes (words = L / 4)
    components  GGM trees each query expands (3 for xor-dpf-k's parties 0
                and 1, whose keys carry the DPF and two mask trees)
    """
    bucket: int
    rows: int
    item_bytes: int
    components: int = 1

    @property
    def words(self) -> int:
        return self.item_bytes // 4

    @property
    def log_rows(self) -> int:
        return (self.rows - 1).bit_length()

    @property
    def trees(self) -> int:
        """GGM trees one step expands: queries x components."""
        return self.bucket * self.components


Params = Dict[str, int]


@dataclass(frozen=True)
class KernelDescriptor:
    """One way an answer step runs: its tunable space and its models."""

    name: str
    share_kind: str                       # xor | additive | lwe | prg
    #: ExecutionPlan base fields (serve kernels); empty for standalone
    expand: str = ""
    scan: str = ""
    #: shape -> {param: candidate values}
    space_fn: Callable[[ProblemShape], Dict[str, Tuple[int, ...]]] = \
        field(default=lambda s: {})
    #: shape, params -> params with coupled constraints applied; runs before
    #: dedup so two requests that legalize alike are measured once
    legalize_fn: Callable[[ProblemShape, Params], Params] = \
        field(default=lambda s, p: p)
    #: shape, params -> peak device bytes of the plain PyTorch temporaries
    footprint_fn: Callable[[ProblemShape, Params], int] = \
        field(default=lambda s, p: 0)
    #: shape, params -> bytes one answer step moves (reporting, pruning)
    bytes_fn: Callable[[ProblemShape, Params], int] = \
        field(default=lambda s, p: 0)
    #: shape, params -> eager PyTorch ops one step runs (pruning)
    host_ops_fn: Callable[[ProblemShape, Params], int] = \
        field(default=lambda s, p: 0)
    #: the CUDA library the plan launches (``kernels/build.py``), if any
    library: Optional[str] = None
    #: shape, params -> threads per block of that launch
    threads_fn: Callable[[ProblemShape, Params], int] = \
        field(default=lambda s, p: SERVE_KERNEL_THREADS)
    #: shape -> the template instance the library launches for it (the
    #: mangled-name stem ``build.registers`` looks up); None: the library's
    #: largest register count
    instance_fn: Callable[[ProblemShape], Optional[str]] = \
        field(default=lambda s: None)
    serve: bool = True

    def launch_ok(self, shape: ProblemShape, params: Params) -> bool:
        """The launch limits: threads per block, the registers of the
        instance the shape selects, fused depth."""
        if self.library is None:
            return True
        from repro_torch.kernels import build
        threads = self.threads_fn(shape, params)
        regs = build.registers(self.library, self.instance_fn(shape))
        return (threads <= MAX_THREADS_PER_BLOCK
                and (regs is None or regs * threads <= REGISTERS_PER_SM)
                and params.get("chunk_log", 0) <= FUSED_MAX_CLOG)

    def feasible(self, shape: ProblemShape, params: Params,
                 mem_budget: Optional[int] = None) -> bool:
        return self.launch_ok(shape, params) and (
            mem_budget is None or self.footprint_fn(shape, params)
            <= mem_budget)

    def enumerate(self, shape: ProblemShape,
                  mem_budget: Optional[int] = None
                  ) -> List[Tuple[Params, bool]]:
        """Every legal parameter assignment once, with its feasibility."""
        space = self.space_fn(shape)
        names = sorted(space)
        combos = itertools.product(*(space[n] for n in names)) \
            if names else [()]
        seen, out = set(), []
        for combo in combos:
            params = self.legalize_fn(shape, dict(zip(names, combo)))
            key = tuple(sorted(params.items()))
            if key in seen:
                continue
            seen.add(key)
            out.append((params, self.feasible(shape, params, mem_budget)))
        return out

    def candidates(self, shape: ProblemShape,
                   max_candidates: Optional[int] = None,
                   mem_budget: Optional[int] = None) -> List[Params]:
        """Feasible parameter assignments, deduped after legalization;
        ``max_candidates`` is the per-kernel budget cap."""
        out = [p for p, ok in self.enumerate(shape, mem_budget) if ok]
        return out if max_candidates is None else out[:max_candidates]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

KERNELS: Dict[str, KernelDescriptor] = {}


def register_kernel(desc: KernelDescriptor) -> KernelDescriptor:
    KERNELS[desc.name] = desc
    return desc


def serve_kernels(share_kind: str) -> List[KernelDescriptor]:
    """Serve descriptors for one share algebra, in registry order."""
    return [d for d in KERNELS.values()
            if d.serve and d.share_kind == share_kind]


def get_kernel(name: str) -> KernelDescriptor:
    if name not in KERNELS:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(KERNELS)}")
    return KERNELS[name]


# ---------------------------------------------------------------------------
# Spaces and legalization
# ---------------------------------------------------------------------------
#: the reference's ladders (``engine/kernels.py:145-148, 233``): the plain
#: chunked expand's chunk logs, and the fused kernels' row tiles x chunk
#: logs; the pre-engine constants are members, so the heuristic's plan is
#: in the space
_FUSED_CHUNK_LOGS = (8, 10, 12, 14)
_FUSED_KERNEL_TILES = (512, 1024, 2048, 4096)
_FUSED_KERNEL_CHUNK_LOGS = (8, 10, 12)
#: threads per block of the GGM level kernel (the reference's lane tiles
#: ``_GGM_TILES`` have no meaning on the card)
_GGM_BLOCKS = (128, 256, 512, 1024)


def _fused_space(shape: ProblemShape) -> Dict[str, Tuple[int, ...]]:
    # chunks larger than the DB are degenerate duplicates (one chunk)
    return {"chunk_log": tuple(sorted({min(c, shape.log_rows)
                                       for c in _FUSED_CHUNK_LOGS}))}


def _fused_kernel_space(shape: ProblemShape) -> Dict[str, Tuple[int, ...]]:
    return {"tile_r": _FUSED_KERNEL_TILES,
            "chunk_log": _FUSED_KERNEL_CHUNK_LOGS}


def fused_kernel_legalize(shape: ProblemShape, p: Params) -> Params:
    """The fused kernels' coupled rule: ``ops.fused_tile`` (a row tile holds
    whole chunks) on the DB's rows, the kernels' stack cap, then the tile
    written as ``2^clog``: the kernels read no tile, so every request that
    expands the same levels becomes one candidate."""
    from repro_torch.kernels.ops import fused_tile
    _, clog = fused_tile(shape.rows, p["tile_r"],
                         min(p["chunk_log"], shape.log_rows))
    clog = min(clog, FUSED_MAX_CLOG)
    return {**p, "tile_r": 1 << clog, "chunk_log": clog}


def _ggm_space(shape: ProblemShape) -> Dict[str, Tuple[int, ...]]:
    n = shape.rows                        # parent nodes of the level
    return {"tile": tuple(sorted({legal_tile(n, min(t, MAX_THREADS_PER_BLOCK))
                                  for t in _GGM_BLOCKS}))}


# ---------------------------------------------------------------------------
# Memory, bytes and host-op models
# ---------------------------------------------------------------------------

def _expand_peak(trees: int, leaves: int) -> int:
    """Peak bytes of a breadth-first expansion of ``trees`` subtrees down to
    ``leaves`` leaves each (``dpf.eval_to_depth``)."""
    return trees * max(leaves // 2, 1) * _LEVEL_PEAK


def _plain_block_peak(q: int, rows: int, cols: int, elem: int) -> int:
    """Peak bytes of a plain scan or GEMM's row blocks: about three
    ``[Q, step, cols]`` temporaries of ``elem``-byte elements."""
    return 3 * elem * min(q * rows * cols, _PLAIN_ELEMS)


def _roots(shape: ProblemShape, p: Params) -> int:
    return max(1, shape.rows >> p.get("chunk_log", 0))


def _xor_mat_footprint(shape: ProblemShape, p: Params, *, plain: bool
                       ) -> int:
    bits = U32_BYTES * shape.trees * shape.rows
    scan = (_plain_block_peak(shape.bucket, shape.rows, shape.words,
                              U32_BYTES) if plain else 0)
    return max(_expand_peak(shape.trees, shape.rows), bits + scan)


def _xor_fused_footprint(shape: ProblemShape, p: Params) -> int:
    chunk = min(1 << p["chunk_log"], shape.rows)
    return (_expand_peak(shape.trees, chunk)
            + _plain_block_peak(shape.bucket, chunk, shape.words, U32_BYTES))


def _fused_kernel_footprint(shape: ProblemShape, p: Params) -> int:
    return _expand_peak(shape.trees, _roots(shape, p))


def _gemm_footprint(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    leaves = shape.bucket * shape.rows
    conv = max(_expand_peak(shape.bucket, shape.rows),
               leaves * _CONVERT_PEAK)
    gemm = leaves + (_plain_block_peak(shape.bucket, shape.rows,
                                       shape.item_bytes, 8) if plain else 0)
    return max(conv, gemm)


def _lwe_footprint(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    return (_plain_block_peak(shape.bucket, shape.rows, shape.item_bytes, 8)
            if plain else 0)


def _xor_mat_bytes(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    q, r, w = shape.bucket, shape.rows, shape.words
    leaves = shape.trees * r * (4 * U32_BYTES + U32_BYTES)   # seeds + t out
    bits = q * r * U32_BYTES                                 # scan reads bits
    masked = 2 * q * r * w * U32_BYTES if plain else 0       # plain temporary
    return leaves + bits + masked + r * w * U32_BYTES + q * w * U32_BYTES


def _xor_fused_bytes(shape: ProblemShape, p: Params) -> int:
    # chunk by chunk: the same leaves and masked temporaries, bits on-chip
    # never; the DB is read once (each chunk's rows by its fold)
    return _xor_mat_bytes(shape, p, plain=True)


def _fused_kernel_bytes(shape: ProblemShape, p: Params, *, cols: int,
                        elem: int) -> int:
    q, c, cl = shape.trees, _roots(shape, p), p.get("chunk_log", 0)
    # the DB once per batch; chunk roots written by the descent and read by
    # the kernel (4 seed words + t each), clog correction levels (4 + 2)
    roots = 2 * q * c * 5 * U32_BYTES + q * cl * 6 * U32_BYTES
    return shape.rows * cols * elem + roots + q * cols * U32_BYTES


def _gemm_bytes(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    q, r, l = shape.bucket, shape.rows, shape.item_bytes
    leaves = q * r * (4 * U32_BYTES + U32_BYTES)    # leaf seeds + t out
    convert = q * r * (4 * U32_BYTES + 1)           # seeds read, shares out
    if plain:   # shares read once; the int64 products written and summed
        scan = q * r + r * l + 2 * q * r * l * 8
    else:       # the kernel reads the DB once per 8-query group
        scan = q * r + r * l * (-(-q // 8))
    return leaves + convert + scan + q * l * U32_BYTES


def _lwe_bytes(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    q, r, l = shape.bucket, shape.rows, shape.item_bytes
    products = 2 * q * r * l * 8 if plain else 0
    return U32_BYTES * (q * r + r * l + q * l) + products


def _plain_scan_ops(q: int, rows: int, cols: int) -> int:
    """Eager ops of a plain scan or GEMM over ``rows``: a few per row block
    plus the XOR fold's halvings or the sum."""
    step = max(1, _PLAIN_ELEMS // max(q * cols, 1))
    blocks = -(-rows // step)
    return blocks * (6 + 2 * max(step, 1).bit_length())


def _xor_mat_ops(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    scan = (_plain_scan_ops(shape.bucket, shape.rows, shape.words)
            if plain else 2)
    return shape.log_rows * _LEVEL_OPS + scan


def _xor_fused_ops(shape: ProblemShape, p: Params) -> int:
    chunk = min(1 << p["chunk_log"], shape.rows)
    return _roots(shape, p) * (shape.log_rows * _LEVEL_OPS + _plain_scan_ops(
        shape.bucket, chunk, shape.words))


def _fused_kernel_ops(shape: ProblemShape, p: Params) -> int:
    return max(shape.log_rows - p["chunk_log"], 0) * _LEVEL_OPS + 8


def _gemm_ops(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    scan = (_plain_scan_ops(shape.bucket, shape.rows, shape.item_bytes)
            if plain else 2)
    return (shape.log_rows + 1) * _LEVEL_OPS + scan


def _lwe_ops(shape: ProblemShape, p: Params, *, plain: bool) -> int:
    return (_plain_scan_ops(shape.bucket, shape.rows, shape.item_bytes)
            if plain else 2)


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

def _dpxor_instance(s: ProblemShape) -> str:
    from repro_torch.kernels import dpxor
    return dpxor.instance(s.words, s.bucket)   # components fold before it


def _fused_xor_instance(s: ProblemShape) -> str:
    from repro_torch.kernels import fused_scan
    return fused_scan.instance_xor(s.words, queries=s.trees)


def _pir_gemm_instance(s: ProblemShape) -> str:
    from repro_torch.kernels import pir_matmul
    return pir_matmul.instance(s.item_bytes, s.bucket)


def _fused_add_instance(s: ProblemShape) -> str:
    from repro_torch.kernels import fused_scan
    return fused_scan.instance_add(s.item_bytes)


def _lwe_gemm_instance(s: ProblemShape) -> str:
    from repro_torch.kernels import lwe_matmul
    return lwe_matmul.instance(s.bucket, s.item_bytes)


def _pair(name, kind, scan, library, footprint, nbytes, ops, instance=None):
    """The plain (``torch``) and kernel (``cuda``) forms of one plan; the
    kernel form names its ``instance`` function."""
    plain = scan == "torch"
    return register_kernel(KernelDescriptor(
        name=name, share_kind=kind, expand="materialize", scan=scan,
        footprint_fn=lambda s, p: footprint(s, p, plain=plain),
        bytes_fn=lambda s, p: nbytes(s, p, plain=plain),
        host_ops_fn=lambda s, p: ops(s, p, plain=plain),
        library=None if plain else library,
        instance_fn=instance or (lambda s: None)))


MATERIALIZE_TORCH = _pair("xor-materialize-torch", "xor", "torch", None,
                          _xor_mat_footprint, _xor_mat_bytes, _xor_mat_ops)
MATERIALIZE_CUDA = _pair("xor-materialize-cuda", "xor", "cuda", "dpxor",
                         _xor_mat_footprint, _xor_mat_bytes, _xor_mat_ops,
                         _dpxor_instance)

FUSED_TORCH = register_kernel(KernelDescriptor(
    name="xor-fused-torch", share_kind="xor", expand="fused", scan="torch",
    space_fn=_fused_space, footprint_fn=_xor_fused_footprint,
    bytes_fn=_xor_fused_bytes, host_ops_fn=_xor_fused_ops,
))

FUSED_CUDA = register_kernel(KernelDescriptor(
    name="xor-fused-cuda", share_kind="xor", expand="fused-cuda",
    scan="cuda", space_fn=_fused_kernel_space,
    legalize_fn=fused_kernel_legalize, footprint_fn=_fused_kernel_footprint,
    bytes_fn=lambda s, p: _fused_kernel_bytes(s, p, cols=s.words,
                                              elem=U32_BYTES),
    host_ops_fn=_fused_kernel_ops, library="fused_scan_xor",
    instance_fn=_fused_xor_instance,
))

GEMM_TORCH = _pair("gemm-torch", "additive", "torch", None,
                   _gemm_footprint, _gemm_bytes, _gemm_ops)
GEMM_CUDA = _pair("gemm-cuda", "additive", "cuda", "pir_gemm",
                  _gemm_footprint, _gemm_bytes, _gemm_ops,
                  _pir_gemm_instance)

FUSED_CUDA_GEMM = register_kernel(KernelDescriptor(
    name="gemm-fused-cuda", share_kind="additive", expand="fused-cuda",
    scan="cuda", space_fn=_fused_kernel_space,
    legalize_fn=fused_kernel_legalize, footprint_fn=_fused_kernel_footprint,
    bytes_fn=lambda s, p: _fused_kernel_bytes(s, p, cols=s.item_bytes,
                                              elem=1),
    host_ops_fn=_fused_kernel_ops, library="fused_scan_add",
    instance_fn=_fused_add_instance,
))

LWE_GEMM_TORCH = _pair("lwe-gemm-torch", "lwe", "torch", None,
                       _lwe_footprint, _lwe_bytes, _lwe_ops)
LWE_GEMM_CUDA = _pair("lwe-gemm-cuda", "lwe", "cuda", "lwe_gemm",
                      _lwe_footprint, _lwe_bytes, _lwe_ops,
                      _lwe_gemm_instance)

GGM_EXPAND = register_kernel(KernelDescriptor(
    name="ggm-expand", share_kind="prg", serve=False, space_fn=_ggm_space,
    # the level's operands and outputs: 20 B read, 40 B written per node
    footprint_fn=lambda s, p: 60 * s.rows,
    bytes_fn=lambda s, p: 60 * s.rows,
    library="ggm_expand", threads_fn=lambda s, p: p["tile"],
))


# ---------------------------------------------------------------------------
# Plan <-> descriptor bridges
# ---------------------------------------------------------------------------

def plans_from_kernel(desc: KernelDescriptor, shape: ProblemShape, *,
                      base_plan, max_candidates: Optional[int] = None,
                      mem_budget: Optional[int] = None,
                      pruned: Optional[Dict] = None):
    """ExecutionPlan candidates of one serve descriptor for one shape.

    ``base_plan`` supplies the fields a descriptor does not tune; tunables
    overwrite their plan fields (parameter names are ``ExecutionPlan``
    field names). Infeasible plans go to ``pruned`` (plan -> predicted peak
    device bytes) when it is given.
    """
    if not desc.serve:
        raise ValueError(f"{desc.name} is not a serve-path kernel")
    out = []
    for params, ok in desc.enumerate(shape, mem_budget):
        plan = replace(base_plan, expand=desc.expand, scan=desc.scan,
                       **params)
        if ok:
            if max_candidates is None or len(out) < max_candidates:
                out.append(plan)
        elif pruned is not None:
            pruned[plan] = desc.footprint_fn(shape, params)
    return out


def descriptor_for_plan(plan, share_kind: str) -> KernelDescriptor:
    """The registered descriptor a plan runs on, matching ``answer_local``'s
    dispatch: ``fused-cuda`` is its own; the GEMM schemes read only
    ``scan`` otherwise (they materialize for ``fused`` too, and LWE has no
    expansion); the plain chunked XOR expand folds with the plain scan
    whatever ``scan`` says."""
    for d in serve_kernels(share_kind):
        if plan.expand == "fused-cuda" or (share_kind == "xor"
                                           and plan.expand == "fused"):
            if d.expand == plan.expand:
                return d
        elif d.expand == "materialize" and d.scan == plan.scan:
            return d
    raise KeyError(f"no registered kernel for plan {plan.name!r} "
                   f"({share_kind})")


def launches_kernel(plan, share_kind: str) -> bool:
    """Whether a plan's answer step launches a CUDA kernel. On the card the
    engine chooses, caches and serves no other plan: a plain plan there
    would answer in PyTorch with the kernel beside it unused."""
    return descriptor_for_plan(plan, share_kind).library is not None


def plan_params(plan) -> Params:
    """The tunable fields of a plan, as a descriptor params dict."""
    return {"chunk_log": plan.chunk_log, "tile_r": plan.tile_r}


def _model_inputs(plan, share_kind: str, shape: ProblemShape):
    desc = descriptor_for_plan(plan, share_kind)
    return desc, desc.legalize_fn(shape, plan_params(plan))


def predicted_step_bytes(plan, share_kind: str, shape: ProblemShape) -> int:
    """Modeled device-memory bytes one answer step moves under ``plan``."""
    desc, params = _model_inputs(plan, share_kind, shape)
    return desc.bytes_fn(shape, params)


def predicted_peak_bytes(plan, share_kind: str, shape: ProblemShape) -> int:
    """Modeled peak device bytes of the plan's plain PyTorch temporaries
    (the resident DB and the keys not counted)."""
    desc, params = _model_inputs(plan, share_kind, shape)
    return desc.footprint_fn(shape, params)


def predicted_host_ops(plan, share_kind: str, shape: ProblemShape) -> int:
    """Modeled eager PyTorch ops of one answer step under ``plan``."""
    desc, params = _model_inputs(plan, share_kind, shape)
    return desc.host_ops_fn(shape, params)
