"""Three-term roofline model of a step, and the kernels' bounds, on the
NVIDIA H100: the port of ``repro/analysis/roofline.py``.

Terms (per step, every card):
  compute    = FLOPs / (cards x peak FLOP/s)
  memory     = bytes / (cards x HBM rate)
  collective = collective bytes / (cards x link rate)

Sources: the reference reads FLOPs and bytes from optimized HLO
(``hlo_cost``) and parses the collectives out of the same text. The port
has no HLO: its op-level cost counter (``analysis/op_cost.py``) runs the
step on meta tensors and counts the same three totals from the aten ops
it dispatches, the collectives included (``collective_stats``);
``from_cost`` takes its totals where the reference's ``from_compiled``
takes the compiled artifact.

Hardware model: one NVIDIA H100 SXM5 80GB, from its data sheet (published
peaks, not measurements of any card; a card set below its 700 W power
limit reaches less): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s of
NVLink 4 per direction, 80 GB of HBM.

``PEAK_BYTES_PER_S`` / ``achieved_fraction`` are what the engine reads
(``engine/tuner.py``, ``engine.plan_report``). ``"cpu"`` keeps the
reference's deliberately generous 1e11 B/s, so that the tuner's
bandwidth-floor pruning never drops a plan on a CPU that a real machine
might still win with.

The bound functions at the end are the least time the card can take for
each of the port's six kernels (bytes over the HBM rate, or integer
operations over the card's issue rate), which ``chip_smoke.py`` reports
beside every kernel's time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

# -- hardware constants (NVIDIA H100 SXM5 80GB data sheet: published
# -- peaks, not measured) -----------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s per card, HBM3
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction
                             # (the data sheet's 900 GB/s counts both)
HBM_BYTES = 80e9             # device memory per card, bytes

#: peak memory bandwidth per backend, bytes/s
PEAK_BYTES_PER_S = {
    "cuda": HBM_BW,
    "cpu": 1.0e11,        # generous on purpose (see module docstring)
}

#: peak dense bf16 matrix rate per backend, FLOP/s (data sheet, not
#: measured; no CPU figure): a training run's model-FLOPs share
PEAK_BF16_FLOPS_PER_S = {
    "cuda": PEAK_FLOPS,
}


def peak_bytes_per_s(backend: str) -> float:
    """Peak memory bandwidth for ``backend`` ("cuda" or "cpu")."""
    return PEAK_BYTES_PER_S.get(backend, PEAK_BYTES_PER_S["cpu"])


def achieved_fraction(bytes_touched: float, wall_s: float, *,
                      backend: str) -> float:
    """``bytes_touched / wall_s / peak``: the fraction of the backend's
    peak bandwidth a measured run reached over its modeled bytes."""
    if wall_s <= 0:
        return 0.0
    return bytes_touched / wall_s / peak_bytes_per_s(backend)


#: HLO element types -> bytes (the reference's table)
_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}


def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of an HLO shape: ``shape_bytes("bf16", "4,128")``."""
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def tensor_bytes(dtype: torch.dtype, shape: Sequence[int]) -> int:
    """Bytes of a tensor of ``shape`` and torch ``dtype``: the twin of
    :func:`shape_bytes` that the op-level cost counter charges."""
    return math.prod(shape) * dtype.itemsize


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_stats(cost) -> CollectiveStats:
    """The collectives an ``op_cost.Cost`` saw, by kind: the counterpart of
    the reference's ``parse_collectives`` over HLO text (output bytes of
    every ``c10d`` / ``_c10d_functional`` collective op)."""
    return CollectiveStats(
        bytes_by_kind={k: int(v) for k, v in cost.coll_by_kind.items()},
        count_by_kind=dict(cost.coll_count_by_kind))


@dataclass
class Roofline:
    name: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float           # 6·N·D (or 6·N_active·D) per step
    collectives: Optional[CollectiveStats] = None
    hlo_elem_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.n_chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.n_chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.step_time == 0:
            return 0.0
        return self.model_flops / (self.step_time * self.n_chips
                                   * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "n_chips": self.n_chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "hlo_elem_flops": self.hlo_elem_flops,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_step_s": self.step_time,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu,
            "collective_breakdown": (self.collectives.bytes_by_kind
                                     if self.collectives else {}),
        }


def cost_totals(cost: dict) -> Dict[str, float]:
    """Normalize cost_analysis output (it may be a dict or list of dicts)."""
    if isinstance(cost, (list, tuple)):
        merged: Dict[str, float] = {}
        for c in cost:
            for k, v in c.items():
                merged[k] = merged.get(k, 0.0) + v
        cost = merged
    return cost


def model_flops_for(n_params: int, n_tokens: int, *, training: bool) -> float:
    """6·N·D for a train step, 2·N·D for inference (per forward token)."""
    factor = 6.0 if training else 2.0
    return factor * n_params * n_tokens


def from_cost(name: str, cost, *, n_chips: int,
              model_flops: float) -> Roofline:
    """Roofline terms from an ``op_cost.Cost``, the counterpart of the
    reference's ``from_compiled``. The counter's totals are per card per
    step (each card runs the step it saw), so the whole-step totals are
    the card's times ``n_chips``."""
    return Roofline(name=name, n_chips=n_chips,
                    hlo_flops=cost.flops * n_chips,
                    hlo_bytes=cost.bytes * n_chips,
                    collective_bytes=cost.coll_bytes * n_chips,
                    model_flops=model_flops,
                    collectives=collective_stats(cost),
                    hlo_elem_flops=cost.elem_flops * n_chips)


def format_table(rows: List[dict]) -> str:
    """Markdown table of ``Roofline.to_dict`` rows."""
    hdr = ("| cell | chips | t_compute | t_memory | t_collective | "
           "bottleneck | useful/HLO | MFU-bound |")
    sep = "|" + "---|" * 8
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['name']} | {r['n_chips']} | {_fmt_s(r['t_compute_s'])} "
            f"| {_fmt_s(r['t_memory_s'])} | {_fmt_s(r['t_collective_s'])} "
            f"| {r['bottleneck']} | {r['useful_flop_ratio']:.2f} "
            f"| {r['mfu_bound']*100:.1f}% |")
    return "\n".join(out)


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f} s"
    if x >= 1e-3:
        return f"{x*1e3:.2f} ms"
    return f"{x*1e6:.1f} µs"


# -- the six kernels' bounds (fixed before any timing) ------------------------
# H100 SXM data sheet: 132 SMs, 1.98 GHz max boost clock. Integer issue: 4
# schedulers x 32 lanes = 128 int32 lane-ops per SM per clock (ALU pipe for
# IADD3/LOP3/SHF plus the FMA pipe for IMAD-form adds).
HBM_BYTES_PER_S = HBM_BW
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit integer multiply-add: 64 per clock per SM (the CUDA programming
# guide's arithmetic-throughput table, compute capability 9.0).
IMAD_PER_S = 132 * 64 * 1.98e9
# ChaCha ARX per block: rounds/2 double rounds x 8 quarter rounds x 12 ops
# (4 add, 4 xor, 4 rotate = one SHF funnel shift each).
ARX_OPS_PER_DOUBLE_ROUND = 8 * 12


def dpxor_bound_ms(rows: int, words: int, queries: int) -> float:
    """Bytes bound: DB and bits read once, answers written once."""
    nbytes = rows * words * 4 + queries * rows * 4 + queries * words * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def fused_bound_ms(rows: int, queries: int, clog: int, rounds: int) -> float:
    """Operations bound: one ChaCha permutation per internal GGM node of
    every chunk subtree, (rows - chunks) per query; corrections, feed-
    forward adds and the leaf mask/XOR are left out (a lower bound)."""
    chunks = rows >> clog
    ops = queries * (rows - chunks) * (rounds // 2) * ARX_OPS_PER_DOUBLE_ROUND
    return ops / INT32_OPS_PER_S * 1e3


def fused_xor_bound(rows: int, words: int, queries: int, clog: int,
                    rounds: int) -> tuple:
    """(bound ms, "bytes" or "operations") of the fused XOR scan: the DB
    read once and the answers written once over HBM, or its ChaCha
    operations (:func:`fused_bound_ms`), the larger."""
    bytes_ms = (rows * words + queries * words) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = fused_bound_ms(rows, queries, clog, rounds)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def gemm_bound_ms(rows: int, cols: int, queries: int) -> float:
    """Bytes bound of the int8 GEMM: DB bytes and shares read once, int32
    answers written once."""
    nbytes = rows * cols + queries * rows + queries * cols * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def fused_add_bound_ms(rows: int, queries: int, clog: int,
                       rounds: int) -> float:
    """Operations bound of the fused select-add: one ChaCha permutation per
    internal node (rows - chunks per query) and one per leaf for its
    conversion word (rows per query); the select-add's multiply-adds and
    the corrections are left out (a lower bound)."""
    chunks = rows >> clog
    blocks = queries * (2 * rows - chunks)
    ops = blocks * (rounds // 2) * ARX_OPS_PER_DOUBLE_ROUND
    return ops / INT32_OPS_PER_S * 1e3


def ggm_bound(n: int, rounds: int) -> dict:
    """Bound of one GGM level over n parents: 20 B read and 40 B written per
    node over HBM, and one ChaCha block per node at the int32 issue rate;
    the larger of the two bounds it."""
    bytes_ms = 60 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = n * (rounds // 2) * ARX_OPS_PER_DOUBLE_ROUND / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def lwe_gemm_bound(m: int, k: int, p: int) -> tuple:
    """(bound ms, "bytes" or "operations") of the wrapping int32 GEMM
    [m, k] x [k, p]: both operands read once and the output written once
    over HBM, or its m*k*p IMADs at the card's IMAD rate, the larger."""
    bytes_ms = (m * k + k * p + m * p) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = m * k * p / IMAD_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")
