"""Measured autotuner: enumerate feasible plans, time them, keep the winner.

Port of ``repro/engine/tuner.py``:

  1. enumerate candidate ``ExecutionPlan``s from the kernel registry
     (``engine/kernels.py``): spaces legalized for the concrete shapes and
     pruned by the device-memory and launch-limit models,
  2. time each candidate on the real (db_view, bucket) shapes: the
     protocol's whole ``answer_local`` (root descent and kernel), with CUDA
     events on the card and the host clock on the CPU, median of the reps,
  3. keep the fastest and record it in the plan cache (``engine/cache.py``)
     under (device, protocol, spec signature, bucket).

A timed run is what serving pays for one batch: every party's
``answer_local`` back to back, as ``MultiServerPIR`` dispatches them, so
the host's launches of one party overlap the card's work for the one
before. On the card only plans that launch a kernel are candidates.

The heuristic (``core.protocol.plan_for``, unchanged) is candidate #0 and
is always measured. Another plan replaces it only when it is faster by
more than the heuristic's own spread (slowest less fastest of its timed
runs), so noise never moves a bucket off its fallback; a cache miss falls
back to it. Candidates that launch CUDA kernels are timed before
plain-PyTorch ones, and a candidate whose floor already exceeds the best
time measured is skipped without running: the floor is the larger of its
modeled bytes over the peak bandwidth and its modeled eager PyTorch ops
over ``HOST_OP_FLOOR_S`` each. Budgets bound the rest (:class:`TuneBudget`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import roofline
from repro_torch.engine import kernels as kernels_mod
from repro_torch.engine.backend import Device, backend_of, resolve_device
from repro_torch.engine.cache import device_key, spec_signature
from repro_torch.engine.kernels import (ProblemShape, descriptor_for_plan,
                                        get_kernel, plans_from_kernel,
                                        predicted_host_ops,
                                        predicted_peak_bytes,
                                        predicted_step_bytes, serve_kernels)

#: host time of one eager PyTorch op, as a floor: dispatching an op costs
#: the host several microseconds, so one microsecond is a lower bound
HOST_OP_FLOOR_S = 1e-6


# ---------------------------------------------------------------------------
# The deterministic fallback
# ---------------------------------------------------------------------------

def heuristic_plan(cfg, n_queries: int, *, backend: str,
                   chunk_log: int = 12):
    """The cache-miss plan: ``core.protocol.plan_for``, unchanged (its two
    stated deviations from the reference heuristic on the card included)."""
    from repro_torch.core.protocol import plan_for
    return plan_for(cfg, n_queries, backend=backend, chunk_log=chunk_log)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

def problem_shape(cfg, bucket: int, *, n_shards: int = 1) -> ProblemShape:
    """The shape a plan serves: one DB shard's rows (``n_items / n_shards``,
    validated as ``DatabaseSpec.rows_per_shard`` does). Its record width
    is the stored one (with ``cfg.checksum``, 4 bytes past
    ``item_bytes``): the kernels scan the stored rows, and the width
    selects their template instance."""
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.db.spec import DatabaseSpec
    proto = protocol_mod.get(cfg.protocol)
    spec = DatabaseSpec.from_config(cfg)
    return ProblemShape(bucket=bucket, rows=spec.rows_per_shard(n_shards),
                        item_bytes=spec.stored_bytes,
                        components=proto.key_components)


def candidate_plans(cfg, bucket: int, *, backend: str, chunk_log: int = 12,
                    max_per_kernel: Optional[int] = None,
                    mem_budget: Optional[int] = None,
                    pruned: Optional[Dict] = None) -> List:
    """Feasible ExecutionPlans for (cfg, bucket): the tuner's search space.

    One entry per surviving point of each registered serve kernel's space;
    on ``backend="cuda"`` only the kernels that launch CUDA code (the plain
    PyTorch descriptors are the CPU's). Plans over ``mem_budget`` device
    bytes, or past a launch limit, are pruned here without running;
    ``pruned`` (a dict) receives them with their predicted peak bytes.
    """
    from repro_torch.core import protocol as protocol_mod
    proto = protocol_mod.get(cfg.protocol)
    shape = problem_shape(cfg, bucket)
    base = protocol_mod.pin_tile(protocol_mod.ExecutionPlan(
        chunk_log=min(chunk_log, shape.log_rows)), cfg)
    plans: List = []
    for desc in serve_kernels(proto.share_kind):
        if backend == "cuda" and desc.library is None:
            continue
        for plan in plans_from_kernel(desc, shape, base_plan=base,
                                      max_candidates=max_per_kernel,
                                      mem_budget=mem_budget, pruned=pruned):
            if plan not in plans:
                plans.append(plan)
    return plans


def plan_label(plan) -> str:
    """Stable key for timing tables: the path, and for the chunked paths
    the levels each chunk expands (the fused kernels' chunk_log after their
    row tile clamps it)."""
    lbl = f"{plan.expand}/{plan.scan}"
    if plan.expand == "fused":
        lbl += f"/cl{plan.chunk_log}"
    elif plan.expand == "fused-cuda":
        lbl += f"/cl{min(plan.chunk_log, plan.tile_r.bit_length() - 1)}"
    return lbl


def _canonical(plan, shape: ProblemShape, share_kind: str):
    """Normalize fields the step does not read before dedup and timing, so
    one executable is timed once: the fused kernels' (tile_r, chunk_log)
    legalized as the kernel registry does; the plain chunked XOR path's
    chunk_log clipped to the DB, its fold always the plain one; the GEMM
    schemes' ``fused`` (and LWE's every) expand is a materialized one."""
    if plan.expand == "fused-cuda":
        return replace(plan, **kernels_mod.fused_kernel_legalize(
            shape, {"tile_r": plan.tile_r, "chunk_log": plan.chunk_log}))
    if share_kind == "xor":
        if plan.expand == "fused":
            return replace(plan, scan="torch",
                           chunk_log=min(plan.chunk_log, shape.log_rows))
        return plan
    return replace(plan, expand="materialize")


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TuneBudget:
    """How much wall clock / search breadth a tune may spend."""
    max_candidates: Optional[int] = 8      # per kernel, after pruning
    warmup: int = 1                        # untimed runs per candidate
    iters: int = 3                         # timed reps (median kept)
    max_seconds: float = 120.0             # soft cap, checked between plans


#: the smoke budget: <= 2 candidates per kernel, one timed rep
SMOKE_BUDGET = TuneBudget(max_candidates=2, warmup=1, iters=1,
                          max_seconds=90.0)


@dataclass
class TuneResult:
    plan: object                   # the winner, provenance="tuned"
    heuristic: object              # the deterministic fallback (measured)
    timings: Dict[str, float]      # plan_label -> median seconds per batch
    n_candidates: int              # search-space size after pruning
    n_timed: int                   # how many the budget let us measure
    n_pruned: int = 0              # skipped on the floor, never run
    #: the heuristic's slowest less fastest timed run: the margin another
    #: plan must beat it by to win
    heuristic_spread_s: float = 0.0
    #: plan_label -> predicted peak bytes of candidates the device-memory
    #: model (or a launch limit) pruned before timing
    mem_pruned: Dict[str, int] = field(default_factory=dict)
    #: the heuristic's peak device bytes: the model's and, on the card,
    #: ``max_memory_allocated`` over its timed runs (above the inputs)
    heuristic_peak: Dict[str, Optional[int]] = field(default_factory=dict)

    @property
    def heuristic_s(self) -> float:
        return self.timings[plan_label(self.heuristic)]

    @property
    def tuned_s(self) -> float:
        return self.timings[plan_label(self.plan)]

    @property
    def speedup(self) -> float:
        return self.heuristic_s / self.tuned_s if self.tuned_s else 0.0


@dataclass
class MeasurementInputs:
    """What the tuner times on: the protocol's DB view on the device and
    one key batch per party of the largest bucket (smaller buckets take
    its first queries)."""
    db: torch.Tensor
    keys: tuple
    bucket: int

    def keys_for(self, bucket: int) -> tuple:
        from repro_torch.core.server import map_keys
        if bucket > self.bucket:
            raise ValueError(f"inputs hold {self.bucket} queries, not "
                             f"{bucket}")
        return tuple(map_keys(k, lambda x: x[:bucket]) for k in self.keys)


def measurement_inputs(cfg, bucket: int, *, device: Device = None,
                       seed: int = 0) -> MeasurementInputs:
    """Real-shape inputs drawn as the reference's tuner draws them (one
    generator from ``seed``: the database, then ``bucket`` indices, then
    their keys) and placed on the device once."""
    from repro_torch.core import pir
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.db import Database
    dev = resolve_device(device)
    proto = protocol_mod.get(cfg.protocol)
    rng = np.random.default_rng(seed)
    db_words = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    db = Database(db_words, cfg, dev).view(proto.db_view)
    idx = rng.integers(0, cfg.n_items, size=bucket).tolist()
    if proto.needs_hint:
        keys = proto.query_gen_batch(rng, idx, cfg, device=dev)
    else:
        keys = tuple(k.to(dev) for k in proto.query_gen_batch(rng, idx, cfg))
    return MeasurementInputs(db=db, keys=keys, bucket=bucket)


def timed_seconds(fn, device: torch.device, budget: TuneBudget
                  ) -> List[float]:
    """Seconds of each timed run of ``fn()`` after the budget's warm-up
    runs: CUDA events around each run on the card (the host waits for
    each), the host clock on the CPU."""
    on_card = device.type == "cuda"
    for _ in range(max(budget.warmup, 1)):
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(max(budget.iters, 1)):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return ts


def time_plan(proto, plan, db, keys: tuple, log_local: int,
              budget: TuneBudget) -> List[float]:
    """Seconds of each timed run of one batch under ``plan``: every party's
    whole ``answer_local`` (root descent and kernel), back to back."""
    def batch():
        for k in keys:
            proto.answer_local(db, k, 0, log_local, plan)
    return timed_seconds(batch, db.device, budget)


def _floor_s(plan, share_kind: str, shape: ProblemShape, backend: str,
             parties: int = 1) -> float:
    return parties * max(
        predicted_step_bytes(plan, share_kind, shape)
        / roofline.peak_bytes_per_s(backend),
        predicted_host_ops(plan, share_kind, shape) * HOST_OP_FLOOR_S)


def tune(cfg, bucket: int, *, device: Device = None,
         budget: Optional[TuneBudget] = None, chunk_log: int = 12,
         cache=None, seed: int = 0,
         inputs: Optional[MeasurementInputs] = None) -> TuneResult:
    """Measure the candidate plans for one (cfg, bucket) and pick a winner.

    The heuristic plan is measured first and unconditionally; another plan
    wins only if its median beats the heuristic's by more than the
    heuristic's spread, so the tuned result is never slower than the
    fallback on the measured shapes. ``inputs`` (from
    :func:`measurement_inputs`) are drawn here when not given. Pass
    ``cache`` (a :class:`~repro_torch.engine.cache.PlanCache`) to record
    the winner; the caller owns ``cache.save()``.
    """
    from repro_torch.core import protocol as protocol_mod
    budget = budget or TuneBudget()
    dev = resolve_device(device)
    be = backend_of(dev)
    proto = protocol_mod.get(cfg.protocol)
    kind = proto.share_kind
    shape = problem_shape(cfg, bucket)
    if inputs is None:
        inputs = measurement_inputs(cfg, bucket, device=dev, seed=seed)
    db, keys = inputs.db, inputs.keys_for(bucket)

    heur = _canonical(heuristic_plan(cfg, bucket, backend=be,
                                     chunk_log=chunk_log), shape, kind)
    pruned: Dict = {}
    cands = [_canonical(p, shape, kind) for p in candidate_plans(
        cfg, bucket, backend=be, chunk_log=chunk_log,
        max_per_kernel=budget.max_candidates,
        mem_budget=kernels_mod.memory_budget(dev), pruned=pruned)]
    # kernels first: the plain PyTorch candidates are the slow ones, and
    # the time budget should cut them, not the kernels
    by_label = {plan_label(heur): heur}
    for p in [p for p in cands if p.scan == "cuda"] + \
            [p for p in cands if p.scan != "cuda"]:
        by_label.setdefault(plan_label(p), p)     # one executable, one run

    t_start = time.perf_counter()
    timings: Dict[str, float] = {}
    spread = 0.0
    n_pruned = 0
    peak = {"predicted": predicted_peak_bytes(heur, kind, shape),
            "measured": None}
    for i, (label, plan) in enumerate(by_label.items()):
        if i > 0 and time.perf_counter() - t_start > budget.max_seconds:
            break                    # budget spent; heuristic was first
        # a plan whose floor exceeds the best measured so far could not
        # win at the roof: it is never run (the heuristic always is)
        if i > 0 and _floor_s(plan, kind, shape, be, len(keys)) > \
                min(timings.values()):
            n_pruned += 1
            continue
        if i == 0 and dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        runs = time_plan(proto, plan, db, keys, cfg.log_n, budget)
        timings[label] = float(np.median(runs))
        if i == 0:
            spread = max(runs) - min(runs)
            if dev.type == "cuda":
                peak["measured"] = torch.cuda.max_memory_allocated(dev) - base

    heur_label = plan_label(heur)
    best_label = min(timings, key=timings.get)
    if timings[best_label] >= timings[heur_label] - spread:
        best_label = heur_label
    tuned = replace(by_label[best_label], provenance="tuned")
    mem_pruned = {plan_label(_canonical(p, shape, kind)): b
                  for p, b in pruned.items()}
    if cache is not None:
        cache.put(device_key(dev), proto.name, spec_signature(cfg), bucket,
                  tuned, meta={
                      "tuned_s": timings[best_label],
                      "heuristic_s": timings[heur_label],
                      "heuristic_spread_s": spread,
                      "n_candidates": len(by_label),
                      "n_timed": len(timings),
                      "n_pruned": n_pruned,
                  })
    return TuneResult(plan=tuned, heuristic=heur, timings=timings,
                      n_candidates=len(by_label), n_timed=len(timings),
                      n_pruned=n_pruned, heuristic_spread_s=spread,
                      mem_pruned=mem_pruned, heuristic_peak=peak)


def autotune(cfg, buckets: Sequence[int], *, device: Device = None,
             budget: Optional[TuneBudget] = None, cache=None,
             persist: bool = True, seed: int = 0) -> Dict[int, TuneResult]:
    """Tune every bucket of a config and (optionally) persist the winners.

    The inputs are drawn and placed on the device once, for the largest
    bucket. ``cache=None`` uses the process-wide plan cache
    (``repro_torch.engine.plan_cache()``), so servers built afterwards with
    ``path=None`` pick the tuned plans up; ``persist`` also writes its file.
    """
    from repro_torch import engine
    cache = cache if cache is not None else engine.plan_cache()
    buckets = sorted(set(buckets))
    inputs = measurement_inputs(cfg, buckets[-1], device=device, seed=seed)
    out = {b: tune(cfg, b, device=device, budget=budget, cache=cache,
                   inputs=inputs) for b in buckets}
    if persist:
        cache.save()
    return out


def tune_standalone(kernel_name: str, n: int, *,
                    budget: Optional[TuneBudget] = None, rounds: int = 12,
                    seed: int = 0, device: Device = None) -> Dict:
    """Tune a non-serve kernel (``ggm-expand``) standalone.

    Times ``ops.ggm_expand`` at ``n`` parent nodes over its threads-per-
    block space (CUDA events on the card, the host clock on the CPU);
    returns ``{"params", "timings"}`` (seconds by candidate). GGM expansion
    is no ``ExecutionPlan`` field, so the result is reported, not cached.
    """
    from repro_torch.kernels import ops
    budget = budget or TuneBudget()
    desc = get_kernel(kernel_name)
    if desc.serve:
        raise ValueError(f"{kernel_name} is a serve kernel; use tune()")
    dev = resolve_device(device)
    shape = ProblemShape(bucket=1, rows=n, item_bytes=4)
    rng = np.random.default_rng(seed)

    def draw(size, high):
        return torch.from_numpy(rng.integers(0, high, size=size,
                                             dtype=np.uint32).view(np.int32)
                                ).to(dev)

    seeds, t_bits = draw((n, 4), 1 << 32), draw((n,), 2)
    cw_s, cw_t = draw((4,), 1 << 32), draw((2,), 2)
    timings: Dict[str, float] = {}
    for params in desc.candidates(shape, budget.max_candidates):
        timings[f"tile{params['tile']}"] = float(np.median(timed_seconds(
            lambda: ops.ggm_expand(seeds, t_bits, cw_s, cw_t, rounds=rounds,
                                   tile=params["tile"]), dev, budget)))
    best = min(timings, key=timings.get)
    return {"params": {"tile": int(best[4:])}, "timings": timings}


# ---------------------------------------------------------------------------
# Smoke: heuristic-fallback gate + tiny-budget tunes
# ---------------------------------------------------------------------------

#: ``plan_for``'s choices on the smoke grid, as literals — (protocol,
#: log_n, n_queries, backend) -> (expand, scan). The cpu rows are the
#: reference's ``_PRE_ENGINE_EXPECTED`` with jnp -> torch; the cuda rows
#: are the port's stated deviations on the card (PERF.md §3): kernels
#: always, ``fused-cuda`` past one query on a DB over 2^12 rows for the DPF
#: schemes, ``materialize`` at every LWE bucket. Hardcoded so a rule change
#: cannot rewrite its own oracle.
_HEURISTIC_EXPECTED = {
    ("xor-dpf-2", 10, 1, "cpu"): ("materialize", "torch"),
    ("xor-dpf-2", 10, 4, "cpu"): ("materialize", "torch"),
    ("additive-dpf-2", 10, 1, "cpu"): ("materialize", "torch"),
    ("additive-dpf-2", 10, 4, "cpu"): ("materialize", "torch"),
    ("xor-dpf-2", 14, 1, "cpu"): ("materialize", "torch"),  # single query
    ("xor-dpf-2", 14, 4, "cpu"): ("fused", "torch"),        # big-db regime
    ("xor-dpf-2", 10, 4, "cuda"): ("materialize", "cuda"),
    ("additive-dpf-2", 10, 4, "cuda"): ("materialize", "cuda"),
    ("xor-dpf-2", 14, 1, "cuda"): ("materialize", "cuda"),
    ("xor-dpf-2", 14, 4, "cuda"): ("fused-cuda", "cuda"),
    ("additive-dpf-2", 14, 4, "cuda"): ("fused-cuda", "cuda"),
    ("lwe-simple-1", 14, 4, "cuda"): ("materialize", "cuda"),
}


def _check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def smoke(device: Device = None) -> int:
    """The engine's smoke gate on ``device`` (``None`` means CUDA).

    Checks, for every cell of a small grid, that the cache-miss plan is
    ``plan_for``'s literal choice (above); runs one tiny tune per share
    kind into an in-memory cache and checks the hit; and checks a fused
    kernel candidate's answer at 2^8 rows against the materialized oracle.
    Nothing is persisted.
    """
    from repro_torch.config import PIRConfig
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.core.protocol import GEMM_TILE_R_DEFAULT, plan_for
    from repro_torch.engine.cache import PlanCache
    dev = resolve_device(device)

    for (name, log_n, n_q, be), want in _HEURISTIC_EXPECTED.items():
        cfg = PIRConfig(n_items=1 << log_n, item_bytes=32, protocol=name,
                        n_servers=1 if name == "lwe-simple-1" else 2)
        got = plan_for(cfg, n_q, backend=be)
        _check((got.expand, got.scan) == want,
               f"heuristic drifted from plan_for's rules: {name} 2^{log_n} "
               f"n_q={n_q} {be}: {(got.expand, got.scan)} != {want}")
        _check(got.chunk_log == 12 and got.provenance == "heuristic",
               f"heuristic plan fields drifted: {got}")
        if name != "xor-dpf-2":
            _check(got.tile_r == GEMM_TILE_R_DEFAULT,
                   f"GEMM scheme plan lost its pinned tile: {got}")
    print(f"[smoke] heuristic fallback == plan_for on "
          f"{len(_HEURISTIC_EXPECTED)} grid cells", flush=True)

    cache = PlanCache(path=None)             # in-memory only
    for name in ("xor-dpf-2", "additive-dpf-2", "lwe-simple-1"):
        cfg = PIRConfig(n_items=1 << 10, item_bytes=32, protocol=name,
                        n_servers=1 if name == "lwe-simple-1" else 2)
        res = tune(cfg, 2, device=dev, budget=SMOKE_BUDGET, cache=cache)
        _check(res.tuned_s <= res.heuristic_s,
               f"{name}: tuned plan slower than the heuristic")
        print(f"[smoke] {name}: tuned {plan_label(res.plan)} "
              f"{res.tuned_s * 1e3:.3f} ms vs heuristic "
              f"{plan_label(res.heuristic)} {res.heuristic_s * 1e3:.3f} ms "
              f"({res.n_timed}/{res.n_candidates} candidates timed)",
              flush=True)
        hit = cache.get(device_key(dev), cfg.protocol, spec_signature(cfg),
                        2)
        _check(hit == res.plan and hit.provenance == "tuned",
               f"{name}: plan cache round trip lost the tuned plan")
    print("[smoke] plan cache round-trip ok", flush=True)

    cfg = PIRConfig(n_items=1 << 8, item_bytes=32)
    proto = protocol_mod.get(cfg.protocol)
    fused = [p for p in candidate_plans(cfg, 2, backend=backend_of(dev))
             if p.expand == "fused-cuda"]
    _check(bool(fused), "no legal fused-cuda candidate at 2^8")
    plan = fused[0]
    _check(descriptor_for_plan(plan, proto.share_kind).name
           == "xor-fused-cuda", "fused-cuda plan maps to the wrong kernel")
    inputs = measurement_inputs(cfg, 2, device=dev, seed=7)
    oracle = heuristic_plan(cfg, 2, backend=backend_of(dev))
    want = proto.answer_local(inputs.db, inputs.keys[0], 0, cfg.log_n,
                              oracle)
    got = proto.answer_local(inputs.db, inputs.keys[0], 0, cfg.log_n, plan)
    _check(torch.equal(got.cpu(), want.cpu()),
           "fused-cuda answer diverges from the materialized oracle")
    print(f"[smoke] fused kernel parity ok ({plan_label(plan)} vs "
          f"{plan_label(oracle)})", flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.engine",
        description="The port's plan tuner: run its smoke gate.")
    ap.add_argument("--smoke", action="store_true",
                    help="heuristic-fallback gate + tiny-budget tunes")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    ap.print_help()
    return 2
