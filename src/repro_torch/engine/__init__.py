"""The port's engine plane: kernel registry + measured tuner + plan cache.

Port of ``repro/engine``; it owns plan selection end to end:

``engine/backend.py``   device resolution (``None`` means CUDA) and
                        legal-tile arithmetic.
``engine/kernels.py``   descriptors over the plans the port can run, with
                        their tunable spaces and a feasibility model against
                        the card: device memory for the plain PyTorch work,
                        launch limits for the CUDA kernels.
``engine/tuner.py``     the measured autotuner: times feasible
                        ``ExecutionPlan`` candidates on the real
                        (db_view, bucket) shapes under a budget (CUDA events
                        on the card); ``python -m repro_torch.engine
                        --smoke`` is its gate.
``engine/cache.py``     persistent JSON plan cache keyed by (device name,
                        protocol, spec signature, bucket).

:func:`resolve` is the seam the protocol plane delegates to
(``core/protocol.py resolve_plan`` with ``path=None``/``"auto"``): cache
hit -> the tuned plan; miss -> ``plan_for``, exactly. Resolution happens
once per bucket when ``BucketedServeFns`` first needs the bucket's plan,
never on the dispatch path.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.engine.backend import legal_tile, resolve_device
from repro_torch.engine.cache import (PlanCache, cache_path, device_key,
                                      plan_key, spec_signature)
from repro_torch.engine.kernels import (KERNELS, KernelDescriptor,
                                        ProblemShape, get_kernel,
                                        memory_budget, predicted_peak_bytes,
                                        predicted_step_bytes, serve_kernels)
from repro_torch.engine.tuner import (SMOKE_BUDGET, TuneBudget, TuneResult,
                                      autotune, candidate_plans,
                                      heuristic_plan, plan_label,
                                      problem_shape, tune, tune_standalone)

__all__ = [
    "legal_tile", "resolve_device", "PlanCache", "cache_path", "device_key",
    "plan_key", "spec_signature", "KERNELS", "KernelDescriptor",
    "ProblemShape", "get_kernel", "memory_budget", "predicted_peak_bytes",
    "predicted_step_bytes", "serve_kernels", "SMOKE_BUDGET", "TuneBudget",
    "TuneResult", "autotune", "candidate_plans", "heuristic_plan",
    "plan_label", "problem_shape", "tune", "tune_standalone", "plan_cache",
    "resolve", "plan_report", "record_plans",
]

_PLAN_CACHE: Optional[PlanCache] = None


def plan_cache(reload: bool = False) -> PlanCache:
    """The process-wide plan cache (``REPRO_TORCH_PLAN_CACHE`` location),
    loaded once; ``reload=True`` re-reads it (after a tuner wrote it, or
    after the variable changed)."""
    global _PLAN_CACHE
    if _PLAN_CACHE is None or reload:
        _PLAN_CACHE = PlanCache(cache_path())
    return _PLAN_CACHE


def resolve(cfg, n_queries: int, *, backend: str, device=None,
            chunk_log: int = 12):
    """A plan for (cfg, bucket): tuned on a cache hit, ``plan_for`` on a
    miss. ``device`` (the card a server serves on) keys the lookup; without
    it the backend does (``cuda`` is the current card)."""
    plan = heuristic_plan(cfg, n_queries, backend=backend,
                          chunk_log=chunk_log)   # raises on a bad backend
    hit = plan_cache().get(device_key(backend if device is None else device),
                           cfg.protocol, spec_signature(cfg), n_queries)
    return plan if hit is None else hit


def record_plans(cfg, plans: dict, *, device="cuda",
                 persist: bool = False) -> int:
    """Seed the process-wide cache with ``{bucket: plan}`` warm entries
    (``PlanCache.warm_put``: a tuned entry is never displaced). Returns
    the number written; ``persist=True`` also saves the file."""
    cache = plan_cache()
    key, sig = device_key(device), spec_signature(cfg)
    written = sum(cache.warm_put(key, cfg.protocol, sig, bucket, plan)
                  for bucket, plan in plans.items())
    if persist and written:
        cache.save()
    return written


def plan_report(cfg, plan, bucket: int, *, n_shards: int = 1,
                backend: str = "cuda",
                measured_wall_s: Optional[float] = None) -> dict:
    """Reporting row for one bucket's plan: provenance, the modeled bytes
    its answer step moves (one DB shard's contraction of ``bucket``
    queries when ``n_shards`` > 1, as upstream) and the backend's
    bandwidth roof; with ``measured_wall_s``, the fraction of that roof
    the run reached."""
    from repro_torch.analysis.roofline import (achieved_fraction,
                                               peak_bytes_per_s)
    from repro_torch.core import protocol as protocol_mod
    kind = protocol_mod.get(cfg.protocol).share_kind
    step_bytes = predicted_step_bytes(
        plan, kind, problem_shape(cfg, bucket, n_shards=n_shards))
    out = {
        "plan": plan.name,
        "label": plan_label(plan),
        "provenance": plan.provenance,
        "predicted_step_bytes": step_bytes,
        "peak_bytes_per_s": peak_bytes_per_s(backend),
    }
    if measured_wall_s is not None:
        out["measured_wall_s"] = measured_wall_s
        out["achieved_frac"] = achieved_fraction(step_bytes, measured_wall_s,
                                                 backend=backend)
    return out
