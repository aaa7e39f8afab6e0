"""Where a served batch's time goes, on the heuristic and the tuned plans.

    python -m repro_torch.analysis.serve_trace [--config pir-1g]
        [--batch 32] [--out DIR] [--device cuda|cpu]

Builds the configuration's database from a seed and a ``TwoServerPIR`` on
the heuristic plans (plan cache off), then prints one JSON line per step:

  before    the heuristic deployment's batch latency (host clock around
            ``query()``), before anything is tuned
  tune      ``engine.autotune`` of the batch's bucket into a plan cache
            under a temporary directory
  after     the heuristic and a tuned deployment timed interleaved
            (heuristic, tuned, tuned, heuristic), which parts the plan's
            effect from that of what the process ran before
  trace     one batch on each deployment under ``torch.profiler`` (CPU and
            CUDA activities): wall time, the device's busy time (the union
            of its kernel and copy intervals) and idle share, its kernel
            count, and the host ops with the most time of their own; the
            Chrome traces go to ``DIR`` when it is given

The tuned plans are read through the plan cache the tune wrote, as a
server with ``path=None`` reads them; nothing is written under
``results/``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SEED = 20251016


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _deployment(database, cfg, batch: int, seed: int, device):
    """A TwoServerPIR whose plans are resolved now, under the current
    plan cache."""
    from repro_torch.runtime.serve_loop import TwoServerPIR
    system = TwoServerPIR(database, cfg, device=device, n_queries=batch,
                          buckets=(batch,), path=None,
                          client_rng=np.random.default_rng(seed))
    for server in system.servers:
        server.bucketed.plan_for_bucket(batch)
    return system


def _latency(system, cfg, rng, batch: int) -> float:
    idx = rng.integers(0, cfg.n_items, size=batch)
    t0 = time.perf_counter()
    system.query(idx)
    return time.perf_counter() - t0


def _summary(lat: List[float]) -> Dict:
    return {"latency_s": lat, "median_s": float(np.median(lat)),
            "spread_s": max(lat) - min(lat)}


def device_intervals(prof) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name) of each device kernel and copy of a
    finished ``torch.profiler`` run, read from kineto's own records:
    ``prof.events()`` builds a Python object per event, tens of times
    slower over a train step's hundreds of thousands of kernels."""
    from torch.autograd import DeviceType
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def union_us(intervals: List[Tuple[float, float, str]]) -> float:
    """The device's busy µs: the length of the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi, _ in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _trace(system, cfg, rng, batch: int, out: Optional[str], name: str
           ) -> Dict:
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    idx = rng.integers(0, cfg.n_items, size=batch)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        system.query(idx)
        wall_s = time.perf_counter() - t0
    device = device_intervals(prof)
    busy_s = union_us(device) / 1e6
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    if out:
        prof.export_chrome_trace(os.path.join(out, f"{name}_b{batch}.json"))
    return {"wall_s": wall_s, "device_events": len(device),
            "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall_s if device else None,
            "host_top": [{"op": a.key, "calls": a.count,
                          "self_cpu_ms": a.self_cpu_time_total / 1e3}
                         for a in host]}


def run(config: str = "pir-1g", batch: int = 32, out: Optional[str] = None,
        device=None, reps: int = 4) -> Dict:
    from repro_torch import engine
    from repro_torch.configs.pir import PIR_CONFIGS
    from repro_torch.core import pir
    from repro_torch.db import Database
    from repro_torch.engine.backend import resolve_device
    from repro_torch.engine.cache import CACHE_ENV
    from repro_torch.engine.tuner import TuneBudget, autotune, plan_label
    cfg = PIR_CONFIGS[config]
    dev = resolve_device(device)
    if out:
        os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(SEED + 1)
    host_db = pir.make_database(np.random.default_rng(SEED), cfg.n_items,
                                cfg.item_bytes)
    database = Database(host_db, cfg, dev)
    saved = os.environ.get(CACHE_ENV)
    folder = tempfile.mkdtemp(prefix="repro_torch_trace_")
    result: Dict = {}
    try:
        os.environ[CACHE_ENV] = "off"
        engine.plan_cache(reload=True)
        systems = {"heuristic": _deployment(database, cfg, batch, SEED + 2,
                                            dev)}
        _latency(systems["heuristic"], cfg, rng, batch)          # warm-up
        result["before"] = _summary([_latency(systems["heuristic"], cfg, rng,
                                              batch) for _ in range(reps)])
        _emit({"step": "before", "config": config, "batch": batch,
               **result["before"]})

        os.environ[CACHE_ENV] = os.path.join(folder, "plans.json")
        engine.plan_cache(reload=True)
        t0 = time.perf_counter()
        res = autotune(cfg, (batch,), device=dev, cache=engine.plan_cache(),
                       budget=TuneBudget(max_candidates=8, warmup=1, iters=3,
                                         max_seconds=20.0))[batch]
        _emit({"step": "tune", "heuristic": plan_label(res.heuristic),
               "tuned": plan_label(res.plan),
               "timings_ms": {k: v * 1e3 for k, v in res.timings.items()},
               "heuristic_spread_ms": res.heuristic_spread_s * 1e3,
               "seconds": time.perf_counter() - t0})

        systems["tuned"] = _deployment(database, cfg, batch, SEED + 3, dev)
        _latency(systems["tuned"], cfg, rng, batch)              # warm-up
        lat: Dict[str, List[float]] = {name: [] for name in systems}
        for _ in range(reps):
            for name in ("heuristic", "tuned", "tuned", "heuristic"):
                lat[name].append(_latency(systems[name], cfg, rng, batch))
        result["after"] = {name: _summary(v) for name, v in lat.items()}
        _emit({"step": "after", "plans": {
            name: plan_label(s.servers[0].bucketed.plan_for_bucket(batch))
            for name, s in systems.items()}, **result["after"]})

        for name, system in systems.items():
            result[f"trace_{name}"] = _trace(system, cfg, rng, batch, out,
                                             name)
            _emit({"step": "trace", "deployment": name,
                   **result[f"trace_{name}"]})
    finally:
        if saved is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = saved
        engine.plan_cache(reload=True)
        shutil.rmtree(folder, ignore_errors=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.serve_trace",
        description="Trace a served batch on the heuristic and the tuned "
                    "plans.")
    ap.add_argument("--config", default="pir-1g")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome traces")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.config, args.batch, args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
