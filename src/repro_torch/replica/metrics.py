"""Replica-plane observability: one JSON-serializable snapshot
(``repro/replica/metrics.py``).

Everything an operator's dashboard needs from the fleet, computed from
state the router and schedulers already keep (no new instrumentation on
the dispatch path): per-replica QPS, queue depth, epoch lag, latency
percentiles; router-level failover and resubmission counters.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def replica_snapshot(router, rid: str) -> Dict:
    """One replica's row: health, epoch position, load, service stats."""
    replica = router.replicas[rid]
    stats = replica.stats
    suspects = set(router.registry.suspects())
    lat = list(stats.latencies)
    return {
        "id": rid,
        "state": ("lost" if replica.lost
                  else "suspect" if rid in suspects else "healthy"),
        "running": replica.running,
        "epoch": router.epochs.get(rid, replica.epoch),
        "epoch_lag": router.epoch_lag(rid),
        "queue_depth": replica.queue_depth,
        "answered": stats.answered,
        "batches": stats.batches,
        "pad_fraction": round(stats.pad_fraction, 4),
        "qps": round(stats.qps, 3),
        "p50_latency_s": _percentile(lat, 50),
        "p99_latency_s": _percentile(lat, 99),
    }


def snapshot(router) -> Dict:
    """The fleet snapshot: per-replica rows + router counters."""
    with router._lock:
        rids = list(router.replicas)
    rows = [replica_snapshot(router, rid) for rid in rids]
    answered = sum(r["answered"] for r in rows)
    return {
        "replicas": rows,
        "router": {
            "n_replicas": len(rows),
            "healthy": router.registry.healthy(),
            "suspects": router.registry.suspects(),
            "published_epoch": router.published_epoch,
            "max_epoch_lag": max((r["epoch_lag"] for r in rows), default=0),
            "staleness_bound": router.staleness_bound,
            "answered": answered,
            "failovers": router.failovers,
            "resubmitted": router.resubmitted,
            "integrity_failures": router.integrity_failures,
            "hedges": router.hedges,
            "deadline_expired": router.deadline_expired,
            "retry": {
                "attempts": router.retry_stats.attempts,
                "retried": router.retry_stats.retried,
                "slept_s": round(router.retry_stats.slept_s, 6),
            },
        },
    }


def export_json(router, path: str) -> str:
    """Write :func:`snapshot` to ``path`` (dirs created); returns the
    absolute path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(router), f, indent=2, sort_keys=True)
        f.write("\n")
    return os.path.abspath(path)
