"""Streaming PIR session twin: concurrent clients, one pipelined
scheduler, as ``examples/serving_session.py`` runs it on the JAX package.

Several client threads submit queries at their own pace; the scheduler
coalesces them into padded bucket batches, pipelines their dispatch, and
resolves each client's ``AnswerFuture`` once the two parties' shares are
reconciled.

Run:  PYTHONPATH=src python -m repro_torch.serving_session [--device cpu]
(the default device is the CUDA card; without one it raises). The last
line printed is a JSON summary; a wrong record exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.config import PIRConfig
from repro_torch.core import pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import TwoServerPIR

N_CLIENTS = 3
QUERIES_PER_CLIENT = 4


def _client(name: str, system: TwoServerPIR, db, rng, errors: list, say):
    indices = rng.integers(0, system.cfg.n_items,
                           size=QUERIES_PER_CLIENT).tolist()
    futures = [(i, system.submit(i)) for i in indices]  # returns at once
    for idx, fut in futures:
        row = fut.result(timeout=300.0)
        ok = np.array_equal(row, db[idx])
        say(f"  [{name}] D[{idx:5d}] -> "
            f"{bytes(np_words_to_bytes(row))[:8].hex()}... "
            f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            errors.append((name, idx))


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """Serve ``N_CLIENTS`` client threads of ``QUERIES_PER_CLIENT`` queries
    each through one background session; raises on a wrong record and
    returns the scheduler's stats (kernel counters included)."""
    cfg = PIRConfig(n_items=1 << 12, item_bytes=32)
    say = print if verbose else (lambda *a: None)
    ops.reset_counts()
    db = pir.make_database(np.random.default_rng(seed), cfg.n_items,
                           cfg.item_bytes)
    system = TwoServerPIR(db, cfg, device=device, n_queries=4, buckets=(4,),
                          client_rng=np.random.default_rng(seed + 1))
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B; "
        f"buckets={system.servers[0].buckets}")

    errors: list = []
    with system:                                  # background session
        threads = [threading.Thread(
            target=_client, args=(f"client{c}", system, db,
                                  np.random.default_rng(seed + 100 + c),
                                  errors, say))
            for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    stats = system.scheduler.stats
    say(f"answered={stats.answered} batches={stats.batches} "
        f"padded={stats.padded} (pad fraction {stats.pad_fraction:.0%})")
    if errors or stats.answered != N_CLIENTS * QUERIES_PER_CLIENT:
        raise AssertionError(f"mismatches {errors}, answered "
                             f"{stats.answered}")
    say("all private retrievals verified.")
    counts = ops.counts()
    return {"twin": "serving_session", "answered": stats.answered,
            "batches": stats.batches, "padded": stats.padded,
            "pad_fraction": stats.pad_fraction, "qps": stats.qps,
            "device": str(system.db.device),
            "launches": {k: v["launches"] for k, v in counts.items()},
            "plain_calls": {k: v["plain_calls"] for k, v in counts.items()}}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device, seed=args.seed)))


if __name__ == "__main__":
    main()
