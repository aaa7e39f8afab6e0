"""Quickstart twin: private information retrieval on the port.

Spins up the two non-colluding servers on one device, retrieves records
without either server learning which, and checks the reconstruction —
the paper's Figure 2 flow, as ``examples/quickstart.py`` runs it on the
JAX package.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
(the default device is the CUDA card; without one it raises).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE
from repro_torch.core import pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.runtime.serve_loop import TwoServerPIR


def run(device: Optional[str] = None, seed: int = 0,
        indices: Optional[Sequence[int]] = None, verbose: bool = True
        ) -> dict:
    """Retrieve ``indices`` (default ``[7, 4242, 9000, N-1]``) at
    ``PIR_SMOKE`` and return what happened; raises on a wrong record."""
    cfg = PIR_SMOKE
    rng = np.random.default_rng(seed)
    db = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    if indices is None:
        indices = [7, 4242, 9000, cfg.n_items - 1]
    say = print if verbose else (lambda *a: None)
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B "
        f"({cfg.db_bytes / (1 << 20):.1f} MiB)")
    system = TwoServerPIR(db, cfg, device=device, n_queries=4,
                          client_rng=np.random.default_rng(seed + 1))
    say(f"querying indices {list(indices)} (servers never see these)")
    t0 = time.perf_counter()
    records = system.query(indices)
    seconds = time.perf_counter() - t0
    exact = [bool(np.array_equal(rec, db[i]))
             for i, rec in zip(indices, records)]
    for i, rec, ok in zip(indices, records, exact):
        say(f"  D[{i:6d}] -> {bytes(np_words_to_bytes(rec))[:8].hex()}... "
            f"{'OK' if ok else 'MISMATCH'}")
    if not all(exact):
        raise AssertionError(f"wrong records at {indices}: {exact}")
    say("private retrieval verified.")
    plan = system.servers[0].bucketed.plan_for_bucket(
        system.servers[0].bucketed.bucket_for(len(indices)))
    return {"indices": list(indices), "exact": exact, "plan": plan.name,
            "device": str(system.db.device), "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
