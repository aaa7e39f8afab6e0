"""Single-server PIR twin (SimplePIR-style LWE): hint reuse and epoch
refresh, as ``examples/single_server.py`` runs it on the JAX package.

One server holds the database and answers LWE-encrypted one-hot queries
with a wrapping int32 GEMM (the ``lwe_gemm`` kernel on the card): privacy
rests on LWE, not on parties that never collude. The client fetches the
epoch's hint ``H = A^T.DB`` once, decodes every answer against it, and
fetches again only when ``publish()`` bumps the epoch; the server keeps the
hint up to date by an exact delta.

Run:  PYTHONPATH=src python -m repro_torch.single_server [--device cpu]
(the default device is the CUDA card; without one it raises). The last
line printed is a JSON summary; a wrong record or hint count exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE_LWE
from repro_torch.core import pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import SingleServerPIR


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """Two batches on one hint, then a publish and a batch on the next
    epoch's, at ``PIR_SMOKE_LWE``; raises on a wrong record or hint count
    and returns what happened (kernel counters included)."""
    cfg = PIR_SMOKE_LWE          # 2^14 records x 32 B, lwe-simple-1
    say = print if verbose else (lambda *a: None)
    ops.reset_counts()
    rng = np.random.default_rng(seed)
    db_host = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    system = SingleServerPIR(db_host, cfg, device=device, n_queries=4,
                             buckets=(4,),
                             client_rng=np.random.default_rng(seed + 1))
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B; protocol="
        f"{cfg.protocol} ({system.n_parties} server, no collusion "
        f"assumption, privacy from LWE)")

    indices = [7, 4242, 9000, cfg.n_items - 1]
    records = system.query(indices)
    oracle = np_words_to_bytes(db_host)
    for i, rec in zip(indices, records):
        _check(np.array_equal(rec, oracle[i]), f"D[{i}] mismatch")
        say(f"  D[{i:6d}] -> {bytes(rec)[:8].hex()}... OK")
    system.query([123, 456, 789, 1011])
    _check(system.hint_fetches == 1, "the second batch must reuse the hint")
    _check(system.db.stats.n_hint_builds == 1, "the hint was built twice")
    say(f"hint: built once on the server, fetched once by the client "
        f"({system.hint_fetches} fetch across 2 batches)")

    target = indices[0]
    new_record = rng.integers(0, 1 << 32, size=(1, cfg.item_bytes // 4),
                              dtype=np.uint32)
    system.update([target], new_record)
    epoch = system.publish()
    db_host[target] = new_record[0]
    after = system.query([target])[0]
    _check(np.array_equal(after, np_words_to_bytes(db_host)[target]),
           "the updated row must serve from the new epoch")
    _check(system.db.stats.n_hint_deltas == 1,
           "publish must update the hint by its delta, not rebuild it")
    _check(system.db.stats.n_hint_builds == 1, "the hint was rebuilt")
    _check(system.hint_fetches == 2, "the epoch bump must refresh the cache")
    say(f"published epoch {epoch}: hint delta-updated (O(rows changed)), "
        f"the client's stale hint refreshed ({system.hint_fetches} "
        f"fetches)")
    say("single-server private retrieval verified.")
    counts = ops.counts()
    return {"twin": "single_server", "epoch": epoch,
            "hint_fetches": system.hint_fetches,
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
