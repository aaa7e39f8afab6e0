"""Batch PIR twin: m records per round through cuckoo buckets, as
``examples/batch_query.py`` runs it on the JAX package.

A ``BatchPIR`` session retrieves m = 4 records per round by cuckoo-hashing
the requested indices into B = 2m buckets (each a slice of the database
of ``capacity`` rows, every record replicated under 3 hash functions) and
sending exactly one real-or-dummy query per bucket: the servers see a
B-wide round whatever the indices, and a round's B · capacity (about 4N)
scanned rows serve m records instead of one. All B buckets share one plan
per party. Mid-session, a stage and publish lands in every candidate
bucket and the next round's future carries the new epoch.

Run:  PYTHONPATH=src python -m repro_torch.batch_query [--device cpu]
(the default device is the CUDA card; without one it raises).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE_BATCH
from repro_torch.core import pir
from repro_torch.runtime.batch import BatchPIR


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """One round, an update and a round after it at ``PIR_SMOKE_BATCH``;
    raises on a wrong record, width or tag and returns what happened."""
    cfg = PIR_SMOKE_BATCH        # 2^10 records x 32 B, m = 4, checksums on
    rng = np.random.default_rng(seed)
    db_host = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    say = print if verbose else (lambda *a: None)

    system = BatchPIR(db_host, cfg, device=device,
                      client_rng=np.random.default_rng(seed + 1))
    bdb = system.db
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B -> m="
        f"{cfg.batch_m} batch: B={bdb.n_buckets} buckets x {bdb.capacity} "
        f"rows (expansion {bdb.expansion:.1f}x, cuckoo failure bound "
        f"{system.layout.params.failure_bound():.3f})")

    batch = [123, 7, 877, 123]           # a duplicate shares a bucket query
    records = system.query_batch(batch)
    for i, rec in zip(batch, records):
        if not np.array_equal(rec, db_host[i]):
            raise AssertionError(f"record {i} differs")
    rounds, width = system.dispatch_log[-1]
    if width != bdb.n_buckets:
        raise AssertionError(f"a round was {width} wide, not "
                             f"{bdb.n_buckets}")
    say(f"epoch {bdb.epoch}: {len(batch)} records in {rounds} round(s) of "
        f"{width} per-bucket queries (scanned {width * bdb.capacity} rows "
        f"vs {len(set(batch)) * cfg.n_items} single-query)")

    target = batch[0]
    new_record = rng.integers(0, 1 << 32, size=(1, cfg.item_bytes // 4),
                              dtype=np.uint32)
    system.update([target], new_record)
    epoch = system.publish()
    fut = system.submit_batch([target, 7])
    system.scheduler.pump()
    after = fut.result(timeout=360.0)
    if not np.array_equal(after[0], new_record[0]):
        raise AssertionError("the updated row does not serve its new value")
    if not np.array_equal(after[1], db_host[7]):
        raise AssertionError("an untouched row changed")
    if fut.epoch != epoch:
        raise AssertionError(f"tagged {fut.epoch}, not {epoch}")
    say(f"published epoch {epoch}: D[{target}] rewritten in all "
        f"{len(system.layout.occurrences(target))} candidate buckets; "
        f"post-publish round tagged epoch={fut.epoch}")

    # every bucket of every round, before and after the publish, ran on
    # one plan per party: the buckets share one shape
    plans = [s.plan_for_bucket(1).name for s in system.serve]
    say(f"batch session served: {system.n_parties} parties x one plan "
        f"({plans[0]}), uniform {bdb.n_buckets}-wide rounds, checksums "
        f"verified on every reconstruction.")
    return {"epoch": epoch, "tag": fut.epoch, "n_buckets": bdb.n_buckets,
            "capacity": bdb.capacity, "dispatch_log": list(system.dispatch_log),
            "plans": plans, "device": str(bdb.device)}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
