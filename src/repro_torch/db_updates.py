"""Online database updates twin: stage, publish, re-query under 3-server
PIR, as ``examples/db_updates.py`` runs it on the JAX package.

``MultiServerPIR.update`` stages public row writes and ``publish`` swaps
them in as a new epoch: the host sends only the written rows, and the
device copies the database once (copy-on-publish) so that batches already
dispatched keep reading the old epoch. Updates are public metadata (privacy
protects the query index, not the data), so all three parties apply the
same delta. Every answer future is tagged with the epoch it was computed
at.

Run:  PYTHONPATH=src python -m repro_torch.db_updates [--device cpu]
(the default device is the CUDA card; without one it raises).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE_UPD
from repro_torch.core import pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.runtime.serve_loop import MultiServerPIR


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """Query, update one row, publish, query again at ``PIR_SMOKE_UPD``;
    raises on a wrong record or tag and returns what happened."""
    cfg = PIR_SMOKE_UPD          # 2^10 records x 32 B, xor-dpf-k, k = 3
    rng = np.random.default_rng(seed)
    db_host = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    say = print if verbose else (lambda *a: None)
    system = MultiServerPIR(db_host, cfg, device=device, n_queries=2,
                            buckets=(2,),
                            client_rng=np.random.default_rng(seed + 1))
    stats = system.db.stats
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B; protocol="
        f"{cfg.protocol} ({system.n_parties} parties, one shared database: "
        f"{stats.preload_h2d_bytes} B host->device)")

    target, bystander = 123, 877
    before = system.query([target, bystander])
    if not (np.array_equal(before[0], db_host[target])
            and np.array_equal(before[1], db_host[bystander])):
        raise AssertionError("a record before the update differs")
    say(f"epoch {system.epoch}: D[{target}] = "
        f"{bytes(np_words_to_bytes(before[0]))[:8].hex()}...")

    new_record = rng.integers(0, 1 << 32, size=(1, cfg.item_bytes // 4),
                              dtype=np.uint32)
    system.update([target], new_record)
    epoch = system.publish()
    delta_bytes = stats.update_h2d_bytes
    say(f"published epoch {epoch}: rewrote D[{target}] ({delta_bytes} B "
        f"host->device, against {cfg.db_bytes} B for a full placement; "
        f"{stats.clone_device_bytes} B copied on the device)")
    if delta_bytes >= cfg.db_bytes // 100:        # O(rows), not O(db)
        raise AssertionError(f"the update moved {delta_bytes} B")
    if stats.n_full_placements != 1:
        raise AssertionError("the update placed the database again")

    futs = [system.submit(target), system.submit(bystander)]
    system.scheduler.pump()
    after = [f.result(timeout=360.0) for f in futs]
    if not np.array_equal(after[0], new_record[0]):
        raise AssertionError("the updated row does not serve its new value")
    if not np.array_equal(after[1], db_host[bystander]):
        raise AssertionError("an untouched row changed")
    if any(f.epoch != epoch for f in futs):
        raise AssertionError(f"answers tagged {[f.epoch for f in futs]}, "
                             f"not {epoch}")
    say(f"epoch {epoch}: D[{target}] = "
        f"{bytes(np_words_to_bytes(after[0]))[:8].hex()}... (new record, "
        f"answer futures tagged epoch={futs[0].epoch})")
    say("online update served: updated and untouched rows verified on "
        "3-server PIR.")
    return {"epoch": epoch, "tags": [f.epoch for f in futs],
            "update_h2d_bytes": delta_bytes,
            "clone_device_bytes": stats.clone_device_bytes,
            "device": str(system.db.device)}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
