"""Three-server PIR twin: ``xor-dpf-k`` with k = 3 through the protocol
plane, as ``examples/multi_server.py`` runs it on the JAX package.

One real DPF pair is blinded by a ring of pairwise-shared GGM mask seeds:
each of the three servers scans the whole database with a dense
pseudorandom selection vector, so no server (and no single answer share)
learns the queried index, and the client XORs all three shares. Below the
facade it is the quickstart's machinery: one ``PIRServer`` per party, one
``QueryScheduler``, shares reconciled by ``PIRProtocol.reconstruct_with``.

Run:  PYTHONPATH=src python -m repro_torch.multi_server [--device cpu]
(the default device is the CUDA card; without one it raises). The last
line printed is a JSON summary; a wrong record exits non-zero.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE_K3
from repro_torch.core import dpf, pir
from repro_torch.crypto.packing import np_words_to_bytes, tensor_to_words
from repro_torch.kernels import ops
from repro_torch.runtime.serve_loop import MultiServerPIR


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """Retrieve four records at ``PIR_SMOKE_K3`` from three servers and show
    that one server's share alone is not the record; raises on a wrong
    record and returns what happened (kernel counters included)."""
    cfg = PIR_SMOKE_K3           # 2^12 records x 32 B, xor-dpf-k, k = 3
    say = print if verbose else (lambda *a: None)
    ops.reset_counts()
    db = pir.make_database(np.random.default_rng(seed), cfg.n_items,
                           cfg.item_bytes)
    system = MultiServerPIR(db, cfg, device=device, n_queries=4, buckets=(4,),
                            client_rng=np.random.default_rng(seed + 1))
    say(f"DB: {cfg.n_items} records x {cfg.item_bytes} B; protocol="
        f"{cfg.protocol} ({system.n_parties} parties)")
    if len(system.servers) != 3:
        raise AssertionError(f"{len(system.servers)} servers, not 3")

    indices = [7, 1234, 4000, cfg.n_items - 1]
    say(f"querying indices {indices} (none of the 3 servers sees these)")
    records = system.query(indices)
    exact = [bool(np.array_equal(rec, db[i]))
             for i, rec in zip(indices, records)]
    for i, rec, ok in zip(indices, records, exact):
        say(f"  D[{i:5d}] -> {bytes(np_words_to_bytes(rec))[:8].hex()}... "
            f"{'OK' if ok else 'MISMATCH'}")
    if not all(exact):
        raise AssertionError(f"wrong records at {indices}: {exact}")

    # one server's share alone is pseudorandom
    q = pir.query_gen(np.random.default_rng(seed + 2), 7, cfg)
    share0 = tensor_to_words(system.servers[0].answer(
        dpf.stack_keys([q.keys[0]])))[0]
    say(f"server 0's answer share for D[7]: "
        f"{bytes(np_words_to_bytes(share0))[:8].hex()}... (pseudorandom; "
        f"D[7] only after XOR with the other two)")
    if np.array_equal(share0, db[7]):
        raise AssertionError("one server's share equals the record")
    say("3-server private retrieval verified.")
    counts = ops.counts()
    return {"twin": "multi_server", "indices": indices, "exact": exact,
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
