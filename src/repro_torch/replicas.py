"""Replica plane twin: router, failover under load, bounded-staleness
epochs, as ``examples/replicas.py`` runs it on the JAX package.

IM-PIR scales PIR throughput with many independent clusters, each
scanning its own full database replica (Take-away 5). This twin runs that
topology one tier up: two :class:`ServeReplica` deployments (own
sub-mesh, own LWE plans, own ``Database``) behind a :class:`Router` doing
power-of-two-choices balancing — then

  1. publishes an update through the front tier and shows both replicas
     converge to the same epoch;
  2. kills one replica while its queue is loaded and shows every
     submitted query still resolves byte-correct (failover resubmits by
     index onto the healthy peer — no lost answers);
  3. rejoins a fresh replica warmed from the healthy peer's plans and
     shows it comes up at the front-tier epoch with a non-heuristic plan
     (the delta-log catch-up + plan-cache warm start).

Run:  PYTHONPATH=src python -m repro_torch.replicas [--device cpu]
(the default device is the CUDA card; without one it raises; on one card
both replicas share it). The last line printed is a JSON summary; a
wrong record or a failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.pir import PIR_SMOKE_REPL
from repro_torch.core import pir
from repro_torch.kernels import ops
from repro_torch.replica import Router, ServeReplica, metrics
from repro_torch.runtime.elastic import carve_submeshes


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def run(device: Optional[str] = None, seed: int = 0,
        verbose: bool = True) -> dict:
    """Publish, kill under load and rejoin warm on a two-replica LWE fleet
    at ``PIR_SMOKE_REPL``; raises on a wrong record or a failed check and
    returns what happened (kernel counters included)."""
    cfg = PIR_SMOKE_REPL         # 2^12 records x 32 B, lwe-simple-1
    say = print if verbose else (lambda *a: None)
    ops.reset_counts()
    rng = np.random.default_rng(seed)
    db_host = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    oracle = pir.db_as_bytes(db_host).copy()

    meshes = carve_submeshes(2, model_axis=1, live_devices=(
        None if device is None else [device]))
    router = Router(rng=np.random.default_rng(seed + 1), base_delay=0.01,
                    max_delay=0.5)
    kw = dict(n_queries=4, buckets=(4,), max_wait_s=0.002)
    r0 = router.attach(ServeReplica(
        "r0", db_host, cfg, meshes[0],
        client_rng=np.random.default_rng(seed + 2), **kw))
    r1 = router.attach(ServeReplica(
        "r1", db_host, cfg, meshes[1],
        client_rng=np.random.default_rng(seed + 3), **kw))
    say(f"fleet: 2 replicas x ({cfg.n_items} records x {cfg.item_bytes} B,"
        f" protocol={cfg.protocol}) on {[str(m.device) for m in meshes]}, "
        f"P2C routing")

    # --- 1. epoch propagation: one publish, both replicas converge ------
    target = 7
    new_record = rng.integers(0, 1 << 32, size=(1, cfg.item_bytes // 4),
                              dtype=np.uint32)
    router.update([target], new_record)
    epoch = router.publish()
    oracle[target] = new_record.view(np.uint8).ravel()
    _check((r0.epoch, r1.epoch) == (epoch, epoch), "fleet must converge")
    say(f"published epoch {epoch}: fan-out converged "
        f"(r0={r0.epoch}, r1={r1.epoch}, lag=0)")

    # --- 2. kill one replica mid-load: no lost answer --------------------
    session = router.session("demo-client")
    session.replica = "r0"       # pin the load onto the victim
    indices = [target, 3, 999, cfg.n_items - 1, 42, target, 17, 2048]
    futures = [router.submit(i, session=session) for i in indices]
    r0.kill("demo: power loss")
    for idx, fut in zip(indices, futures):
        ans = np.asarray(fut.result(timeout=180.0))
        _check(np.array_equal(ans, oracle[idx]), f"D[{idx}] mismatch")
        _check(fut.epoch == epoch, f"D[{idx}] answered at epoch {fut.epoch}")
    _check("r0" in router.registry.suspects(), "dead replica quarantined")
    say(f"killed r0 with {len(indices)} queries submitted: all "
        f"{len(indices)} answers correct at epoch {epoch} "
        f"({router.failovers} failovers, none lost)")

    # --- 3. rejoin warm: catch up the epoch, skip re-tuning --------------
    router.detach("r0")
    r0b = ServeReplica("r0", db_host, cfg, meshes[0],
                       warm_plans=r1.export_plans(),
                       client_rng=np.random.default_rng(seed + 4), **kw)
    router.attach(r0b)
    _check(r0b.epoch == epoch, "delta-log replay must catch the joiner up")
    provenances = sorted({r["provenance"]
                          for r in r0b.plan_report().values()})
    _check("heuristic" not in provenances,
           f"warm-started replica fell back to the heuristic ({provenances})")
    session2 = router.session("demo-client-2")
    session2.replica = "r0"
    check = router.submit(target, session=session2).result(timeout=180.0)
    _check(np.array_equal(np.asarray(check), oracle[target]),
           "the rejoined replica's first answer is wrong")
    say(f"r0 rejoined hot: epoch {r0b.epoch}, plan provenance "
        f"{provenances} (no re-tuning), first query correct")

    snap = metrics.snapshot(router)
    say(f"fleet metrics: answered={snap['router']['answered']} "
        f"failovers={snap['router']['failovers']} "
        f"max_epoch_lag={snap['router']['max_epoch_lag']}")
    for r in list(router.replicas.values()):
        r.close()
    say("replica-plane failover + epoch propagation verified.")
    counts = ops.counts()
    return {"twin": "replicas", "epoch": epoch,
            "failovers": router.failovers, "provenance": provenances,
            "device": str(r1.db.device), "router": snap["router"],
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
