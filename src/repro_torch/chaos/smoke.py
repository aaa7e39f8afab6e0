"""Chaos smoke: two seeded fault scenarios on the port's serve stack
(``repro/chaos/smoke.py``).

Run:  PYTHONPATH=src python -m repro_torch.chaos --smoke [--device cpu]

Both scenarios drive a two-replica LWE fleet (``carve_submeshes(2,
model_axis=1)``; on one card both replicas share it, and ``meshes=`` may
give sub-meshes of ranks, whose other ranks run :func:`follow`) through
the router, with a :class:`~repro_torch.chaos.ChaosInjector` wired into
r0 and the router, and assert the two halves of the robustness contract:

* **detection**: the injected fault surfaces as the right signal
  (``InjectedFault`` for a kill, ``IntegrityError`` for a corrupted
  answer share), never as a silently wrong record;
* **recovery**: every query submitted before the fault still resolves
  byte-exact against the plaintext oracle, served by r1 after failover.

Scenario A kills r0 at its ``scheduler.dispatch`` seam (its session dies
mid-batch). Scenario B serves the checksummed config (``PIR_SMOKE_CHK``)
and corrupts r0's answer at ``replica.serve_step``: verified
reconstruction raises ``IntegrityError``, the router quarantines r0 and
resubmits to r1. The seeds, indices and router settings are upstream's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.chaos import ChaosInjector, FaultEvent, FaultPlan


#: each scenario's config and the seed of its host database
SCENARIOS = {"kill": ("PIR_SMOKE_REPL", 0), "corrupt": ("PIR_SMOKE_CHK", 2)}
#: the replicas' keywords
REPLICA_KW = dict(n_queries=4, buckets=(4,))


def _config(name: str):
    from repro_torch.configs import pir as configs
    cfg_name, seed = SCENARIOS[name]
    return getattr(configs, cfg_name), seed


def _fleet(cfg, injector, rng, device: Optional[str], meshes=None,
           max_wait_s: float = 0.002):
    """Two replicas behind a router; the injector is wired into r0 (and
    the router) only."""
    from repro_torch.core import pir
    from repro_torch.replica import Router, ServeReplica
    from repro_torch.runtime.elastic import carve_submeshes

    db_host = pir.make_database(rng, cfg.n_items, cfg.item_bytes)
    oracle = pir.db_as_bytes(db_host).copy()
    if meshes is None:
        meshes = carve_submeshes(2, model_axis=1, live_devices=(
            None if device is None else [device]))
    router = Router(rng=np.random.default_rng(1), base_delay=0.01,
                    max_delay=0.2, chaos=injector)
    kw = dict(REPLICA_KW, max_wait_s=max_wait_s)
    router.attach(ServeReplica("r0", db_host, cfg, meshes[0],
                               chaos=injector, **kw))
    router.attach(ServeReplica("r1", db_host, cfg, meshes[1], **kw))
    return router, oracle


def follow(name: str, meshes) -> list:
    """A rank other than the fleet's controller in scenario ``name``
    (``"kill"`` or ``"corrupt"``) on ``meshes``: the same host database,
    then ``follow_fleet`` until the controller closes the fleet."""
    from repro_torch.core import pir
    from repro_torch.replica import follow_fleet
    cfg, seed = _config(name)
    db_host = pir.make_database(np.random.default_rng(seed), cfg.n_items,
                                cfg.item_bytes)
    return follow_fleet(meshes, db_host, cfg, **REPLICA_KW)


def _drive_pinned(router, oracle, indices, deadline_s=240.0):
    """Pin a session onto the victim replica, offer the load, and assert
    that every answer resolves byte-exact (possibly after failover)."""
    session = router.session("chaos-smoke")
    session.replica = "r0"
    futs = [router.submit(i, session=session, deadline_s=deadline_s)
            for i in indices]
    for i, f in zip(indices, futs):
        ans = np.asarray(f.result())
        if not np.array_equal(ans, oracle[i]):
            raise AssertionError(
                f"D[{i}] wrong after recovery: silent corruption")
    return futs


def _teardown(router, meshes=None):
    from repro_torch.replica import close_fleet
    for r in list(router.replicas.values()):
        if not r.lost:
            r.close()
    if meshes is not None:
        close_fleet(meshes)


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def scenario_kill(device: Optional[str] = None, meshes=None,
                  max_wait_s: float = 0.002) -> dict:
    """A: a seeded kill of r0's dispatch; failover must lose nothing.
    ``meshes`` default to ``carve_submeshes(2, model_axis=1)`` on
    ``device``; ``max_wait_s`` is the replicas' (upstream's 2 ms cuts
    batches by timing, a long one only when a bucket is full)."""
    cfg, seed = _config("kill")
    plan = FaultPlan(seed=7, events=(
        FaultEvent(seam="scheduler.dispatch", action="kill",
                   target="r0", at=0),))
    injector = ChaosInjector(plan)
    router, oracle = _fleet(cfg, injector, np.random.default_rng(seed),
                            device, meshes, max_wait_s)
    try:
        indices = [3, 999, 42, cfg.n_items - 1, 17, 2048, 0, 7]
        _drive_pinned(router, oracle, indices)
        _check("kill" in injector.fired_actions("scheduler.dispatch"),
               "the planned kill never fired")
        _check(router.failovers > 0, "kill detected but no failover ran")
        return {"fired": injector.fired_actions(),
                "failovers": router.failovers,
                "answers": len(indices)}
    finally:
        _teardown(router, meshes)


def scenario_corrupt(device: Optional[str] = None, meshes=None,
                     max_wait_s: float = 0.002) -> dict:
    """B: one answer share corrupted on the checksummed config; verified
    reconstruction must raise IntegrityError (detection), the router must
    quarantine r0 and serve the queries from r1 (recovery). ``meshes`` and
    ``max_wait_s`` as :func:`scenario_kill`'s."""
    cfg, seed = _config("corrupt")
    plan = FaultPlan(seed=11, events=(
        FaultEvent(seam="replica.serve_step", action="corrupt",
                   target="r0", at=0),))
    injector = ChaosInjector(plan)
    router, oracle = _fleet(cfg, injector, np.random.default_rng(seed),
                            device, meshes, max_wait_s)
    try:
        indices = [5, 1234, cfg.n_items - 1, 64]
        _drive_pinned(router, oracle, indices)
        _check("corrupt" in injector.fired_actions("replica.serve_step"),
               "the planned corruption never fired")
        _check(router.integrity_failures > 0,
               "corruption fired but reconstruction never raised "
               "IntegrityError (silent corruption path)")
        _check("r0" in router.registry.suspects(),
               "an integrity failure must quarantine the corrupting replica")
        return {"fired": injector.fired_actions(),
                "integrity_failures": router.integrity_failures,
                "suspects": router.registry.suspects(),
                "answers": len(indices)}
    finally:
        _teardown(router, meshes)


def run(device: Optional[str] = None, verbose: bool = True) -> dict:
    """Both scenarios; raises on a failed check and returns what happened
    (the kernel counters of the whole run included)."""
    from repro_torch.kernels import ops
    say = print if verbose else (lambda *a: None)
    ops.reset_counts()
    a = scenario_kill(device)
    say(f"chaos smoke A (kill@scheduler.dispatch): {a['answers']} answers "
        f"byte-exact after {a['failovers']} failovers, fired={a['fired']}")
    b = scenario_corrupt(device)
    say(f"chaos smoke B (corrupt@replica.serve_step, checksummed): "
        f"{b['answers']} answers byte-exact, "
        f"integrity_failures={b['integrity_failures']}, "
        f"quarantined={b['suspects']}")
    say("chaos smoke OK: detection + recovery verified on both scenarios")
    counts = ops.counts()
    return {"twin": "chaos", "kill": a, "corrupt": b,
            "launches": {k: v["launches"] for k, v in counts.items()},
            "plain_calls": {k: v["plain_calls"] for k, v in counts.items()}}
