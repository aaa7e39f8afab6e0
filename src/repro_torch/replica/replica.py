"""One serve replica: a PIR deployment facade bound to its own device
(``repro/replica/replica.py``).

The IM-PIR topology, one tier up (paper Take-away 5): the paper scales PIR
throughput by scanning the database with many independent PIM clusters,
each holding a full replica. Each :class:`ServeReplica` owns a full
:class:`~repro_torch.db.Database` on its device (a group of
``runtime/elastic.carve_submeshes``), its own per-bucket plans and its own
``QueryScheduler``; the front tier (``replica/router.py``) spreads offered
load across them. The reference places each replica on a sub-mesh; the
port serves a replica from one card, and on a one-card host every replica
shares it (and its stream).

A replica is deliberately *thin*: it adapts the deployment facades
(``MultiServerPIR`` / ``SingleServerPIR``) to the lifecycle the router
needs — join (``start`` + plan-cache warm start), serve (``submit`` /
``resubmit``), leave (``drain_handoff``), die (``kill``), and observe
(``queue_depth``, ``subscribe_epochs``, heartbeat hook). All query
semantics (protocols, buckets, epoch tagging) stay in the layers below.
A ``chaos=`` keyword (a ``ChaosInjector``) goes on to the facade with
``chaos_scope`` defaulting to the replica id, so that a plan aimed at
``"r0"`` kills or corrupts r0's serve path only.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.config import PIRConfig
from repro_torch.core import protocol as protocol_mod
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.runtime.serve_loop import (AnswerFuture, MultiServerPIR,
                                            SingleServerPIR)


class ReplicaLost(RuntimeError):
    """Terminal failure of one replica: its in-flight and queued futures
    resolve with this, and the router's done-callbacks resubmit them (by
    index) to a healthy peer. Carries the replica id for attribution."""

    def __init__(self, replica_id: str, reason: str = "replica lost"):
        super().__init__(f"{reason}: {replica_id}")
        self.replica_id = replica_id


def make_pir(db_words, cfg: PIRConfig, device: Device, **kwargs):
    """The right deployment facade for ``cfg.protocol``'s party count
    (hint protocols need ``SingleServerPIR``'s client-state plumbing)."""
    proto = protocol_mod.for_config(cfg)
    cls = SingleServerPIR if proto.n_parties(cfg) == 1 else MultiServerPIR
    return cls(db_words, cfg, device=device, **kwargs)


class ServeReplica:
    """One replica of the serving plane: facade + scheduler + database.

    ``db_words`` is a HOST array: each replica places its own copy on its
    own device (sharing one ``Database`` would couple the replicas'
    epochs and lifetimes). ``device=None`` means CUDA, as everywhere in
    the port.
    """

    def __init__(self, replica_id: str, db_words, cfg: PIRConfig,
                 device: Device, warm_plans: Optional[Dict[int, Any]] = None,
                 **pir_kwargs):
        self.id = replica_id
        self.device = resolve_device(device)
        # warm start must precede facade construction: PIRServer resolves
        # its primary bucket's plan in __init__, so plans recorded after
        # that would never be consulted (a healthy peer's export_plans()
        # goes here — the rejoin-hot path). The plan cache is keyed by
        # this replica's device: "cpu" on the CPU, the card's name on CUDA.
        if warm_plans:
            from repro_torch import engine
            engine.record_plans(cfg, warm_plans, device=self.device)
        if "chaos" in pir_kwargs:
            pir_kwargs.setdefault("chaos_scope", replica_id)
        self.pir = make_pir(db_words, cfg, self.device, **pir_kwargs)
        self._lost: Optional[BaseException] = None

    # -- delegated surfaces ---------------------------------------------

    @property
    def cfg(self) -> PIRConfig:
        return self.pir.cfg

    @property
    def db(self):
        return self.pir.db

    @property
    def epoch(self) -> int:
        return self.pir.epoch

    @property
    def scheduler(self):
        return self.pir.scheduler

    @property
    def stats(self):
        return self.pir.scheduler.stats

    @property
    def queue_depth(self) -> int:
        """Unresolved real queries on this replica (the router's
        power-of-two-choices load signal)."""
        return self.pir.scheduler.queue_depth

    @property
    def running(self) -> bool:
        return self.pir.scheduler.running

    @property
    def lost(self) -> bool:
        return self._lost is not None

    # -- serve ----------------------------------------------------------

    def submit(self, index: int, *,
               deadline_s: Optional[float] = None) -> AnswerFuture:
        """Keygen + enqueue one private retrieval of ``db[index]``."""
        return self.pir.submit(index, deadline_s=deadline_s)

    def resubmit(self, item: Any, future: AnswerFuture) -> AnswerFuture:
        """Re-enqueue an already-keygen'd payload under its existing
        future — the graceful-handoff path. Key material is replica-
        agnostic (same cfg/protocol ⇒ same party structure; the LWE
        public matrix A is expanded from the config seed), so a payload
        drained from one replica answers identically on any peer at the
        same epoch."""
        return self.pir.scheduler.submit(item, future=future)

    # -- lifecycle -------------------------------------------------------

    def start(self):
        self._lost = None
        self.pir.start()

    def close(self):
        """Graceful stop: flush + answer everything, then join."""
        self.pir.close()

    def drain_handoff(self) -> List[Tuple[Any, AnswerFuture]]:
        """Graceful leave: stop intake, return undispatched (item, future)
        pairs FIFO for resubmission elsewhere; dispatched work completes
        here (see ``QueryScheduler.drain_handoff``)."""
        pairs = self.pir.scheduler.drain_handoff()
        # let the session thread finish its in-flight batches and exit
        self.pir.scheduler.stop()
        return pairs

    def kill(self, reason: str = "injected fault") -> ReplicaLost:
        """Hard death: every outstanding future on this replica fails
        with :class:`ReplicaLost` (first-wins vs completing batches),
        which is what triggers the router's per-query failover."""
        exc = ReplicaLost(self.id, reason)
        self._lost = exc
        self.pir.scheduler.kill(exc)
        return exc

    # -- observation hooks ----------------------------------------------

    def set_heartbeat(self, fn: Optional[Callable[[], None]]):
        """Liveness hook, called once per scheduler loop iteration; the
        registry wires this at join. An idle session waits without
        beating (as the reference's does), so silence past the registry's
        timeout means a stuck, dead or long-idle session thread."""
        self.pir.scheduler.heartbeat = fn

    def subscribe_epochs(self, fn: Callable[[int], None]) -> Callable:
        """``fn(epoch)`` after every publish on this replica's database;
        returns the unsubscribe callable. The router's bounded-staleness
        eligibility reads the epochs observed here."""
        return self.db.subscribe(lambda delta: fn(delta.epoch))

    # -- epoch propagation ----------------------------------------------

    def apply_delta(self, rows, vals) -> int:
        """Stage + publish one public update delta; returns the new
        epoch. The router fans the identical delta out to every replica
        (and replays missed ones at rejoin), so replicas starting from
        the same epoch-0 contents converge to identical epoch numbering
        AND contents."""
        self.db.stage(rows, vals)
        return self.db.publish()

    # -- plan-cache warm start -------------------------------------------

    def export_plans(self) -> Dict[int, Any]:
        """{bucket: resolved ExecutionPlan} this replica serves with.

        Resolution is cached per bucket and builds no step, so exporting
        is cheap; a peer records these via :func:`warm_start` (or
        ``warm_plans=``) before its facade resolves its buckets."""
        bucketed = self.pir.servers[0].bucketed
        return {b: bucketed.plan_for_bucket(b) for b in bucketed.buckets}

    def warm_start(self, plans: Dict[int, Any], *,
                   persist: bool = False) -> int:
        """Seed the process-wide plan cache with a healthy peer's plans
        (``engine.record_plans`` under this replica's device key): buckets
        resolved after this take measured plans (provenance
        ``tuned``/``warm``, never the heuristic) without re-tuning.
        Returns the number of cache entries written."""
        from repro_torch import engine
        return engine.record_plans(self.cfg, plans, device=self.device,
                                   persist=persist)

    def plan_report(self) -> Dict[int, dict]:
        """Per-bucket ``engine.plan_report`` rows (their ``provenance`` is
        what the rejoin-hot check reads)."""
        return self.pir.servers[0].plan_report()
