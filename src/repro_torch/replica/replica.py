"""One serve replica: a PIR deployment facade bound to its own sub-mesh
(``repro/replica/replica.py``).

The IM-PIR topology, one tier up (paper Take-away 5): the paper scales PIR
throughput by scanning the database with many independent PIM clusters,
each holding a full replica. Each :class:`ServeReplica` owns a whole
:class:`~repro_torch.db.Database` sharded over its own mesh (one of
``runtime/elastic.carve_submeshes``), its own per-bucket plans and its own
``QueryScheduler``; the front tier (``replica/router.py``) spreads offered
load across them.

A replica is deliberately *thin*: it adapts the deployment facades
(``MultiServerPIR`` / ``SingleServerPIR``) to the lifecycle the router
needs — join (``start`` + plan-cache warm start), serve (``submit`` /
``resubmit``), leave (``drain_handoff``), die (``kill``), and observe
(``queue_depth``, ``subscribe_epochs``, heartbeat hook). All query
semantics (protocols, buckets, epoch tagging) stay in the layers below.
A ``chaos=`` keyword (a ``ChaosInjector``) goes on to the facade with
``chaos_scope`` defaulting to the replica id, so that a plan aimed at
``"r0"`` kills or corrupts r0's serve path only.

Without a process group every mesh is the ``(1, 1)`` mesh of one device,
and on one card every replica shares it (and its stream). Under a process
group the reference's single process becomes a fleet (``Fleet``, carved
with the meshes): rank 0 is its controller and runs the ``Router``, the
registry, the chaos injector and the host half of every replica (keygen
from its client rng, its scheduler and futures, the chaos seams and
finalize), and on a sub-mesh that does not hold rank 0 it drives the grid
from outside (``runtime/serve_loop.py``). Every other rank calls
:func:`follow_fleet`, which builds the device half of each replica the
controller announces on a mesh holding that rank (its row block, its
plans, a ``FollowerLoop`` from then on) and ends when the controller calls
:func:`close_fleet`. Nothing sends the database: every rank was given the
host array at start. A graceful handoff moves keyed payloads between two
replicas' schedulers on the controller, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import PIRConfig
from repro_torch.core import protocol as protocol_mod
from repro_torch.launch.mesh import (Mesh, recv_command, recv_tensor,
                                     single_mesh)
from repro_torch.runtime.serve_loop import (AnswerFuture, MultiServerPIR,
                                            SingleServerPIR)


class ReplicaLost(RuntimeError):
    """Terminal failure of one replica: its in-flight and queued futures
    resolve with this, and the router's done-callbacks resubmit them (by
    index) to a healthy peer. Carries the replica id for attribution."""

    def __init__(self, replica_id: str, reason: str = "replica lost"):
        super().__init__(f"{reason}: {replica_id}")
        self.replica_id = replica_id


def make_pir(db_words, cfg: PIRConfig, mesh, **kwargs):
    """The right deployment facade for ``cfg.protocol``'s party count
    (hint protocols need ``SingleServerPIR``'s client-state plumbing), on
    ``mesh`` (a device, or None for the card, stands for its ``(1, 1)``
    mesh)."""
    proto = protocol_mod.for_config(cfg)
    cls = SingleServerPIR if proto.n_parties(cfg) == 1 else MultiServerPIR
    return cls(db_words, cfg, mesh=_as_mesh(mesh), **kwargs)


def _as_mesh(mesh) -> Mesh:
    return mesh if isinstance(mesh, Mesh) else single_mesh(mesh)


def _in_fleet(mesh: Mesh) -> bool:
    """Whether a replica on ``mesh`` is a fleet's, served across ranks."""
    return mesh.fleet is not None and mesh.multi_process


class ServeReplica:
    """One replica of the serving plane: facade + scheduler + database.

    ``db_words`` is a HOST array: each replica places its own copy on its
    own mesh (sharing one ``Database`` would couple the replicas' epochs
    and lifetimes). ``mesh`` is one of ``carve_submeshes``'; a device, or
    None (the card), stands for its ``(1, 1)`` mesh. On a fleet's mesh of
    several ranks the replica is built on the fleet's controller only,
    which announces it to the other ranks (:func:`follow_fleet`).
    """

    def __init__(self, replica_id: str, db_words, cfg: PIRConfig, mesh,
                 warm_plans: Optional[Dict[int, Any]] = None,
                 **pir_kwargs):
        self.id = replica_id
        self.mesh = mesh = _as_mesh(mesh)
        self.device = mesh.device
        fleet = mesh.fleet if _in_fleet(mesh) else None
        if fleet is not None and not fleet.is_controller:
            raise ValueError(
                f"a fleet's replicas are built on its controller (rank "
                f"{fleet.controller}); rank {mesh.rank} follows them with "
                f"follow_fleet")
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
        self.pir = make_pir(db_words, cfg, mesh, **pir_kwargs)
        self._lost: Optional[BaseException] = None
        self._serial: Optional[int] = None
        if fleet is not None:
            self._serial = _announce(fleet, self, warm_plans)
            self.pir.announced()

    # -- delegated surfaces ---------------------------------------------

    @property
    def cfg(self) -> PIRConfig:
        return self.pir.cfg

    @property
    def db(self):
        """The database the router stages and publishes on: the facade's,
        or on a fleet's mesh a view that publishes through the facade, so
        that every rank of the grid publishes (``_GridDatabase``)."""
        return _GridDatabase(self.pir) if self._serial is not None \
            else self.pir.db

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
        """Graceful stop: flush + answer everything, then join (and on a
        fleet's mesh tell the followers the replica left)."""
        self.pir.close()
        self._leave()

    def drain_handoff(self) -> List[Tuple[Any, AnswerFuture]]:
        """Graceful leave: stop intake, return undispatched (item, future)
        pairs FIFO for resubmission elsewhere; dispatched work completes
        here (see ``QueryScheduler.drain_handoff``)."""
        pairs = self.pir.scheduler.drain_handoff()
        # let the session thread finish its in-flight batches and exit
        self.pir.scheduler.stop()
        self._leave()
        return pairs

    def _leave(self):
        """``LEAVE`` to the followers, once, after the session ended."""
        fleet = self.mesh.fleet
        if self._serial is not None and \
                fleet.members.pop(self._serial, None) is not None:
            fleet.send("LEAVE", (self._serial,))

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


class _GridDatabase:
    """The database surface the router calls, for a replica whose database
    lies on a grid of ranks: staged writes go through the facade's
    ``update`` and a publish through its ``publish`` (a ``PUBLISH`` to
    every rank of the grid); every other attribute is the controller's
    database's (``subscribe``, ``epoch``, ...)."""

    def __init__(self, pir: MultiServerPIR):
        self._pir = pir

    def stage(self, rows, values) -> int:
        return self._pir.update(rows, values)

    def publish(self) -> int:
        return self._pir.publish()

    def __getattr__(self, name: str):
        return getattr(self._pir.db, name)


# ---------------------------------------------------------------------------
# The fleet across ranks
# ---------------------------------------------------------------------------

def _bytes_tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _announce(fleet, replica: ServeReplica,
              warm_plans: Optional[Dict[int, Any]]) -> int:
    """On the fleet's controller: ``JOIN`` a replica just built (its serial,
    its mesh's place in the fleet, its id and its warm plans as JSON), so
    that the ranks of its mesh build their halves; returns the serial."""
    serial = fleet.next_serial()
    rid = replica.id.encode()
    plans = json.dumps({str(b): dataclasses.asdict(p) for b, p in
                        (warm_plans or {}).items()}).encode()
    fleet.send("JOIN", (serial, fleet.index(replica.mesh), len(rid),
                        len(plans)),
               (_bytes_tensor(rid), _bytes_tensor(plans)))
    fleet.members[serial] = replica
    return serial


def close_fleet(meshes: Sequence[Mesh]) -> None:
    """On the fleet's controller, at the end: close every replica still
    announced (its session drains; ``LEAVE``), then end every other rank's
    :func:`follow_fleet` (``CLOSE``). Without a fleet it does nothing."""
    fleet = meshes[0].fleet if meshes else None
    if fleet is None or not fleet.is_controller:
        return
    for replica in list(fleet.members.values()):
        replica.close()
    fleet.send("CLOSE")


def follow_fleet(meshes: Sequence[Mesh], db_words, cfg: PIRConfig,
                 **pir_kwargs) -> List[dict]:
    """On every rank of a fleet but its controller: follow the fleet until
    the controller closes it (:func:`close_fleet`). For each replica the
    controller announces on a mesh that holds this rank, build its device
    half (``make_pir(db_words, cfg, mesh, **pir_kwargs)`` with the
    replica's warm plans recorded first: ``pir_kwargs`` are the device
    half's keywords the controller's replicas were built with, such as
    ``n_queries``, ``buckets``, ``path``, ``n_clusters``) and run its
    command loop (``FollowerLoop``) until the replica's session ends;
    on ``LEAVE`` the half is dropped. ``db_words`` is the host array every
    rank was given. Returns one record per replica followed: its id,
    serial and mesh, what its loop ran and how it ended, and its
    database's epoch and hint counters."""
    from repro_torch import engine
    from repro_torch.core.protocol import ExecutionPlan
    fleet = meshes[0].fleet
    if fleet is None:
        raise ValueError("follow_fleet needs the meshes of carve_submeshes "
                         "under a process group")
    if fleet.is_controller:
        raise ValueError(f"rank {fleet.controller} is the fleet's "
                         f"controller: it builds the replicas")
    live: Dict[int, Tuple[dict, MultiServerPIR]] = {}
    done: List[dict] = []

    def retire(serial: int):
        record, pir = live.pop(serial)
        pir.follower.join()
        f, st = pir.follower, pir.db.stats
        record.update(
            dispatches=f.dispatches, publishes=f.publishes, starts=f.starts,
            hints=f.hints, ended_by=f.ended_by, t_end=f.t_end,
            exc=None if f.exc is None else f"{type(f.exc).__name__}: {f.exc}",
            epoch=pir.epoch, n_hint_builds=st.n_hint_builds,
            n_hint_deltas=st.n_hint_deltas)
        done.append(record)

    while True:
        command, fields = recv_command(fleet)
        if command == "JOIN":
            serial, index, n_id, n_plans = fields[:4]
            rid = bytes(recv_tensor(fleet, (n_id,), torch.uint8).tolist())
            plans = json.loads(bytes(recv_tensor(
                fleet, (n_plans,), torch.uint8).tolist()))
            mesh = fleet.meshes[index]
            if not mesh.contains_rank:
                continue
            if plans:
                engine.record_plans(cfg, {int(b): ExecutionPlan(**p)
                                          for b, p in plans.items()},
                                    device=mesh.device)
            pir = make_pir(db_words, cfg, mesh, **pir_kwargs)
            pir.follow()
            live[serial] = ({"id": rid.decode(), "serial": serial,
                             "mesh": index}, pir)
        elif command == "LEAVE":
            if fields[0] in live:
                retire(fields[0])
        elif command == "CLOSE":
            for serial in sorted(live):
                retire(serial)
            return done
        else:
            raise RuntimeError(f"unexpected fleet command {command}")
