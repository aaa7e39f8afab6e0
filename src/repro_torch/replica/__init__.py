"""The replica plane of the port: multi-replica serving behind a front-tier
router (``repro/replica``).

IM-PIR's throughput story is replication — many independent clusters,
each scanning its own full copy of the database (paper Take-away 5).
This package lifts that topology one tier: N :class:`ServeReplica`
deployments (own sub-mesh, own plans, own ``Database``) behind one
:class:`Router` doing power-of-two-choices balancing, health-driven
failover with no lost query, and bounded-staleness epoch propagation.
Under a process group the fleet's controller (rank 0) builds the replicas
and every other rank calls :func:`follow_fleet` until :func:`close_fleet`.
"""
from repro_torch.replica.metrics import export_json, replica_snapshot, snapshot
from repro_torch.replica.registry import ReplicaRegistry
from repro_torch.replica.replica import (ReplicaLost, ServeReplica,
                                        close_fleet, follow_fleet, make_pir)
from repro_torch.replica.router import Router, Session

__all__ = [
    "ReplicaLost", "ReplicaRegistry", "Router", "ServeReplica", "Session",
    "close_fleet", "export_json", "follow_fleet", "make_pir",
    "replica_snapshot", "snapshot",
]
