"""The replica plane of the port: multi-replica serving behind a front-tier
router (``repro/replica``).

IM-PIR's throughput story is replication — many independent clusters,
each scanning its own full copy of the database (paper Take-away 5).
This package lifts that topology one tier: N :class:`ServeReplica`
deployments (own device group, own plans, own ``Database``) behind one
:class:`Router` doing power-of-two-choices balancing, health-driven
failover with no lost query, and bounded-staleness epoch propagation.
"""
from repro_torch.replica.metrics import export_json, replica_snapshot, snapshot
from repro_torch.replica.registry import ReplicaRegistry
from repro_torch.replica.replica import ReplicaLost, ServeReplica, make_pir
from repro_torch.replica.router import Router, Session

__all__ = [
    "ReplicaLost", "ReplicaRegistry", "Router", "ServeReplica", "Session",
    "export_json", "make_pir", "replica_snapshot", "snapshot",
]
