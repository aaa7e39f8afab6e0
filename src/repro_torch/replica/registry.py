"""Replica membership + health: who is joined, who is suspect
(``repro/replica/registry.py``).

Thin policy layer over ``runtime/fault.HeartbeatRegistry`` (injectable
clock, so tests drive suspicion deterministically). Two independent
signals make a replica suspect:

* **silence** — the scheduler loop's per-iteration heartbeat stopped
  arriving for longer than ``timeout`` (stuck, dead, or wedged thread);
* **observed failure** — the router saw a query future fail with that
  replica's :class:`~repro_torch.replica.replica.ReplicaLost` (or an
  ``IntegrityError``) and quarantined it at once (``report_failure``),
  without waiting a timeout.

A replica that *leaves* is removed outright (``HeartbeatRegistry.remove``)
— departure is not failure, and a lingering last-beat entry would
otherwise poison ``suspects()`` forever.
"""
from __future__ import annotations

import time
from typing import Callable, List, Set

from repro_torch.runtime.fault import HeartbeatRegistry


class ReplicaRegistry:
    """Membership + liveness for the replica fleet."""

    def __init__(self, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.heartbeats = HeartbeatRegistry(timeout=timeout, clock=clock)
        self._failed: Set[str] = set()
        #: optional ChaosInjector consulted at the heartbeat seam
        #: (``should_drop("heartbeat", rid)``): a dropped beat never reaches
        #: last_seen, so the replica ages toward suspicion like a wedged one
        self.chaos = None

    # -- membership -------------------------------------------------------

    def join(self, replica) -> None:
        """Register a replica and wire its scheduler's heartbeat hook.

        Rejoin clears any previous quarantine: the operator restarting a
        failed replica IS the recovery signal."""
        rid = replica.id
        self._failed.discard(rid)
        self.heartbeats.beat(rid)
        replica.set_heartbeat(lambda: self.beat(rid))

    def leave(self, rid: str) -> bool:
        """Retire a departing replica entirely (not a failure)."""
        self._failed.discard(rid)
        return self.heartbeats.remove(rid)

    def members(self) -> List[str]:
        return list(self.heartbeats.last_seen)

    def __contains__(self, rid: str) -> bool:
        return rid in self.heartbeats.last_seen

    # -- liveness ----------------------------------------------------------

    def beat(self, rid: str) -> None:
        """Record one liveness beat; beats from replicas that already left
        are dropped (a drained scheduler's last loop iterations must not
        resurrect the membership entry)."""
        if rid in self.heartbeats.last_seen:
            if (self.chaos is not None
                    and self.chaos.should_drop("heartbeat", rid)):
                return
            self.heartbeats.beat(rid)

    def report_failure(self, rid: str) -> None:
        """Quarantine at once on an observed failure — the router calls
        this the moment a future fails with ``ReplicaLost``, so routing
        stops picking the replica without waiting out the heartbeat
        timeout."""
        if rid in self.heartbeats.last_seen:
            self._failed.add(rid)

    def suspects(self) -> List[str]:
        """Heartbeat-silent ∪ observed-failed (members only)."""
        out = set(self.heartbeats.suspects()) | self._failed
        return sorted(out & set(self.heartbeats.last_seen))

    def healthy(self) -> List[str]:
        bad = set(self.suspects())
        return [r for r in self.heartbeats.last_seen if r not in bad]
