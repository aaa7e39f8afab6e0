"""Fault-tolerance policies of the port (``repro/runtime/fault.py``).

Host logic only, with an injectable clock and a caller's ``rng`` for the
jitter, so that the same inputs give the same outputs as the reference's:

* ``HeartbeatRegistry`` — participants check in; silence beyond
  ``timeout`` marks them suspect.
* ``retry_step`` — transient-failure wrapper with capped exponential
  backoff and seeded jitter (``RetryStats`` counts the attempts).
* ``PoisonPolicy`` — a NaN/Inf loss skips the update; ``max_consecutive``
  of them in a row rewind to the last good checkpoint.
* ``StragglerMonitor`` — EWMA of latency per participant; an entry
  ``factor`` x slower than the median is flagged, and
  ``runtime.serve_loop.QueryScheduler.rebalance`` sheds a flagged lane's
  queued batches onto healthy lanes (``shed_stragglers``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class HeartbeatRegistry:
    def __init__(self, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last_seen: Dict[str, float] = {}

    def beat(self, participant: str):
        self.last_seen[participant] = self.clock()

    def remove(self, participant: str) -> bool:
        """Retire a participant that left (not a failure): otherwise its
        last beat ages past ``timeout`` and it stays a suspect forever.
        Returns whether it was registered."""
        return self.last_seen.pop(participant, None) is not None

    forget = remove

    def suspects(self) -> List[str]:
        now = self.clock()
        return [p for p, t in self.last_seen.items()
                if now - t > self.timeout]

    def healthy(self) -> List[str]:
        bad = set(self.suspects())
        return [p for p in self.last_seen if p not in bad]


@dataclass
class RetryStats:
    """Out-param of :func:`retry_step`: its attempt accounting."""
    attempts: int = 0            # calls made (1 == first try succeeded)
    retried: int = 0             # failures that were retried
    slept_s: float = 0.0         # total backoff requested


def retry_step(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5,
               max_delay: float = 30.0,
               sleep: Callable[[float], None] = time.sleep,
               retriable=(RuntimeError, OSError),
               stats: Optional[RetryStats] = None,
               jitter: float = 0.0,
               rng: Optional[np.random.Generator] = None, **kwargs):
    """Run ``fn`` with exponential backoff on transient failures.

    The delay doubles from ``base_delay`` and is capped at ``max_delay``.
    ``jitter`` scales each delay by a uniform factor in ``[1 - jitter,
    1 + jitter]`` drawn from ``rng`` (one draw per retry, then re-capped),
    so a seeded caller gets the same backoff schedule on every replay;
    ``stats.slept_s`` records the delays actually slept.
    """
    if jitter and rng is None:
        rng = np.random.default_rng()
    for attempt in range(retries + 1):
        if stats is not None:
            stats.attempts += 1
        try:
            return fn(*args, **kwargs)
        except retriable:
            if attempt == retries:
                raise
            delay = min(base_delay * (2 ** attempt), max_delay)
            if jitter:
                u = float(rng.uniform(-jitter, jitter))
                delay = min(delay * (1.0 + u), max_delay)
            if stats is not None:
                stats.retried += 1
                stats.slept_s += delay
            sleep(delay)


@dataclass
class PoisonPolicy:
    """Skip-and-rewind policy for non-finite losses."""
    max_consecutive: int = 3
    consecutive: int = 0
    total_skipped: int = 0

    def observe(self, loss: float) -> str:
        """Returns 'ok' | 'skip' | 'rewind'."""
        if math.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_skipped += 1
        if self.consecutive >= self.max_consecutive:
            self.consecutive = 0
            return "rewind"
        return "skip"


@dataclass
class StragglerMonitor:
    factor: float = 2.0
    alpha: float = 0.2           # EWMA smoothing
    ewma: Dict[str, float] = field(default_factory=dict)

    def record(self, participant: str, latency: float):
        prev = self.ewma.get(participant)
        self.ewma[participant] = (latency if prev is None
                                  else (1 - self.alpha) * prev
                                  + self.alpha * latency)

    def stragglers(self) -> List[str]:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        return [p for p, v in self.ewma.items() if v > self.factor * med]

    def reassign(self, queues: Dict[str, list]) -> Dict[str, list]:
        """Move a straggler's queued work to the healthy peers."""
        return self.shed_stragglers(queues)[0]

    def shed_stragglers(self, queues: Dict[str, list]
                        ) -> Tuple[Dict[str, list], int]:
        """``reassign`` plus the number of items moved.

        Donors are flagged lanes with queued work; receivers are the lanes
        that are not flagged, so an idle straggler never receives work.
        """
        slow = set(self.stragglers())
        donors = [p for p in slow if queues.get(p)]
        fast = [p for p in queues if p not in slow]
        if not donors or not fast:
            return queues, 0
        out = {p: list(q) for p, q in queues.items()}
        moved = []
        for p in donors:
            moved.extend(out[p])
            out[p] = []
        for i, item in enumerate(moved):
            out[fast[i % len(fast)]].append(item)
        return out, len(moved)
