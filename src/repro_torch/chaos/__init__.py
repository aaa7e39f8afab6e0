"""The chaos plane of the port (``repro/chaos/__init__.py``):
deterministic, replayable fault injection.

A ``FaultPlan`` is a *seeded schedule* of ``FaultEvent``s; a
``ChaosInjector`` executes it against named **seams** — fixed hook points
the serve stack consults when (and only when) an injector is wired in:

==================== ======================================================
seam                 where it fires
==================== ======================================================
scheduler.dispatch   ``QueryScheduler._launch``, before a batch is collated
replica.serve_step   the facades' dispatch closures, on the answer shares
router.resubmit      ``Router._dispatch`` on failover / hedge resubmits
db.publish           ``Database.publish`` / ``Router.publish`` fan-out
heartbeat            ``ReplicaRegistry.beat``
plan_cache.load      ``engine.cache.PlanCache`` disk load
==================== ======================================================

Actions: ``corrupt`` (flip bits in one answer share), ``kill`` (raise
:class:`InjectedFault` at the seam), ``stall`` / ``delay`` (sleep
``duration_s``), ``drop`` (suppress the seam's effect: a heartbeat, a
publish fan-out, a cache load). Matching is by visit count: the injector
keeps a per-``(seam, target)`` counter, and an event fires on visits
``[at, at + count)``. Everything derives from the plan's one seed, drawn
from numpy's ``default_rng`` in the reference's order, so the same plan
fires the same events and flips the same element of the same share in
both packages.

The injector is passive: a path that was never handed one pays a single
``is None`` check. It imports nothing of the port, so any plane can
depend on it without cycles.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ACTIONS", "SEAMS", "ChaosInjector", "FaultEvent", "FaultPlan",
           "InjectedFault"]

#: the named hook points (see the module docstring)
SEAMS = ("scheduler.dispatch", "replica.serve_step", "router.resubmit",
         "db.publish", "heartbeat", "plan_cache.load")

#: what an event does when it fires
ACTIONS = ("corrupt", "kill", "stall", "drop", "delay")

#: a same-size signed integer view per element size, for the bit flip
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class InjectedFault(RuntimeError):
    """A chaos-injected failure (the ``kill`` action). A ``RuntimeError``,
    so that it rides the retry and failover paths a real crash takes."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    seam        which hook point (one of :data:`SEAMS`)
    action      one of :data:`ACTIONS`
    target      scope id (replica id, ...); ``None`` matches any target
    at          0-based visit count of (seam, target) at which it fires
    count       fires for this many consecutive visits
    duration_s  sleep length for ``stall`` / ``delay``
    """
    seam: str
    action: str
    target: Optional[str] = None
    at: int = 0
    count: int = 1
    duration_s: float = 0.0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; known: {SEAMS}")
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown action {self.action!r}; known: {ACTIONS}")
        if self.at < 0 or self.count < 1 or self.duration_s < 0:
            raise ValueError(f"degenerate fault event: {self}")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable fault schedule: the unit of replay. The seed
    drives both :meth:`random` (which events exist) and the injector's
    corruption draws (which bits flip)."""
    seed: int
    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def random(cls, seed: int, *,
               targets: Sequence[Optional[str]] = (None,),
               seams: Sequence[str] = ("replica.serve_step", "heartbeat",
                                       "scheduler.dispatch"),
               actions: Sequence[str] = ("corrupt", "kill", "drop"),
               n_events: int = 4, max_at: int = 8) -> "FaultPlan":
        """Draw a reproducible plan: same arguments, same schedule (seam,
        action, target and ``at`` per event, in that order)."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(int(n_events)):
            seam = seams[int(rng.integers(len(seams)))]
            action = actions[int(rng.integers(len(actions)))]
            if action == "corrupt":
                seam = "replica.serve_step"   # the only share-bearing seam
            elif action == "drop":
                seam = "heartbeat" if seam == "replica.serve_step" else seam
            target = targets[int(rng.integers(len(targets)))]
            events.append(FaultEvent(
                seam=seam, action=action, target=target,
                at=int(rng.integers(max_at))))
        return cls(seed=seed, events=tuple(events))


@dataclass
class _Fired:
    """One log entry: what fired, where, on which visit."""
    seam: str
    target: Optional[str]
    action: str
    visit: int


def _flip_top_bits(share, pos: int):
    """A copy of ``share`` with element ``pos`` (row-major) XORed with the
    top bit of each of its bytes. A tensor is copied and flipped on its own
    device, through a same-size signed integer view; a numpy array on the
    host, through an unsigned one."""
    if isinstance(share, torch.Tensor):
        out = share.clone(memory_format=torch.contiguous_format)
        size = out.element_size()
        mask = int.from_bytes(b"\x80" * size, "little", signed=True)
        out.view(-1).view(_INT_VIEW[size]).narrow(0, pos, 1).bitwise_xor_(
            mask)
        return out
    arr = np.array(np.asarray(share))           # host copy, mutable
    u = arr.reshape(-1).view(np.dtype(f"u{arr.dtype.itemsize}"))
    mask = int.from_bytes(b"\x80" * arr.dtype.itemsize, "little")
    u[pos] ^= np.asarray(mask, u.dtype)
    return arr


def _n_elements(share) -> int:
    if isinstance(share, torch.Tensor):
        return share.numel()
    return np.asarray(share).size


class ChaosInjector:
    """Executes a :class:`FaultPlan` at the serve stack's seams.

    Counters are bumped under the GIL from short critical paths;
    determinism comes from the per-(seam, target) visit counters, so
    concurrency across different targets cannot reorder one target's own
    schedule.
    """

    def __init__(self, plan: FaultPlan, *,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self.sleep = sleep
        self.rng = np.random.default_rng(plan.seed)
        self._counts: dict = {}
        self.fired: List[_Fired] = []

    # -- core matching --------------------------------------------------

    def fire(self, seam: str, target: Optional[str] = None
             ) -> Tuple[FaultEvent, ...]:
        """Consume one visit of ``(seam, target)`` and return the events
        that fire on it, each logged in :attr:`fired`; sleeps out any
        ``stall`` / ``delay``. What ``kill`` / ``drop`` / ``corrupt`` mean
        is the caller's (or a helper's) business."""
        key = (seam, target)
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        hits = tuple(
            ev for ev in self.plan.events
            if ev.seam == seam
            and (ev.target is None or ev.target == target)
            and ev.at <= n < ev.at + ev.count)
        for ev in hits:
            self.fired.append(_Fired(seam, target, ev.action, n))
            if ev.action in ("stall", "delay") and ev.duration_s > 0:
                self.sleep(ev.duration_s)
        return hits

    # -- seam helpers ----------------------------------------------------

    def visit(self, seam: str, target: Optional[str] = None
              ) -> Tuple[FaultEvent, ...]:
        """``fire``, then raise :class:`InjectedFault` on a ``kill``."""
        hits = self.fire(seam, target)
        for ev in hits:
            if ev.action == "kill":
                raise InjectedFault(
                    f"chaos kill at {seam}"
                    f"{'' if target is None else ':' + str(target)}")
        return hits

    def should_drop(self, seam: str, target: Optional[str] = None) -> bool:
        """``fire``, then whether the seam's effect is suppressed this
        visit (heartbeat delivery, publish fan-out)."""
        return any(ev.action == "drop" for ev in self.fire(seam, target))

    def corrupt_shares(self, seam: str, target: Optional[str], shares):
        """``visit``, then on a ``corrupt`` event flip bits in one share.

        One element of one share is XORed with the repeated-byte mask
        ``0x80...80`` (the top bit of every byte), which every share
        algebra detects: it flips payload bits under XOR, shifts a byte by
        128 mod 256 under additive Z_256 shares, and shifts an LWE
        answer's residual by about Delta/2. The share index and then the
        element are drawn from the plan's rng. Tensors stay on their
        device: the flipped share is a copy there, of the same dtype.
        A kill on the same visit raises first, so its corrupt is logged
        but never applied.
        """
        hits = self.visit(seam, target)
        if not any(ev.action == "corrupt" for ev in hits):
            return shares
        out = list(shares)
        k = int(self.rng.integers(len(out)))
        pos = int(self.rng.integers(_n_elements(out[k])))
        out[k] = _flip_top_bits(out[k], pos)
        return tuple(out)

    # -- introspection ---------------------------------------------------

    def fired_actions(self, seam: Optional[str] = None) -> List[str]:
        """Actions that fired (optionally at one seam), in order."""
        return [f.action for f in self.fired
                if seam is None or f.seam == seam]
