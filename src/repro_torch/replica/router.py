"""Front-tier router: load balancing, failover, bounded-staleness epochs
(``repro/replica/router.py``).

The client-facing seam of the replica plane. One :class:`Router` owns a
fleet of :class:`~repro_torch.replica.replica.ServeReplica` and gives
clients the same ``submit(index) -> AnswerFuture`` surface a single
deployment has, with three properties a single replica can't offer:

* **balancing** — power-of-two-choices on live ``queue_depth``: sample
  two eligible replicas, send to the shallower queue (equal depths go to
  the smaller id, so a seeded rng fixes every route).
* **failover** — every routed query keeps an *outer* future owned by the
  router; the replica's *inner* future forwards into it via done-
  callback. A replica dying (``ReplicaLost``) or answering a corrupted
  share (``IntegrityError``) is quarantined at once and the query —
  regenerated by index — goes to a healthy peer with capped exponential
  backoff. First-wins resolution on both futures makes the
  kill-vs-complete race benign: each query resolves exactly once, so no
  answer is lost. Graceful leave instead *hands off* the undispatched
  (item, future) pairs wholesale (``drain_handoff``).
* **bounded staleness** — database updates enter through the router
  (``update``/``publish``), which appends them to a delta log and
  replays the missing suffix to every healthy replica; per-replica
  epochs are tracked via publish subscriptions. Routing only considers
  replicas within ``staleness_bound`` epochs of the front-tier epoch,
  and a session's ``min_epoch`` ratchets to the newest epoch it has
  read — monotonic reads across failover.

Per-query deadlines: :meth:`Router.reap` hedges a query at half its
budget and expires it with ``QueryTimeout`` past it. Session affinity: a
session sticks to the replica that last served it while that replica
stays eligible, and re-pins transparently when it is not.

``chaos`` (default ``None``) is a ``repro_torch.chaos.ChaosInjector``
visited at the ``router.resubmit`` seam (a kill rides the retry ladder)
and at ``db.publish`` once per replica of a fan-out (a drop leaves that
replica lagging until the next publish or rejoin replays the delta log).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.db.spec import IntegrityError
from repro_torch.replica.registry import ReplicaRegistry
from repro_torch.replica.replica import ReplicaLost, ServeReplica
from repro_torch.runtime.fault import RetryStats, retry_step
from repro_torch.runtime.serve_loop import AnswerFuture, QueryTimeout


@dataclass
class Session:
    """Client session state: affinity pin + monotonic-read floor."""
    id: str
    replica: Optional[str] = None       # affinity pin (advisory)
    min_epoch: int = 0                  # newest epoch this session read


@dataclass
class _Delta:
    """One published front-tier delta: replayable update batch."""
    epoch: int
    updates: List[Tuple[np.ndarray, np.ndarray]]   # [(rows, vals), ...]


class Router:
    """Front tier over a replica fleet (see module docstring)."""

    def __init__(self, *, registry: Optional[ReplicaRegistry] = None,
                 retries: int = 3, base_delay: float = 0.05,
                 max_delay: float = 5.0, jitter: float = 0.0,
                 staleness_bound: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None):
        self.registry = registry if registry is not None \
            else ReplicaRegistry()
        self.retries = retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        #: backoff jitter fraction (see runtime.fault.retry_step), drawn
        #: from the router's seeded rng, so replays stay deterministic
        self.jitter = jitter
        #: max epochs a replica may lag the front tier and still be
        #: routable; None disables the bound (lag never disqualifies)
        self.staleness_bound = staleness_bound
        # seeded by default: routing decisions (P2C probe pairs, backoff
        # jitter) replay identically run-to-run unless a caller opts into
        # its own generator
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.sleep = sleep
        self.clock = clock
        self.chaos = chaos

        self._lock = threading.RLock()
        self.replicas: Dict[str, ServeReplica] = {}
        self.epochs: Dict[str, int] = {}      # last epoch seen per replica
        self.sessions: Dict[str, Session] = {}
        self._unsubs: Dict[str, Callable] = {}
        # front-tier update plane
        self._staged: List[Tuple[np.ndarray, np.ndarray]] = []
        self.delta_log: List[_Delta] = []
        self._published = 0                   # front-tier epoch
        # deadline plane: queries submitted with a deadline, awaiting
        # resolution — reap() expires and hedges from this table
        self._pending_q: Dict[int, dict] = {}
        self._pending_seq = 0

        # metrics (replica/metrics.py snapshots these)
        self.failovers = 0                    # inner-future failures seen
        self.resubmitted = 0                  # handoff pairs re-enqueued
        self.integrity_failures = 0           # corrupted answers caught
        self.hedges = 0                       # deadline-driven resubmits
        self.deadline_expired = 0             # futures failed by reap()
        self.retry_stats = RetryStats()

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def attach(self, replica: ServeReplica, *,
               warm_from: Any = None) -> ServeReplica:
        """Join a replica: warm the plan cache, wire health + epoch
        tracking, replay the delta suffix it missed, start serving.

        ``warm_from`` is a healthy :class:`ServeReplica` (its exported
        plans are recorded) or a ``{bucket: plan}`` dict. The facades
        resolve their primary bucket at construction, so for a freshly
        *constructed* replica prefer ``ServeReplica(...,
        warm_plans=peer.export_plans())``; ``warm_from`` here still covers
        the buckets resolved later.
        """
        if warm_from is not None:
            plans = (warm_from.export_plans()
                     if hasattr(warm_from, "export_plans") else warm_from)
            replica.warm_start(plans)
        rid = replica.id
        with self._lock:
            self.replicas[rid] = replica
            self.epochs[rid] = replica.epoch
        self.registry.join(replica)
        self._unsubs[rid] = replica.subscribe_epochs(
            lambda e, rid=rid: self._note_epoch(rid, e))
        self._catch_up(replica)
        replica.start()
        return replica

    def detach(self, rid: str) -> int:
        """Graceful leave: drain the replica's undispatched queries and
        resubmit each (item, future) pair to a healthy peer — the futures
        move with the work, so clients never observe the migration.
        Returns the number of pairs moved. Dispatched batches complete on
        the leaving replica before its session thread exits."""
        with self._lock:
            replica = self.replicas.pop(rid)
            self.epochs.pop(rid, None)
            unsub = self._unsubs.pop(rid, None)
        if unsub is not None:
            unsub()
        self.registry.leave(rid)
        pairs = replica.drain_handoff()
        for item, fut in pairs:
            # a fresh route per attempt: the first pick may itself die
            # between routing and submit (submit raises RuntimeError on a
            # closed scheduler) — retry_step re-picks with capped backoff
            retry_step(self._resubmit_pair, item, fut,
                       retries=self.retries, base_delay=self.base_delay,
                       max_delay=self.max_delay, sleep=self.sleep,
                       jitter=self.jitter, rng=self.rng,
                       stats=self.retry_stats)
        with self._lock:
            self.resubmitted += len(pairs)
        return len(pairs)

    def _resubmit_pair(self, item: Any, fut: AnswerFuture):
        rid = self._route(None)
        self.replicas[rid].resubmit(item, fut)

    # ------------------------------------------------------------------
    # epoch tracking + eligibility
    # ------------------------------------------------------------------

    def _note_epoch(self, rid: str, epoch: int):
        with self._lock:
            if rid in self.epochs:
                self.epochs[rid] = max(self.epochs[rid], epoch)

    @property
    def published_epoch(self) -> int:
        """The front-tier epoch: every delta published through the
        router bumps it; replicas converge to it (bounded staleness)."""
        return self._published

    def epoch_lag(self, rid: str) -> int:
        with self._lock:
            return max(self._published - self.epochs.get(rid, 0), 0)

    def _eligible(self, min_epoch: int, exclude=()) -> List[str]:
        healthy = set(self.registry.healthy())
        with self._lock:
            out = []
            for rid in self.replicas:
                if rid in exclude or rid not in healthy:
                    continue
                e = self.epochs.get(rid, 0)
                if e < min_epoch:
                    continue
                if (self.staleness_bound is not None
                        and self._published - e > self.staleness_bound):
                    continue
                out.append(rid)
            return out

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def session(self, session_id: str, *, min_epoch: int = 0) -> Session:
        """Get-or-create client session state (affinity + epoch floor)."""
        with self._lock:
            s = self.sessions.get(session_id)
            if s is None:
                s = self.sessions[session_id] = Session(id=session_id)
            s.min_epoch = max(s.min_epoch, min_epoch)
            return s

    def _route(self, session: Optional[Session], exclude=()) -> str:
        """Pick an eligible replica: session affinity if still eligible,
        else power-of-two-choices on queue depth."""
        min_epoch = session.min_epoch if session is not None else 0
        eligible = self._eligible(min_epoch, exclude)
        if not eligible:
            raise RuntimeError(
                f"no eligible replica (min_epoch={min_epoch}, "
                f"staleness_bound={self.staleness_bound}, "
                f"healthy={self.registry.healthy()})")
        if session is not None and session.replica in eligible:
            return session.replica
        if len(eligible) == 1:
            pick = eligible[0]
        else:
            i, j = self.rng.choice(len(eligible), size=2, replace=False)
            a, b = eligible[int(i)], eligible[int(j)]
            da = self.replicas[a].queue_depth
            db = self.replicas[b].queue_depth
            if da == db:
                # deterministic tie-break: equal depths pick the smaller
                # id, so a seeded rng fully determines the route
                pick = min(a, b)
            else:
                pick = a if da < db else b
        if session is not None:
            session.replica = pick
        return pick

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------

    def submit(self, index: int, session: Optional[Session] = None, *,
               deadline_s: Optional[float] = None) -> AnswerFuture:
        """Private retrieval of ``db[index]`` through the fleet.

        Returns the router-owned *outer* future; it resolves when some
        replica answers (possibly after failover), tagged with the epoch
        the answer was computed at. Exhausting ``retries`` failovers
        resolves it with the last failure.

        ``deadline_s`` arms a per-query deadline: the future's
        ``result()`` stops waiting at the deadline, and :meth:`reap`
        additionally *hedges* the query (resubmits to a different
        replica, first answer wins) once half the deadline budget is
        spent, then expires it with :class:`QueryTimeout` past the
        deadline.
        """
        now = self.clock()
        deadline = None if deadline_s is None else now + deadline_s
        outer = AnswerFuture(deadline=deadline)
        if session is not None:
            outer.context["session"] = session.id
        if deadline is not None:
            with self._lock:
                key = self._pending_seq
                self._pending_seq += 1
                self._pending_q[key] = {
                    "index": index, "outer": outer, "session": session,
                    "t0": now, "deadline": deadline, "hedged": False}
            outer.add_done_callback(
                lambda f, key=key: self._pop_pending(key))
        self._dispatch(index, outer, session, attempt=0)
        return outer

    def _pop_pending(self, key: int):
        with self._lock:
            self._pending_q.pop(key, None)

    def reap(self, now: Optional[float] = None) -> Dict[str, int]:
        """Deadline police over the pending table; callers (or a
        maintenance thread) invoke it periodically.

        Two actions per sweep, both idempotent per query:

        * **hedge** — a query that has burnt half its deadline budget
          without resolving is resubmitted once to a replica *other*
          than the one serving it; first-wins resolution on the outer
          future makes the duplicate benign.
        * **expire** — a query past its deadline fails with
          :class:`QueryTimeout` (carrying session/replica/elapsed
          context). The late answer, if it ever lands, hits the
          already-resolved future and is discarded.

        Returns ``{"expired": n, "hedged": m}`` for this sweep.
        """
        now = self.clock() if now is None else now
        expired = hedged = 0
        with self._lock:
            entries = list(self._pending_q.items())
        for key, ent in entries:
            outer = ent["outer"]
            if outer.done():
                self._pop_pending(key)
                continue
            if now >= ent["deadline"]:
                with self._lock:
                    self.deadline_expired += 1
                outer.set_exception(QueryTimeout(
                    outer, timeout=ent["deadline"] - ent["t0"]))
                expired += 1
                continue
            half = ent["t0"] + 0.5 * (ent["deadline"] - ent["t0"])
            if not ent["hedged"] and now >= half:
                ent["hedged"] = True
                rid = outer.context.get("rid")
                with self._lock:
                    self.hedges += 1
                hedged += 1
                self._dispatch(ent["index"], outer, ent["session"],
                               attempt=0,
                               exclude=() if rid is None else (rid,))
        return {"expired": expired, "hedged": hedged}

    def _dispatch(self, index: int, outer: AnswerFuture,
                  session: Optional[Session], attempt: int, exclude=()):
        self.retry_stats.attempts += 1
        try:
            if self.chaos is not None and attempt > 0:
                # seam: a fault here simulates the failover path itself
                # failing (a RuntimeError rides the retry ladder below)
                self.chaos.visit("router.resubmit")
            rid = self._route(session, exclude)
            inner = self.replicas[rid].submit(index)
        except (RuntimeError, KeyError) as e:
            # routing found nothing, or the pick died between route and
            # submit (closed scheduler raises) — same failover path
            self._on_failure(None, index, outer, session, attempt, e)
            return
        outer.context["rid"] = rid
        inner.add_done_callback(
            lambda f: self._forward(rid, index, outer, session, attempt, f))

    def _forward(self, rid: str, index: int, outer: AnswerFuture,
                 session: Optional[Session], attempt: int,
                 inner: AnswerFuture):
        """Done-callback of the inner (replica-side) future: forward
        success into the outer future, or fail over. Runs on the
        resolving thread, outside every scheduler lock (the port's
        scheduler resolves futures after releasing its condition, on
        kill, on a failed finalize and on a failed pump alike)."""
        exc = inner.exception()
        if exc is None:
            outer.epoch = inner.epoch
            if session is not None and inner.epoch is not None:
                with self._lock:   # monotonic reads: ratchet the floor
                    session.min_epoch = max(session.min_epoch, inner.epoch)
            self.registry.beat(rid)
            outer.set_result(inner.result())
            return
        if isinstance(exc, (ReplicaLost, IntegrityError)):
            # quarantine NOW — a dead replica must stop being picked
            # before the heartbeat timeout notices the silence, and a
            # replica handing back corrupted shares is just as unfit to
            # serve as a dead one (trust the checksum, not the replica)
            self.registry.report_failure(rid)
            if isinstance(exc, IntegrityError):
                with self._lock:
                    self.integrity_failures += 1
        self._on_failure(rid, index, outer, session, attempt, exc)

    def _on_failure(self, rid: Optional[str], index: int,
                    outer: AnswerFuture, session: Optional[Session],
                    attempt: int, exc: BaseException):
        with self._lock:
            self.failovers += 1
        if attempt >= self.retries:
            outer.set_exception(exc)
            return
        delay = min(self.base_delay * (2 ** attempt), self.max_delay)
        if self.jitter:
            u = float(self.rng.uniform(-self.jitter, self.jitter))
            delay = min(delay * (1.0 + u), self.max_delay)
        self.retry_stats.retried += 1
        self.retry_stats.slept_s += delay
        self.sleep(delay)
        # resubmission is BY INDEX: fresh keygen on the new replica (the
        # failed replica's staged key material died with it); exclude the
        # replica we just watched fail — report_failure already
        # quarantined it, but the exclusion also covers soft failures
        # that don't trip the health registry
        self._dispatch(index, outer, session, attempt + 1,
                       exclude=() if rid is None else (rid,))

    # ------------------------------------------------------------------
    # update plane: fan-out with bounded staleness
    # ------------------------------------------------------------------

    def update(self, rows, values) -> int:
        """Stage public row writes at the front tier; nothing reaches any
        replica until :meth:`publish`. Returns staged batch count."""
        with self._lock:
            self._staged.append((np.asarray(rows), np.asarray(values)))
            return len(self._staged)

    def publish(self) -> int:
        """Seal the staged updates as the next front-tier epoch and fan
        the delta out: every *healthy* replica replays its missing log
        suffix (usually just this delta) in order. Suspect replicas skip
        — they converge via the same replay at rejoin (:meth:`attach`)
        or at the next publish after recovering. Returns the front-tier
        epoch; per-replica epochs are tracked via subscriptions and
        bounded by ``staleness_bound`` at routing time."""
        with self._lock:
            staged, self._staged = self._staged, []
            if not staged:
                return self._published
            self._published += 1
            self.delta_log.append(_Delta(epoch=self._published,
                                         updates=staged))
            targets = [self.replicas[rid]
                       for rid in self.registry.healthy()
                       if rid in self.replicas]
        for replica in targets:
            if (self.chaos is not None
                    and self.chaos.should_drop("db.publish", replica.id)):
                # this replica misses the fan-out; it converges via the
                # same delta-log replay at the next publish or rejoin
                continue
            self._catch_up(replica)
        return self._published

    def _catch_up(self, replica: ServeReplica) -> int:
        """Replay, in epoch order, every logged delta the replica has not
        applied yet. Deterministic replay from the same epoch-0 contents
        ⇒ identical epoch numbering AND contents across the fleet.

        This runs on the caller's thread while the other replicas (and
        this one, at publish) serve. On a card their copy-on-publish
        clones and the serving kernels are queued on the same default
        stream, so a clone never overlaps a scan reading the rows it
        copies; no further synchronisation is needed."""
        applied = 0
        with self._lock:
            missing = [d for d in self.delta_log if d.epoch > replica.epoch]
        for delta in missing:
            for rows, vals in delta.updates:
                replica.db.stage(rows, vals)
            replica.db.publish()
            applied += 1
        return applied
