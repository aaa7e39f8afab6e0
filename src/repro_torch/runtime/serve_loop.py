"""PIR serving runtime of the port (``repro/runtime/serve_loop.py``).

Pipeline (paper Figure 8, §3.4):
  ① client keys arrive per query                        -> pending queue
  ② the scheduler coalesces them into padded batches of a few bucket sizes
  ③ batches are spread round-robin over ``n_clusters`` lanes; a lane whose
     latency EWMA flags it a straggler has its queued batches shed onto
     healthy lanes (``StragglerMonitor.shed_stragglers`` via
     ``QueryScheduler.rebalance``)
  ④ a depth-2 dispatch loop stages batch k+1's keys (pad, pinned upload)
     and launches its answer step while batch k still runs on the card
  ⑤ answers return through per-query futures; all parties' shares are
     reconciled (``PIRProtocol.reconstruct_with``) when a batch completes

The port keeps ``AnswerFuture``, ``QueryScheduler``, ``PIRServeLoop``
(one party, batches of stacked keys), ``MultiServerPIR`` (k parties, e.g.
``xor-dpf-k``), ``TwoServerPIR`` (``xor-dpf-2``, ``additive-dpf-2``) and
``SingleServerPIR`` (``lwe-simple-1``: per-query client state and a client
hint cache) on one device. The lanes are logical: they share the device
and its stream. With verified reconstruction (``cfg.checksum``) records
come back at the logical width, and a corrupted share raises
``IntegrityError`` (``bad_queries`` are indices in its batch) out of the
batch's finalize; as upstream, that ends a session, which fails every
outstanding future with the same exception. Online updates (``update`` /
``publish``) swap in a new database epoch; every answer is tagged with the
epoch its own dispatch read. Per-query deadlines ride on the futures
(``QueryTimeout``). The replica plane's hooks are ``queue_depth``,
``drain_handoff``, ``kill`` and ``heartbeat``. Two chaos seams live here
(``repro_torch.chaos``): ``scheduler.dispatch``, visited once per batch
launch, and ``replica.serve_step``, where the facades hand each batch's
answer shares to ``corrupt_shares``; as upstream, the facades stage keys
padded to their bucket, so that those shares are ``[bucket, cols]``.

On a mesh of more than one rank, or one whose controller lies outside
it (``mesh=``, ``launch/mesh.py``), the database is sharded over the mesh
and each party's ``PIRServer`` answers through the sharded step
(``core/server.py``). The facades keep this contract there:

* SPMD construction and lifecycle: every rank builds the facade and calls
  ``start()`` and ``close()``. Outside a session ``query``, ``update``
  and ``publish`` are SPMD too: every rank calls them with the same
  arguments, the keys of a call are drawn on the controller and broadcast
  (a client rng that differs between ranks cannot split them), and every
  rank returns the records. ``SingleServerPIR`` encrypts there (A.s needs
  the whole of A, which only the controller draws) and broadcasts the
  ciphertexts and the client's secrets; its hint is built per row block
  and summed over the shard axis (``db/sharded.py``).
* One controller, ``mesh.controller`` (the grid's first rank unless the
  mesh names another). Its
  ``start()`` runs the scheduler's session thread, as on one card; every
  other rank's runs a follower (:class:`FollowerLoop`), which takes
  commands from the controller until ``STOP`` or ``ABORT``.
* ``submit`` and ``submit_batch`` are the controller's at any time (what
  it submits before ``start()`` waits for the session), and during a
  session so are ``query``, ``update``, ``publish``, ``queue_depth``,
  ``drain_handoff`` and ``kill``: a follower raises a ``ValueError`` that
  names the controller's rank (:data:`FOLLOWER_REFUSED`). An SPMD
  ``query`` refuses while the controller holds submitted queries (its
  pump would dispatch them on that rank alone).
* One thread per rank makes collectives: the controller's session thread
  or a follower's loop, so every rank makes the same collectives in the
  same order. A follower keeps at most ``depth`` dispatches in flight.
* Commands (``launch/mesh.send_command``, over ``mesh.control_group``,
  each a header of integers and then tensors as they are, never pickled):
  ``DISPATCH`` carries a batch's collated payload, which every rank then
  stages and dispatches itself (the parties' keys as one int32 tensor;
  the whole ``[Q, N]`` LWE ciphertext, of which each rank's answer reads
  its block's columns; a round's per-bucket keys); ``PUBLISH`` carries the
  staged rows and values, which every rank stages and publishes between
  the same two dispatches (a publish issued by a client thread runs on
  the session thread); ``STOP`` follows the controller's drain, and
  ``ABORT`` a kill, the chaos kill at ``scheduler.dispatch`` or a failed
  finalize. The controller sends ``DISPATCH`` after the
  ``scheduler.dispatch`` seam, so a kill there fails the batch before any
  rank dispatched it.
* Keys are drawn once, on the controller, from the client rng in the
  reference's order (one ``query_gen`` per ``submit``, ``plan_round`` per
  ``submit_batch``); only the controller finalizes, visits the chaos
  seams, records the straggler monitor and sheds lanes. A follower
  discards its answers once its reduce has returned.
* ``SingleServerPIR.start()`` builds the epoch's hint on every rank (a
  collective); a publish's delta is applied on every rank inside
  ``PUBLISH``, so the controller's finalize never builds one.
* Failures: a follower whose dispatch raises leaves its loop and sends
  nothing; the controller's next collective then fails (the peer is gone,
  or the group's timeout, ``init_distributed(timeout=)``, runs out), which
  ends the session like a dispatch crash. A failure between a command's
  send and the end of the controller's own part of it sends no ``ABORT``
  (the followers are inside that command's collectives and leave by the
  timeout); every other death does. Either way every outstanding future
  fails and ``close()`` returns on every rank.

A fleet's replica (``replica/replica.py``, on a mesh of
``runtime/elastic.carve_submeshes``) changes three things:

* Its followers run their loops from construction (:meth:`follow`, when
  the fleet's controller announces the replica) to the session's end, so
  a publish before ``start()`` (the router's catch-up) goes over the
  channel, and the controller's ``start()`` sends ``START``, on which
  every rank opens the session (``SingleServerPIR``: the hint).
* The controller may lie outside the grid (``mesh.controller`` not in
  ``mesh.ranks``; the facade's ``remote``). It then holds the host half
  only: the client rng and keygen (``SingleServerPIR``: the whole of A),
  the scheduler and its futures, the chaos seams and finalize; its
  database is a :class:`ControllerDatabase` (epoch, staged log,
  subscribers, no rows) and its parties :class:`PartyPlans`. It takes no
  part in the grid's collectives: after each ``DISPATCH`` the grid's first
  rank sends the reduced ``[k, bucket, cols]`` answer shares back as a
  reply (``launch/mesh.send_reply``), which finalize reads in dispatch
  order (the ``replica.serve_step`` seam is visited there), and a hint
  the client's cache misses is asked for with ``HINT`` and comes back the
  same way. Its traffic stays on the grid's control group.
* SPMD calls outside a session (``query``) are refused: the grid answers
  only what the controller sends in a session.

Still refused on a mesh (ROADMAP's A6b, what is left): replicas on
overlapping sub-meshes of several ranks (``carve_submeshes`` raises) and
``dryrun --mesh``.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import PIRConfig
from repro_torch.core import dpf, lwe
from repro_torch.core import protocol as protocol_mod
from repro_torch.core.protocol import PIRProtocol
from repro_torch.core.server import PartyPlans, PIRServer, bucket_for
from repro_torch.crypto.packing import records_to_host
from repro_torch.db import Database
from repro_torch.db.sharded import PublishedDelta, last_writes, staged_rows
from repro_torch.db.spec import DatabaseSpec
from repro_torch.engine.backend import Device
from repro_torch.launch.mesh import (REPLIES, Mesh, broadcast_from,
                                     collective_timeout, recv_command,
                                     recv_reply, recv_tensor, send_command,
                                     send_reply)
from repro_torch.runtime.fault import StragglerMonitor

#: dispatch depth: one batch running on the card, one being staged
PIPELINE_DEPTH = 2

#: what a follower rank raises for a client call during a session
FOLLOWER_REFUSED = ("{} is the controller's on a mesh: call it on rank {} "
                    "(mesh.controller)")

#: how long a lone query may wait for companions before an under-full
#: (padded) batch is cut
DEFAULT_MAX_WAIT_S = 0.005


@dataclass
class ServeStats:
    answered: int = 0
    batches: int = 0
    padded: int = 0              # pad slots computed and discarded
    reassignments: int = 0       # queued batches moved off stragglers
    latencies: List[float] = field(default_factory=list)
    bucket_counts: Dict[int, int] = field(default_factory=dict)
    # serving window, earliest dispatch .. latest completion: pipelined
    # batches overlap, so QPS is taken over it, never over the latency sum
    t_first: Optional[float] = None
    t_last: Optional[float] = None

    def observe_window(self, t0: float, t1: float):
        self.t_first = t0 if self.t_first is None else min(self.t_first, t0)
        self.t_last = t1 if self.t_last is None else max(self.t_last, t1)

    @property
    def wall_s(self) -> float:
        if self.t_first is None or self.t_last is None:
            return 0.0
        return self.t_last - self.t_first

    @property
    def qps(self) -> float:
        wall = self.wall_s
        return self.answered / wall if wall > 0 else 0.0

    @property
    def pad_fraction(self) -> float:
        slots = self.answered + self.padded
        return self.padded / slots if slots else 0.0


class QueryTimeout(TimeoutError):
    """``AnswerFuture.result`` ran out of time; the message names what is
    known of the query (bucket, epoch, elapsed time, how far past its
    deadline), as ``serve_loop.py:87`` upstream."""

    def __init__(self, fut: Optional["AnswerFuture"] = None,
                 timeout: Optional[float] = None):
        parts = []
        if fut is not None:
            now = time.monotonic()
            for key in ("session", "replica", "bucket"):
                if fut.context.get(key) is not None:
                    parts.append(f"{key}={fut.context[key]}")
            if fut.epoch is not None:
                parts.append(f"epoch={fut.epoch}")
            parts.append(f"elapsed={now - fut.created:.3f}s")
            if fut.deadline is not None:
                parts.append(f"deadline_over_by={now - fut.deadline:+.3f}s")
        if timeout is not None:
            parts.append(f"timeout={timeout:.3f}s")
        detail = f" ({', '.join(parts)})" if parts else ""
        super().__init__(f"answer not ready{detail}")


class AnswerFuture:
    """Per-query result handle; completion is first-wins and thread-safe.

    ``epoch`` is the database epoch the answer was computed at.
    ``deadline`` is an absolute ``time.monotonic()`` instant or ``None``:
    ``result()`` without a timeout waits until it and then raises
    :class:`QueryTimeout`. ``context`` holds attribution for that message.
    """

    def __init__(self, *, deadline: Optional[float] = None):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["AnswerFuture"], None]] = []
        self.epoch: Optional[int] = None
        self.deadline = deadline
        self.context: Dict[str, Any] = {}
        self.created = time.monotonic()

    def _resolve(self, value: Any, exc: Optional[BaseException]) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._value, self._exc = value, exc
            callbacks, self._callbacks = self._callbacks, []
            self._ev.set()
        for cb in callbacks:        # outside the lock: a callback may block
            cb(self)
        return True

    def set_result(self, value: Any) -> bool:
        return self._resolve(value, None)

    def set_exception(self, exc: BaseException) -> bool:
        return self._resolve(None, exc)

    def add_done_callback(self, fn: Callable[["AnswerFuture"], None]):
        """Call ``fn(self)`` when the future resolves (at once if it has),
        on the resolving thread."""
        with self._lock:
            if not self._ev.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def done(self) -> bool:
        return self._ev.is_set()

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def result(self, timeout: Optional[float] = None) -> Any:
        if timeout is None and self.deadline is not None:
            timeout = max(self.deadline - time.monotonic(), 0.0)
        if not self._ev.wait(timeout):
            raise QueryTimeout(self, timeout=timeout)
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclass
class _Batch:
    """One cut (not yet padded) batch bound for a cluster lane."""
    items: List[Any]                  # per-query payloads
    futures: List[AnswerFuture]
    cluster: str
    bucket: int = 0
    epoch: Optional[int] = None       # database epoch read at dispatch


class QueryScheduler:
    """Dynamic batcher + depth-2 dispatcher over cluster lanes.

    Parameterized by four callables:

      collate(items)    stack per-query payloads into a batch
      stage(payload)    pad to the bucket and upload (overlaps compute)
      dispatch(staged)  launch the answer step (asynchronous on the card)
      finalize(raw, n)  wait and convert the first n real answers

    ``epoch_of(raw)`` reads the database epoch a batch was answered at from
    its own dispatch result, so across a publish a batch already
    dispatched keeps the old epoch's tag and data, while a batch still
    queued is tagged with the epoch it reads when it is dispatched.
    Batches are cut when a full largest bucket is pending or when the
    oldest query has waited ``max_wait_s``, and spread round-robin over
    ``n_clusters`` lanes (``cluster0``, ...); after each completion
    :meth:`rebalance` sheds a flagged straggler lane's queued batches onto
    healthy lanes (``monitor``, a ``StragglerMonitor``). ``clock`` is read
    for every timestamp the scheduler keeps.

    Drive it with :meth:`pump` or as a background session (:meth:`start` /
    :meth:`stop`). A failure in finalize (an ``IntegrityError`` of a
    corrupted share included) fails the batch's futures and is raised, as
    upstream: a session dies and fails every outstanding future with it;
    :meth:`pump` fails the batches it had launched and re-raises, leaving
    the batches it had not launched queued. The replica plane reads
    :attr:`queue_depth` and calls :meth:`drain_handoff` (graceful leave)
    and :meth:`kill` (hard death); ``heartbeat`` is called once per pump
    and once per turn of the session loop. ``chaos`` (a
    ``ChaosInjector``, ``None`` in production) is visited at
    ``"scheduler.dispatch"`` with ``chaos_target`` once per launch, before
    the batch is collated: a kill there fails the batch and, in a session,
    ends it like a dispatch crash.

    On a mesh (module docstring) the facade sets :attr:`channel` on the
    controller: its session thread then sends each batch's ``DISPATCH``
    before dispatching it, ``STOP`` after its drain and ``ABORT`` when it
    dies, and runs :meth:`call_in_session` callables (a publish) between
    two dispatches. ``spmd`` marks a scheduler that :meth:`pump` drives on
    every rank at once, which then keeps the lanes as cut (a shed follows
    each rank's own timings). ``following`` holds the controller's rank
    while this rank follows a session: the client calls raise then.
    """

    def __init__(self, *, collate: Callable[[List[Any]], Any],
                 stage: Callable[[Any], Any], dispatch: Callable[[Any], Any],
                 finalize: Callable[[Any, int], Sequence[Any]],
                 buckets: Sequence[int], n_clusters: int = 1,
                 max_wait_s: float = DEFAULT_MAX_WAIT_S,
                 monitor: Optional[StragglerMonitor] = None,
                 depth: int = PIPELINE_DEPTH,
                 clock: Callable[[], float] = time.monotonic,
                 epoch_of: Optional[Callable[[Any], Optional[int]]] = None,
                 heartbeat: Optional[Callable[[], None]] = None,
                 chaos=None, chaos_target: Optional[str] = None):
        self._collate = collate
        self._stage = stage
        self._dispatch = dispatch
        self._finalize = finalize
        self._epoch_of = epoch_of
        self.buckets = tuple(sorted(set(buckets)))
        self.n_clusters = max(n_clusters, 1)
        self.max_wait_s = max_wait_s
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self.depth = max(depth, 1)
        self.clock = clock
        #: liveness hook: silence means the session thread stopped turning
        self.heartbeat = heartbeat
        self.chaos = chaos
        self.chaos_target = chaos_target
        self.stats = ServeStats()
        self._cv = threading.Condition()
        self._pending: deque = deque()        # (item, future, t_submit)
        self.queues: Dict[str, List[_Batch]] = {
            f"cluster{i}": [] for i in range(self.n_clusters)}
        self._rr = 0                          # round-robin lane counter
        self._n_inflight = 0                  # real queries dispatched
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._closed = False                  # set by stop(), death, kill()
        self._abort_exc: Optional[BaseException] = None   # set by kill()
        #: callables for the session thread, run between two dispatches
        self._ops: deque = deque()            # (fn, future)
        #: the controller's command channel on a mesh (``_Channel``)
        self.channel: Optional["_Channel"] = None
        self.spmd = False
        self.following: Optional[int] = None

    def _refuse_on_follower(self, what: str):
        if self.following is not None:
            raise ValueError(FOLLOWER_REFUSED.format(what, self.following))

    # -- intake ----------------------------------------------------------

    def submit(self, item: Any, *, future: Optional[AnswerFuture] = None
               ) -> AnswerFuture:
        """Enqueue one query payload; returns its future (``future``, when
        given: a caller's deadline, or a handed-off query moving with its
        future). Raises ``RuntimeError`` once a session was stopped, died
        or was killed."""
        self._refuse_on_follower("submit")
        fut = future if future is not None else AnswerFuture()
        with self._cv:
            if self._closed:
                raise RuntimeError(
                    "QueryScheduler is stopped; submit() after stop() would "
                    "never be answered")
            self._pending.append((item, fut, self.clock()))
            if len(self._pending) >= self.buckets[-1]:
                self._cut_locked(self.buckets[-1])
            self._cv.notify()
        return fut

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    @property
    def queue_depth(self) -> int:
        """Real queries accepted and not yet resolved: pending, cut into
        lanes and dispatched (pad slots excluded)."""
        self._refuse_on_follower("queue_depth")
        with self._cv:
            return (len(self._pending) + self._n_inflight
                    + sum(len(b.items) for lane in self.queues.values()
                          for b in lane))

    def drain_handoff(self) -> List[Tuple[Any, AnswerFuture]]:
        """Graceful leave: close intake and return every query not yet
        dispatched as FIFO ``(item, future)`` pairs, to be resubmitted
        elsewhere with ``submit(item, future=fut)``. Batches already
        dispatched complete here; a running session finishes them and
        exits."""
        self._refuse_on_follower("drain_handoff")
        out: List[Tuple[Any, AnswerFuture]] = []
        with self._cv:
            self._closed = True
            self._stopping = True
            for lane in self.queues.values():
                for batch in lane:
                    out.extend(zip(batch.items, batch.futures))
                lane.clear()
            while self._pending:
                item, fut, _ = self._pending.popleft()
                out.append((item, fut))
            self._cv.notify_all()
        return out

    def kill(self, exc: BaseException):
        """Hard death: fail every outstanding future with ``exc`` and stop
        without draining. Queued and pending futures fail on the calling
        thread (outside the lock: their callbacks may resubmit); a running
        session fails its in-flight batches the same way and exits.
        Futures resolve first-wins, so a batch that beats the kill keeps
        its answers."""
        self._refuse_on_follower("kill")
        victims: List[AnswerFuture] = []
        with self._cv:
            self._closed = True
            self._stopping = True
            self._abort_exc = exc
            victims.extend(self._take_ops_locked())
            for lane in self.queues.values():
                for batch in lane:
                    victims.extend(batch.futures)
                lane.clear()
            while self._pending:
                victims.append(self._pending.popleft()[1])
            self._cv.notify_all()
        for fut in victims:
            fut.set_exception(exc)

    def flush(self):
        """Cut every pending query into batches now."""
        with self._cv:
            while self._pending:
                self._cut_locked(min(len(self._pending), self.buckets[-1]))
            self._cv.notify()

    def _cut_locked(self, n: int):
        """Form one batch of ``n`` pending queries onto the next lane."""
        taken = [self._pending.popleft() for _ in range(n)]
        lane = f"cluster{self._rr % self.n_clusters}"
        self._rr += 1
        batch = _Batch(items=[t[0] for t in taken],
                       futures=[t[1] for t in taken], cluster=lane,
                       bucket=self.bucket_for(n))
        for fut in batch.futures:          # for a timeout's message
            fut.context.setdefault("bucket", batch.bucket)
        self.queues[lane].append(batch)

    def _cut_ripe_locked(self):
        while self._pending and \
                self.clock() - self._pending[0][2] >= self.max_wait_s:
            self._cut_locked(min(len(self._pending), self.buckets[-1]))

    # -- straggler shedding ----------------------------------------------

    def rebalance(self) -> int:
        """Move queued batches off flagged straggler lanes; returns how
        many moved."""
        with self._cv:
            new_queues, moved = self.monitor.shed_stragglers(self.queues)
            if moved:
                for lane, batches in new_queues.items():
                    for b in batches:
                        b.cluster = lane
                self.queues = new_queues
                self.stats.reassignments += moved
        return moved

    def _pop_batch_locked(self) -> Optional[_Batch]:
        for i in range(self.n_clusters):
            lane = f"cluster{(self._rr + i) % self.n_clusters}"
            if self.queues[lane]:
                return self.queues[lane].pop(0)
        return None

    # -- dispatch engine -------------------------------------------------

    def _launch(self, batch: _Batch, channel: Optional["_Channel"] = None
                ) -> Tuple[_Batch, Any, float]:
        """Collate + stage + dispatch one batch; the card runs it async. A
        failure fails the batch's futures before it propagates: the batch
        has left the lanes already. With a ``channel`` the collated batch
        goes to every follower before this rank stages it."""
        try:
            if self.chaos is not None:
                self.chaos.visit("scheduler.dispatch", self.chaos_target)
            payload = self._collate(batch.items)
            if channel is not None:
                channel.dispatch(payload)
            staged = self._stage(payload)
            t0 = self.clock()
            raw = self._dispatch(staged)
            if channel is not None:
                channel.done()
            if self._epoch_of is not None:
                batch.epoch = self._epoch_of(raw)
        except BaseException as e:
            for fut in batch.futures:
                fut.set_exception(e)
            raise
        with self._cv:
            self._n_inflight += len(batch.items)
        return batch, raw, t0

    def _complete(self, batch: _Batch, raw: Any, t0: float, *,
                  rebalance: bool = True):
        try:
            answers = self._finalize(raw, len(batch.items))
            dt = self.clock() - t0
            for fut, ans in zip(batch.futures, answers):
                fut.epoch = batch.epoch      # before the result event fires
                fut.set_result(ans)
        except BaseException as e:
            for fut in batch.futures:
                fut.set_exception(e)
            raise
        finally:
            with self._cv:
                self._n_inflight -= len(batch.items)
        self.monitor.record(batch.cluster, dt)
        self.stats.observe_window(t0, t0 + dt)
        self.stats.latencies.append(dt)
        self.stats.batches += 1
        self.stats.answered += len(batch.items)
        self.stats.padded += batch.bucket - len(batch.items)
        self.stats.bucket_counts[batch.bucket] = \
            self.stats.bucket_counts.get(batch.bucket, 0) + 1
        if rebalance:
            self.rebalance()

    def _fail_inflight(self, inflight: deque, exc: BaseException):
        """Fail the futures of batches launched and not completed."""
        victims: List[AnswerFuture] = []
        with self._cv:
            for batch, _, _ in inflight:
                victims.extend(batch.futures)
                self._n_inflight -= len(batch.items)
        inflight.clear()
        for fut in victims:          # outside the lock: callbacks may
            fut.set_exception(exc)   # resubmit into other schedulers

    def pump(self) -> int:
        """Synchronously answer everything pending, depth-pipelined: batch
        k+1 is staged and launched before batch k is waited on. Returns the
        number of queries answered. On a failure the batches this pump
        launched and has not completed fail with it before it is raised
        (upstream leaves them unresolved); batches not launched stay
        queued."""
        if self.heartbeat is not None:
            self.heartbeat()
        self.flush()
        answered0 = self.stats.answered
        inflight: deque = deque()
        try:
            while True:
                with self._cv:
                    batch = self._pop_batch_locked()
                if batch is None and not inflight:
                    break
                if batch is not None:
                    inflight.append(self._launch(batch))
                while inflight and (len(inflight) >= self.depth
                                    or batch is None):
                    self._complete(*inflight.popleft(),
                                   rebalance=not self.spmd)
        except BaseException as e:
            self._fail_inflight(inflight, e)
            raise
        return self.stats.answered - answered0

    # -- background session ----------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        """Run the dispatch loop on a background thread (reopens a stopped,
        dead or killed session)."""
        if self.running:
            return
        with self._cv:
            self._closed = False
            self._stopping = False
            self._abort_exc = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pir-scheduler")
        self._thread.start()

    def stop(self):
        """Flush, answer everything in flight, then join the thread."""
        with self._cv:
            thread = self._thread
            if thread is None or not thread.is_alive():
                return
            self._closed = True
            self._stopping = True
            self._cv.notify()
        thread.join()
        with self._cv:
            if self._thread is thread:
                self._thread = None

    def call_in_session(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn()`` on the session thread between two dispatches and
        return its result: on a mesh a publish runs there, so that one
        thread of the rank makes collectives. Raises ``RuntimeError`` when
        no session runs; ``fn``'s failure is raised here and ends the
        session."""
        fut = AnswerFuture()
        with self._cv:
            if self._closed or not self.running:
                raise RuntimeError("QueryScheduler has no running session "
                                   "to run a call between its dispatches")
            self._ops.append((fn, fut))
            self._cv.notify()
        return fut.result()

    def _take_ops_locked(self) -> List[AnswerFuture]:
        futs = [fut for _, fut in self._ops]
        self._ops.clear()
        return futs

    def _run(self):
        inflight: deque = deque()
        channel = self.channel
        try:
            while True:
                batch = op = None
                if self.heartbeat is not None:
                    self.heartbeat()
                with self._cv:
                    if self._abort_exc is not None:   # kill(): no draining
                        raise self._abort_exc
                    if self._ops:
                        op = self._ops.popleft()
                    else:
                        self._cut_ripe_locked()
                        if self._stopping:
                            while self._pending:
                                self._cut_locked(min(len(self._pending),
                                                     self.buckets[-1]))
                        if len(inflight) < self.depth:
                            batch = self._pop_batch_locked()
                        if batch is None and not inflight:
                            if self._stopping:
                                break
                            wait = None
                            if self._pending:
                                age = self.clock() - self._pending[0][2]
                                wait = max(self.max_wait_s - age, 0.0)
                            self._cv.wait(timeout=wait)
                            continue
                if op is not None:
                    fn, fut = op
                    try:
                        fut.set_result(fn())
                    except BaseException as e:
                        fut.set_exception(e)
                        raise
                    continue
                if batch is not None:
                    inflight.append(self._launch(batch, channel))
                    continue          # keep the pipeline full before waiting
                self._complete(*inflight.popleft())
            if channel is not None:
                channel.stop()
        except BaseException as e:
            try:
                # the followers leave first: failing the futures runs their
                # callbacks here (a router's failovers, keygen included)
                if channel is not None and not channel.busy:
                    channel.abort()
            finally:
                self._fail_outstanding(inflight, e)

    def _fail_outstanding(self, inflight: deque, exc: BaseException):
        """A dead session resolves every outstanding future with ``exc``
        and rejects later submits."""
        victims: List[AnswerFuture] = []
        with self._cv:
            self._closed = True
            victims.extend(self._take_ops_locked())
            for lane in self.queues.values():
                for batch in lane:
                    victims.extend(batch.futures)
                lane.clear()
            while self._pending:
                victims.append(self._pending.popleft()[1])
        self._fail_inflight(inflight, exc)
        for fut in victims:
            fut.set_exception(exc)


class _Ready:
    """Marks the point in the device's stream where an answer is complete,
    so that waiting for it does not wait for batches launched after it
    (the port's ``block_until_ready``); on the CPU the tensor is already
    complete. ``where`` is the answer, or the device whose current stream
    is marked."""

    def __init__(self, where):
        device = where.device if isinstance(where, torch.Tensor) \
            else torch.device(where)
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def wait(self):
        if self._event is not None:
            self._event.synchronize()


class _Channel:
    """The controller's end of a session's command channel on a mesh.

    ``wire(payload)`` turns a collated batch into a ``DISPATCH`` command's
    fields and tensors. Each command's sends are waited for at most the
    collective timeout; ``ABORT``'s are not waited for (the death path must
    return whether or not a follower reads it). ``busy`` is set from a
    command's send until the controller's own part of it returns
    (``done``): a failure in between means the followers sit inside that
    command's collectives, and they leave by the timeout, so that the
    death path sends no ``ABORT`` then. ``sent`` counts the commands,
    ``seconds`` is the host time spent sending them, by command, and
    ``dispatched`` holds each ``DISPATCH``'s fields (its query count
    first).

    On a controller outside the grid (``remote``) the grid's first rank
    replies: :meth:`answer` reads each dispatched batch's answer shares, in
    dispatch order, and :meth:`hint` asks for an epoch's hint (``HINT``)
    and reads it, keeping the answers that arrive before it. Before
    ``ABORT`` the answers of batches still in flight are read and dropped,
    so that no reply outlives the session. ``reply_s`` holds each reply's
    seconds from its send to its arrival, and ``wait_s`` the host time
    spent waiting for replies, by kind."""

    def __init__(self, mesh: Mesh, wire: Callable[[Any], Tuple[Sequence[int],
                                                            Sequence[Any]]]):
        self.mesh = mesh
        self.wire = wire
        self.busy = False
        self.sent: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self.dispatched: List[Tuple[int, ...]] = []
        self._pending: list = []      # the last ABORT's unwaited sends
        self.remote = not mesh.contains_rank
        self.owed = 0                 # answers dispatched and not read
        self._replies: Dict[str, deque] = {k: deque() for k in REPLIES}
        self.reply_s: Dict[str, List[float]] = {k: [] for k in REPLIES}
        self.wait_s: Dict[str, float] = {k: 0.0 for k in REPLIES}

    def _send(self, command: str, fields: Sequence[int] = (),
              tensors: Sequence[torch.Tensor] = (), wait: bool = True):
        self.busy = True
        t0 = time.perf_counter()
        works = send_command(self.mesh, command, fields, tensors, wait=wait)
        self.seconds[command] = (self.seconds.get(command, 0.0)
                                 + time.perf_counter() - t0)
        self.sent[command] = self.sent.get(command, 0) + 1
        return works

    def dispatch(self, payload):
        fields, tensors = self.wire(payload)
        self._send("DISPATCH", fields, tensors)
        self.dispatched.append(tuple(fields))
        if self.remote:
            self.owed += 1

    def publish(self, rows: np.ndarray, vals: np.ndarray):
        """The staged log: ``[R]`` int64 rows, ``[R, W]`` u32 values (sent
        as their int32 bits)."""
        self._send("PUBLISH", (len(rows), vals.shape[1]), (
            torch.from_numpy(np.ascontiguousarray(rows, np.int64)),
            torch.from_numpy(np.ascontiguousarray(vals).view(np.int32))))

    def start(self):
        self._send("START")
        self.busy = False

    def done(self):
        self.busy = False

    def stop(self):
        self._send("STOP")
        self.busy = False

    def abort(self):
        try:
            while self.owed:
                self._reply("ANSWER")
                self.owed -= 1
        except RuntimeError:    # the grid's first rank is gone: no reply
            self.owed = 0
        self._pending = self._send("ABORT", wait=False)
        self.busy = False

    def _reply(self, kind: str) -> Tuple[int, torch.Tensor]:
        """The grid's next reply of ``kind`` (field, tensor), reading and
        keeping the replies of the other kind that come first."""
        t0 = time.perf_counter()
        while not self._replies[kind]:
            got, value, t, seconds = recv_reply(self.mesh)
            self._replies[got].append((value, t))
            self.reply_s[got].append(seconds)
        self.wait_s[kind] += time.perf_counter() - t0
        return self._replies[kind].popleft()

    def answer(self, epoch: int) -> torch.Tensor:
        """The next dispatched batch's ``[k, bucket, cols]`` answer shares,
        which the grid must have read at ``epoch``."""
        got, t = self._reply("ANSWER")
        self.owed -= 1
        if got != epoch:
            raise RuntimeError(f"the grid answered a batch at epoch {got}, "
                               f"the controller dispatched it at {epoch}")
        return t

    def hint(self, epoch: int) -> torch.Tensor:
        """The grid's hint of ``epoch`` (``HINT``)."""
        self._send("HINT", (epoch,))
        self.busy = False
        got, t = self._reply("HINT")
        if got != epoch:
            raise RuntimeError(f"the grid sent the hint of epoch {got} for "
                               f"{epoch}")
        return t


class FollowerLoop:
    """A follower rank's part of a session on a mesh (module docstring).

    A thread takes the controller's commands until ``STOP`` or ``ABORT``:
    ``DISPATCH`` is turned back into a batch payload by
    ``unwire(fields, recv)`` (``recv(shape, dtype)`` reads the command's
    next tensor), staged and dispatched with the facade's own closures,
    keeping at most ``depth`` dispatches in flight, its answers dropped
    unless ``reply(raw)`` sends them to a controller outside the grid (it
    returns the pending sends); ``PUBLISH`` calls ``publish(rows,
    values)``, ``START`` calls ``start()`` and ``HINT`` calls
    ``hint(epoch)`` (which returns its pending sends too). A failure ends
    the loop at once and sends nothing: the controller's next collective
    then fails. ``dispatches``, ``publishes``, ``starts`` and ``hints``
    count what it ran, ``ended_by`` is the command that ended it (None
    after a failure, which is ``exc``) and ``t_end`` its
    ``time.monotonic()`` end. Its replies' sends are waited for before it
    ends, at most the collective timeout each."""

    def __init__(self, mesh: Mesh, *, unwire: Callable, stage: Callable,
                 dispatch: Callable, publish: Callable,
                 start: Optional[Callable] = None,
                 hint: Optional[Callable] = None,
                 reply: Optional[Callable] = None,
                 depth: int = PIPELINE_DEPTH):
        self.mesh = mesh
        self._unwire = unwire
        self._stage = stage
        self._dispatch = dispatch
        self._publish = publish
        self._start = start
        self._hint = hint
        self._reply = reply
        self.depth = max(depth, 1)
        self.dispatches = 0
        self.publishes = 0
        self.starts = 0
        self.hints = 0
        self.ended_by: Optional[str] = None
        self.exc: Optional[BaseException] = None
        self.t_end: Optional[float] = None
        self._sends: deque = deque()     # replies' pending (work, tensor)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pir-follower")

    def start(self):
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout)

    def _recv(self, shape, dtype) -> torch.Tensor:
        return recv_tensor(self.mesh, shape, dtype)

    def _sent(self, works: list, *, all_: bool = False):
        """Keep a reply's pending sends; forget those done (all of them,
        waited for, with ``all_``)."""
        self._sends.extend(works)
        while self._sends and (all_ or self._sends[0][0].is_completed()):
            work, _ = self._sends.popleft()
            work.wait(timeout=collective_timeout())

    def _run(self):
        inflight: deque = deque()
        try:
            while True:
                command, fields = recv_command(self.mesh)
                if command == "DISPATCH":
                    staged = self._stage(self._unwire(fields, self._recv))
                    while len(inflight) >= self.depth:
                        inflight.popleft().wait()
                    raw = self._dispatch(staged)
                    inflight.append(_Ready(self.mesh.device))
                    if self._reply is not None:
                        self._sent(self._reply(raw))
                    self.dispatches += 1
                elif command == "PUBLISH":
                    n, w = fields[:2]
                    rows = self._recv((n,), torch.int64).cpu().numpy()
                    vals = self._recv((n, w), torch.int32).cpu().numpy()
                    self._publish(rows, vals.view(np.uint32))
                    self.publishes += 1
                elif command == "START":
                    if self._start is not None:
                        self._start()
                    self.starts += 1
                elif command == "HINT":
                    self._sent(self._hint(fields[0]))
                    self.hints += 1
                else:
                    self._sent([], all_=True)
                    self.ended_by = command
                    return
        except BaseException as e:
            self.exc = e
        finally:
            self.t_end = time.monotonic()


class PIRServeLoop:
    """Single-party serve loop over a :class:`PIRServer`: batches of
    stacked keys in, answer shares out (``serve_loop.py:637`` upstream)."""

    def __init__(self, server: PIRServer, *, n_clusters: int = 1):
        self.server = server
        self.n_clusters = n_clusters
        self.task_q: "queue.Queue" = queue.Queue()
        self.straggler = StragglerMonitor()
        self.stats = ServeStats()

    def submit(self, keys):
        """Enqueue a batch of stacked keys (one cluster step of work)."""
        self.task_q.put(keys)

    def drain(self) -> List[torch.Tensor]:
        """Serial baseline: answer every queued batch, waiting for each
        (the paper's strictly synchronous Figure 8 loop); the comparison
        point of :meth:`drain_pipelined`."""
        out = []
        while not self.task_q.empty():
            keys = self.task_q.get()
            t0 = time.monotonic()
            ans = self.server.answer(keys)
            _Ready(ans).wait()
            self._record(keys, t0, time.monotonic() - t0)
            out.append(ans)
        return out

    def drain_pipelined(self, depth: int = PIPELINE_DEPTH
                        ) -> List[torch.Tensor]:
        """Depth-``depth`` drain: batch k+1 is staged and launched before
        batch k is waited on. The same answers as :meth:`drain`: pad-slot
        answers are dropped here."""
        out: List[torch.Tensor] = []
        inflight: deque = deque()
        while not self.task_q.empty() or inflight:
            if not self.task_q.empty() and len(inflight) < depth:
                keys = self.task_q.get()
                staged = self.server.stage_keys(keys)
                t0 = time.monotonic()
                ans = self.server.answer(staged)
                inflight.append((keys, ans, _Ready(ans), t0))
                continue
            keys, ans, ready, t0 = inflight.popleft()
            ans = ans[:self.server.protocol.n_queries(keys)]
            ready.wait()
            self._record(keys, t0, time.monotonic() - t0)
            out.append(ans)
        return out

    def _record(self, keys, t0: float, dt: float):
        self.stats.observe_window(t0, t0 + dt)
        self.stats.latencies.append(dt)
        self.stats.batches += 1
        self.stats.answered += self.server.protocol.n_queries(keys)
        self.straggler.record(
            f"cluster{self.stats.batches % max(self.n_clusters, 1)}", dt)


def _key_tensors(keys: dpf.DPFKey) -> List[torch.Tensor]:
    return [t for t in (keys.root_seed, keys.cw_seed, keys.cw_t,
                        keys.cw_final) if t is not None]


def _flat_keys(keys: Sequence[dpf.DPFKey]) -> torch.Tensor:
    """Every party's batched keys as one int32 tensor (a ``DISPATCH``)."""
    return torch.cat([t.reshape(-1) for k in keys for t in _key_tensors(k)])


def _unflat_keys(recv: Callable, specs: Sequence[dpf.DPFKey]
                 ) -> Tuple[dpf.DPFKey, ...]:
    """The keys :func:`_flat_keys` sent, read with ``recv(shape, dtype)``
    into the shapes of ``specs`` (``PIRProtocol.key_specs``)."""
    sizes = [t.numel() for k in specs for t in _key_tensors(k)]
    parts = iter(torch.split(recv((sum(sizes),), torch.int32), sizes))
    take = lambda spec: next(parts).view(spec.shape)
    out = []
    for spec in specs:          # the order of _key_tensors
        root, seed, cw_t = (take(spec.root_seed), take(spec.cw_seed),
                            take(spec.cw_t))
        final = None if spec.cw_final is None else take(spec.cw_final)
        out.append(dpf.DPFKey(party=spec.party, log_n=spec.log_n,
                              root_seed=root, cw_seed=seed, cw_t=cw_t,
                              cw_final=final, rounds=spec.rounds))
    return tuple(out)


def _padded(server: PIRServer, keys):
    """A scheduler batch's keys padded to its bucket, as upstream's stage
    pads them: the answer shares at the ``replica.serve_step`` seam are
    then ``[bucket, cols]`` in both packages, so one plan flips the same
    element, and finalize keeps the first n rows."""
    proto = server.protocol
    return proto.pad(keys, server.bucketed.bucket_for(proto.n_queries(keys)))


class ControllerDatabase:
    """A database sharded over a grid, as its controller sees it from
    outside the grid: the spec, the epoch, the staged log and the
    subscribers, and no rows. The facade publishes through its command
    channel (``PUBLISH``, which every rank of the grid stages and
    publishes) and then here, so that the epoch moves in step with the
    grid's; :meth:`hint` reads an epoch's hint back from the grid's first
    rank. ``register_hint`` is the grid's: nothing is built here."""

    def __init__(self, cfg: PIRConfig, mesh: Mesh):
        self.spec = DatabaseSpec.from_config(cfg)
        self.mesh = mesh
        self.device = mesh.device
        self._lock = threading.Lock()
        self._epoch = 0
        self._staged: List[Tuple[np.ndarray, np.ndarray]] = []
        self._subscribers: List[Callable[[PublishedDelta], None]] = []
        #: every published delta, in epoch order
        self.published: List[PublishedDelta] = []
        #: the facade's command channel (its ``hint``)
        self.channel: Optional[_Channel] = None
        #: optional ChaosInjector consulted at the "db.publish" seam
        self.chaos = None

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def stage(self, rows, values) -> int:
        """Append row writes to the log (``Database.stage``'s checks)."""
        staged = staged_rows(self.spec, rows, values)
        with self._lock:
            self._staged.append(staged)
            return sum(len(r) for r, _ in self._staged)

    def take_staged(self) -> Tuple[np.ndarray, np.ndarray]:
        """Remove the staged log and return it (``Database.take_staged``)."""
        with self._lock:
            staged, self._staged = self._staged, []
        if not staged:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.spec.item_words), np.uint32))
        return (np.concatenate([r for r, _ in staged]),
                np.concatenate([v for _, v in staged]))

    def subscribe(self, fn: Callable[[PublishedDelta], None]
                  ) -> Callable[[], None]:
        """``Database.subscribe``."""
        self._subscribers.append(fn)

        def _unsubscribe(fn=fn):
            if fn in self._subscribers:
                self._subscribers.remove(fn)
        return _unsubscribe

    def publish(self) -> int:
        """The next epoch from the staged log (what the grid has just
        published), and the subscribers told, as ``Database.publish``;
        nothing staged is a no-op."""
        rows, vals = self.take_staged()
        if not len(rows):
            return self.epoch
        n_staged, keep = len(rows), last_writes(rows)
        with self._lock:
            self._epoch += 1
            delta = PublishedDelta(epoch=self._epoch, rows=rows[keep],
                                   n_staged=n_staged, vals=vals[keep])
            self.published.append(delta)
        chaos = self.chaos
        if chaos is not None and chaos.should_drop("db.publish"):
            return delta.epoch
        for fn in tuple(self._subscribers):
            fn(delta)
        return delta.epoch

    def register_hint(self, name: str, build: Callable,
                      delta: Optional[Callable] = None) -> None:
        """The grid's ranks register and build the hint: nothing here."""

    def hint(self, name: str, *, epoch: Optional[int] = None
             ) -> torch.Tensor:
        """The grid's hint of ``epoch`` (current by default), read over the
        channel from the grid's first rank: on the session thread, the
        one that reads replies."""
        return self.channel.hint(self.epoch if epoch is None else epoch)


class MultiServerPIR:
    """End-to-end k-party deployment: client + k non-colluding servers.

    One shared :class:`Database` on ``device`` (``None`` means CUDA; no
    card raises), one :class:`PIRServer` per party, and one
    :class:`QueryScheduler` that fans every batch out to all parties and
    reconstructs the records. ``path=None`` lets the engine pick each
    bucket's kernel path: the tuned plan on a plan-cache hit, else
    ``plan_for`` (the reference defaults to ``"fused"``, its jnp-chunked
    path, which runs no kernel).

      query(indices)  synchronous retrieval (keys for the whole call are
                      generated in one batch; pumps the scheduler unless a
                      session is running)
      submit(index)   streaming form: returns an :class:`AnswerFuture`
      update(rows, values) / publish()
                      online updates: stage public row writes, then swap
                      them in as the next epoch (``Database.publish``)

    ``default_deadline_s`` (default 120 s per party, upstream's) becomes
    each future's deadline. ``n_clusters`` is the scheduler's lane count;
    the lanes share the one device. ``chaos`` (a ``ChaosInjector``, ``None``
    in production) is consulted at ``"scheduler.dispatch"`` (each launch)
    and ``"replica.serve_step"`` (each batch's answer shares, where a
    ``corrupt`` flips bits), with ``chaos_scope`` as the target: the
    replica plane passes its replica id. Both are held by the scheduler
    (``scheduler.chaos``, ``scheduler.chaos_target``) and read on every
    visit, so setting them on a built facade takes effect.

    ``mesh`` (a ``launch.mesh.Mesh``) shards the database over its ranks
    and makes the facade SPMD, with one controller for a session (module
    docstring); ``collective`` is the XOR schemes' reduce over the shard
    axis. ``follower`` is a follower rank's last :class:`FollowerLoop`.
    """

    #: hint protocols (``PIRProtocol.needs_hint``) carry per-query client
    #: state and an epoch hint through the scheduler; only subclasses that
    #: do (SingleServerPIR) may serve them
    _supports_hint_protocols = False
    #: the mesh the database is sharded over (None: one device), and
    #: whether the facade runs SPMD over its ranks
    mesh: Optional[Mesh] = None
    spmd = False

    def __init__(self, db_words, cfg: PIRConfig, *, device: Device = None,
                 path: Optional[str] = None, n_queries: int = 4,
                 buckets: Optional[Sequence[int]] = None,
                 max_wait_s: float = DEFAULT_MAX_WAIT_S,
                 protocol: Optional[PIRProtocol] = None,
                 client_rng: Optional[np.random.Generator] = None,
                 default_deadline_s: Optional[float] = None,
                 n_clusters: int = 1, chaos=None,
                 chaos_scope: Optional[str] = None,
                 mesh: Optional[Mesh] = None, collective: str = "gather"):
        self.cfg = cfg
        self.mesh = mesh
        self.protocol = (protocol if protocol is not None
                         else protocol_mod.for_config(cfg))
        if self.protocol.needs_hint and not self._supports_hint_protocols:
            raise ValueError(
                f"protocol {self.protocol.name!r} needs hint plumbing "
                f"(per-query client state + epoch hints) — use "
                f"SingleServerPIR, not {type(self).__name__}")
        self.n_parties = self.protocol.n_parties(cfg)
        #: this rank drives a grid it is not part of (a fleet's controller)
        self.remote = mesh is not None and not mesh.contains_rank
        if self.remote:
            if not mesh.is_controller:
                raise ValueError(
                    f"rank {mesh.rank} is neither in the mesh over ranks "
                    f"{list(mesh.ranks)} nor its controller "
                    f"({mesh.controller})")
            self.db = ControllerDatabase(cfg, mesh)
            self.servers = [
                PartyPlans(b, cfg, mesh, n_queries=n_queries, path=path,
                           buckets=buckets, protocol=self.protocol,
                           collective=collective)
                for b in range(self.n_parties)]
        else:
            self.db = (db_words if isinstance(db_words, Database)
                       else Database(db_words, cfg, device, mesh=mesh))
            self.servers = [
                PIRServer(party=b, database=self.db, cfg=cfg, mesh=mesh,
                          n_queries=n_queries, path=path, buckets=buckets,
                          protocol=self.protocol, collective=collective)
                for b in range(self.n_parties)]
        # key material must not be replayable: OS entropy unless a seeded
        # generator is injected (tests, benchmarks)
        self.rng = (client_rng if client_rng is not None
                    else np.random.default_rng())
        self._lock = threading.Lock()
        self.default_deadline_s = (default_deadline_s
                                   if default_deadline_s is not None
                                   else 120.0 * self.n_parties)
        self.scheduler = self._make_scheduler(max_wait_s, n_clusters)
        self.scheduler.chaos = chaos
        self.scheduler.chaos_target = chaos_scope
        self._init_session(mesh)

    def _init_session(self, mesh: Optional[Mesh]):
        """The session's state on any rank, and the controller's channel."""
        self.spmd = mesh is not None and mesh.multi_process
        self.remote = getattr(self, "remote", False)
        self._session = False              # between start() and close()
        #: the followers run their loops from construction (a fleet's
        #: replica, ``follow`` / ``announced``): every call that reaches
        #: the grid goes over the channel, before a session too
        self.followed = False
        self._opened = False
        self._update_lock = threading.Lock()
        self.follower: Optional[FollowerLoop] = None
        self.scheduler.spmd = self.spmd
        if self.spmd and mesh.is_controller:
            self.scheduler.channel = _Channel(mesh, self._wire)
            if self.remote:
                self.db.channel = self.scheduler.channel

    def announced(self):
        """On the controller of a fleet's replica: the followers were told
        of it (``JOIN``) and run their loops from now on, so a publish
        before ``start()`` goes over the channel and ``start()`` sends
        ``START``."""
        self.followed = True

    def follow(self):
        """On a follower of a fleet's replica: run the command loop from
        now on, the session's and the catch-up publishes before it. The
        grid's first rank sends the answers and hints to a controller
        outside the grid."""
        mesh = self.mesh
        replier = (mesh.controller not in mesh.ranks
                   and mesh.rank == mesh.ranks[0])
        self.followed = self._session = True
        self.scheduler.following = mesh.controller
        self.follower = FollowerLoop(
            mesh, unwire=self._unwire, stage=self.scheduler._stage,
            dispatch=self.scheduler._dispatch, publish=self._apply_publish,
            start=self._open, hint=self._send_hint,
            reply=self._send_answer if replier else None,
            depth=self.scheduler.depth)
        self.follower.start()

    def _open(self):
        """What every rank of the grid does as a session opens (the hint,
        for ``SingleServerPIR``)."""

    def _raw_answers(self, raw) -> Tuple[torch.Tensor, int]:
        """A dispatch's answer shares as one ``[k, bucket, cols]`` tensor,
        and the epoch it read."""
        answers, epoch = raw
        return torch.stack(answers), epoch

    def _send_answer(self, raw) -> list:
        """On the grid's first rank: a dispatch's answers to the controller
        outside the grid."""
        answers, epoch = self._raw_answers(raw)
        return send_reply(self.mesh, "ANSWER", epoch, answers)

    def _send_hint(self, epoch: int) -> list:
        """A ``HINT``: every rank of the grid reads the epoch's hint (a
        collective, where it is not built yet); the first sends it."""
        h = self.db.hint(self.protocol.name, epoch=epoch)
        if self.mesh.rank == self.mesh.ranks[0]:
            return send_reply(self.mesh, "HINT", epoch, h)
        return []

    def _controller_only(self, what: str, *, always: bool = False):
        """A follower refuses a client call during a session, or at any
        time (``always``: the streaming submits)."""
        if (self._session or always) and self.spmd \
                and not self.mesh.is_controller:
            raise ValueError(FOLLOWER_REFUSED.format(what,
                                                     self.mesh.controller))

    def _local(self) -> bool:
        """Whether a client call runs on this rank alone: on one device, or
        on the controller during a session (anywhere else it is SPMD)."""
        return not self.spmd or self._session

    def _spmd_pump_ready(self):
        """An SPMD call pumps the scheduler on every rank: the controller's
        queries submitted for a session must not ride along, and a grid
        that follows the controller from construction, or that the
        controller is not part of, answers in a session only."""
        if self.spmd and not self._session and (self.followed
                                                or self.remote):
            raise ValueError(
                "this deployment's grid answers what its controller sends "
                "in a session: start() one before a query")
        if self.spmd and not self._session and self.scheduler.queue_depth:
            raise ValueError(
                f"queries submitted on this mesh wait for a session "
                f"({self.scheduler.queue_depth}): start() one before an "
                f"SPMD query")

    def _wire(self, payload) -> Tuple[Tuple[int, ...], List[torch.Tensor]]:
        """A collated batch as a ``DISPATCH``: its query count, and every
        party's keys as one int32 tensor."""
        return (dpf.n_queries_of(payload[0]),), [_flat_keys(payload)]

    def _unwire(self, fields, recv):
        """A follower's payload from a ``DISPATCH`` (:meth:`_wire`)."""
        n = fields[0]
        return _unflat_keys(recv, [
            self.protocol.key_specs(self.cfg, n, party=p)
            for p in range(self.n_parties)])

    def _apply_publish(self, rows: np.ndarray, vals: np.ndarray) -> int:
        """A ``PUBLISH`` on a follower: the command's log replaces its own
        (what every rank staged before the session is the controller's
        too), then the next epoch."""
        self.db.take_staged()
        self.db.stage(rows, vals)
        return self.db.publish()

    def _publish_in_session(self) -> int:
        """The controller's publish, on its session thread (or, before a
        session of a grid that follows it, on the caller's): the staged log
        goes to every follower, then is published here."""
        with self._update_lock:
            rows, vals = self.db.take_staged()
            if not len(rows):
                return self.db.epoch
            channel = self.scheduler.channel
            channel.publish(rows, vals)
            self.db.stage(rows, vals)
            epoch = self.db.publish()
            channel.done()
            return epoch

    def _scheduler(self, **kwargs) -> QueryScheduler:
        """The facade's scheduler over its closures, with its buckets."""
        return QueryScheduler(buckets=self.servers[0].buckets,
                              epoch_of=lambda raw: raw[1], **kwargs)

    def _serve_step(self, answers: tuple) -> tuple:
        """The ``replica.serve_step`` seam: the scheduler's injector, read
        on every dispatch, may flip bits in one of the batch's answer
        shares."""
        chaos = self.scheduler.chaos
        if chaos is None or (self._session and self.follower is not None):
            return answers
        return chaos.corrupt_shares("replica.serve_step",
                                    self.scheduler.chaos_target, answers)

    def _make_scheduler(self, max_wait_s: float, n_clusters: int
                        ) -> QueryScheduler:
        servers, proto, db = self.servers, self.protocol, self.db
        parties = range(self.n_parties)

        def collate(items):
            return tuple(dpf.stack_keys([it[p] for it in items])
                         for p in parties)

        def stage(payload):
            if self.remote:                 # the grid stages it
                return payload
            return tuple(servers[p].stage_keys(_padded(servers[p], payload[p]))
                         for p in parties)

        def dispatch(staged):
            if self.remote:                 # the grid answers: finalize reads
                return None, db.epoch
            epoch, views = db.snapshot((proto.db_view,))
            view = views[proto.db_view]
            return self._serve_step(tuple(
                servers[p].bucketed.answer(view, staged[p])
                for p in parties)), epoch

        cfg = self.cfg

        def finalize(raw, n):
            answers, epoch = raw
            if answers is None:
                answers = self._serve_step(tuple(
                    self.scheduler.channel.answer(epoch)))
            # with cfg.checksum the records are verified and stripped to the
            # logical width; a corrupted share raises IntegrityError here
            rec = proto.reconstruct_with([a[:n] for a in answers], [None] * n,
                                         cfg=cfg)
            return list(records_to_host(rec))

        return self._scheduler(collate=collate, stage=stage,
                               dispatch=dispatch, finalize=finalize,
                               n_clusters=n_clusters, max_wait_s=max_wait_s)

    # -- streaming session API ------------------------------------------

    def start(self):
        """Open a session (reopen a dead one). On a mesh every rank calls
        it: the controller runs the session thread, a follower its loop.
        On a grid that follows the controller from construction only the
        controller calls it, once: it sends ``START`` to the followers'
        loops (a session there ends with their loops)."""
        if not self.spmd or self.mesh.is_controller:
            if self.spmd and not self.scheduler.running:
                if self.followed:
                    if self._opened:
                        raise RuntimeError(
                            "this grid's followers left their loops with "
                            "its session: serve on a fresh deployment")
                    self.scheduler.channel.start()
                if not self.remote:
                    self._open()
            self._opened = self._session = True
            self.scheduler.start()
        elif self.follower is None or not self.follower.running:
            self._session = True
            self._open()
            self.scheduler.following = self.mesh.controller
            self.follower = FollowerLoop(
                self.mesh, unwire=self._unwire, stage=self.scheduler._stage,
                dispatch=self.scheduler._dispatch,
                publish=self._apply_publish, depth=self.scheduler.depth)
            self.follower.start()

    def close(self):
        """Drain and end the session: on a mesh every rank calls it, and a
        follower returns once its loop has ended."""
        if not self.spmd or self.mesh.is_controller:
            self.scheduler.stop()
        elif self.follower is not None:
            self.follower.join()
            self.scheduler.following = None
        self._session = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    def _deadline_future(self, deadline_s: Optional[float]) -> AnswerFuture:
        """A fresh future carrying this query's absolute deadline."""
        d = self.default_deadline_s if deadline_s is None else deadline_s
        return AnswerFuture(
            deadline=None if d is None else time.monotonic() + d)

    def submit(self, index: int, *,
               deadline_s: Optional[float] = None) -> AnswerFuture:
        """Private retrieval of ``db[index]``; resolves to one record
        (``PIRProtocol.record_struct``: ``[W]`` uint32 words for XOR
        schemes, ``[L]`` uint8 bytes for the additive one)."""
        self._controller_only("submit", always=True)
        fut = self._deadline_future(deadline_s)
        with self._lock:         # client-side keygen shares one rng
            keys = self.protocol.query_gen(self.rng, index, self.cfg)
        return self.scheduler.submit(keys, future=fut)

    # -- online updates (public metadata) -------------------------------

    @property
    def epoch(self) -> int:
        """The database's current epoch (bumped by :meth:`publish`)."""
        return self.db.epoch

    def update(self, rows, values) -> int:
        """Stage public row writes (``[R, item_words]`` u32 or ``[R,
        item_bytes]`` u8); nothing is served from them until
        :meth:`publish`. Returns the staged entry count."""
        self._controller_only("update")
        with self._update_lock:
            return self.db.stage(rows, values)

    def publish(self) -> int:
        """Swap the staged writes in as the next epoch and return it.
        Batches already dispatched finish on the previous epoch and stay
        tagged with it; later batches read the new one. On a mesh during a
        session the session thread publishes, between two dispatches, on
        every rank."""
        self._controller_only("publish")
        if self.spmd and self._session:
            return self.scheduler.call_in_session(self._publish_in_session)
        if self.spmd and self.followed:     # before the session: no thread
            return self._publish_in_session()   # makes collectives yet
        return self.db.publish()

    # -- synchronous batch API ------------------------------------------

    def query(self, indices: Sequence[int]) -> np.ndarray:
        """Private retrieval of ``db[indices]``: ``[Q, W]`` uint32 records,
        or ``[Q, L]`` uint8 for the byte schemes."""
        self._controller_only("query")
        self._spmd_pump_ready()
        indices = list(indices)
        if not indices:
            tail, dtype = self.protocol.record_struct(self.cfg)
            return np.empty((0,) + tail, dtype)
        with self._lock:
            items = self._query_items(indices)
        futs = [self.scheduler.submit(it, future=self._deadline_future(None))
                for it in items]
        if not self.scheduler.running:
            self.scheduler.pump()
        return np.stack([f.result() for f in futs])

    def query_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Multi-query retrieval, the same as :meth:`query` here: each
        index is a full-database query. ``BatchPIR`` overrides it with the
        cuckoo-bucketed rounds."""
        return self.query(indices)

    def _query_items(self, indices: List[int]) -> List[Any]:
        """The scheduler's per-query items for a whole call, generated in
        one batch (the same rng draws as one :meth:`submit` per index):
        one key per party."""
        batch = self._drawn(lambda: self.protocol.query_gen_batch(
            self.rng, indices, self.cfg))
        return [tuple(dpf.key_at(k, i) for k in batch)
                for i in range(len(indices))]

    def _drawn(self, draw: Callable[[], Any]) -> Any:
        """``draw()`` once for the deployment: on a mesh outside a session,
        on the controller, then broadcast to every rank (as host tensors),
        so that every rank answers the same keys whatever its own rng
        holds; in a session on the controller alone."""
        if self._local():
            return draw()
        src = self.mesh.controller
        box = [draw() if self.mesh.rank == src else None]
        dist.broadcast_object_list(
            box, src=src, group=self.mesh.all_group,
            device=self.mesh.device if self.mesh.backend == "nccl" else None)
        return box[0]


class SingleServerPIR(MultiServerPIR):
    """Single-server deployment for hint protocols (``lwe-simple-1``).

    Reuses the multi-server machinery — ``Database``, ``PIRServer``'s
    bucketed plans, the ``QueryScheduler`` — with the two additions a hint
    protocol needs (``serve_loop.py:938-1050`` upstream):

      * client state: queries carry ``(ciphertext, state)``; the secret
        rides through the scheduler beside the ciphertext (never to the
        device) and meets the answers again at finalize;
      * a client-side hint cache keyed by the epoch each batch's answers
        are tagged with; a miss fetches the epoch's hint from the database
        (``hint_fetches`` counts the fetches) and two epochs are kept.
        The server keeps the hint itself up to date: a publish applies
        the registered exact delta (``lwe.hint_delta_fn``, one call of
        the int32 GEMM) into a new tensor, so a batch tagged with the
        retired epoch still decodes with that epoch's hint.

    The client encrypts on the database's device: ``A.s`` is one int32
    GEMM through ``ops.lwe_gemm``.

    On a mesh (module docstring) the client is the controller: it
    encrypts with the whole of A. Outside a session it broadcasts a call's
    ``[Q, N]`` ciphertexts (each rank's answer reads its block's columns)
    and the secrets; the hint, built per row block and summed, is the same
    on every rank, so every rank decodes the records, and the first query
    of an epoch builds the hint in finalize, a collective every rank
    reaches at the same batch. In a session each ``DISPATCH`` carries the
    whole ciphertext (one broadcast) and the secrets stay on the
    controller, which alone decodes; :meth:`start` builds the hint on
    every rank, and each publish's delta is applied on every rank inside
    its ``PUBLISH``.
    """

    _supports_hint_protocols = True

    def __init__(self, db_words, cfg: PIRConfig, *,
                 protocol: Optional[PIRProtocol] = None, **kwargs):
        proto = (protocol if protocol is not None
                 else protocol_mod.for_config(cfg))
        k = proto.n_parties(cfg)
        if k != 1:
            raise ValueError(
                f"SingleServerPIR requires a 1-party protocol; "
                f"{proto.name!r} has {k} parties — use MultiServerPIR")
        # the client hint cache exists before the scheduler's finalize
        # closure is built
        self._hint_lock = threading.Lock()
        self._hint_cache: Dict[int, np.ndarray] = {}
        self.hint_fetches = 0
        super().__init__(db_words, cfg, protocol=proto, **kwargs)

    def _open(self):
        """As a session opens on a mesh every rank of the grid builds the
        current epoch's hint (a collective), which the publishes' deltas
        then keep up to date on every rank."""
        if self.spmd and not self.remote:
            self.db.hint(self.protocol.name)

    def _raw_answers(self, raw) -> Tuple[torch.Tensor, int]:
        ans, epoch, _ = raw
        return ans[None], epoch

    def _wire(self, payload):
        ct, _ = payload           # the secrets stay with the client
        return (ct.ct.shape[0],), [ct.ct]

    def _unwire(self, fields, recv):
        n = fields[0]
        spec = self.protocol.key_specs(self.cfg, n)
        return spec.map(lambda t: recv(t.shape, t.dtype)), [None] * n

    def _client_hint(self, epoch: int) -> np.ndarray:
        """The hint of one epoch (``[n, L]`` int32 on the host), through
        the client-side cache."""
        with self._hint_lock:
            if epoch not in self._hint_cache:
                self.hint_fetches += 1
                self._hint_cache[epoch] = self.db.hint(
                    self.protocol.name, epoch=epoch).cpu().numpy()
                for e in sorted(self._hint_cache)[:-2]:
                    del self._hint_cache[e]
            return self._hint_cache[epoch]

    def _make_scheduler(self, max_wait_s: float, n_clusters: int
                        ) -> QueryScheduler:
        server, proto, db, cfg = (self.servers[0], self.protocol, self.db,
                                  self.cfg)
        db.register_hint(proto.name, proto.hint_builder(cfg),
                         proto.hint_delta(cfg))

        def collate(items):
            # items: ((ct,), state) per query -> one [Q, N] batch and the
            # states beside it (host only, never staged)
            return (lwe.stack_ciphertexts([it[0][0] for it in items]),
                    [it[1] for it in items])

        def stage(payload):
            if self.remote:                 # the grid stages it
                return payload
            keys, states = payload
            return server.stage_keys(_padded(server, keys)), states

        def dispatch(staged):
            keys, states = staged
            if self.remote:                 # the grid answers: finalize reads
                return None, db.epoch, states
            epoch, views = db.snapshot((proto.db_view,))
            (ans,) = self._serve_step(
                (server.bucketed.answer(views[proto.db_view], keys),))
            return ans, epoch, states

        def finalize(raw, n):
            ans, epoch, states = raw
            if ans is None:
                (ans,) = self._serve_step(
                    (self.scheduler.channel.answer(epoch)[0],))
            rec = proto.reconstruct_with([ans[:n]], states[:n], cfg=cfg,
                                         hint=self._client_hint(epoch))
            return list(rec)

        return self._scheduler(collate=collate, stage=stage,
                               dispatch=dispatch, finalize=finalize,
                               n_clusters=n_clusters, max_wait_s=max_wait_s)

    def submit(self, index: int, *,
               deadline_s: Optional[float] = None) -> AnswerFuture:
        """Private retrieval of ``db[index]``; resolves to one record
        (``[L]`` uint8). The secret stays with the client: only the
        ciphertext reaches the device path."""
        self._controller_only("submit", always=True)
        fut = self._deadline_future(deadline_s)
        with self._lock:         # client-side keygen shares one rng
            keys, state = self.protocol.query_gen_full(
                self.rng, index, self.cfg, device=self.db.device)
        return self.scheduler.submit((keys, state), future=fut)

    def _query_items(self, indices: List[int]) -> List[Any]:
        """``((ct,), state)`` per query, the whole call encrypted in one
        batch on the database's device (on a mesh outside a session, on the
        controller, then broadcast: the states as objects, the ciphertexts
        as one int32 tensor)."""
        first = self._local() or self.mesh.is_controller
        (ct,), states = (self.protocol.query_gen_batch_full(
            self.rng, indices, self.cfg, device=self.db.device)
            if first else ((None,), None))
        if not self._local():
            states = self._drawn(lambda: states)
            spec = self.protocol.key_specs(self.cfg, len(indices))
            buf = ct.ct if first else torch.empty(
                spec.ct.shape, dtype=spec.ct.dtype, device=self.db.device)
            ct = spec.map(lambda _: broadcast_from(
                buf, self.mesh.controller, self.mesh.all_group))
        return [((ct.map(lambda x, i=i: x[i]),), states[i])
                for i in range(len(indices))]


class TwoServerPIR(MultiServerPIR):
    """The two-party deployment (a ``MultiServerPIR`` whose protocol has
    exactly two parties: ``xor-dpf-2`` or ``additive-dpf-2``)."""

    def __init__(self, db_words, cfg: PIRConfig, *,
                 protocol: Optional[PIRProtocol] = None, **kwargs):
        proto = (protocol if protocol is not None
                 else protocol_mod.for_config(cfg))
        k = proto.n_parties(cfg)
        if k != 2:
            raise ValueError(
                f"TwoServerPIR requires a 2-party protocol; {proto.name!r} "
                f"has {k} parties — use MultiServerPIR")
        super().__init__(db_words, cfg, protocol=proto, **kwargs)
