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

On a mesh of more than one rank (``mesh=``, ``launch/mesh.py``) the
database is sharded over the mesh and each party's ``PIRServer`` answers
through the sharded step (``core/server.py``). The facades keep this
contract there:

* SPMD construction and lifecycle: every rank builds the facade and calls
  ``start()`` and ``close()``. Outside a session ``query``, ``update``
  and ``publish`` are SPMD too: every rank calls them with the same
  arguments, the keys of a call are drawn on the controller and broadcast
  (a client rng that differs between ranks cannot split them), and every
  rank returns the records. ``SingleServerPIR`` encrypts there (A.s needs
  the whole of A, which only the controller draws) and broadcasts the
  ciphertexts and the client's secrets; its hint is built per row block
  and summed over the shard axis (``db/sharded.py``).
* One controller, ``mesh.controller`` (the grid's first rank). Its
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
* Commands (``launch/mesh.send_command``, over ``mesh.all_group``, each a
  header of integers and then tensors as they are, never pickled):
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

Still refused on a mesh (ROADMAP's A6b-serve-2, what is left): replicas
spanning cards (``replica/``), ``elastic`` returning meshes and
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
from repro_torch.core.server import PIRServer, bucket_for
from repro_torch.crypto.packing import records_to_host
from repro_torch.db import Database
from repro_torch.engine.backend import Device
from repro_torch.launch.mesh import (Mesh, broadcast_from, recv_command,
                                     recv_tensor, send_command)
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
            self._fail_outstanding(inflight, e)
            if channel is not None and not channel.busy:
                channel.abort()

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
    death path sends no ``ABORT`` then. ``sent`` counts the commands and
    ``seconds`` is the host time spent sending them, by command."""

    def __init__(self, mesh: Mesh, wire: Callable[[Any], Tuple[Sequence[int],
                                                            Sequence[Any]]]):
        self.mesh = mesh
        self.wire = wire
        self.busy = False
        self.sent: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self._pending: list = []      # the last ABORT's unwaited sends

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
        self._send("DISPATCH", *self.wire(payload))

    def publish(self, rows: np.ndarray, vals: np.ndarray):
        """The staged log: ``[R]`` int64 rows, ``[R, W]`` u32 values (sent
        as their int32 bits)."""
        self._send("PUBLISH", (len(rows), vals.shape[1]), (
            torch.from_numpy(np.ascontiguousarray(rows, np.int64)),
            torch.from_numpy(np.ascontiguousarray(vals).view(np.int32))))

    def done(self):
        self.busy = False

    def stop(self):
        self._send("STOP")
        self.busy = False

    def abort(self):
        self._pending = self._send("ABORT", wait=False)
        self.busy = False


class FollowerLoop:
    """A follower rank's part of a session on a mesh (module docstring).

    A thread takes the controller's commands until ``STOP`` or ``ABORT``:
    ``DISPATCH`` is turned back into a batch payload by
    ``unwire(fields, recv)`` (``recv(shape, dtype)`` reads the command's
    next tensor), staged and dispatched with the facade's own closures,
    keeping at most ``depth`` dispatches in flight, its answers dropped;
    ``PUBLISH`` calls ``publish(rows, values)``. A failure ends the loop at
    once and sends nothing: the controller's next collective then fails.
    ``dispatches`` and ``publishes`` count what it ran, ``ended_by`` is the
    command that ended it (None after a failure, which is ``exc``) and
    ``t_end`` its ``time.monotonic()`` end."""

    def __init__(self, mesh: Mesh, *, unwire: Callable, stage: Callable,
                 dispatch: Callable, publish: Callable,
                 depth: int = PIPELINE_DEPTH):
        self.mesh = mesh
        self._unwire = unwire
        self._stage = stage
        self._dispatch = dispatch
        self._publish = publish
        self.depth = max(depth, 1)
        self.dispatches = 0
        self.publishes = 0
        self.ended_by: Optional[str] = None
        self.exc: Optional[BaseException] = None
        self.t_end: Optional[float] = None
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

    def _run(self):
        inflight: deque = deque()
        try:
            while True:
                command, fields = recv_command(self.mesh)
                if command == "DISPATCH":
                    staged = self._stage(self._unwire(fields, self._recv))
                    while len(inflight) >= self.depth:
                        inflight.popleft().wait()
                    self._dispatch(staged)
                    inflight.append(_Ready(self.mesh.device))
                    self.dispatches += 1
                elif command == "PUBLISH":
                    n, w = fields[:2]
                    rows = self._recv((n,), torch.int64).cpu().numpy()
                    vals = self._recv((n, w), torch.int32).cpu().numpy()
                    self._publish(rows, vals.view(np.uint32))
                    self.publishes += 1
                else:
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
        self.spmd = mesh is not None and mesh.size > 1
        self._session = False              # between start() and close()
        self._update_lock = threading.Lock()
        self.follower: Optional[FollowerLoop] = None
        self.scheduler.spmd = self.spmd
        if self.spmd and mesh.is_controller:
            self.scheduler.channel = _Channel(mesh, self._wire)

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
        queries submitted for a session must not ride along."""
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
        """The controller's publish, on its session thread: the staged log
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
            return tuple(servers[p].stage_keys(_padded(servers[p], payload[p]))
                         for p in parties)

        def dispatch(staged):
            epoch, views = db.snapshot((proto.db_view,))
            view = views[proto.db_view]
            return self._serve_step(tuple(
                servers[p].bucketed.answer(view, staged[p])
                for p in parties)), epoch

        cfg = self.cfg

        def finalize(raw, n):
            answers, _ = raw
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
        it: the controller runs the session thread, a follower its loop."""
        self._session = True
        if not self.spmd or self.mesh.is_controller:
            self.scheduler.start()
        elif self.follower is None or not self.follower.running:
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

    def start(self):
        """Open a session; on a mesh every rank first builds the current
        epoch's hint (a collective), which the publishes' deltas then keep
        up to date on every rank."""
        if self.spmd:
            self.db.hint(self.protocol.name)
        super().start()

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
            keys, states = payload
            return server.stage_keys(_padded(server, keys)), states

        def dispatch(staged):
            keys, states = staged
            epoch, views = db.snapshot((proto.db_view,))
            (ans,) = self._serve_step(
                (server.bucketed.answer(views[proto.db_view], keys),))
            return ans, epoch, states

        def finalize(raw, n):
            ans, epoch, states = raw
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
