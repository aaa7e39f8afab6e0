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
facades run SPMD: every rank builds the facade and calls ``query``,
``update`` and ``publish`` with the same arguments. The database is
sharded over the mesh and each party's ``PIRServer`` answers through the
sharded step (``core/server.py``); the keys of a call are drawn on the
mesh's first rank and broadcast, so a client rng that differs between
ranks cannot split them, and every rank returns the records.
``SingleServerPIR`` serves the same way: rank 0 encrypts (A.s needs the
whole of A, which only that rank draws) and broadcasts the ciphertexts and
the client's secrets, the hint is built per row block and summed over the
shard axis (``db/sharded.py``), and every rank decodes. What needs one
controller is refused with a ``ValueError``: a session (``start`` /
``submit``), ``n_clusters`` lanes and ``chaos`` (the one-controller half of
ROADMAP's A6b-serve-2).
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
from repro_torch.launch.mesh import Mesh, broadcast_from
from repro_torch.runtime.fault import StragglerMonitor

#: dispatch depth: one batch running on the card, one being staged
PIPELINE_DEPTH = 2

#: what a facade on a mesh of more than one rank refuses
MESH_REFUSED = ("{} on a mesh of more than one rank is not ported: it needs "
                "one controller (ROADMAP A6b-serve-2)")

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

    # -- intake ----------------------------------------------------------

    def submit(self, item: Any, *, future: Optional[AnswerFuture] = None
               ) -> AnswerFuture:
        """Enqueue one query payload; returns its future (``future``, when
        given: a caller's deadline, or a handed-off query moving with its
        future). Raises ``RuntimeError`` once a session was stopped, died
        or was killed."""
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
        victims: List[AnswerFuture] = []
        with self._cv:
            self._closed = True
            self._stopping = True
            self._abort_exc = exc
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

    def _launch(self, batch: _Batch) -> Tuple[_Batch, Any, float]:
        """Collate + stage + dispatch one batch; the card runs it async. A
        failure fails the batch's futures before it propagates: the batch
        has left the lanes already."""
        try:
            if self.chaos is not None:
                self.chaos.visit("scheduler.dispatch", self.chaos_target)
            staged = self._stage(self._collate(batch.items))
            t0 = self.clock()
            raw = self._dispatch(staged)
            if self._epoch_of is not None:
                batch.epoch = self._epoch_of(raw)
        except BaseException as e:
            for fut in batch.futures:
                fut.set_exception(e)
            raise
        with self._cv:
            self._n_inflight += len(batch.items)
        return batch, raw, t0

    def _complete(self, batch: _Batch, raw: Any, t0: float):
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
                    self._complete(*inflight.popleft())
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

    def _run(self):
        inflight: deque = deque()
        try:
            while True:
                batch = None
                if self.heartbeat is not None:
                    self.heartbeat()
                with self._cv:
                    if self._abort_exc is not None:   # kill(): no draining
                        raise self._abort_exc
                    self._cut_ripe_locked()
                    if self._stopping:
                        while self._pending:
                            self._cut_locked(
                                min(len(self._pending), self.buckets[-1]))
                    if len(inflight) < self.depth:
                        batch = self._pop_batch_locked()
                    if batch is None and not inflight:
                        if self._stopping:
                            return
                        wait = None
                        if self._pending:
                            age = self.clock() - self._pending[0][2]
                            wait = max(self.max_wait_s - age, 0.0)
                        self._cv.wait(timeout=wait)
                        continue
                if batch is not None:
                    inflight.append(self._launch(batch))
                    continue          # keep the pipeline full before waiting
                self._complete(*inflight.popleft())
        except BaseException as e:
            self._fail_outstanding(inflight, e)

    def _fail_outstanding(self, inflight: deque, exc: BaseException):
        """A dead session resolves every outstanding future with ``exc``
        and rejects later submits."""
        victims: List[AnswerFuture] = []
        with self._cv:
            self._closed = True
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
    complete."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))

    def wait(self):
        if self._event is not None:
            self._event.synchronize()


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
    and makes the facade SPMD (module docstring); ``collective`` is the
    XOR schemes' reduce over the shard axis.
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
        self.spmd = mesh is not None and mesh.size > 1
        if self.spmd and n_clusters != 1:
            raise ValueError(MESH_REFUSED.format("n_clusters lanes"))
        if self.spmd and chaos is not None:
            raise ValueError(MESH_REFUSED.format("chaos"))
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

    def _scheduler(self, **kwargs) -> QueryScheduler:
        """The facade's scheduler over its closures, with its buckets."""
        return QueryScheduler(buckets=self.servers[0].buckets,
                              epoch_of=lambda raw: raw[1], **kwargs)

    def _serve_step(self, answers: tuple) -> tuple:
        """The ``replica.serve_step`` seam: the scheduler's injector, read
        on every dispatch, may flip bits in one of the batch's answer
        shares."""
        chaos = self.scheduler.chaos
        if chaos is None:
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
        if self.spmd:
            raise ValueError(MESH_REFUSED.format("a session"))
        self.scheduler.start()

    def close(self):
        self.scheduler.stop()

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
        if self.spmd:
            raise ValueError(MESH_REFUSED.format("submit"))
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
        return self.db.stage(rows, values)

    def publish(self) -> int:
        """Swap the staged writes in as the next epoch and return it.
        Batches already dispatched finish on the previous epoch and stay
        tagged with it; later batches read the new one."""
        return self.db.publish()

    # -- synchronous batch API ------------------------------------------

    def query(self, indices: Sequence[int]) -> np.ndarray:
        """Private retrieval of ``db[indices]``: ``[Q, W]`` uint32 records,
        or ``[Q, L]`` uint8 for the byte schemes."""
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
        """``draw()`` once for the deployment: on a mesh, on its first rank,
        then broadcast to every rank (as host tensors), so that every rank
        answers the same keys whatever its own rng holds."""
        if not self.spmd:
            return draw()
        src = self.mesh.ranks[0]
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

    On a mesh (SPMD, module docstring) the client is the mesh's first
    rank: it encrypts a call's queries there and broadcasts the whole
    ``[Q, N]`` ciphertexts (each rank's answer reads its block's columns)
    and the secrets; the hint, built per row block and summed, is the same
    on every rank, so every rank decodes the records. The first query of
    an epoch builds the hint in finalize, a collective every rank reaches
    at the same batch.
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
        if self.spmd:
            raise ValueError(MESH_REFUSED.format("submit"))
        fut = self._deadline_future(deadline_s)
        with self._lock:         # client-side keygen shares one rng
            keys, state = self.protocol.query_gen_full(
                self.rng, index, self.cfg, device=self.db.device)
        return self.scheduler.submit((keys, state), future=fut)

    def _query_items(self, indices: List[int]) -> List[Any]:
        """``((ct,), state)`` per query, the whole call encrypted in one
        batch on the database's device (on a mesh, on its first rank, then
        broadcast: the states as objects, the ciphertexts as one int32
        tensor)."""
        first = not self.spmd or self.mesh.rank == self.mesh.ranks[0]
        (ct,), states = (self.protocol.query_gen_batch_full(
            self.rng, indices, self.cfg, device=self.db.device)
            if first else ((None,), None))
        if self.spmd:
            states = self._drawn(lambda: states)
            spec = self.protocol.key_specs(self.cfg, len(indices))
            buf = ct.ct if first else torch.empty(
                spec.ct.shape, dtype=spec.ct.dtype, device=self.db.device)
            ct = spec.map(lambda _: broadcast_from(
                buf, self.mesh.ranks[0], self.mesh.all_group))
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
