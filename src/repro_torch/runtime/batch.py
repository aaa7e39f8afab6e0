"""``BatchPIR``: the cuckoo-bucketed multi-query session (port of
``repro/runtime/batch.py``).

The client's cuckoo plan (``core/batch.py``) meets the bucketed database
(``db/bucketed.py``) through the same :class:`QueryScheduler` every other
deployment uses: one scheduler item is one :class:`RoundPlan` (a whole
m-record batch), and one dispatch sends its B per-bucket queries to all k
parties. A round scans B · capacity (about 2 · n_hashes · N) rows for m
records, against N rows per record for single queries.

Privacy: every round issues exactly one real-or-dummy query per bucket,
and dummies run the same keygen as real queries, so the servers see B keys
per party per round whatever the m indices were.

On the device: one :class:`BucketedServeFns` per party serves every bucket
view (all buckets have one shape, so one plan per rounds-bucket). A party's
keys for all B buckets travel as one batch (one upload), its B buckets'
leaves are expanded together (``BucketedServeFns.answer_views``; the
reference answers bucket by bucket) and each bucket is scanned on its own,
and the B answers are stacked on the device, so that finalize pays one
device-to-host copy per party.

On a mesh (``mesh=``, SPMD as ``MultiServerPIR``'s): the buckets are
sharded over the ``model`` axis (``BucketedDatabase(mesh=)``), each rank
answers its block of every bucket and each party's dispatch makes one
cross-shard reduce for all B buckets. A round is planned on the mesh's
first rank and broadcast, a ``CuckooFailure`` included, so every rank
takes the same halving in ``query_batch``. Still refused there, as the
one-controller half of ROADMAP's A6b-serve-2: a session (``start`` /
``submit``) and ``n_clusters`` lanes.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core import dpf
from repro_torch.core import protocol as protocol_mod
from repro_torch.core.batch import (CuckooFailure, RoundPlan, plan_round,
                                    reassemble)
from repro_torch.core.protocol import PIRProtocol
from repro_torch.core.server import BucketedServeFns
from repro_torch.crypto.packing import records_to_host
from repro_torch.db import BucketedDatabase
from repro_torch.engine.backend import Device, backend_of
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime.serve_loop import (DEFAULT_MAX_WAIT_S, MESH_REFUSED,
                                            AnswerFuture, MultiServerPIR,
                                            QueryScheduler)


class BatchPIR(MultiServerPIR):
    """k-party batch deployment: m records per round over B cuckoo buckets.

    The :class:`MultiServerPIR` facade (``query`` / ``submit`` /
    ``update`` / ``publish`` / the session) plus the batch plane:

      query_batch(indices)    synchronous retrieval of any number of
                              records, in rounds of at most m; splits and
                              retries a batch whose cuckoo placement fails
      submit_batch(indices)   one round -> one AnswerFuture resolving to
                              ``[len(indices), ...]`` records in request
                              order, tagged with the outer epoch

    ``db_words`` is the host array or a built :class:`BucketedDatabase`.
    ``rounds`` is the scheduler's bucket ladder in rounds per dispatch.
    ``n_clusters`` is its lane count (``cluster0``, ...), round-robin with
    straggler shedding as for every facade; the lanes are logical, on one
    device and one stream, and each dispatch reads its own snapshot.
    ``path=None`` resolves each bucket's plan through the engine at the
    bucket shape (``inner_cfg``). ``mesh`` shards the buckets over its
    ranks (module docstring; a prebuilt database must be placed on it) and
    ``collective`` is the XOR schemes' reduce over the shard axis.
    """

    def __init__(self, db_words, cfg: PIRConfig, *, device: Device = None,
                 path: Optional[str] = None, rounds: Sequence[int] = (1,),
                 max_wait_s: float = DEFAULT_MAX_WAIT_S,
                 n_clusters: int = 1,
                 protocol: Optional[PIRProtocol] = None,
                 client_rng: Optional[np.random.Generator] = None,
                 default_deadline_s: Optional[float] = None,
                 mesh: Optional[Mesh] = None, collective: str = "gather"):
        if cfg.batch_m < 1:
            raise ValueError(
                f"BatchPIR needs cfg.batch_m >= 1 (got {cfg.batch_m}); "
                f"use MultiServerPIR for single-query serving")
        self.cfg = cfg
        self.mesh = mesh
        self.spmd = mesh is not None and mesh.size > 1
        if self.spmd and n_clusters != 1:
            raise ValueError(MESH_REFUSED.format("n_clusters lanes"))
        self.protocol = (protocol if protocol is not None
                         else protocol_mod.for_config(cfg))
        if self.protocol.needs_hint:
            raise ValueError(
                f"protocol {self.protocol.name!r} needs hint plumbing; "
                f"the batch composite serves the k-party protocols "
                f"(xor-dpf-2, xor-dpf-k, additive-dpf-2)")
        self.n_parties = self.protocol.n_parties(cfg)
        self.db = (db_words if isinstance(db_words, BucketedDatabase)
                   else BucketedDatabase(db_words, cfg, device, mesh=mesh))
        if self.db.mesh != mesh:
            raise ValueError("the bucketed database was placed on a "
                             "different mesh than the serve steps run on")
        self.layout = self.db.layout
        #: the bucket shape the inner protocol keygens and serves against
        self.inner_cfg = self.db.inner_cfg
        dev = self.db.device
        self.serve = [
            BucketedServeFns(self.inner_cfg, buckets=rounds,
                             backend=backend_of(dev), path=path,
                             protocol=self.protocol, device=dev, mesh=mesh,
                             collective=collective)
            for _ in range(self.n_parties)]
        self.rng = (client_rng if client_rng is not None
                    else np.random.default_rng())
        self._lock = threading.Lock()
        self.default_deadline_s = (default_deadline_s
                                   if default_deadline_s is not None
                                   else 120.0 * self.n_parties)
        #: per dispatch: (rounds, per-bucket queries issued per round); the
        #: second is always ``db.n_buckets`` whatever the indices were
        self.dispatch_log: List[Tuple[int, int]] = []
        self.scheduler = self._make_scheduler(max_wait_s, n_clusters)

    def _make_scheduler(self, max_wait_s: float, n_clusters: int
                        ) -> QueryScheduler:
        serve, proto, db = self.serve, self.protocol, self.db
        parties = range(self.n_parties)
        inner_cfg = self.inner_cfg
        n_buckets = db.n_buckets
        log = self.dispatch_log
        dev = db.device

        def collate(plans: List[RoundPlan]):
            # per party, one key batch for the whole dispatch, bucket-major:
            # bucket b's rounds are queries [b*R, (b+1)*R); the plans ride
            # along for finalize's reassembly
            keys = tuple(
                dpf.stack_keys([plan.keys[b][p] for b in range(n_buckets)
                                for plan in plans])
                for p in parties)
            return list(plans), keys

        def stage(payload):
            plans, keys = payload
            return plans, tuple(serve[p].stage(keys[p], dev) for p in parties)

        def dispatch(staged):
            plans, keys = staged
            # all B bucket views and the outer epoch read together
            epoch, views = db.snapshot((proto.db_view,))
            bviews = views[proto.db_view]
            answers = tuple(serve[p].answer_views(bviews, keys[p])
                            for p in parties)                # [B, R, cols]
            log.append((len(plans), n_buckets))
            return plans, answers, epoch

        def finalize(raw, n):
            plans, answers, _ = raw
            host = [a.cpu() for a in answers]       # one copy per party
            out = []
            for r in range(n):
                # with checksums every bucket's record is verified, dummy
                # buckets' included (their pad rows carry valid checksums)
                recs = records_to_host(proto.reconstruct_with(
                    [h[:, r] for h in host], [None] * n_buckets,
                    cfg=inner_cfg))
                out.append(reassemble(plans[r], recs))
            return out

        return QueryScheduler(
            collate=collate, stage=stage, dispatch=dispatch,
            finalize=finalize, buckets=serve[0].buckets,
            n_clusters=n_clusters, max_wait_s=max_wait_s,
            epoch_of=lambda raw: raw[2])

    # -- client API -------------------------------------------------------

    def submit_batch(self, indices: Sequence[int], *,
                     deadline_s: Optional[float] = None) -> AnswerFuture:
        """Retrieve up to m records in one round; resolves to
        ``[len(indices), ...]`` records in request order (a duplicate
        shares one bucket query). Raises :class:`CuckooFailure` before
        anything is enqueued when the indices cannot be placed
        (probability O(1/B)); :meth:`query_batch` splits and retries."""
        request = [int(i) for i in indices]
        if not request:
            raise ValueError("submit_batch needs at least one index")
        if any(i < 0 or i >= self.cfg.n_items for i in request):
            raise ValueError(
                f"indices out of range [0, {self.cfg.n_items})")
        if len(set(request)) > self.layout.params.m:
            raise ValueError(
                f"batch of {len(set(request))} unique indices exceeds "
                f"m={self.layout.params.m}")
        fut = self._deadline_future(deadline_s)

        def draw():
            try:
                return plan_round(self.rng, request, self.layout,
                                  self.inner_cfg, self.protocol)
            except CuckooFailure as e:      # raised alike on every rank
                return e

        with self._lock:    # keygen and the cuckoo walk share one rng
            plan = self._drawn(draw)
        if isinstance(plan, CuckooFailure):
            raise plan
        return self.scheduler.submit(plan, future=fut)

    def query_batch(self, indices: Sequence[int]) -> np.ndarray:
        """``db[indices]`` for any number of indices: rounds of at most m
        unique indices, a batch that fails cuckoo placement halved and
        retried (one index always places), records in request order."""
        request = [int(i) for i in indices]
        if not request:
            tail, dtype = self.protocol.record_struct(self.cfg)
            return np.empty((0,) + tail, dtype)
        unique = list(dict.fromkeys(request))
        m = self.layout.params.m
        groups = [unique[i:i + m] for i in range(0, len(unique), m)]
        futs: List[Tuple[List[int], AnswerFuture]] = []
        while groups:
            g = groups.pop(0)
            try:
                futs.append((g, self.submit_batch(g)))
            except CuckooFailure:
                groups.insert(0, g[len(g) // 2:])
                groups.insert(0, g[:len(g) // 2])
        if not self.scheduler.running:
            self.scheduler.pump()
        rec_of = {}
        for g, f in futs:
            for i, rec in zip(g, f.result()):
                rec_of[i] = rec
        return np.stack([rec_of[i] for i in request])

    def query(self, indices: Sequence[int]) -> np.ndarray:
        """:meth:`query_batch`: every retrieval goes through the buckets."""
        return self.query_batch(indices)

    def submit(self, index: int, *,
               deadline_s: Optional[float] = None) -> AnswerFuture:
        """One index as a round of one real and B - 1 dummy queries (the
        servers see the same B-wide round as for a full batch)."""
        if self.spmd:
            raise ValueError(MESH_REFUSED.format("submit"))
        inner = self.submit_batch([index], deadline_s=deadline_s)
        fut = AnswerFuture(deadline=inner.deadline)

        def _unwrap(done: AnswerFuture):
            exc = done.exception()
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.epoch = done.epoch
                fut.set_result(done.result(timeout=0)[0])

        inner.add_done_callback(_unwrap)
        return fut
