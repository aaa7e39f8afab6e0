"""PIR server of one party (port of ``repro/core/server.py``).

The reference shards the DB over a TPU mesh and compiles one ``shard_map``
serve step per batch bucket. PyTorch runs eagerly, so a bucket's "step"
is its resolved plan applied through the protocol's ``answer_local``.
Ragged batches pad up to the smallest covering bucket, and batches past
the largest bucket are chunked, exactly as upstream.

Without a mesh (or on a ``(1, 1)`` one) the whole DB is one shard
(``start_block = 0``) and there is no collective. On a mesh the port is
SPMD where the reference is single-controller: every rank calls
``answer`` with the same keys, and rank ``(c, d)`` of the
``(cluster, model)`` grid runs the per-shard step of the reference's
``shard_map`` (``server.py:180-201``) itself:

  1. it takes cluster ``c``'s queries ``[c*Q/C, (c+1)*Q/C)`` of the padded
     batch (the clusters answer disjoint queries);
  2. it answers them against its own row block,
     ``answer_local(block, keys_c, start_block=d, log_local)``;
  3. ``protocol.reduce`` combines the partials over the ``model`` group,
     in the protocol's share algebra (the paper's MASTERXOR step);
  4. the clusters' results are gathered over the cluster axes, so that
     every rank returns the whole ``[Q, cols]``, as the reference's global
     output holds it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core import dpf
from repro_torch.core import protocol as protocol_mod
from repro_torch.core.lwe import LWECiphertext
from repro_torch.core.protocol import ExecutionPlan, PIRProtocol
from repro_torch.db import Database, DatabaseSpec
from repro_torch.engine.backend import Device, backend_of
from repro_torch.launch.mesh import (Mesh, cluster_index, mesh_axis_size,
                                     n_clusters, pir_cluster_axes,
                                     pir_shard_axis, single_mesh)


Keys = Union[dpf.DPFKey, LWECiphertext]

#: leaves expanded together by ``BucketedServeFns.answer_views``: one
#: PIR_1G query's worth, which bounds the plain expansion's temporaries
EXPAND_LEAVES = 1 << 25


def map_keys(keys: Keys, fn) -> Keys:
    """Apply ``fn`` to every tensor of a key batch (DPF keys or LWE
    ciphertexts)."""
    if isinstance(keys, LWECiphertext):
        return keys.map(fn)
    return dpf.map_keys(keys, fn)


def key_specs(cfg: PIRConfig, n_queries: int, *, party: int = 0,
              protocol: Optional[PIRProtocol] = None) -> Keys:
    """Meta-tensor stand-ins for a batch of ``party``'s keys: the config's
    protocol's ``key_specs`` (``server.py:66`` upstream)."""
    proto = protocol if protocol is not None else protocol_mod.for_config(cfg)
    return proto.key_specs(cfg, n_queries, party=party)


def bucket_for(buckets: Sequence[int], n: int) -> int:
    """The padding rule: smallest bucket >= n, else the largest (the
    caller then chunks). ``buckets`` must be sorted ascending."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def default_buckets(n_clusters: int = 1, max_bucket: int = 32
                    ) -> Tuple[int, ...]:
    """Power-of-two batch buckets from ``n_clusters`` up to ``max_bucket``."""
    n_clusters = max(n_clusters, 1)
    b, out = n_clusters, []
    while b <= max(max_bucket, n_clusters):
        out.append(b)
        b *= 2
    return tuple(out)


class BucketedServeFns:
    """Per-bucket plans of one party, and the padded answer dispatch.

    ``path=None`` resolves each bucket's plan through the engine for the
    device served on: its tuned plan on a plan-cache hit, else ``plan_for``
    for the backend, so small and large buckets may take different kernel
    paths; plans are resolved once per bucket and cached.

    ``n_compiles`` counts the per-bucket serve steps built, the analogue
    of the reference's jit-cache misses: a bucket's step is built at its
    first dispatch (its plan resolved and bound), or by ``PIRServer`` for
    its ``n_queries`` bucket at construction as upstream, and reused by
    every later batch of that bucket and across publishes. On the card
    this compiles nothing per bucket: the kernels' libraries are built
    once per process (``kernels/build.py``), so the count is of steps
    bound, not of nvcc runs. Resolving a plan alone (``plan_for_bucket``,
    ``plan_report``) builds no step.
    """

    def __init__(self, cfg: PIRConfig, *, buckets: Sequence[int],
                 backend: str, path: Optional[str] = None,
                 protocol: Optional[PIRProtocol] = None, chunk_log: int = 12,
                 device: Device = None, mesh: Optional[Mesh] = None,
                 collective: str = "gather"):
        if not buckets:
            raise ValueError("need at least one bucket")
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.path = path
        self.chunk_log = chunk_log
        self.collective = collective
        self.protocol = (protocol if protocol is not None
                         else protocol_mod.for_config(cfg))
        self.mesh = mesh
        #: more than one rank: answers run the sharded step
        self.sharded = mesh is not None and mesh.size > 1
        self.shard_axis = pir_shard_axis(mesh) if mesh else None
        self.n_shards = mesh_axis_size(mesh, self.shard_axis) if mesh else 1
        self.n_clusters = n_clusters(mesh) if mesh else 1
        for b in buckets:
            if b % self.n_clusters:
                raise ValueError(
                    f"bucket {b} not divisible by {self.n_clusters} clusters")
        #: this rank's DB shard (its leaf block) and cluster (its queries);
        #: a controller outside the grid resolves plans and answers nothing
        inside = mesh is not None and mesh.contains_rank
        self.shard_index = mesh.coord(self.shard_axis) if inside else 0
        self.cluster = cluster_index(mesh) if inside else 0
        self.log_local = int(math.log2(
            DatabaseSpec.from_config(cfg).rows_per_shard(self.n_shards)))
        self.buckets = tuple(sorted(set(buckets)))
        self._plans: Dict[int, ExecutionPlan] = {}
        self._steps: set = set()       # buckets whose step was built

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def plan_for_bucket(self, bucket: int) -> ExecutionPlan:
        if bucket not in self._plans:
            self._plans[bucket] = protocol_mod.resolve_plan(
                self.path, self.cfg, bucket, backend=self.backend,
                chunk_log=self.chunk_log, device=self.device,
                collective=self.collective)
        return self._plans[bucket]

    @property
    def n_compiles(self) -> int:
        return len(self._steps)

    def plan_report(self) -> Dict[int, dict]:
        """``{bucket: engine.plan_report row}`` for every bucket: the plan,
        its provenance and the modeled bytes of one rank's contraction (its
        cluster's ``bucket / C`` queries against its shard), resolved
        without building a step (``server.py:300`` upstream)."""
        from repro_torch import engine
        return {b: engine.plan_report(self.cfg, self.plan_for_bucket(b),
                                      b // self.n_clusters,
                                      n_shards=self.n_shards,
                                      backend=self.backend)
                for b in self.buckets}

    def step_for(self, bucket: int) -> ExecutionPlan:
        """The plan a batch of ``bucket`` is answered with, building the
        bucket's step at its first dispatch (counted in ``n_compiles``)."""
        self._steps.add(bucket)
        return self.plan_for_bucket(bucket)

    def stage(self, keys: Keys, device: torch.device) -> Keys:
        """Copy a batch to ``device`` ahead of dispatch (``answer`` pads);
        host keys go through pinned memory, keys already on the card (LWE
        ciphertexts, encrypted there) stay where they are."""
        if device.type == "cuda":
            pinned = map_keys(keys, lambda x: x if x.is_cuda
                              else x.contiguous().pin_memory())
            return pinned.to(device, non_blocking=True)
        return keys.to(device)

    def answer(self, db: Union[torch.Tensor, Database], keys: Keys
               ) -> torch.Tensor:
        """Answer a batch of any size: exactly ``[Q, cols]`` shares (async
        on the card)."""
        if isinstance(db, Database):
            db = db.view(self.protocol.db_view)
        keys = keys.to(db.device)               # no copy once staged
        q = self.protocol.n_queries(keys)
        max_b = self.buckets[-1]
        if q <= max_b:
            return self._answer_one(db, keys)
        parts = [self._answer_one(
                     db, map_keys(keys, lambda x: x[lo:lo + max_b]))
                 for lo in range(0, q, max_b)]
        return torch.cat(parts, dim=0)

    def answer_views(self, views: Sequence[torch.Tensor], keys: Keys
                     ) -> torch.Tensor:
        """Answer a batch spread over same-shape views (the batch plane's
        buckets): queries ``[b*R, (b+1)*R)`` of ``keys`` against
        ``views[b]``, as ``[B, R, cols]`` (async on the card). Each view's
        queries are padded to the bucket of R, as :meth:`answer` pads.

        Under a ``materialize`` plan the views' queries share the leaf
        expansion (``expand_local``), one pass per ``EXPAND_LEAVES``
        leaves instead of one per view; the scan (``scan_local``) runs per
        view. Other plans answer view by view.

        On a mesh each view is this rank's row block of a bucket: the rank
        answers its cluster's queries of every view against its block
        (``start_block`` = its shard), then the stacked ``[B, R/C, cols]``
        partials take **one** protocol reduce over the shard axis and one
        gather over the clusters, whatever B is. In a session only the
        controller cuts batches; every rank answers each one it is sent
        (``runtime/serve_loop.py``).
        """
        n_views = len(views)
        q = self.protocol.n_queries(keys)
        if q % n_views:
            raise ValueError(f"{q} queries do not split over {n_views} views")
        r = q // n_views
        dev = views[0].device
        max_b = self.buckets[-1]
        if r > max_b:                    # past the largest bucket: chunks
            return torch.cat([self.answer_views(views, map_keys(
                keys, lambda x, lo=lo: x.reshape(n_views, r, *x.shape[1:])[
                    :, lo:lo + max_b].flatten(0, 1)))
                for lo in range(0, r, max_b)], dim=1)
        bucket = self.bucket_for(r)
        plan = self.step_for(bucket)
        # this rank's cluster's slots of each view's padded queries, one
        # gather for all views (a pad slot repeats its view's last query)
        per = bucket // self.n_clusters
        slot = torch.arange(self.cluster * per, (self.cluster + 1) * per)
        idx = (torch.arange(n_views)[:, None] * r
               + slot.clamp(max=r - 1)[None, :]).flatten()
        keys = map_keys(keys.to(dev), lambda x: x[idx.to(x.device)])
        part = lambda lo, hi: map_keys(keys, lambda x: x[lo * per:hi * per])
        if plan.expand != "materialize":
            out = [self.protocol.answer_local(v, part(b, b + 1),
                                              self.shard_index,
                                              self.log_local, plan)
                   for b, v in enumerate(views)]
        else:
            chunk = max(1, EXPAND_LEAVES // (per * views[0].shape[0]))
            out = []
            for lo in range(0, n_views, chunk):
                hi = min(lo + chunk, n_views)
                sel = self.protocol.expand_local(
                    part(lo, hi), self.shard_index, self.log_local, plan)
                out.extend(self.protocol.scan_local(
                    views[b], sel[(b - lo) * per:(b - lo + 1) * per], plan)
                    for b in range(lo, hi))
        return self.combine(torch.stack(out), plan)[:, :r]

    def local_answer(self, db: torch.Tensor, keys: Keys
                     ) -> Tuple[torch.Tensor, ExecutionPlan]:
        """Steps 1-2 of a batch of at most the largest bucket: its keys
        padded to the bucket, this rank's cluster's share of them answered
        against this rank's shard. Returns the partial shares and the
        bucket's plan (off a mesh: the answer)."""
        bucket = self.bucket_for(self.protocol.n_queries(keys))
        keys = self.protocol.pad(keys, bucket)
        plan = self.step_for(bucket)
        if self.n_clusters > 1:
            per = bucket // self.n_clusters
            lo = self.cluster * per
            keys = map_keys(keys, lambda x: x[lo:lo + per])
        return self.protocol.answer_local(db, keys, self.shard_index,
                                          self.log_local, plan), plan

    def combine(self, partial_res: torch.Tensor, plan: ExecutionPlan
                ) -> torch.Tensor:
        """Steps 3-4: the protocol's reduce over the shard axis, then the
        clusters' answers gathered (innermost cluster axis first, so the
        rows come in cluster order); the identity off a mesh. The partial
        is ``[Q/C, cols]``, or ``[B, Q/C, cols]`` for B views at once."""
        if not self.sharded:
            return partial_res
        out = partial_res
        if self.n_shards > 1:
            out = self.protocol.reduce(out, self.mesh.group(self.shard_axis),
                                       self.n_shards, plan)
        for axis in reversed(pir_cluster_axes(self.mesh)):
            if mesh_axis_size(self.mesh, axis) > 1:
                out = protocol_mod.all_gather_stack(
                    out, self.mesh.group(axis)).movedim(0, -3).flatten(-3,
                                                                       -2)
        return out

    def _answer_one(self, db: torch.Tensor, keys: Keys) -> torch.Tensor:
        q = self.protocol.n_queries(keys)
        return self.combine(*self.local_answer(db, keys))[:q]


def party_buckets(mesh: Mesh, n_queries: int,
                  buckets: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """A party's buckets: ``buckets`` (the doubling ladder from the mesh's
    cluster count by default) with ``n_queries`` among them."""
    if buckets is None:
        buckets = default_buckets(n_clusters(mesh),
                                  max_bucket=max(n_queries, 1))
    return tuple(sorted(set(buckets) | {n_queries}))


class PartyPlans:
    """One party's per-bucket plans on a session controller outside the
    grid of ranks that serves it (a fleet's replica, ``replica/``): what a
    :class:`PIRServer` resolves, without its database, which the grid's
    ranks hold and answer from."""

    def __init__(self, party: int, cfg: PIRConfig, mesh: Mesh, *,
                 n_queries: int = 32, path: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 protocol: Optional[PIRProtocol] = None,
                 collective: str = "gather"):
        self.party = party
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.bucketed = BucketedServeFns(
            cfg, buckets=party_buckets(mesh, n_queries, buckets),
            backend=backend_of(self.device), path=path, protocol=protocol,
            device=self.device, mesh=mesh, collective=collective)
        self.protocol = self.bucketed.protocol
        self.bucketed.plan_for_bucket(n_queries)

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.bucketed.buckets

    def plan_report(self) -> Dict[int, dict]:
        """``BucketedServeFns.plan_report`` of this party's buckets."""
        return self.bucketed.plan_report()


class PIRServer:
    """One logical PIR server (one of the non-colluding parties).

    References a :class:`Database` (shared across parties: its contents
    are public) and owns that party's per-bucket plans. ``db_words`` (a
    host array, placed into a private ``Database`` on ``device``, or on
    ``mesh``) is the legacy construction path; new code passes
    ``database=``, placed on the same ``mesh`` (``None``: one card).
    ``collective`` is the XOR schemes' reduce over the shard axis.
    """

    def __init__(self, party: int, db_words: Optional[np.ndarray] = None,
                 cfg: Optional[PIRConfig] = None, *,
                 database: Optional[Database] = None, device: Device = None,
                 mesh: Optional[Mesh] = None, n_queries: int = 32,
                 path: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 protocol: Optional[PIRProtocol] = None,
                 collective: str = "gather"):
        if (db_words is None) == (database is None):
            raise ValueError("pass exactly one of db_words= (host array) or "
                             "database= (Database)")
        if cfg is None:
            raise ValueError("cfg= is required")
        if database is None:
            database = Database(db_words, cfg, device, mesh=mesh)
        elif device is not None and torch.device(device) != database.device:
            raise ValueError(f"database lives on {database.device}, not "
                             f"{device}")
        if database.spec != DatabaseSpec.from_config(cfg):
            raise ValueError(f"database spec {database.spec} does not match "
                             f"the config")
        # fail here, not in the first answer (``server.py:423`` upstream)
        if database.mesh != (mesh if mesh is not None
                             else single_mesh(database.device)):
            raise ValueError("database was placed on a different mesh than "
                             "the serve steps will run on")
        self.party = party
        self.cfg = cfg
        self.db = database
        self.mesh = database.mesh
        self.device = database.device
        self.bucketed = BucketedServeFns(
            cfg, buckets=party_buckets(self.mesh, n_queries, buckets),
            backend=backend_of(self.device), path=path, protocol=protocol,
            device=self.device, mesh=self.mesh, collective=collective)
        self.protocol = self.bucketed.protocol
        self.bucketed.step_for(n_queries)

    @property
    def n_compiles(self) -> int:
        """Per-bucket serve steps built (``BucketedServeFns.n_compiles``)."""
        return self.bucketed.n_compiles

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.bucketed.buckets

    @property
    def db_epoch(self) -> int:
        """Current epoch of the (possibly shared) database."""
        return self.db.epoch

    def plan_report(self) -> Dict[int, dict]:
        """``BucketedServeFns.plan_report`` of this party's buckets."""
        return self.bucketed.plan_report()

    def stage_keys(self, keys: Keys) -> Keys:
        """Upload a key batch ahead of dispatch (pipelining)."""
        return self.bucketed.stage(keys, self.device)

    def answer(self, keys: Keys) -> torch.Tensor:
        """Answer a batch of queries: exactly ``[Q, cols]`` answer shares."""
        return self.bucketed.answer(self.db, keys)
