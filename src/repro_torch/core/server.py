"""PIR server of one party on one device (port of ``repro/core/server.py``).

The reference shards the DB over a TPU mesh and compiles one ``shard_map``
serve step per batch bucket. The port runs on one device: the whole DB
is one shard (``start_block = 0``), there is no collective, and PyTorch
runs eagerly, so a bucket's "step" is its resolved plan applied through
the protocol's ``answer_local``. Ragged batches still pad up to the
smallest covering bucket, and batches past the largest bucket are
chunked, exactly as upstream.
"""
from __future__ import annotations

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
                 device: Device = None):
        if not buckets:
            raise ValueError("need at least one bucket")
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.path = path
        self.chunk_log = chunk_log
        self.protocol = (protocol if protocol is not None
                         else protocol_mod.for_config(cfg))
        self.buckets = tuple(sorted(set(buckets)))
        self.log_local = cfg.log_n
        self._plans: Dict[int, ExecutionPlan] = {}
        self._steps: set = set()       # buckets whose step was built

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def plan_for_bucket(self, bucket: int) -> ExecutionPlan:
        if bucket not in self._plans:
            self._plans[bucket] = protocol_mod.resolve_plan(
                self.path, self.cfg, bucket, backend=self.backend,
                chunk_log=self.chunk_log, device=self.device)
        return self._plans[bucket]

    @property
    def n_compiles(self) -> int:
        return len(self._steps)

    def plan_report(self) -> Dict[int, dict]:
        """``{bucket: engine.plan_report row}`` for every bucket: the plan,
        its provenance and its modeled bytes, resolved without building a
        step (``server.py:300`` upstream)."""
        from repro_torch import engine
        return {b: engine.plan_report(self.cfg, self.plan_for_bucket(b), b,
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
        ``views[b]``, as ``[B, R, cols]`` (async on the card).

        Under a ``materialize`` plan the views' queries share the leaf
        expansion (``expand_local``), one pass per ``EXPAND_LEAVES``
        leaves instead of one per view; the scan (``scan_local``) runs per
        view. Other plans answer view by view, as :meth:`answer` does.
        """
        n_views = len(views)
        q = self.protocol.n_queries(keys)
        if q % n_views:
            raise ValueError(f"{q} queries do not split over {n_views} views")
        r = q // n_views
        keys = keys.to(views[0].device)
        part = lambda lo, hi: map_keys(keys, lambda x: x[lo * r:hi * r])
        plan = self.step_for(self.bucket_for(r))
        if plan.expand != "materialize":
            return torch.stack([self.answer(v, part(b, b + 1))
                                for b, v in enumerate(views)])
        per = max(1, EXPAND_LEAVES // (r * views[0].shape[0]))
        out = []
        for lo in range(0, n_views, per):
            hi = min(lo + per, n_views)
            sel = self.protocol.expand_local(part(lo, hi), 0, self.log_local,
                                             plan)
            out.extend(self.protocol.scan_local(
                views[b], sel[(b - lo) * r:(b - lo + 1) * r], plan)
                for b in range(lo, hi))
        return torch.stack(out)

    def _answer_one(self, db: torch.Tensor, keys: Keys) -> torch.Tensor:
        q = self.protocol.n_queries(keys)
        bucket = self.bucket_for(q)
        keys = self.protocol.pad(keys, bucket)
        return self.protocol.answer_local(
            db, keys, 0, self.log_local, self.step_for(bucket))[:q]


class PIRServer:
    """One logical PIR server (one of the non-colluding parties).

    References a :class:`Database` (shared across parties: its contents
    are public) and owns that party's per-bucket plans. ``db_words`` (a
    host array, placed into a private ``Database`` on ``device``) is the
    legacy construction path; new code passes ``database=``.
    """

    def __init__(self, party: int, db_words: Optional[np.ndarray] = None,
                 cfg: Optional[PIRConfig] = None, *,
                 database: Optional[Database] = None, device: Device = None,
                 n_queries: int = 32, path: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 protocol: Optional[PIRProtocol] = None):
        if (db_words is None) == (database is None):
            raise ValueError("pass exactly one of db_words= (host array) or "
                             "database= (Database)")
        if cfg is None:
            raise ValueError("cfg= is required")
        if database is None:
            database = Database(db_words, cfg, device)
        elif device is not None and torch.device(device) != database.device:
            raise ValueError(f"database lives on {database.device}, not "
                             f"{device}")
        if database.spec != DatabaseSpec.from_config(cfg):
            raise ValueError(f"database spec {database.spec} does not match "
                             f"the config")
        self.party = party
        self.cfg = cfg
        self.db = database
        self.device = database.device
        if buckets is None:
            buckets = default_buckets(max_bucket=max(n_queries, 1))
        if n_queries not in buckets:
            buckets = tuple(sorted(set(buckets) | {n_queries}))
        self.bucketed = BucketedServeFns(
            cfg, buckets=buckets, backend=backend_of(self.device), path=path,
            protocol=protocol, device=self.device)
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
