"""``BucketedDatabase``: the batch-PIR bucketed layout over ``Database``
(port of ``repro/db/bucketed.py``).

One logical N-record database held as B per-bucket databases, each a
:class:`~repro_torch.db.sharded.Database` of ``capacity`` rows (the cuckoo
layout's power-of-two bucket height). Record i is replicated into every
distinct candidate bucket ``h_j(i)``, so whichever bucket the client's
cuckoo assignment picks for i can answer for it. Unused slots are zero
rows (with a valid checksum when the config has checksums).

``stage(rows, values)`` takes global row ids and fans each write out to
the ``(bucket, slot)`` places the layout gives the record; ``publish()``
publishes the touched buckets only and bumps one outer epoch. Each touched
bucket's new epoch is built outside the outer lock (``Database``'s
copy-on-publish, so only those buckets are cloned), and the outer lock is
held only to swap them all, so a ``snapshot`` sees all B buckets at one
version. Memory: B · capacity stored rows, about 2 · n_hashes · N
(replication times the power-of-two rounding).

On a mesh (``mesh=``, as upstream's ``BucketedDatabase(..., mesh)``) each
bucket is a ``Database(..., mesh=mesh)``: rank ``(c, d)`` holds rows
``[d·C/P, (d+1)·C/P)`` of every bucket's ``capacity`` C, and reads only
those rows of the host store (a memory-mapped file is read once per block,
never gathered whole). ``stage`` / ``publish`` are SPMD: every rank calls
them with the same arguments and keeps the same outer epoch. A prebuilt
``layout`` saves each rank the host layout's build.
"""
from __future__ import annotations

import threading
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.core.batch import CuckooLayout, CuckooParams
from repro_torch.db.sharded import Database, TransferStats
from repro_torch.db.spec import DatabaseSpec
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.launch.mesh import Mesh, mesh_axis_size, pir_shard_axis


class BucketedDatabase:
    """B cuckoo buckets of one PIR database, versioned by one outer epoch.

    ``db_words``: the logical host store, ``[N, item_words]`` u32 (rows at
    the stored width are accepted too: the checksum column is recomputed
    per bucket either way, since pad rows need their own).
    """

    def __init__(self, db_words: np.ndarray, cfg: PIRConfig,
                 device: Device = None,
                 layout: Optional[CuckooLayout] = None, *,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.params = CuckooParams.from_config(cfg).validate()
        self.spec = DatabaseSpec.from_config(cfg)       # outer, logical
        if layout is None:
            layout = CuckooLayout.build(cfg.n_items, self.params)
        if layout.n_items != cfg.n_items or layout.params != self.params:
            raise ValueError(
                f"layout built for (n_items={layout.n_items}, "
                f"{layout.params}) does not match cfg "
                f"(n_items={cfg.n_items}, {self.params})")
        self.layout = layout
        #: each bucket's spec and config: the record format, ``capacity``
        #: rows; the inner protocol keygens and plans against inner_cfg
        self.inner_spec = DatabaseSpec(n_items=layout.capacity,
                                       item_bytes=cfg.item_bytes,
                                       checksum=cfg.checksum)
        self.inner_cfg = dc_replace(cfg, n_items=layout.capacity)

        host = np.asarray(db_words)
        if host.ndim != 2 or host.shape[0] != cfg.n_items:
            raise ValueError(
                f"db_words must be [{cfg.n_items}, words], got {host.shape}")
        if host.shape[1] == self.spec.stored_words and self.spec.checksum:
            host = host[:, :self.spec.item_words]       # re-derived per bucket
        if host.shape[1] != self.spec.item_words:
            raise ValueError(
                f"db_words rows must be {self.spec.item_words} payload "
                f"words (or {self.spec.stored_words} stored), got "
                f"{host.shape[1]}")

        self._lock = threading.RLock()           # the outer epoch
        # staging and publishing: a publish takes every bucket's log at
        # once, so no logical write lands in some of its buckets only
        self._stage_lock = threading.RLock()
        self._epoch = 0
        self._n_staged_logical = 0
        w = self.spec.item_words
        # this rank's slots of every bucket (all of them off a mesh); the
        # rest of a bucket's host rows stay unwritten zero pages
        n_shards = mesh_axis_size(mesh, pir_shard_axis(mesh)) if mesh else 1
        block = self.inner_spec.rows_per_shard(n_shards)
        lo = (mesh.coord(pir_shard_axis(mesh)) if mesh else 0) * block
        buckets = []
        for rows in layout.bucket_rows:
            rows_host = np.zeros((layout.capacity, w), np.uint32)
            mine = rows[lo:lo + block]
            rows_host[lo:lo + len(mine)] = host[mine]
            buckets.append(Database(rows_host, self.inner_cfg,
                                    None if mesh else self.device,
                                    mesh=mesh))
        self.buckets: Tuple[Database, ...] = tuple(buckets)

    # -- geometry -------------------------------------------------------

    @property
    def n_buckets(self) -> int:
        return self.layout.n_buckets

    @property
    def capacity(self) -> int:
        return self.layout.capacity

    @property
    def expansion(self) -> float:
        """Stored rows / logical rows: the replication's space cost."""
        return self.n_buckets * self.capacity / self.spec.n_items

    @property
    def epoch(self) -> int:
        """The outer epoch: bumped once per publish that changed a bucket,
        so the answers of one dispatch carry one tag."""
        with self._lock:
            return self._epoch

    @property
    def n_staged(self) -> int:
        """Staged ``(bucket, slot)`` writes across all buckets."""
        with self._stage_lock:
            return sum(b.n_staged for b in self.buckets)

    @property
    def stats(self) -> TransferStats:
        """Transfer accounting summed over the buckets."""
        agg = TransferStats()
        for b in self.buckets:
            for k in vars(agg):
                setattr(agg, k, getattr(agg, k) + getattr(b.stats, k))
        return agg

    @property
    def resident_bytes(self) -> int:
        """Device bytes of every bucket's current and retired views."""
        return sum(b.resident_bytes for b in self.buckets)

    # -- reads ------------------------------------------------------------

    def snapshot(self, names: Sequence[str] = ("words",)
                 ) -> Tuple[int, Dict[str, Tuple[torch.Tensor, ...]]]:
        """``(outer epoch, {view: one tensor per bucket})`` read under the
        outer lock, so the B views are one consistent version."""
        with self._lock:
            return self._epoch, {
                n: tuple(b.view(n) for b in self.buckets) for n in names}

    # -- epoched online updates (global rows in, bucket deltas out) ------

    def stage(self, rows, values) -> int:
        """Stage global row writes; each lands in every bucket that holds
        the record (at most n_hashes ``(bucket, slot)`` writes per row).
        ``values``: ``[R, item_words]`` u32 or ``[R, item_bytes]`` u8
        logical payloads. Returns the staged logical entry count."""
        idx = np.atleast_1d(np.asarray(rows, np.int64))
        vals = self.spec.coerce_rows_to_words(values)
        if idx.ndim != 1 or len(idx) != len(vals):
            raise ValueError(
                f"rows/values length mismatch: {idx.shape} vs {vals.shape}")
        if len(idx) and (idx.min() < 0 or idx.max() >= self.spec.n_items):
            raise ValueError(
                f"row indices out of range [0, {self.spec.n_items})")
        per_bucket: Dict[int, Tuple[List[int], List[np.ndarray]]] = {}
        for r, v in zip(idx, vals):              # write order kept per bucket
            for b, slot in self.layout.occurrences(int(r)):
                slots, rows_v = per_bucket.setdefault(b, ([], []))
                slots.append(slot)
                rows_v.append(v)
        with self._stage_lock:
            for b, (slots, rows_v) in per_bucket.items():
                self.buckets[b].stage(slots, np.stack(rows_v))
            self._n_staged_logical += len(idx)
            return self._n_staged_logical

    def publish(self) -> int:
        """Publish every touched bucket and bump the outer epoch once (a
        no-op when nothing is staged); returns the outer epoch. Stagers
        wait while the touched buckets' next epochs are built; readers
        wait only for the swap."""
        with self._stage_lock:
            prepared = [(b, b._prepare_publish()) for b in self.buckets
                        if b.n_staged]
            prepared = [(b, p) for b, p in prepared if p is not None]
            with self._lock:
                for b, p in prepared:
                    b._commit_publish(p)
                if prepared:
                    self._epoch += 1
                    self._n_staged_logical = 0
                return self._epoch
