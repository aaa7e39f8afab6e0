"""``Database``: the device-resident PIR database of one device, versioned
by epochs.

Single-device counterpart of ``repro/db/sharded.py ShardedDatabase``. It
owns the ``words`` view, resident on the device as a row-major ``[R, W]``
int32 tensor (each record contiguous; the kernels read it as stored), and
the epoch tag that answers are stamped with. With ``cfg.checksum`` the rows
are stored with their checksum word, attached on the host, so every view is
at the stored width (``W = item_words + 1``). The ``bytes`` view is not a
second copy: it is the same memory reinterpreted as ``[R, 4W]`` int8
(``words.view(torch.int8)``), little-endian as the reference's
``words_to_bytes_i8`` packs it, so it follows every publish for free. The
``bytes32`` view (the LWE GEMM's operand, 4x the records) is a real copy,
built on the device the first time it is asked for (``stats.n_view_packs``)
and then maintained by each publish like the words.

Hints (single-server preprocessing, ``H = A^T.D`` for ``lwe-simple-1``) are
registered by name with a builder and an optional exact delta, built
lazily per epoch and delta-updated on publish (dropped and rebuilt lazily
when no delta is registered), as upstream (``sharded.py:244-276``).

Online updates (``sharded.py:278-403`` upstream): ``stage`` appends public
row writes to a host log and touches nothing on the device; ``publish``
applies the deduplicated (last-write-wins) delta and bumps the epoch. JAX
arrays are immutable, so upstream's retired epoch costs nothing; torch
tensors are not, and a batch already dispatched may still be reading the
old rows on the card. So a publish is **copy-on-publish**: on the
publishing thread, outside the database lock, each resident view of the
current epoch is cloned on the device (O(N) device traffic) and the
delta's rows are scattered into the clone (O(rows) host-to-device
traffic), and the hint deltas are computed into new tensors. The lock is
then taken only to swap the epochs. The previous epoch's views and hints
stay pinned until the next publish (``view(..., epoch=)``), so the
database holds two copies after its first publish (``resident_bytes``).
Everything is enqueued on the current CUDA stream, which the serving
threads share, so a dispatch that reads the new epoch is ordered after the
scatter that produced it, and the retired tensors are released on the
stream that last read them. A second lock serializes publishers without
blocking readers.

All parties of a deployment share one ``Database``: the contents are
public in the PIR model, and replicas stay equal by applying the same
published deltas (``subscribe``).

On a mesh (``launch/mesh.py``) the database is placed as upstream's
``ShardedDatabase`` places it (``sharded.py:127-178``): the rows are split
over the ``model`` axis in the paper's linear layout and replicated over
the cluster axes, so rank ``(c, d)`` keeps rows ``[d*B, (d+1)*B)`` on its
device, ``B = spec.rows_per_shard(P)``, and every view is that block.
Every rank constructs the database and calls ``stage`` / ``publish`` with
the same arguments (SPMD): the staged log is the whole public delta, each
rank scatters the rows its block owns, and every rank advances the epoch
in lockstep, whether or not its block changed. In a session on a mesh
(``runtime/serve_loop.py``) the controller's staged log moves into the
``PUBLISH`` command (:meth:`take_staged`), and every rank stages and
publishes that log on its command thread, so the epoch advances at the same
point of the dispatch order on every rank. A hint on a mesh of P > 1
blocks is built per block and summed: each rank builds its block's
partial (the LWE hint's ``A_block^T.D_block``, from the rows of A its
block owns) and a SUM all-reduce over the ``model`` group makes the whole
hint on every rank, replicated over the clusters as upstream's hint is; a
publish's delta is summed the same way, a block the delta misses adding
a zero partial, so every rank makes the same collectives in the same
order.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PIRConfig
from repro_torch.crypto.packing import words_to_tensor
from repro_torch.db.spec import DatabaseSpec
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.launch.mesh import (Mesh, all_reduce_sum, mesh_axis_size,
                                     pir_cluster_axes, pir_shard_axis,
                                     single_mesh)


@dataclass
class TransferStats:
    """Byte and event accounting of one database (``sharded.py:66``)."""
    preload_h2d_bytes: int = 0     # the placement at construction
    update_h2d_bytes: int = 0      # published deltas: int32 indices + rows
    clone_device_bytes: int = 0    # device bytes copied by copy-on-publish
    n_full_placements: int = 0     # host -> device placements of all rows
    n_view_packs: int = 0          # device builds of a whole bytes32 view
    n_publishes: int = 0
    n_hint_builds: int = 0         # full hint builds (lazy, per epoch)
    n_hint_deltas: int = 0         # O(rows) hint updates on publish


@dataclass(frozen=True)
class _HintSpec:
    """One registered hint: ``build(words) -> hint`` and an optional exact
    ``delta(hint, rows, old_words, new_words) -> new hint`` (rows: the
    deduplicated published indices; old/new: their ``[R, W]`` stored word
    rows before and after)."""
    build: Callable
    delta: Optional[Callable] = None


@dataclass
class PublishedDelta:
    """Public metadata of one published epoch (``sharded.py:93``):
    replaying ``stage(rows, vals); publish()`` against a replica of the
    previous epoch reproduces this one. ``vals`` are the deduplicated
    logical rows (a checksummed replica attaches its own column)."""
    epoch: int                     # the epoch the delta produced
    rows: np.ndarray               # deduplicated row indices written
    n_staged: int                  # staged entries folded into it
    vals: Optional[np.ndarray] = None   # [R, item_words] u32


@dataclass
class _Epoch:
    """One database version: its device views and its built hints."""
    epoch: int
    views: Dict[str, torch.Tensor] = field(default_factory=dict)
    hints: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class ShardPlacement:
    """Where one view lives (the counterpart of upstream's
    ``NamedSharding(mesh, P(shard, None))``): rows split over ``axis`` in
    ``n_shards`` blocks, replicated over ``replicated_over``; this rank
    holds block ``shard``, rows ``[rows[0], rows[1])``."""
    view: str
    axis: Optional[str]
    n_shards: int
    shard: int
    rows: Tuple[int, int]
    replicated_over: Tuple[str, ...]


@dataclass
class _Pending:
    """A prepared publish, not yet visible: the epoch it was built from,
    the new epoch, and its delta."""
    base: _Epoch
    new: _Epoch
    delta: PublishedDelta


class Database:
    """The PIR database on one device (``device=None`` means CUDA, or the
    mesh's device), or this rank's block of it on a ``mesh``.

    ``db_words`` is ``[N, W]`` u32 numpy (placed on the device; on a mesh
    only the rank's block is read, so a memory-mapped file is read once
    per block) or an int32 words tensor at the stored width, taken over
    without a copy where it already lies on the card (``_take_tensor``).

    Thread-safe: the scheduler reads ``snapshot()`` on its thread while
    clients ``stage`` / ``publish`` on theirs. Callers re-read the views
    per dispatch; a batch keeps the tensors of the epoch it read.
    """

    def __init__(self, db_words, cfg: PIRConfig, device: Device = None, *,
                 mesh: Optional[Mesh] = None):
        self.spec = DatabaseSpec.from_config(cfg)
        if mesh is None:
            mesh = single_mesh(resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"the mesh places this rank on {mesh.device}, "
                             f"not {device}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device)
        self.shard_axis = pir_shard_axis(mesh)
        self.n_shards = mesh_axis_size(mesh, self.shard_axis)
        self.shard_index = mesh.coord(self.shard_axis)
        block = self.spec.rows_per_shard(self.n_shards)   # validates
        #: the global rows this rank's block holds, [lo, hi)
        self.rows = (self.shard_index * block,
                     (self.shard_index + 1) * block)
        self.stats = TransferStats()
        self._lock = threading.RLock()          # epochs, staging, hints
        self._publish_lock = threading.RLock()  # one publisher at a time
        self._staged_rows: List[np.ndarray] = []
        self._staged_vals: List[np.ndarray] = []
        #: every published delta, in epoch order
        self.published: List[PublishedDelta] = []
        self._hint_specs: Dict[str, _HintSpec] = {}
        self._subscribers: List[Callable[[PublishedDelta], None]] = []
        #: optional ChaosInjector consulted at the "db.publish" seam
        self.chaos = None
        if isinstance(db_words, torch.Tensor):
            words = self._take_tensor(db_words)
        else:
            # payload rows take their checksum column here, once (rows
            # already at the stored width pass through)
            host = self._host_block(db_words)
            words = words_to_tensor(host, self.device)
            if words.device.type == "cpu":
                # from_numpy shares the caller's array; an epoch's rows are
                # the database's own, as the card's copy is
                words = words.clone()
            self.stats.preload_h2d_bytes += host.nbytes
        self.stats.n_full_placements += 1
        self._current = _Epoch(epoch=0, views={"words": words})
        self._retired: Optional[_Epoch] = None

    def _host_block(self, db_words) -> np.ndarray:
        """This rank's rows of a ``[N, W]`` u32 host array at the stored
        width (checksums attached to the block only)."""
        lo, hi = self.rows
        arr = np.asarray(db_words)
        if arr.ndim != 2 or len(arr) != self.spec.n_items:
            self.spec.validate_words(arr)              # raises
        if (lo, hi) == (0, self.spec.n_items):
            return self.spec.validate_words(self.spec.attach_checksums(arr))
        block = self.spec.attach_checksums(arr[lo:hi])
        if block.shape[1] != self.spec.stored_words \
                or block.dtype != np.uint32:
            self.spec.validate_words(arr)              # raises
        return block

    def _take_tensor(self, words: torch.Tensor) -> torch.Tensor:
        """A ``[N, item_words]`` int32 words tensor (the u32 bits) as the
        database's rows. On the card, a tensor already there is taken
        over, not copied: ownership passes to the database (a table built
        on the card never visits the host), and the caller keeps no
        reference it writes to. On the CPU the rows are copied, as the
        numpy path copies them: an epoch's rows are the database's own.
        The checksum column is computed on the host, so a checksummed
        database takes numpy rows and refuses a tensor."""
        if self.spec.checksum:
            raise ValueError(
                "a checksummed database attaches its checksum column on the "
                "host: pass the rows as a numpy array, not a tensor")
        want = self.spec.view_shape("words")
        if tuple(words.shape) != want or words.dtype != torch.int32:
            raise ValueError(
                f"a words tensor must be {want} int32 (the stored width), "
                f"got {tuple(words.shape)} {words.dtype}")
        lo, hi = self.rows
        placed = words[lo:hi].to(self.device).contiguous()
        if words.device != placed.device:
            self.stats.preload_h2d_bytes += placed.numel() * 4
        if placed.device.type == "cpu":
            placed = placed.clone()
        return placed

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._current.epoch

    @property
    def n_staged(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._staged_rows)

    @property
    def n_hint_builds(self) -> int:
        """Full hint builds so far (``stats.n_hint_builds``)."""
        return self.stats.n_hint_builds

    @property
    def resident_bytes(self) -> int:
        """Device bytes the views of the current and the retired epoch
        hold: the words (the ``bytes`` view aliases them) and ``bytes32``
        where built; hints are not counted."""
        with self._lock:
            held = [self._current] + ([self._retired] if self._retired
                                      else [])
            return sum(t.numel() * t.element_size()
                       for e in held for t in e.views.values())

    # -- placement and views -------------------------------------------

    def sharding(self, view: str = "words") -> ShardPlacement:
        """The placement of one view (every view shares the row split);
        ``KeyError`` for a view the spec does not know."""
        self.spec.view_dtype(view)
        return ShardPlacement(
            view=view, axis=self.shard_axis, n_shards=self.n_shards,
            shard=self.shard_index, rows=self.rows,
            replicated_over=pir_cluster_axes(self.mesh))

    def _holder(self, epoch: Optional[int]) -> _Epoch:
        """The resident epoch ``epoch`` names (lock held by the caller)."""
        if epoch is None or epoch == self._current.epoch:
            return self._current
        if self._retired is None or epoch != self._retired.epoch:
            raise KeyError(
                f"epoch {epoch} is not resident (current="
                f"{self._current.epoch}, retired="
                f"{None if self._retired is None else self._retired.epoch})")
        return self._retired

    def view(self, name: str = "words", *,
             epoch: Optional[int] = None) -> torch.Tensor:
        """The device tensor of one view at the current epoch, or at the
        epoch just retired; ``KeyError`` for a view the spec does not know
        or an older epoch."""
        self.spec.view_dtype(name)
        with self._lock:
            holder = self._holder(epoch)
            if name == "bytes":                   # an alias of the words
                return self.spec.words_to_view_device(
                    name, holder.views["words"])
            if name not in holder.views:          # bytes32, once per epoch
                holder.views[name] = self.spec.words_to_view_device(
                    name, holder.views["words"])
                self.stats.n_view_packs += 1
            return holder.views[name]

    def snapshot(self, views: Sequence[str] = ("words",)
                 ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """``(epoch, {view: tensor})`` read together, for one dispatch: a
        batch answered from these tensors and tagged with this epoch is
        never mislabelled, whatever publish lands meanwhile."""
        with self._lock:
            return self._current.epoch, {v: self.view(v) for v in views}

    # -- hints (single-server preprocessing) ----------------------------

    def register_hint(self, name: str, build: Callable,
                      delta: Optional[Callable] = None) -> None:
        """Register a per-epoch hint: ``build(words) -> hint`` and an
        optional exact ``delta(hint, rows, old_words, new_words)``.
        Re-registering a name replaces the spec and keeps built hints.

        On a mesh of P > 1 row blocks a hint must be additive over the
        blocks: the database calls ``build(block, row0=)`` (``row0`` the
        block's first global row) for its block's partial and
        ``delta(zeros, rows, old_words, new_words, row0=, n_rows=)`` for
        the change of the published rows its block holds, and sums the
        partials over the ``model`` process group (an int32 hint wraps mod
        2^32). Building a hint is then a collective, so every rank must
        ask for it at the same call, as SPMD callers do
        (``SingleServerPIR``'s finalize outside a session, its ``start()``
        before one); a mesh without that group refuses the hint
        (``ValueError``)."""
        if self.n_shards > 1 and self.mesh.group(self.shard_axis) is None:
            raise ValueError(
                f"a hint over a database sharded in {self.n_shards} blocks "
                f"sums the blocks' partials over the mesh's "
                f"{self.shard_axis!r} process group, and this mesh has none")
        with self._lock:
            self._hint_specs[name] = _HintSpec(build=build, delta=delta)

    def hint(self, name: str, *, epoch: Optional[int] = None
             ) -> torch.Tensor:
        """The device-resident hint of one epoch (current or retired),
        built on first use; ``KeyError`` for an unregistered name or an
        epoch not resident. On a mesh the first use is a collective."""
        with self._lock:
            if name not in self._hint_specs:
                raise KeyError(f"unknown hint {name!r}; registered: "
                               f"{sorted(self._hint_specs)}")
            holder = self._holder(epoch)
            if name not in holder.hints:
                build, words = self._hint_specs[name].build, \
                    holder.views["words"]
                holder.hints[name] = (
                    build(words) if self.n_shards == 1
                    else self._shard_sum(build(words, row0=self.rows[0])))
                self.stats.n_hint_builds += 1
            return holder.hints[name]

    def _shard_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The blocks' partials summed over the ``model`` group."""
        return all_reduce_sum(partial, self.mesh.group(self.shard_axis))

    # -- epoched online updates -----------------------------------------

    def stage(self, rows, values) -> int:
        """Append row writes to the pending (public) delta log.

        ``rows``: ``[R]`` indices; ``values``: ``[R, item_words]`` u32 or
        ``[R, item_bytes]`` u8. Nothing touches the device until
        :meth:`publish`. Returns the total staged entry count.
        """
        idx = np.atleast_1d(np.asarray(rows, np.int64))
        vals = self.spec.coerce_rows_to_words(values)
        if idx.ndim != 1 or len(idx) != len(vals):
            raise ValueError(
                f"rows/values length mismatch: {idx.shape} vs {vals.shape}")
        if len(idx) and (idx.min() < 0 or idx.max() >= self.spec.n_items):
            raise ValueError(
                f"row indices out of range [0, {self.spec.n_items})")
        with self._lock:
            self._staged_rows.append(idx)
            self._staged_vals.append(np.array(vals, np.uint32, copy=True))
            return sum(len(r) for r in self._staged_rows)

    def take_staged(self) -> Tuple[np.ndarray, np.ndarray]:
        """Remove the staged log and return it: ``[R]`` int64 rows and
        ``[R, item_words]`` u32 logical rows, in staging order. A session
        on a mesh moves the controller's log this way into the command
        that every rank stages and publishes."""
        with self._lock:
            rows = (np.concatenate(self._staged_rows) if self._staged_rows
                    else np.zeros((0,), np.int64))
            vals = (np.concatenate(self._staged_vals) if self._staged_vals
                    else np.zeros((0, self.spec.item_words), np.uint32))
            self._staged_rows.clear()
            self._staged_vals.clear()
            return rows, vals

    def subscribe(self, fn: Callable[[PublishedDelta], None]
                  ) -> Callable[[], None]:
        """Call ``fn(delta)`` after every publish that made a new epoch;
        returns an unsubscribe callable. Callbacks run on the publishing
        thread after the swap, outside the database lock (a subscriber may
        stage and publish into another database), in epoch order."""
        self._subscribers.append(fn)

        def _unsubscribe(fn=fn):
            if fn in self._subscribers:
                self._subscribers.remove(fn)
        return _unsubscribe

    def publish(self) -> int:
        """Apply the staged delta as the next epoch and return the current
        epoch; nothing staged is a no-op (no new epoch).

        The copy and the scatter run outside the database lock, which is
        held only for the swap; the previous epoch stays readable until
        the next publish. Subscribers are notified after the swap, unless
        ``chaos`` drops this publish's fan-out.
        """
        with self._publish_lock:
            pending = self._prepare_publish()
            if pending is None:
                return self.epoch
            self._commit_publish(pending)
            # chaos seam "db.publish" (no target): a drop swallows this
            # epoch's fan-out; subscribers hear the next publish
            chaos = self.chaos
            if chaos is not None and chaos.should_drop("db.publish"):
                return pending.delta.epoch
            for fn in tuple(self._subscribers):
                fn(pending.delta)
            return pending.delta.epoch

    def _prepare_publish(self) -> Optional[_Pending]:
        """The first half of :meth:`publish` (the publish lock held): take
        the staged log, and build the next epoch's views and hints from
        the current one's on the device, outside the database lock.
        ``None`` when nothing is staged."""
        with self._lock:
            rows = (np.concatenate(self._staged_rows) if self._staged_rows
                    else np.zeros((0,), np.int64))
            vals = (np.concatenate(self._staged_vals) if self._staged_vals
                    else None)
            self._staged_rows.clear()
            self._staged_vals.clear()
            base = self._current
            views = dict(base.views)
            delta_hints = {n: (h, self._hint_specs[n].delta)
                           for n, h in base.hints.items()
                           if self._hint_specs[n].delta is not None}
        if not len(rows):
            return None
        n_staged = len(rows)
        # last write wins: a scatter's order for repeated indices is not
        # defined, so collisions are resolved here
        _, first_of_rev = np.unique(rows[::-1], return_index=True)
        keep = np.sort(len(rows) - 1 - first_of_rev)
        rows, vals = rows[keep], vals[keep]
        # this rank's block keeps its own rows (all of them off a mesh);
        # a block the delta misses carries its views into the new epoch
        lo, hi = self.rows
        mine = (rows >= lo) & (rows < hi)
        new_views, new_hints = dict(views), {}
        if mine.any():
            stored = self.spec.attach_checksums(vals[mine])   # stored width
            idx32 = np.ascontiguousarray(rows[mine] - lo, np.int32)
            idx = torch.from_numpy(idx32).to(self.device).long()
            new_words = words_to_tensor(stored, self.device)
            self.stats.update_h2d_bytes += idx32.nbytes + stored.nbytes
            old_words = base.views["words"][idx] if delta_hints else None
            for name, tensor in views.items():
                rows_v = self.spec.words_to_view_device(name, new_words)
                new_views[name] = tensor.clone().index_copy_(0, idx, rows_v)
                self.stats.clone_device_bytes += \
                    tensor.numel() * tensor.element_size()
        for name, (h, delta) in delta_hints.items():
            if self.n_shards == 1:
                new_hints[name] = delta(h, rows, old_words, new_words)
            else:
                # this block's change (zero where the delta misses it),
                # summed over the blocks on every rank
                part = (delta(torch.zeros_like(h), rows[mine], old_words,
                              new_words, row0=lo, n_rows=hi - lo)
                        if mine.any() else torch.zeros_like(h))
                new_hints[name] = h + self._shard_sum(part)
            self.stats.n_hint_deltas += 1
        epoch = base.epoch + 1
        return _Pending(base=base,
                        new=_Epoch(epoch=epoch, views=new_views,
                                   hints=new_hints),
                        delta=PublishedDelta(epoch=epoch, rows=rows,
                                             n_staged=n_staged, vals=vals))

    def _commit_publish(self, pending: _Pending) -> None:
        """The second half of :meth:`publish`: swap the epochs under the
        database lock (the publish lock held since the first half)."""
        with self._lock:
            if self._current is not pending.base:
                raise RuntimeError("the current epoch moved under a "
                                   "prepared publish")
            self._retired = self._current
            self._current = pending.new
            self.stats.n_publishes += 1
            self.published.append(pending.delta)
