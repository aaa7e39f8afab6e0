"""Device meshes and device groups of the port (``repro/launch/mesh.py``).

The reference is single-controller: one process drives every device of a
``jax.sharding.Mesh``. The port is SPMD under ``torch.distributed``: one
process per rank, every rank calling the same functions in the same order.
A :class:`Mesh` is one rank's view of a named grid of ranks: the axes and
their sizes (``mesh.shape``, as upstream), this rank's coordinate on each
axis, its device, and a process group per axis from a
``torch.distributed.device_mesh.DeviceMesh``.

Axis semantics (as upstream):
  pod    extra cluster parallelism (PIR)
  data   PIR "DPU clusters": the DB is replicated over them and they answer
         disjoint queries
  model  PIR DB shards (the "DPUs of one cluster"): shard d holds a
         contiguous row block

A ``(1, 1)`` mesh needs no process group: it is the single-card case.

Backend and transport. ``nccl`` runs when every rank has a card of its
own, ``gloo`` otherwise (the CPU, or several ranks sharing one card:
NCCL refuses two ranks on one card). Gloo's point-to-point ops take no
CUDA tensors, so under gloo a rank on the card moves a collective's
operand to the host and back (``transport == "host"``); NCCL and gloo on
the CPU run the collective where the tensor lies (``"device"``).

The command channel. A streaming session on a mesh has one controller,
``mesh.controller``: it cuts every batch, and the other ranks, its
followers, dispatch what it tells them (``runtime/serve_loop.py``). The
controller is the grid's first rank unless the mesh was built with
another (:func:`mesh_over`): a fleet's replicas all have the fleet's
controller, rank 0, which lies outside the grid of every replica but the
one it serves in. The commands go over ``mesh.control_group``, a gloo
group of the controller and the grid's ranks kept for them, with host
tensors whatever the backend: :func:`send_command` broadcasts a header of
``HEADER_LEN`` int64 words (the command's code, then up to
``HEADER_LEN - 1`` integer fields), then each of its tensors as it is
(never pickled). A follower reads the header with :func:`recv_command`
and each tensor, whose shape the fields give, with :func:`recv_tensor`.
A follower may wait for its next command as long as a session sits idle,
so the control group's timeout is ``CONTROL_IDLE_S``; the controller waits
for each send at most the collective timeout (:func:`collective_timeout`),
so a follower that is gone fails the send instead of hanging it. A
controller outside the grid takes no part in the grid's collectives: the
grid's first rank sends what the controller needs (a batch's reduced
answer, a hint) back over the control group, point to point, as a reply
(:func:`send_reply` / :func:`recv_reply`: a header with the reply's kind,
an integer field, the tensor's dtype and shape, then the tensor as it
is). A timeout given to :func:`init_distributed` bounds every collective
of the process group and of the meshes' axis groups, so a rank that never
joins one fails the others' after it instead of hanging them.

``split_devices`` partitions a list of devices, or of ranks, for the
replica plane (``runtime/elastic.carve_submeshes``), and a
:class:`Fleet` is the channel over which a fleet's controller announces
each replica to every other rank of the process group
(``replica/replica.follow_fleet``).
"""
from __future__ import annotations

import datetime
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig


def local_devices() -> List[torch.device]:
    """Every CUDA card of this process, ``cuda:0`` first. Raises
    ``RuntimeError`` without one, as ``engine.backend.resolve_device``
    does: pass the devices explicitly to run on the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass the devices explicitly "
            "(e.g. [torch.device('cpu')]) to run on the CPU")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def split_devices(n_groups: int, devices: Optional[Sequence] = None, *,
                  min_per_group: int = 1) -> list:
    """Partition the device list, or a list of ranks, into ``n_groups``
    disjoint groups.

    The replica plane carves one serve replica per group
    (``runtime/elastic.carve_submeshes``). Groups are equal-sized; leftover
    devices idle until the next resize. When there are fewer than
    ``n_groups * min_per_group`` devices, every group gets the FULL list:
    replicas then share the cards but keep separate schedulers, plans and
    databases (one card: both replicas on ``cuda:0``).
    """
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    devs = list(devices if devices is not None else local_devices())
    per = len(devs) // n_groups
    if per < max(min_per_group, 1):
        return [list(devs) for _ in range(n_groups)]
    return [devs[i * per:(i + 1) * per] for i in range(n_groups)]


# ---------------------------------------------------------------------------
# Ranks, backends and devices
# ---------------------------------------------------------------------------

def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else the device
    :func:`init_distributed` was given, else
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else the global
    rank), so that on one card every rank gets ``cuda:0``. Raises
    ``RuntimeError`` without a card, as ``resolve_device`` does."""
    if device is not None:
        return torch.device(device)
    if _DEVICE is not None:
        return _DEVICE
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    local = int(os.environ.get("LOCAL_RANK", _rank()))
    return torch.device(f"cuda:{local % n}")


def default_backend(world_size: int, device=None) -> str:
    """``nccl`` when every one of ``world_size`` ranks has a card of its
    own, else ``gloo`` (the CPU, or ranks sharing a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= world_size and dist.is_nccl_available():
        return "nccl"
    return "gloo"


#: the collective timeout :func:`init_distributed` was given (None: the
#: backend's default), applied to every group a mesh makes
_TIMEOUT: Optional[datetime.timedelta] = None
#: the device :func:`init_distributed` was given: every mesh's default
_DEVICE: Optional[torch.device] = None


def init_distributed(rank: int, world_size: int, init_method: str, *,
                     device=None, timeout: Optional[float] = None) -> str:
    """Join the process group (``init_method`` e.g. ``"file:///tmp/x"`` or
    ``"tcp://localhost:29500"``) with :func:`default_backend` for
    ``device``; returns the backend. ``device`` is then this rank's
    device wherever a mesh is built without one (:func:`rank_device`).
    ``timeout`` (seconds) bounds the rendezvous and every collective of
    this group and of the groups the meshes make (PyTorch's default is 30
    minutes)."""
    global _TIMEOUT, _DEVICE
    backend = default_backend(world_size, device)
    _DEVICE = None if device is None else torch.device(device)
    _TIMEOUT = (None if timeout is None
                else datetime.timedelta(seconds=timeout))
    kwargs = {} if _TIMEOUT is None else {"timeout": _TIMEOUT}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return backend


def _bound_timeout(group) -> None:
    """Give ``group`` the process group's timeout: a group made later
    (``new_group``, ``DeviceMesh``) otherwise takes the backend's
    default."""
    if _TIMEOUT is not None and group is not None:
        dist.distributed_c10d._set_pg_timeout(_TIMEOUT, group)


def on_transport(fn, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(x)`` run on the tensor where the group's backend takes it: gloo
    takes no CUDA tensor for point-to-point ops, so under gloo a card's
    tensor goes to the host and the result comes back
    (:func:`transport_of`)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return fn(x.cpu()).to(x.device)
    return fn(x)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A SUM all-reduce of ``x`` over ``group`` into a new tensor (``x`` is
    left as it was); int32 wraps mod 2^32, as the reference's ``psum``."""
    def allreduce(t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    return on_transport(allreduce, x, group)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``: the others
    pass a buffer of its shape and dtype, which is filled."""
    def bcast(t):
        t = t.contiguous()
        dist.broadcast(t, src=src, group=group)
        return t
    return on_transport(bcast, x, group)


#: the controller's commands, by code: a batch to stage and dispatch, a
#: delta to stage and publish, the end of a drained session, the end of a
#: dead or killed one, the opening of a session whose followers were
#: already in their loops (a fleet's replica), and a hint the grid's first
#: rank sends back to a controller outside the grid; then a fleet's: a
#: replica joins, a replica left, the fleet is closed
COMMANDS = ("DISPATCH", "PUBLISH", "STOP", "ABORT", "START", "HINT",
            "JOIN", "LEAVE", "CLOSE")
#: what the grid's first rank sends back to a controller outside the grid:
#: a batch's reduced answer shares, and a hint
REPLIES = ("ANSWER", "HINT")
#: the dtypes a reply's tensor may have, by code
REPLY_DTYPES = (torch.int32, torch.int64, torch.uint8)
#: the point-to-point tag of replies on a control group
REPLY_TAG = 7
#: int64 words of a command's header: its code and its fields
HEADER_LEN = 8
#: how long a follower waits for the controller's next command: the
#: longest a session may sit idle (the control group's timeout)
CONTROL_IDLE_S = 24 * 3600.0
#: PyTorch's default collective timeout, where init_distributed set none
DEFAULT_TIMEOUT_S = 1800.0


def collective_timeout() -> datetime.timedelta:
    """The bound of one collective: :func:`init_distributed`'s timeout, or
    PyTorch's default."""
    return _TIMEOUT or datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def send_command(mesh, command: str, fields: Sequence[int] = (),
                 tensors: Sequence[torch.Tensor] = (), *,
                 wait: bool = True) -> list:
    """On the controller: broadcast ``command`` with its integer ``fields``
    and then each of ``tensors`` (sent from the host) to every rank of
    ``mesh.control_group`` (a :class:`Mesh`'s, or a :class:`Fleet`'s). The
    fields must tell the followers the tensors' shapes and dtypes. Each
    send is waited for at most :func:`collective_timeout`
    (``RuntimeError`` past it); with ``wait`` false none is waited for, and
    the pending works are returned."""
    if len(fields) >= HEADER_LEN:
        raise ValueError(f"a command carries at most {HEADER_LEN - 1} "
                         f"fields, got {len(fields)}")
    header = torch.zeros(HEADER_LEN, dtype=torch.int64)
    header[0] = COMMANDS.index(command)
    header[1:1 + len(fields)] = torch.tensor(list(fields), dtype=torch.int64)
    works = []
    for t in [header] + [t.cpu().contiguous() for t in tensors]:
        work = dist.broadcast(t, src=mesh.controller,
                              group=mesh.control_group, async_op=True)
        if wait:
            work.wait(timeout=collective_timeout())
        works.append(work)
    return works


def recv_command(mesh) -> Tuple[str, Tuple[int, ...]]:
    """On a follower: wait (up to ``CONTROL_IDLE_S``) for the controller's
    next command; returns its name and its ``HEADER_LEN - 1`` fields
    (unused ones are 0)."""
    header = recv_tensor(mesh, (HEADER_LEN,), torch.int64).tolist()
    return COMMANDS[header[0]], tuple(header[1:])


def recv_tensor(mesh, shape: Sequence[int],
                dtype: torch.dtype) -> torch.Tensor:
    """On a follower: the command's next tensor, on the host."""
    t = torch.empty(tuple(shape), dtype=dtype)
    dist.broadcast(t, src=mesh.controller, group=mesh.control_group)
    return t


def send_reply(mesh: "Mesh", kind: str, field_value: int,
               tensor: torch.Tensor) -> list:
    """On the grid's first rank: send ``tensor`` (at most three dims) to a
    controller outside the grid, point to point over the control group,
    with a header of its kind (``REPLIES``), one integer field, its dtype,
    its shape and the send's ``time.monotonic_ns()``. Nothing is waited
    for: the pending works are returned, holding the sent tensors, for
    the caller to wait on before the session ends (the controller reads
    a reply only after it sent the next command)."""
    t = tensor.detach().cpu().contiguous()
    if t.dim() > 3:
        raise ValueError(f"a reply carries at most 3 dims, got {t.dim()}")
    shape = list(t.shape) + [0] * (3 - t.dim())
    header = torch.tensor([REPLIES.index(kind), field_value,
                           REPLY_DTYPES.index(t.dtype), t.dim(), *shape,
                           time.monotonic_ns()], dtype=torch.int64)
    return [(dist.isend(x, dst=mesh.controller, group=mesh.control_group,
                        tag=REPLY_TAG), x) for x in (header, t)]


def recv_reply(mesh: "Mesh") -> Tuple[str, int, torch.Tensor, float]:
    """On a controller outside the grid: the grid's next reply
    (:func:`send_reply`), waited for at most :func:`collective_timeout`;
    returns its kind, its field, its tensor and the seconds from its send
    to its arrival (both ``time.monotonic`` instants of one host)."""
    src = mesh.ranks[0]

    def recv(t):
        dist.irecv(t, src=src, group=mesh.control_group,
                   tag=REPLY_TAG).wait(timeout=collective_timeout())
        return t
    header = recv(torch.empty(HEADER_LEN, dtype=torch.int64)).tolist()
    kind, value, dtype, ndim = header[:4]
    t = recv(torch.empty(tuple(header[4:4 + ndim]),
                         dtype=REPLY_DTYPES[dtype]))
    return REPLIES[kind], value, t, (time.monotonic_ns() - header[7]) / 1e9


def transport_of(backend: Optional[str], device: torch.device) -> str:
    """Where a collective's operand travels: ``"host"`` for gloo on the
    card (copied to the host and back), ``"device"`` otherwise, and
    ``"none"`` without a process group."""
    if backend is None:
        return "none"
    return "host" if backend == "gloo" and device.type == "cuda" \
        else "device"


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """One rank's view of a named grid of ranks.

    ``ranks`` are the global ranks of the grid, row-major over ``axes``;
    ``rank`` is this process's. Equality is the grid's (axes, sizes and
    ranks), as two ``jax.sharding.Mesh`` over the same devices are equal.
    ``control_rank`` is the session controller when it is not the grid's
    first rank (it may lie outside the grid); ``fleet`` is the
    :class:`Fleet` a replica carved on this mesh joins.
    """
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device = field(compare=False)
    backend: Optional[str] = field(default=None, compare=False)
    device_mesh: Optional[object] = field(default=None, compare=False,
                                          repr=False)
    #: a group over every rank of the grid (key broadcasts)
    all_group: Optional[object] = field(default=None, compare=False,
                                        repr=False)
    #: a gloo group over the controller and every rank of the grid for a
    #: session's commands (``send_command``) and the grid's replies to a
    #: controller outside it (``send_reply``), with the idle timeout
    #: ``CONTROL_IDLE_S``
    control_group: Optional[object] = field(default=None, compare=False,
                                            repr=False)
    control_rank: Optional[int] = field(default=None, compare=False)
    fleet: Optional["Fleet"] = field(default=None, compare=False,
                                     repr=False)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def transport(self) -> str:
        return transport_of(self.backend if self.size > 1 else None,
                            self.device)

    @property
    def contains_rank(self) -> bool:
        return self.rank in self.ranks

    @property
    def controller(self) -> int:
        """The global rank that cuts a session's batches: ``control_rank``
        where one was given, else the grid's first."""
        return self.ranks[0] if self.control_rank is None \
            else self.control_rank

    @property
    def is_controller(self) -> bool:
        return self.rank == self.controller

    @property
    def multi_process(self) -> bool:
        """Whether serving on this mesh takes more than one process: a
        grid of several ranks, or a controller outside the grid."""
        return self.size > 1 or self.controller not in self.ranks

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis; ``ValueError`` for a rank
        outside the grid."""
        if not self.contains_rank:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{dict(self.shape)} over ranks {self.ranks}")
        flat, out = self.ranks.index(self.rank), {}
        for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[name] = flat % n
            flat //= n
        return {a: out[a] for a in self.axis_names}

    def coord(self, name: Optional[str]) -> int:
        """This rank's index on axis ``name`` (0 on an absent axis)."""
        return self.coords.get(name, 0) if name else 0

    def group(self, name: str):
        """The process group of axis ``name`` through this rank
        (``DeviceMesh.get_group``); None on a mesh without one."""
        if self.device_mesh is None or name not in self.axis_names:
            return None
        return self.device_mesh.get_group(name)


def single_mesh(device=None, axes: Tuple[str, ...] = ("data", "model")
                ) -> Mesh:
    """The ``(1, 1)`` mesh of this rank alone: no process group."""
    return Mesh(axis_names=tuple(axes), sizes=(1,) * len(axes),
                ranks=(_rank(),), rank=_rank(), device=rank_device(device))


def _control_group(ranks: Sequence[int]):
    return dist.new_group(sorted(ranks), backend="gloo",
                          timeout=datetime.timedelta(seconds=CONTROL_IDLE_S))


def mesh_over(ranks: Sequence[int], axes: Sequence[str],
              sizes: Sequence[int], *, device=None,
              controller: Optional[int] = None) -> Mesh:
    """A mesh over the global ``ranks``, row-major over ``axes`` of
    ``sizes``, whose session controller is ``controller`` (default: the
    first rank; it may lie outside the grid). Building its groups is
    collective: every rank of the process group calls this with the same
    arguments, in the same order, ranks outside the grid included (they
    get a mesh with ``contains_rank`` false and no coordinates). A grid of
    one rank controlled by itself needs no process group."""
    ranks, axes, sizes = (tuple(int(r) for r in ranks), tuple(axes),
                          tuple(int(s) for s in sizes))
    n = 1
    for s in sizes:
        n *= s
    if len(ranks) != n or len(set(ranks)) != n:
        raise ValueError(f"a {dict(zip(axes, sizes))} mesh needs {n} "
                         f"distinct ranks, got {list(ranks)}")
    ctl = ranks[0] if controller is None else int(controller)
    dev = rank_device(device)
    if n == 1 and ctl == ranks[0]:
        return Mesh(axis_names=axes, sizes=sizes, ranks=ranks, rank=_rank(),
                    device=dev)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(axes, sizes))} mesh over ranks {list(ranks)} "
            f"needs an initialized process group (init_distributed)")
    if max(ranks + (ctl,)) >= _world() or min(ranks + (ctl,)) < 0:
        raise ValueError(f"a mesh over ranks {list(ranks)} controlled by "
                         f"{ctl} needs those ranks; the process group has "
                         f"{_world()}")
    backend = dist.get_backend()
    device_mesh = all_group = None
    if n > 1:
        from torch.distributed.device_mesh import DeviceMesh
        device_mesh = DeviceMesh(
            "cuda" if backend == "nccl" else "cpu",
            torch.tensor(ranks, dtype=torch.int).reshape(sizes),
            mesh_dim_names=axes)
        all_group = (dist.group.WORLD if sorted(ranks) == list(range(
            _world())) else dist.new_group(sorted(ranks)))
        if _rank() in ranks:          # a rank outside the grid has no groups
            for group in [all_group] + [device_mesh.get_group(a)
                                        for a in axes]:
                _bound_timeout(group)
    control_group = _control_group(set(ranks) | {ctl})
    return Mesh(axis_names=axes, sizes=sizes, ranks=ranks, rank=_rank(),
                device=dev, backend=backend, device_mesh=device_mesh,
                all_group=all_group, control_group=control_group,
                control_rank=None if ctl == ranks[0] else ctl)


def _grid(axes: Tuple[str, ...], sizes: Tuple[int, ...], device) -> Mesh:
    """A mesh over global ranks ``0 .. prod(sizes)-1``. Every rank of the
    process group calls this (building groups is collective)."""
    n = 1
    for s in sizes:
        n *= s
    if n == 1:
        return single_mesh(device, axes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(axes, sizes))} mesh needs an initialized process "
            f"group (init_distributed) of at least {n} ranks")
    if n > _world():
        raise ValueError(f"a mesh of {n} ranks needs {n} processes, the "
                         f"process group has {_world()}")
    return mesh_over(range(n), axes, sizes, device=device)


class Fleet:
    """The channel of a fleet of replicas carved from one process group
    (``runtime/elastic.carve_submeshes``): its controller (rank 0) runs the
    router and every replica's host half, and announces each replica it
    builds (``JOIN``), retires (``LEAVE``) and the fleet's end (``CLOSE``)
    to every other rank, each of which follows the fleet
    (``replica.follow_fleet``). The commands go over ``control_group``, a
    gloo group of every rank of the process group with the idle timeout,
    from one thread of the controller at a time; ``meshes`` are the
    fleet's meshes, in carving order, and ``members`` the controller's
    replicas announced and not retired, by serial."""

    def __init__(self, controller: int = 0):
        self.controller = controller
        self.control_group = _control_group(range(_world()))
        self.meshes: List[Mesh] = []
        self.members: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._serial = 0

    @property
    def is_controller(self) -> bool:
        return _rank() == self.controller

    def index(self, mesh: Mesh) -> int:
        """The position of ``mesh`` among the fleet's meshes."""
        for i, m in enumerate(self.meshes):
            if m is mesh:
                return i
        return self.meshes.index(mesh)

    def send(self, command: str, fields: Sequence[int] = (),
             tensors: Sequence[torch.Tensor] = ()) -> None:
        with self._lock:
            send_command(self, command, fields, tensors)

    def next_serial(self) -> int:
        with self._lock:
            self._serial += 1
            return self._serial


def make_mesh(cfg: MeshConfig, *, device=None) -> Mesh:
    """A mesh for a ``MeshConfig`` over the first ``cfg.n_devices`` ranks
    (``repro/launch/mesh.py:34``); ``device`` as :func:`rank_device`."""
    return _grid(tuple(cfg.axes), tuple(cfg.shape), device)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A ``("data", "model")`` mesh over the ranks the process group has,
    clipped as upstream clips to ``len(jax.devices())``; without a process
    group, the ``(1, 1)`` mesh."""
    n = _world()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return _grid(("data", "model"), (data, model), device)


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes over which the global batch is sharded."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def pir_cluster_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that enumerate PIR clusters (DB replicas)."""
    return batch_axes(mesh)


def pir_shard_axis(mesh: Mesh) -> Optional[str]:
    """Axis that shards the PIR database inside one cluster."""
    return "model" if "model" in mesh.axis_names else None


def n_clusters(mesh: Mesh) -> int:
    """Clusters of a mesh: the product of its cluster axes' sizes."""
    n = 1
    for a in pir_cluster_axes(mesh):
        n *= mesh_axis_size(mesh, a)
    return n


def cluster_index(mesh: Mesh) -> int:
    """This rank's cluster, row-major over the cluster axes."""
    c = 0
    for a in pir_cluster_axes(mesh):
        c = c * mesh_axis_size(mesh, a) + mesh.coord(a)
    return c
