"""Op-level cost of a PyTorch step: FLOPs, bytes, collective bytes and the
peak of live tensor bytes.

The counterpart of ``repro/analysis/hlo_cost.py``. The reference lowers a
step to optimized HLO without allocating anything and counts each
instruction of the text. The port runs the step itself, normally on
``meta`` tensors (shapes and dtypes, no storage), under a
``TorchDispatchMode`` that sees every aten op the step dispatches, its
backward and its optimizer included:

  flops       matrix-class ops only (mm, addmm, bmm, baddbmm, the
              convolutions and the attention ops), through
              ``torch.utils.flop_counter.flop_registry``; every other op
              that launches a kernel adds one FLOP per output element to
              ``elem_flops`` (reported aside, as the reference's VPU-class
              count)
  bytes       each op that launches a kernel pays for its operands plus
              its outputs. Eager PyTorch fuses nothing, so every op is a
              kernel boundary: this is the HBM-traffic proxy ``hlo_cost``
              takes at fusion boundaries. Views (``view``, ``slice``,
              ``transpose``, ``expand``, ``as_strided``, ...) and
              allocations (``empty``) cost nothing. Gather-type ops
              (``embedding``, ``index_select``, ``gather``,
              ``index.Tensor``) pay for the rows they read and write and
              their indices, not the whole operand (the reference's
              ``dynamic-slice`` rule). Writes into a region
              (``index_copy_``, ``index_put_``, ``index_add_``,
              ``scatter*_``) pay for the rows they write and read, and
              ``copy_`` for its source and destination; every other
              in-place op (``add_``, ``mul_``) pays for the views it reads
              and writes, not for the storage behind them
  collective  output bytes of every ``c10d`` / ``_c10d_functional``
              collective by kind (``all-reduce``, ``all-gather``,
              ``reduce-scatter``, ``all-to-all``, ``collective-permute``;
              ``broadcast`` under its own name)
  peak live   the largest sum of live storage bytes over the run: the
              storages reachable from the arguments (and from ``resident``)
              and those an op reads that existed before the call count from
              the start; every storage an op creates is added when it
              appears and subtracted when it is freed (a weak reference to
              the storage; ``torch.utils.checkpoint``'s recompute and
              autograd's saved tensors are seen as they happen)

The port's six kernels (the ``repro_torch::`` custom ops) pay for their
operands plus their outputs and 0 FLOPs, as ``hlo_cost`` treats a
``custom-call``; on meta tensors they run through the fakes registered
beside each op (``kernels/*.py``).

Loops need no trip count: the step's Python loops (layers,
microbatches, SSD chunks, the sLSTM's time steps) run in full, each
iteration dispatching its own ops. That is why the port has no
counterpart of ``hlo_cost``'s loop recovery, and ``unknown_loops`` is
always 0. A step that reads a value on the host (``.item()``,
``nonzero``) raises on meta; the caller records the failure.

Totals are for the one device the step runs on.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.roofline import tensor_bytes

aten = torch.ops.aten

#: matrix-class ops: their FLOPs come from ``flop_registry``
_MATRIX = frozenset(p for p in flop_registry
                    if isinstance(p, torch._ops.OpOverloadPacket))

#: ops that launch no kernel (besides every op whose schema is a view)
_FREE = frozenset({
    aten.detach, aten._unsafe_view, aten.alias, aten.lift_fresh,
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size, aten._local_scalar_dense,
    aten.set_, aten.resize_, aten._has_compatible_shallow_copy_type,
})

#: gathers: (operands that are indices) read and write only their rows
_GATHER = frozenset({aten.embedding, aten.index_select, aten.gather,
                     aten.index})

#: region writes: argument position of the source (or values) tensor
_REGION_WRITE = {aten.index_copy_: 3, aten.index_put_: 2,
                 aten.index_add_: 3, aten.scatter_: 3,
                 aten.scatter_add_: 3, aten.scatter_reduce_: 3}

#: collective op name (without a trailing underscore) -> kind
_COLLECTIVE_KIND = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "broadcast",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")


@dataclass
class Cost:
    """``hlo_cost.Cost``'s fields, and the live-bytes figures."""
    flops: float = 0.0           # matrix-class ops only
    elem_flops: float = 0.0      # one per output element of other kernels
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    unknown_loops: int = 0       # always 0: loops run in full
    coll_count_by_kind: Dict[str, int] = field(default_factory=dict)
    peak_live_bytes: int = 0
    #: bytes of the storages reachable from the arguments and ``resident``
    #: when the call began
    argument_bytes: int = 0
    #: bytes of the storages the call returns that it did not receive
    output_bytes: int = 0
    n_ops: int = 0               # ops dispatched


def _nbytes(t: torch.Tensor) -> int:
    return tensor_bytes(t.dtype, t.shape)


def _tensors(x):
    """The tensors of an op's arguments or outputs (one level of lists)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                yield y
            elif isinstance(y, (list, tuple)):
                yield from (z for z in y if isinstance(z, torch.Tensor))


def _walk(obj, seen: set, depth: int = 0):
    """Every tensor reachable from ``obj``: containers, modules (their
    parameters and buffers), dataclasses and plain objects' attributes."""
    if depth > 6 or id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _walk(v, seen, depth + 1)
    elif isinstance(obj, (list, tuple, set)):
        for v in obj:
            yield from _walk(v, seen, depth + 1)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():
            yield from _walk(v, seen, depth + 1)


class _Counter(TorchDispatchMode):

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.known: Dict[int, int] = {}     # storage key -> bytes
        self.refs: Dict[int, weakref.ref] = {}
        self.resident = 0                   # storages from before the call
        self.live = 0                       # storages made by the call
        self.peak = 0

    def add_resident(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.known:
            self.known[key] = n = st.nbytes()
            self.resident += n

    def _add_new(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known:
            return
        self.known[key] = n = st.nbytes()
        self.live += n

        def freed(_, key=key, n=n):
            self.live -= n
            self.known.pop(key, None)
            self.refs.pop(key, None)
        self.refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for a in (*args, *kwargs.values()) for t in _tensors(a)]
        for t in ins:
            if t.untyped_storage()._cdata not in self.known:
                self.add_resident(t)
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self._add_new(t)
        self.peak = max(self.peak, self.live)
        self._charge(func, args, kwargs, ins, out, outs)
        return out

    def _charge(self, func, args, kwargs, ins, out, outs) -> None:
        c = self.cost
        c.n_ops += 1
        packet = func.overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_KIND.get(packet.__name__.rstrip("_"))
            if kind is None:            # wait_tensor and other bookkeeping
                return
            nbytes = sum(_nbytes(t) for t in outs)
            c.coll_bytes += nbytes
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + nbytes
            c.coll_count_by_kind[kind] = c.coll_count_by_kind.get(kind, 0) + 1
            c.bytes += sum(_nbytes(t) for t in ins) + nbytes
            return
        if ns == "repro_torch":         # a kernel of the port: custom-call
            c.bytes += (sum(_nbytes(t) for t in ins)
                        + sum(_nbytes(t) for t in outs))
            return
        if packet in _FREE or func.is_view:
            return
        if packet in _MATRIX:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            c.bytes += (sum(_nbytes(t) for t in ins)
                        + sum(_nbytes(t) for t in outs))
            return
        out_bytes = sum(_nbytes(t) for t in outs)
        c.elem_flops += sum(t.numel() for t in outs)
        if packet in _GATHER:
            # the rows read and written, and the indices
            src = args[0]
            c.bytes += 2 * out_bytes + sum(
                _nbytes(t) for t in ins if t is not src)
        elif packet in _REGION_WRITE:
            pos = _REGION_WRITE[packet]
            rest = list(_tensors(args[1:pos])) + list(_tensors(args[pos + 1:]))
            src = list(_tensors(args[pos:pos + 1]))
            c.bytes += (2 * sum(_nbytes(t) for t in src)
                        + sum(_nbytes(t) for t in rest))
        elif packet is aten.copy_:
            c.bytes += _nbytes(args[0]) + _nbytes(args[1])
        else:
            c.bytes += sum(_nbytes(t) for t in ins) + out_bytes


def analyze(fn, *args, resident=(), **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once under the counter; its cost.

    ``resident``: further objects whose tensors are live from the start
    (a module whose parameters the call reads by closure). Pass meta
    tensors for a dry run; CPU tensors run (and count) as well.
    """
    cost = Cost()
    counter = _Counter(cost)
    seen: set = set()
    for obj in (args, kwargs, resident):
        for t in _walk(obj, seen):
            counter.add_resident(t)
    cost.argument_bytes = counter.resident
    given = set(counter.known)
    with counter:
        result = fn(*args, **kwargs)
    cost.peak_live_bytes = counter.resident + counter.peak
    returned = {}
    for t in _walk(result, set()):
        st = t.untyped_storage()
        if st._cdata not in given:
            returned[st._cdata] = st.nbytes()
    cost.output_bytes = sum(returned.values())
    return cost
