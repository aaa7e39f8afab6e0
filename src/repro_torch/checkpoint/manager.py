"""Atomic, async checkpointing — the port of
``repro/checkpoint/manager.py``, with the same on-disk layout::

    <root>/step_00000100/
        manifest.json          # step, time, n_leaves, caller's metadata
        proc000.npz            # every leaf, keyed by its path

* **Atomicity** — a save lands in ``step_<k>.tmp`` and is renamed only
  once the arrays and the manifest are written ("commit by rename"); a
  crash mid-write never corrupts the latest checkpoint.
* **Async** — ``save()`` copies the tensors to host memory before it
  returns (the train step then updates them in place) and hands the file
  I/O to a background thread; ``wait()`` joins it and raises what the
  write raised. One save is in flight at a time.
* **Rolling retention** — the newest ``keep`` checkpoints stay.
* **Restore onto any device** — ``restore(tree_like, device=)`` rebuilds
  the tree from the file and places every leaf on ``device`` (default:
  the device of its counterpart in ``tree_like``): the port's analogue of
  the reference's elastic restore under new shardings.

``timings`` keeps the seconds of each host copy (``snapshot_s``), each
file write (``write_s``: the npz, the manifest, the rename, the
retention) and each ``restore`` (``restore_s``), for the run's report.

A tree is nested dicts, tuples, lists and NamedTuples of tensors; a
``None`` leaf holds nothing (the reference's ``()``). A leaf's key is its
path joined by ``/`` (dict keys, NamedTuple field names, sequence
indices). bfloat16 is stored as float32 (npz has no bfloat16) and cast
back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# the reference's file of process 0; the port writes from one process
SHARD_FILE = "proc000.npz"


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    if isinstance(tree, (tuple, list)):
        return ((str(i), v) for i, v in enumerate(tree))
    raise TypeError(f"unsupported checkpoint node {type(tree).__name__}")


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from _leaves(child, f"{prefix}/{name}" if prefix else name)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy, never a view of ``t`` (the train step updates ``t`` in
    place while the copy is written)."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _rebuild(like, arrays: Dict[str, np.ndarray], device, prefix: str = ""):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        if prefix not in arrays:
            raise KeyError(f"leaf {prefix} missing from checkpoint")
        dev = like.device if device is None else device
        return torch.from_numpy(arrays[prefix]).to(device=dev,
                                                   dtype=like.dtype)
    kids = [(name, _rebuild(child, arrays, device,
                            f"{prefix}/{name}" if prefix else name))
            for name, child in _children(like)]
    if isinstance(like, dict):
        return dict(kids)
    values = [v for _, v in kids]
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.timings: Dict[str, List[float]] = {
            "snapshot_s": [], "write_s": [], "restore_s": []}
        os.makedirs(root, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Copy to host memory, then write (in the background unless
        ``blocking``)."""
        self.wait()                       # one in-flight save at a time
        t0 = time.perf_counter()
        flat = {k: _to_host(t) for k, t in _leaves(tree)}
        self.timings["snapshot_s"].append(time.perf_counter() - t0)
        meta = dict(metadata or {})
        meta.update({"step": step, "time": time.time(),
                     "n_leaves": len(flat)})

        def _write():
            t0 = time.perf_counter()
            tmp = os.path.join(self.root, f"step_{step:08d}.tmp")
            final = os.path.join(self.root, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, SHARD_FILE), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)         # the commit point
            self._gc()
            self.timings["write_s"].append(time.perf_counter() - t0)

        if blocking:
            _write()
            return

        def _background():
            try:
                _write()
            except Exception as e:        # handed to wait(), re-raised there
                self._error = e

        self._thread = threading.Thread(target=_background, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                device=None) -> Tuple[Any, dict]:
        """Rebuild ``tree_like``'s structure from checkpoint ``step``
        (default the latest), each leaf in its counterpart's dtype, on
        ``device`` (default: the counterpart's device). Returns (tree,
        manifest)."""
        t0 = time.perf_counter()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        arrays: Dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    for k in z.files:
                        arrays[k] = z[k]
        dev = None if device is None else torch.device(device)
        tree = _rebuild(tree_like, arrays, dev)
        self.timings["restore_s"].append(time.perf_counter() - t0)
        return tree, meta
