"""Persistent JSON plan cache: measured plans survive the process.

Port of ``repro/engine/cache.py``. The cache maps

    (device key, protocol, DatabaseSpec signature, bucket)  ->  ExecutionPlan

where the device key names the card (``cuda:<torch.cuda.get_device_name>``)
or ``cpu``: a plan tuned on one card is a miss on another. Lookup happens
once per bucket when ``BucketedServeFns`` resolves its plans (never on the
dispatch path); a hit returns the tuned plan (provenance ``"tuned"``), a
miss falls through to the heuristic, so a machine without a cache file
resolves exactly what ``plan_for`` resolves.

Robustness contract: a missing, corrupted, stale-schema or bad-entry cache
file degrades to "no cache" — a tuning artifact can never take serving
down. Writes are atomic (tmp + rename), so a crashed tuner cannot leave a
torn file.

Location: ``REPRO_TORCH_PLAN_CACHE``; unset -> ``results/plan_cache_torch.json``
relative to the working directory; ``off``/``none``/``0`` disable
persistence. The name and the file are the port's own, so neither package
reads the other's cache and a test that sets one never flips the other.
``PlanCache(path, chaos=)`` visits the ``plan_cache.load`` chaos seam: a
kill or a drop there degrades the load like a torn file.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import torch

SCHEMA_VERSION = 1
DEFAULT_PATH = os.path.join("results", "plan_cache_torch.json")
CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"

#: ExecutionPlan fields a cache entry round-trips; provenance is stored
#: beside them, per entry
_PLAN_FIELDS = ("expand", "scan", "chunk_log", "tile_r")


def cache_path() -> Optional[str]:
    """The configured cache file, or None when persistence is disabled."""
    raw = os.environ.get(CACHE_ENV)
    if raw is None:
        return DEFAULT_PATH
    raw = raw.strip()
    if raw.lower() in ("", "off", "none", "0"):
        return None
    return raw


def device_key(device) -> str:
    """The cache's device axis: ``cuda:<card name>`` or ``cpu``.

    ``device`` is a ``torch.device``, a device string or a backend name;
    ``cuda`` and ``cuda:0`` name the same card. Without a card, a ``cuda``
    request keys as plain ``cuda`` (only a miss can follow).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            return "cuda"
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def plan_key(device: str, protocol: str, spec_sig: str, bucket: int) -> str:
    return f"{device}|{protocol}|{spec_sig}|b{bucket}"


def spec_signature(cfg) -> str:
    """DatabaseSpec signature of a PIRConfig: the shape axes plan
    selection depends on (``"+c"`` marks a checksummed config)."""
    sig = f"{cfg.n_items}x{cfg.item_bytes}"
    if getattr(cfg, "checksum", False):
        sig += "+c"
    return sig


def plan_to_dict(plan) -> Dict:
    return {f: getattr(plan, f) for f in _PLAN_FIELDS}


def plan_from_dict(d: Dict, provenance: str = "tuned"):
    from repro_torch.core.protocol import ExecutionPlan
    unknown = set(d) - set(_PLAN_FIELDS)
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    fields = {f: d[f] for f in _PLAN_FIELDS if f in d}
    for f in ("expand", "scan"):
        if f not in fields or not isinstance(fields[f], str):
            raise ValueError(f"plan entry missing/invalid {f!r}")
    for f in ("chunk_log", "tile_r"):
        if f in fields and (not isinstance(fields[f], int)
                            or isinstance(fields[f], bool)):
            raise ValueError(f"plan entry field {f!r} is not an int")
    return ExecutionPlan(provenance=provenance, **fields)


def _check_servable(device: str, protocol: str, plan) -> None:
    """Raise ValueError for a plan that launches no kernel under a ``cuda``
    device key (``engine.kernels.launches_kernel``)."""
    if device.split(":")[0] != "cuda":
        return
    from repro_torch.core.protocol import get
    from repro_torch.engine.kernels import launches_kernel
    if not launches_kernel(plan, get(protocol).share_kind):
        raise ValueError(f"plan {plan.name!r} of {protocol} launches no "
                         f"kernel; {device} serves kernels only")


class PlanCache:
    """In-memory mirror of the JSON plan store.

    ``path=None`` is a purely in-memory cache (persistence disabled);
    ``save()`` is then a no-op. ``repro_torch.engine`` holds one process-
    wide instance for ``resolve``; tests and the tuner make their own.
    """

    def __init__(self, path: Optional[str] = None, *, chaos=None):
        self.path = path
        self.plans: Dict[str, Dict] = {}
        self.load_error: Optional[str] = None
        #: optional ChaosInjector consulted at the plan_cache.load seam
        self.chaos = chaos
        if path is not None:
            self._load(path)

    def _load(self, path: str) -> None:
        if self.chaos is not None:
            from repro_torch.chaos import InjectedFault
            try:
                hits = self.chaos.visit("plan_cache.load")  # raises on kill
            except InjectedFault as e:
                # the torn-file path: serving never dies on a tuning artifact
                self.load_error = f"{type(e).__name__}: {e}"
                return
            if any(ev.action == "drop" for ev in hits):
                self.load_error = ("InjectedFault: chaos drop at "
                                   "plan_cache.load")
                return
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or raw.get("schema") \
                    != SCHEMA_VERSION:
                schema = raw.get("schema") if isinstance(raw, dict) else None
                raise ValueError(f"stale cache schema {schema!r} "
                                 f"(want {SCHEMA_VERSION})")
            plans = raw.get("plans", {})
            if not isinstance(plans, dict):
                raise ValueError("malformed 'plans' table")
            # validate every entry now: one bad row must not be able to
            # crash plan resolution later
            for entry in plans.values():
                plan_from_dict(entry["plan"])
            self.plans = plans
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self.load_error = f"{type(e).__name__}: {e}"
            self.plans = {}

    def save(self) -> Optional[str]:
        if self.path is None:
            return None
        folder = os.path.dirname(self.path) or "."
        os.makedirs(folder, exist_ok=True)
        payload = {"schema": SCHEMA_VERSION, "plans": self.plans}
        fd, tmp = tempfile.mkstemp(dir=folder, prefix=".plan_cache_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return os.path.abspath(self.path)

    def get(self, device: str, protocol: str, spec_sig: str, bucket: int):
        """The entry's plan, or None on a miss. An entry under a ``cuda``
        key whose plan launches no kernel is refused (a miss): on the card
        the engine serves kernels only."""
        entry = self.plans.get(plan_key(device, protocol, spec_sig, bucket))
        if entry is None:
            return None
        try:
            plan = plan_from_dict(entry["plan"],
                                  entry.get("provenance", "tuned"))
            _check_servable(device, protocol, plan)
        except (ValueError, KeyError, TypeError):
            return None
        return plan

    def put(self, device: str, protocol: str, spec_sig: str, bucket: int,
            plan, meta: Optional[Dict] = None,
            provenance: str = "tuned") -> None:
        _check_servable(device, protocol, plan)
        self.plans[plan_key(device, protocol, spec_sig, bucket)] = {
            "plan": plan_to_dict(plan), "meta": meta or {},
            "provenance": provenance,
        }

    def warm_put(self, device: str, protocol: str, spec_sig: str,
                 bucket: int, plan, meta: Optional[Dict] = None) -> bool:
        """Seed an entry only if the slot is empty (provenance ``"warm"``);
        a tuned entry always wins. Returns whether an entry was written."""
        _check_servable(device, protocol, plan)
        key = plan_key(device, protocol, spec_sig, bucket)
        if key in self.plans:
            return False
        self.plans[key] = {"plan": plan_to_dict(plan), "meta": meta or {},
                           "provenance": "warm"}
        return True

    def __len__(self) -> int:
        return len(self.plans)
