"""Device groups of the port (``repro/launch/mesh.py``: ``split_devices``).

The reference builds JAX meshes here; the port has no mesh yet (sharding
one database over several cards is ROADMAP A6b), so it keeps only the
partition the replica plane carves its device groups with.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


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
    """Partition the device list into ``n_groups`` disjoint groups.

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
