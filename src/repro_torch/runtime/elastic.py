"""Elastic scaling of the port: device groups from the live device set
(``repro/runtime/elastic.py``).

The reference rebuilds a JAX mesh from the live devices and re-shards
onto it. The port serves each replica's whole database from one card
(sharding one replica over several cards is ROADMAP A6b), so a "mesh"
here is a device group: :func:`plan_mesh` is the reference's arithmetic
unchanged, :func:`rebuild_mesh` returns the devices that grid uses,
:func:`carve_submeshes` one group per replica, and :func:`reshard` moves
tensors onto a device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import MeshConfig
from repro_torch.launch.mesh import local_devices, split_devices


def plan_mesh(n_devices: int, *, model_axis: int,
              prefer_pods: int = 1) -> MeshConfig:
    """Choose the largest (pod, data, model) grid for the live device count.

    ``model_axis`` is fixed; data = n_devices // (model * pods), rounded to
    the largest power of two that fits (unused devices idle until the next
    resize)."""
    if n_devices < model_axis:
        raise ValueError(f"{n_devices} devices < model axis {model_axis}")
    per_pod = n_devices // prefer_pods
    data = 1
    while data * 2 * model_axis <= per_pod:
        data *= 2
    if prefer_pods > 1:
        return MeshConfig(shape=(prefer_pods, data, model_axis),
                          axes=("pod", "data", "model"))
    return MeshConfig(shape=(data, model_axis), axes=("data", "model"))


def rebuild_mesh(live_devices: Optional[Sequence] = None, *,
                 model_axis: int, prefer_pods: int = 1
                 ) -> List[torch.device]:
    """The devices :func:`plan_mesh`'s grid uses, in order (the first
    ``n_devices`` of the live list; CUDA's cards by default)."""
    devs = [torch.device(d) for d in (live_devices if live_devices
                                      is not None else local_devices())]
    cfg = plan_mesh(len(devs), model_axis=model_axis,
                    prefer_pods=prefer_pods)
    return devs[:cfg.n_devices]


def carve_submeshes(n_replicas: int, *, model_axis: int,
                    live_devices: Optional[Sequence] = None,
                    prefer_pods: int = 1) -> List[List[torch.device]]:
    """One device group per serve replica, carved from the live device set
    (``launch/mesh.split_devices``, then :func:`rebuild_mesh`), so that a
    replica leaving returns its devices and a rejoining one gets a fresh
    group without perturbing its peers. A replica serves from its group's
    first device.

    With fewer than ``n_replicas * model_axis`` devices the groups share
    the full device set: on one card every replica gets ``cuda:0``. The
    default device list is every CUDA card; without one this raises
    unless ``live_devices`` is given.
    """
    devs = list(live_devices if live_devices is not None
                else local_devices())
    groups = split_devices(n_replicas, devs, min_per_group=model_axis)
    return [rebuild_mesh(g, model_axis=model_axis, prefer_pods=prefer_pods)
            for g in groups]


def reshard(tree: Any, device) -> Any:
    """Move every tensor (or numpy array) of a nested dict / list / tuple
    onto ``device``; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: reshard(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
