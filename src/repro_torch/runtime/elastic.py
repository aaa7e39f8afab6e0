"""Elastic scaling of the port: meshes from the live device set
(``repro/runtime/elastic.py``).

The reference rebuilds a JAX mesh from the live devices and re-shards
onto it. The port's devices are ranks of a process group, one process
each (``launch/mesh.py``): :func:`plan_mesh` is the reference's
arithmetic unchanged, :func:`rebuild_mesh` returns a :class:`Mesh` over
the live ranks in the planned shape, and :func:`carve_submeshes` one mesh
per serve replica, each a disjoint group of ranks holding a whole
database sharded over its own ``(data, model)`` grid, with rank 0 the
fleet's controller. Without a process group (one process: one card, or
the CPU) every mesh is the ``(1, 1)`` mesh of this rank on the group's
first device, so replicas share it as one card serves them.
:func:`reshard` moves tensors onto a device; the reference's moves a tree
onto new shardings, which its checkpoint restore and training use
(ROADMAP A6b-train).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.launch.mesh import (Fleet, Mesh, local_devices, mesh_over,
                                     single_mesh, split_devices)


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


def _live(live_devices: Optional[Sequence]) -> list:
    """The live ranks of the process group (all of them by default), or
    without one the live devices (CUDA's cards by default)."""
    if dist.is_initialized():
        return [int(r) for r in (live_devices if live_devices is not None
                                 else range(dist.get_world_size()))]
    return [torch.device(d) for d in (live_devices if live_devices
                                      is not None else local_devices())]


def _mesh(live: list, cfg: MeshConfig, controller: Optional[int]) -> Mesh:
    """The mesh of ``cfg``'s shape over the first ``cfg.n_devices`` of
    ``live``: ranks under a process group, else this rank's ``(1, 1)``
    mesh on the first device."""
    if not dist.is_initialized():
        return single_mesh(live[0], tuple(cfg.axes))
    return mesh_over(live[:cfg.n_devices], cfg.axes, cfg.shape,
                     controller=controller)


def rebuild_mesh(live_devices: Optional[Sequence] = None, *,
                 model_axis: int, prefer_pods: int = 1) -> Mesh:
    """A mesh in :func:`plan_mesh`'s shape over the first ``n_devices``
    live ranks (every rank of the process group by default; building it
    is collective, so every rank calls this alike), its session controller
    the first. Without a process group: the ``(1, 1)`` mesh of this rank
    on the first live device (CUDA's first card by default)."""
    live = _live(live_devices)
    cfg = plan_mesh(len(live), model_axis=model_axis,
                    prefer_pods=prefer_pods)
    return _mesh(live, cfg, None)


def carve_submeshes(n_replicas: int, *, model_axis: int,
                    live_devices: Optional[Sequence] = None,
                    prefer_pods: int = 1) -> List[Mesh]:
    """One mesh per serve replica, carved from the live ranks
    (``launch/mesh.split_devices``, then each group in :func:`plan_mesh`'s
    shape), so that a replica leaving returns its ranks and a rejoining
    one serves on the same mesh without perturbing its peers. Each keeps
    the pinned ``model`` (DB-shard) axis, so every replica holds a whole
    database sharded the same way.

    Under a process group every rank calls this alike: it builds every
    mesh's groups, and a :class:`~repro_torch.launch.mesh.Fleet` over all
    ranks whose controller, rank 0, is every mesh's session controller
    (inside the grid of the mesh that holds it, outside the others'). With
    fewer than ``n_replicas * model_axis`` ranks the groups would overlap;
    replicas of more than one rank each cannot share ranks, so that raises
    ``ValueError``. Without a process group each mesh is this rank's
    ``(1, 1)`` mesh on its group's first device (``live_devices``, e.g.
    ``["cpu"]``; every CUDA card by default, and without one this raises):
    on one card every replica shares it.
    """
    live = _live(live_devices)
    groups = split_devices(n_replicas, live, min_per_group=model_axis)
    cfgs = [plan_mesh(len(g), model_axis=model_axis,
                      prefer_pods=prefer_pods) for g in groups]
    if not dist.is_initialized():
        return [_mesh(g, cfg, None) for g, cfg in zip(groups, cfgs)]
    used = [r for g, cfg in zip(groups, cfgs) for r in g[:cfg.n_devices]]
    if len(set(used)) < len(used) and max(c.n_devices for c in cfgs) > 1:
        raise ValueError(
            f"{n_replicas} replicas of a model axis of {model_axis} need "
            f"{n_replicas * model_axis} ranks, {len(live)} are live: the "
            f"sub-meshes would overlap, and replicas spanning several ranks "
            f"cannot share them")
    fleet = Fleet(controller=0)
    fleet.meshes.extend(replace(_mesh(g, cfg, fleet.controller), fleet=fleet)
                        for g, cfg in zip(groups, cfgs))
    return list(fleet.meshes)


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
