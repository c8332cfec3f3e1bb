"""Device meshes over ``torch.distributed`` ranks (functions, not module
constants: importing this module touches no process group).

Port of ``repro.launch.mesh``.  A mesh is a ``DeviceMesh`` with named
dimensions, ("data", "model") or ("pod", "data", "model"), over the ranks of
the default process group, one card a rank.  The caller starts the group
(``torch.distributed.init_process_group`` with its address, world size and
rank): nothing here discovers a cluster.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _device_type(device=None) -> str:
    """The mesh's device type: the group's backend decides (gloo: cpu, nccl:
    cuda); with no group, ``device`` (``None``: the CUDA card)."""
    if dist.is_available() and dist.is_initialized():
        backend = str(dist.get_backend()).lower()
        return "cuda" if "nccl" in backend else "cpu"
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) = 256 cards in one pod; (2, 16, 16) = 512 across 2 pods: one
    rank a card.  Raises, with the rank count, where there are fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {have}: start a process group "
            f"of {n} ranks, one a card (torch.distributed.init_process_group)")
    return DeviceMesh(_device_type(device), torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device=None) -> DeviceMesh:
    """A (data, model) mesh over the default group's ranks.  At world size 1,
    or with no process group, a 1 x 1 mesh on the one card (``device``; no
    process groups are made, and the collectives over it are identities
    that its users skip)."""
    n = _world()
    model = max(1, min(model, n))
    data = n // model
    ranks = torch.arange(data * model).reshape(data, model)
    if not (dist.is_available() and dist.is_initialized()):
        return DeviceMesh(_device_type(device), ranks, mesh_dim_names=("data", "model"),
                          _init_backend=False, _rank=0)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def data_axis_size(mesh: DeviceMesh) -> int:
    return int(np.prod([axis_size(mesh, a) for a in mesh.mesh_dim_names
                        if a in ("pod", "data")]))
