"""Device meshes: one process, a group of ranks, the production layouts.

The port of ``src/repro/launch/mesh.py``. A function, not a module-level
constant: importing this module touches no device and no process group.

- ``make_local_mesh`` is the reference's mesh over whatever exists: in one
  process the ``(1, 1)`` ``LocalMesh`` over one device (the card unless
  the caller names another); under an initialised process group a
  ``DeviceMesh`` of ``(W // model_parallel, model_parallel)`` over the
  world's ranks, axes ``("data", "model")``.
- ``make_production_mesh`` is ``(16, 16)`` ``("data", "model")`` or
  ``(2, 16, 16)`` ``("pod", "data", "model")`` over a world of that many
  ranks; the rules resolve onto those shapes without ranks through
  ``sharding.resolve_spec(..., {axis: size})``.
- ``init_ranks`` joins a process group and sets each rank's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    axis_names: Tuple[str, ...]
    devices: np.ndarray            # one torch.device per mesh position

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def pick_backend(device: Union[str, torch.device, None], world: int) -> str:
    """NCCL when every one of ``world`` ranks can have a card of its own,
    gloo otherwise (the host, or ranks sharing a card: NCCL refuses two
    ranks on one device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_ranks(backend: str, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: str = "env://",
               device: Union[str, torch.device, None] = None
               ) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``. The device is ``cuda:(rank % device_count)``, set as
    the current card, unless ``device`` names the CPU; several ranks then
    share a card when there are fewer cards than ranks (gloo only: NCCL
    refuses two ranks on one device). Under gloo on the card the
    functional collectives that gloo cannot run on CUDA tensors are staged
    through the host (``collectives.stage_gloo_functional``).
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    dev = resolve_device(device, "init_ranks")
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    if backend == "gloo" and dev.type == "cuda":
        from repro_torch.dist import collectives

        collectives.stage_gloo_functional()
    return dev


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                 device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device, None] = None):
    """The ``(16, 16)`` mesh, or ``(2, 16, 16)`` with ``multi_pod``, over
    a world of exactly that many ranks; a ``ValueError`` otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"make_production_mesh: the {shape} mesh needs a "
                         f"world of {need} ranks; this one has {world}")
    return _device_mesh(shape, names,
                        resolve_device(device, "make_production_mesh").type)


def make_local_mesh(model_parallel: int = 1,
                    device: Union[str, torch.device, None] = None):
    """The mesh over whatever exists: a ``(1, 1)`` ``LocalMesh`` over one
    device in one process, a ``(W // model_parallel, model_parallel)``
    ``DeviceMesh`` under a process group of ``W`` ranks."""
    dev = resolve_device(device, "make_local_mesh")
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError("model_parallel > 1 needs a process group")
        devices = np.empty((1, 1), dtype=object)
        devices[0, 0] = dev
        return LocalMesh(("data", "model"), devices)
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world of {world} ranks")
    return _device_mesh((world // model_parallel, model_parallel),
                        ("data", "model"), dev.type)
