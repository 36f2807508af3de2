"""The device mesh, on one device.

The port of ``src/repro/launch/mesh.py`` for one card: ``make_local_mesh``
gives the reference's axis names, ``("data", "model")``, over a (1, 1)
array holding the one device, which is what the launcher's banner reads.
Meshes over several cards, and ``make_production_mesh``, come with the
multi-GPU slice (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    axis_names: Tuple[str, ...]
    devices: np.ndarray            # one torch.device per mesh position

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh: meshes over several cards come with the "
        "multi-GPU slice (ROADMAP queue 1, item 3)")


def make_local_mesh(device: Union[str, torch.device, None] = None
                    ) -> LocalMesh:
    """A (1, 1) ``("data", "model")`` mesh over one device: the card
    unless ``device`` names another."""
    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = resolve_device(device, "make_local_mesh")
    return LocalMesh(("data", "model"), devices)
