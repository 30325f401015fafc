"""Production mesh shapes (port of ``repro.launch.mesh``).

A ``torch.distributed`` device mesh needs its ranks to exist, and the dry
run (:mod:`repro_torch.launch.dryrun`) traces on fake tensors in one
process. So a mesh here is a shape only: axis names and their sizes,
which is all that ``rules_for_mesh`` and ``partition_specs`` read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's axes: ``axis_names[i]`` has ``sizes[i]`` devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names}, sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a ``jax`` mesh's ``shape`` reads."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The mesh's device count."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """This host's cards as a 1-D data mesh (one device on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return MeshShape(("data",), (max(n, 1),))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
