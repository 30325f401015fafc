"""Sharding substrate of the port (port of ``repro.sharding``).

Two families of helpers live here:

* **Model-parallel parameter sharding**: logical-axis rules mapped to one
  spec tuple a leaf (re-exported from ``repro_torch.models.params``):
  ``DEFAULT_RULES``, ``partition_specs``, ``rules_for_mesh``. The dry run
  (``repro_torch.launch.dryrun``) reads each device's bytes from them.
* **Meshes of ranks**: the 1-D ``"cohort"`` mesh that the sharded FL
  engine splits device *slots* over while model parameters are
  replicated, and the 1-D ``"pod"`` mesh of the two-stage pipeline
  (``repro_torch.launch.pipeline``), built the same way.

The reference maps one program over the devices of a ``jax`` mesh from a
single controller (``jax.shard_map``). The port runs one process per rank
and takes the mesh to be a ``torch.distributed`` process group, because

* that is PyTorch's idiom for data parallelism (one process per device,
  started by ``torchrun`` or ``torch.multiprocessing``);
* it scales across nodes unchanged, where one process over many devices
  stops at one host;
* its CPU tests run real multi-rank reductions under gloo, where the
  reference needs a forced multi-device CPU platform.

Every rank runs the same ``Simulation`` on the same seeds, so decisions,
queues and packing agree without any exchange; a rank trains its own block
of each tier's slots, and a round's FedAvg is one ``all_reduce`` (sum) of
masked partial sums (``repro_torch.fl.shard``). Only ``all_reduce`` and
``barrier`` are used: gloo takes CUDA tensors for those (not for
``all_gather``), so NCCL on the card, gloo on the CPU and gloo on the card
run the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import (DEFAULT_RULES, partition_specs,
                                       rules_for_mesh)

# the mesh axis the sharded cohort engine splits device slots over
COHORT_AXIS = "cohort"
# the mesh axis of the two pipeline stages
POD_AXIS = "pod"


@dataclasses.dataclass(frozen=True, eq=False)
class CohortMesh:
    """A 1-D mesh of ranks: ``size`` ranks, this process's ``rank`` among
    them, the process group their reductions run in (``None``: no process
    group, one rank, every reduction the identity) and the axis's name."""
    size: int
    rank: int
    group: Optional[object] = None
    axis: str = COHORT_AXIS

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, as a ``jax`` mesh's ``shape`` reads."""
        return {self.axis: self.size}

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    def block(self, rows: int) -> slice:
        """This rank's contiguous block of ``rows`` (a multiple of the mesh
        size): rank r holds rows [r rows / n, (r + 1) rows / n)."""
        per = rows // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        if self.group is not None:
            dist.barrier(group=self.group)


# mesh_shape -> (the default group it was built under, the group built)
_GROUPS: Dict[Optional[Tuple[int, ...]], tuple] = {}


def cohort_mesh(mesh_shape: Optional[Tuple[int, ...]] = None) -> CohortMesh:
    """The cohort mesh for the sharded FL engine.

    ``mesh_shape`` is the (optionally multi-dim, flattened) rank count to
    ask for; ``None`` takes every rank of the default process group. The
    mesh clamps to what there is, down to one rank, as the reference's
    does: with no process group initialized it has size 1 and its
    reduction is the identity (the reference's 1-device mesh); a group of
    one rank runs its reductions through the group. A mesh smaller than the
    world is a ``new_group`` of the first ranks: every rank of the world
    must call this (``new_group`` is collective), and a rank outside the
    mesh raises ``ValueError``.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return CohortMesh(1, 0, None)
    world = dist.get_world_size()
    want = world if mesh_shape is None else int(np.prod(mesh_shape))
    n = max(1, min(want, world))
    key = None if mesh_shape is None else tuple(mesh_shape)
    hit = _GROUPS.get(key)
    if hit is None or hit[0] is not dist.group.WORLD:
        group = dist.group.WORLD if n == world \
            else dist.new_group(list(range(n)))
        hit = _GROUPS[key] = (dist.group.WORLD, group)
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the cohort mesh of {n} "
                         f"ranks (mesh_shape={mesh_shape}, world {world})")
    return CohortMesh(n, rank, hit[1])


def pod_mesh(n_stages: Optional[int] = None) -> CohortMesh:
    """The 1-D ``"pod"`` mesh of the pipeline's stages: :func:`cohort_mesh`
    of ``(n_stages,)`` ranks (``None``: the whole world) under the axis
    name ``POD_AXIS``, one process a stage."""
    mesh = cohort_mesh(None if n_stages is None else (n_stages,))
    return dataclasses.replace(mesh, axis=POD_AXIS)


__all__ = ["DEFAULT_RULES", "partition_specs", "rules_for_mesh",
           "COHORT_AXIS", "POD_AXIS", "CohortMesh", "cohort_mesh",
           "pod_mesh"]
