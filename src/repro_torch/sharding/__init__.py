"""The cohort mesh of the sharded FL engine (port of ``repro.sharding``'s
cohort half): a 1-D ``"cohort"`` axis of ranks that device *slots* are
split over while model parameters are replicated.

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

The model-parallel half of the reference module (``DEFAULT_RULES``,
``partition_specs``, ``rules_for_mesh``) belongs to the LM side's
multi-device launch, not ported yet (ROADMAP.md M11d).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the mesh axis the sharded cohort engine splits device slots over
COHORT_AXIS = "cohort"


@dataclasses.dataclass(frozen=True, eq=False)
class CohortMesh:
    """A 1-D cohort mesh: ``size`` ranks, this process's ``rank`` among
    them, and the process group their reductions run in (``None``: no
    process group, one rank, every reduction the identity)."""
    size: int
    rank: int
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        """``{COHORT_AXIS: size}``, as a ``jax`` mesh's ``shape`` reads."""
        return {COHORT_AXIS: self.size}

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


__all__ = ["COHORT_AXIS", "CohortMesh", "cohort_mesh"]
