"""Parameter templates (port of ``repro.models.params``).

A *template* is a nested dict whose leaves are :class:`PSpec` descriptors
(shape + logical axis names + init kind). From one template come:

* ``init_params(generator, template)`` -> tensors drawn from a
  ``torch.Generator`` on its device, leaf by leaf in the reference's
  pytree order (dict keys sorted at every level);
* ``abstract_params(template)`` -> meta-device tensors (shape and dtype,
  no storage: the counterpart of the reference's ``ShapeDtypeStruct``s);
* ``spec_bytes(template)`` -> the bytes the params take;
* ``partition_specs(template, mesh, rules)`` -> one spec per leaf: a plain
  tuple with one entry a dimension, ``None`` (replicated), a mesh axis
  name or a tuple of them (the reference's ``PartitionSpec``, entry for
  entry).

The port cannot replay ``jax.random``, so the values differ from the
reference's for a seed; parity runs carry the reference's weights across
instead (``repro_torch.models.convert``). A mesh here is anything with
``shape`` (axis name -> size) and ``axis_names``, such as
:class:`repro_torch.launch.mesh.MeshShape`: the specs describe a layout,
and the dry run (:mod:`repro_torch.launch.dryrun`) reads each device's
bytes from them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.models.convert import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"              # normal | zeros | ones | embed | small
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # stacked-layer leading dims are not fan-in; use 2nd-to-last for matmuls
    if len(shape) >= 2:
        return shape[-2]
    return max(shape[0], 1)


def init_leaf(generator: torch.Generator, spec: PSpec,
              dtype=torch.float32) -> torch.Tensor:
    dt = spec.dtype or dtype
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=dev)
    scale = {"normal": 1.0 / math.sqrt(_fan_in(spec.shape)),
             "embed": 0.02, "small": 0.01}[spec.init]
    return (torch.randn(spec.shape, generator=generator, device=dev)
            * scale).to(dt)


def init_params(generator: torch.Generator, template,
                dtype=torch.float32):
    """Tensors for every PSpec of ``template``, on ``generator``'s device,
    drawn in pytree order: keys sorted at every level."""
    return tree_map(lambda s: init_leaf(generator, s, dtype), template)


def abstract_params(template, dtype=torch.bfloat16):
    """Meta-device tensors of every leaf's shape and dtype: nothing is
    allocated."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"),
        template)


def spec_bytes(template, dtype=torch.bfloat16) -> int:
    """Bytes of the params ``template`` describes, in ``dtype`` where a
    leaf names none."""
    return sum(math.prod(s.shape) * (s.dtype or dtype).itemsize
               for s in tree_leaves(template))


# Logical-axis -> mesh-axis rules. A rule value may be a string, a tuple of
# mesh axes, or None.
DEFAULT_RULES = {
    "vocab": "model",
    "embed": "data",       # FSDP-ish: gathered on use, keeps HBM in budget
    "q_heads": "model",    # fused n_heads*head_dim
    "kv_fused": "model",
    "mlp": "model",
    "experts": "model",    # expert parallelism
    "moe_d": "data",       # expert weight d_model dim (FSDP-ish)
    "moe_f": None,         # expert weight hidden dim
    "ssm_in": "model",     # fused d_inner
    "nheads": "model",     # SSD heads
    "hd": "model",         # per-head dim (KV caches)
    "batch": "data",
    "layers": None,
    "seq": None,
}

# one dimension's entry of a spec: replicated, one mesh axis, or several
MeshAxes = Union[None, str, Tuple[str, ...]]


def rules_for_mesh(mesh, overrides=None):
    """DEFAULT_RULES for ``mesh``: its batch over ("pod", "data") where it
    has a pod axis; ``overrides`` on top."""
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh.axis_names:
        rules["batch"] = ("pod", "data")
    if overrides:
        rules.update(overrides)
    return rules


def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def partition_specs(template, mesh, rules=None):
    """Map logical axes to mesh axes, dropping non-divisible shardings and
    mesh axes a leaf already uses: one tuple of :data:`MeshAxes` a leaf."""
    rules = rules or rules_for_mesh(mesh)

    def one(spec: PSpec) -> Tuple[MeshAxes, ...]:
        out = []
        used = set()
        for dim, ax in zip(spec.shape, spec.axes):
            mesh_ax = rules.get(ax) if ax else None
            if mesh_ax is not None:
                flat = (mesh_ax,) if isinstance(mesh_ax, str) \
                    else tuple(mesh_ax)
                if dim % _axis_size(mesh, mesh_ax) != 0 or used & set(flat):
                    mesh_ax = None
                else:
                    used |= set(flat)
            out.append(mesh_ax)
        return tuple(out)

    return tree_map(one, template)
