"""Parameter templates (port of ``repro.models.params``).

A *template* is a nested dict whose leaves are :class:`PSpec` descriptors
(shape + logical axis names + init kind). From one template come:

* ``init_params(generator, template)`` -> tensors drawn from a
  ``torch.Generator`` on its device, leaf by leaf in the reference's
  pytree order (dict keys sorted at every level);
* ``abstract_params(template)`` -> meta-device tensors (shape and dtype,
  no storage: the counterpart of the reference's ``ShapeDtypeStruct``s);
* ``spec_bytes(template)`` -> the bytes the params take.

The port cannot replay ``jax.random``, so the values differ from the
reference's for a seed; parity runs carry the reference's weights across
instead (``repro_torch.models.convert``). The logical axes map onto a
device mesh with the model-parallel rules, which are not ported yet
(ROADMAP.md M11d).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
