"""Parameter templates (port of ``repro.models.params``).

A *template* is a nested dict whose leaves are :class:`PSpec` descriptors
(shape + logical axis names + init kind); :func:`init_params` turns it
into tensors drawn from a ``torch.Generator``, leaf by leaf in the
reference's pytree order (dict keys sorted at every level). The port
cannot replay ``jax.random``, so the values differ from the reference's
for a seed; parity runs carry the reference's weights across instead
(``repro_torch.models.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"              # normal | zeros | ones | embed | small
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # stacked-layer leading dims are not fan-in; use 2nd-to-last for matmuls
    if len(shape) >= 2:
        return shape[-2]
    return max(shape[0], 1)


def init_leaf(generator: torch.Generator, spec: PSpec,
              dtype=torch.float32) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt)
    scale = {"normal": 1.0 / math.sqrt(_fan_in(spec.shape)),
             "embed": 0.02, "small": 0.01}[spec.init]
    return (torch.randn(spec.shape, generator=generator) * scale).to(dt)


def init_params(generator: torch.Generator, template,
                dtype=torch.float32):
    """Tensors for every PSpec of ``template`` (on the CPU; callers move
    them), drawn in pytree order: keys sorted at every level."""
    if isinstance(template, dict):
        return {k: init_params(generator, template[k], dtype)
                for k in sorted(template)}
    return init_leaf(generator, template, dtype)
