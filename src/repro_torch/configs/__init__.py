"""Architecture configurations: the port's own copy of the dataclasses.

The reference's registry of published architectures (``ARCHS``,
``get_config``, ``get_smoke_config``) and its shape table (``ShapeConfig``,
``SHAPES``, ``get_shape``) serve the LM and launch side, not ported yet
(ROADMAP.md M11).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig"]
