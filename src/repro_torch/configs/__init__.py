"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``
(port of ``repro.configs``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ArchConfig, MoEConfig,
                                      ShapeConfig, SSMConfig)

# public arch id -> module name
_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "chameleon-34b": "chameleon_34b",
    "stablelm-3b": "stablelm_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-14b": "qwen3_14b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _mod(arch).reduced()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "ARCHS", "get_config", "get_smoke_config", "get_shape",
]
