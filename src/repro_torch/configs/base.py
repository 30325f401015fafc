"""Architecture configuration objects (port of ``repro.configs.base``).

The port's own copy of the dataclasses the token models are built from,
with the reference's fields and defaults, so a config describes the same
model in both packages (``MoEConfig`` drives ``repro_torch.models.moe``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n: int = 1                 # every n-th FFN layer is MoE
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: pattern of layer kinds, tiled to n_layers. 'A'=attention 'M'=mamba
    layer_pattern: Optional[str] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    enc_layers: int = 0              # encoder depth (encoder-decoder models)
    enc_input: Optional[str] = None
    max_seq: int = 524_288
    window: int = 8192
    source: str = ""                 # citation

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def kind(self, layer_idx: int) -> str:
        if self.layer_pattern is None:
            return "M" if self.family == "ssm" else "A"
        pat = self.layer_pattern
        return pat[layer_idx % len(pat)]
