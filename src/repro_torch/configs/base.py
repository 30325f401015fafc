"""Architecture + input-shape configuration objects (port of
``repro.configs.base``).

The port's own copy of the dataclasses the token models are built from,
with the reference's fields, defaults and parameter counts, so a config
describes the same model in both packages. Every published architecture
has one module in this package exporting ``CONFIG`` (the exact published
shape, cited) and ``reduced()`` (a smoke-test variant: <=2 layers,
d_model<=512, <=4 experts) of the same family.
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
    # encoder-decoder (audio): n_layers is decoder depth
    enc_layers: int = 0
    enc_input: Optional[str] = None  # 'audio_frames' -> frontend stub embeds
    max_seq: int = 524_288
    # sliding-window used for long_500k decode on full-attention archs
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

    @property
    def n_params(self) -> int:
        """Total parameter count (embeddings + blocks), used for 6ND."""
        return _count_params(self, active_only=False)

    @property
    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        return _count_params(self, active_only=True)


def _ffn_params(cfg: ArchConfig, active_only: bool, layer_idx: int = 0) -> int:
    if cfg.d_ff == 0:
        return 0
    swiglu = 3 * cfg.d_model * cfg.d_ff
    moe = cfg.moe
    is_moe = moe is not None and (layer_idx % moe.every_n == moe.every_n - 1)
    if not is_moe:
        return swiglu
    mult = moe.top_k if active_only else moe.n_experts
    router = cfg.d_model * moe.n_experts
    return router + mult * swiglu


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.hd
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _mamba_params(cfg: ArchConfig) -> int:
    s = cfg.ssm or SSMConfig()
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    in_proj = cfg.d_model * (2 * d_in + 2 * s.d_state + nh)
    conv = s.d_conv * (d_in + 2 * s.d_state)
    out = d_in * cfg.d_model
    return in_proj + conv + out + 2 * nh  # + A_log, D


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    total = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.n_layers):
        if cfg.kind(i) == "A":
            total += _attn_params(cfg)
        else:
            total += _mamba_params(cfg)
        total += _ffn_params(cfg, active_only, i)
        total += 2 * cfg.d_model  # norms
    for _ in range(cfg.enc_layers):
        total += _attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model
    if cfg.enc_layers:  # decoder cross-attention
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
