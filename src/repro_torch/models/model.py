"""Parameter templates and forward building blocks of the decoder-only
token models (port of the parts of ``repro.models.model`` the split models
use).

Templates mirror the reference's leaf for leaf (shapes, logical axes,
init kinds), so :func:`repro_torch.models.params.init_params` draws the
same structure. The building blocks are slot-batched: activations are
``(S, B, seq, D)`` and every weight is per slot (a leading ``S`` axis; a
stride-0 expanded view when shared). The encoder-decoder path, qkv
biases, qk-norm, the MoE FFN and the LLM stack's forward are not ported
yet: their templates raise (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, slot_mm, swiglu
from repro_torch.models.params import PSpec


def pattern_of(cfg: ArchConfig) -> str:
    if cfg.layer_pattern is not None:
        return cfg.layer_pattern
    return "M" if cfg.family == "ssm" else "A"


def n_units(cfg: ArchConfig) -> int:
    pat = pattern_of(cfg)
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.n_layers} layers do not tile pattern {pat!r}")
    return cfg.n_layers // len(pat)


def _attn_template(cfg: ArchConfig, u: int) -> Dict[str, PSpec]:
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("qkv biases and qk-norm are not ported "
                                  "yet (no FL config uses them)")
    d, hd = cfg.d_model, cfg.hd
    nh, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": PSpec((u, d, nh * hd), ("layers", "embed", "q_heads")),
        "wk": PSpec((u, d, kv * hd), ("layers", "embed", "kv_fused")),
        "wv": PSpec((u, d, kv * hd), ("layers", "embed", "kv_fused")),
        "wo": PSpec((u, nh * hd, d), ("layers", "q_heads", "embed")),
    }


def _ffn_template(cfg: ArchConfig, u: int,
                  layer_in_unit: int) -> Optional[Dict[str, PSpec]]:
    if cfg.d_ff == 0:
        return None
    d, f = cfg.d_model, cfg.d_ff
    moe = cfg.moe
    if moe is not None and layer_in_unit % moe.every_n == moe.every_n - 1:
        raise NotImplementedError("the MoE FFN (models/moe.py) is not "
                                  "ported yet; see ROADMAP.md")
    return {
        "w1": PSpec((u, d, f), ("layers", "embed", "mlp")),
        "w3": PSpec((u, d, f), ("layers", "embed", "mlp")),
        "w2": PSpec((u, f, d), ("layers", "mlp", "embed")),
    }


def _mamba_template(cfg: ArchConfig, u: int) -> Dict[str, PSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in, n, ds = s.d_inner(d), s.n_heads(d), s.d_state
    conv_ch = d_in + 2 * ds
    return {
        "w_xz": PSpec((u, d, 2 * d_in), ("layers", "embed", "ssm_in")),
        "w_bc": PSpec((u, d, 2 * ds), ("layers", "embed", None)),
        "w_dt": PSpec((u, d, n), ("layers", "embed", "nheads")),
        "dt_bias": PSpec((u, n), ("layers", "nheads"), "zeros"),
        "a_log": PSpec((u, n), ("layers", "nheads"), "zeros"),
        "d_skip": PSpec((u, n), ("layers", "nheads"), "ones"),
        "conv_w": PSpec((u, s.d_conv, conv_ch), ("layers", None, "ssm_in")),
        "conv_b": PSpec((u, conv_ch), ("layers", "ssm_in"), "zeros"),
        "norm": PSpec((u, d_in), ("layers", "ssm_in"), "ones"),
        "w_out": PSpec((u, d_in, d), ("layers", "ssm_in", "embed")),
    }


def _unit_template(cfg: ArchConfig, u: int) -> Dict[str, Any]:
    unit: Dict[str, Any] = {}
    for j, kind in enumerate(pattern_of(cfg)):
        sub: Dict[str, Any] = {
            "ln1": PSpec((u, cfg.d_model), ("layers", "embed"), "ones")}
        if kind == "A":
            sub["attn"] = _attn_template(cfg, u)
        else:
            sub["mamba"] = _mamba_template(cfg, u)
        ffn = _ffn_template(cfg, u, j)
        if ffn is not None:
            sub["ln2"] = PSpec((u, cfg.d_model), ("layers", "embed"), "ones")
            sub["ffn"] = ffn
        unit[f"s{j}"] = sub
    return unit


def build_template(cfg: ArchConfig) -> Dict[str, Any]:
    """The decoder-only model's template (encoder-decoder configs raise)."""
    if cfg.enc_layers:
        raise NotImplementedError("encoder-decoder templates are not ported "
                                  "yet (ROADMAP.md)")
    d = cfg.d_model
    t: Dict[str, Any] = {
        "embed": PSpec((cfg.vocab, d), ("vocab", "embed"), "embed"),
        "final_norm": PSpec((d,), ("embed",), "ones"),
        "blocks": _unit_template(cfg, n_units(cfg)),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((d, cfg.vocab), ("embed", "vocab"))
    return t


def _proj_qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
              positions: Optional[torch.Tensor]):
    """x (S, B, seq, D) -> q (S, B, seq, H, hd), k/v (S, B, seq, KV, hd)."""
    hd, nh, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q, k, v = (slot_mm(x, p[w]) for w in ("wq", "wk", "wv"))
    q = q.reshape(*x.shape[:-1], nh, hd)
    k = k.reshape(*x.shape[:-1], kvh, hd)
    v = v.reshape(*x.shape[:-1], kvh, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn_apply(x: torch.Tensor, p: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU FFN on x (S, B, seq, D), one batched product per slot."""
    s, d = x.shape[0], x.shape[-1]
    y = swiglu(x.reshape(s, -1, d), p["w1"], p["w3"], p["w2"])
    return y.reshape(x.shape)
