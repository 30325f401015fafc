"""Unified decoder / encoder-decoder model covering every published
architecture of ``repro_torch.configs`` (port of ``repro.models.model``:
templates, sequence-mode forward and the decode side).

One config-driven implementation: dense, GQA (+bias, +qk-norm), MoE,
Mamba-2 SSD, hybrid interleave (Jamba), early-fusion VLM (discrete VQ
tokens in the shared vocab) and enc-dec audio (frame-embedding frontend
stub). Templates mirror the reference's leaf for leaf (shapes, logical
axes, init kinds), so :func:`repro_torch.models.params.init_params` draws
the same structure, and a layer's params are stacked over "units" (one
repetition of ``cfg.layer_pattern``), which :func:`forward` walks in a
Python loop.

The building blocks are slot-batched, as the FL split models run them:
activations are ``(S, B, seq, D)`` and every weight is per slot (a leading
``S`` axis; a stride-0 expanded view when shared); the FFN is SwiGLU or
the MoE FFN (``repro_torch.models.moe``), whose routing groups are per
slot. The LM's forward runs them on one slot (``x[None]``, ``w[None]``),
so one slot's B x seq tokens route as one group set, as the reference's
``moe_ffn`` routes them. Self-attention goes through the flash-attention
op (the CUDA kernels on the card, where a head dim they do not take
raises; the plain version on the CPU); cross-attention is plain torch, as
the reference computes it outside any kernel.

The decode side (:func:`cache_template`, :func:`serve_step`,
:func:`encode_for_decode`, :func:`fill_cross_cache`) feeds one token per
step against per-sublayer caches: KV caches (optionally ring buffers),
Mamba conv windows and f32 SSM states, and the encoder-decoder's cross
K/V. It is plain torch on both devices, as the reference computes it
outside any kernel, except the encoder, which runs the flash-attention
op. Where the reference returns a new cache, the port writes into the
cache it was handed, in place (as a jit with the cache donated would),
and returns it: a full-width KV cache is too large to copy every step.
The reference's ``acts`` sharding anchors, scan ``unroll`` and
``serve_step``'s unused ``cache_len`` are jax-only or unused and have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, causal_attention,
                                       decode_attention, ring_index,
                                       rms_norm, slot_bcast, slot_mm, swiglu)
from repro_torch.models.moe import moe_ffn_slots
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


def _attn_template(cfg: ArchConfig, u: int,
                   cross: bool = False) -> Dict[str, PSpec]:
    d, hd = cfg.d_model, cfg.hd
    nh, kv = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": PSpec((u, d, nh * hd), ("layers", "embed", "q_heads")),
        "wk": PSpec((u, d, kv * hd), ("layers", "embed", "kv_fused")),
        "wv": PSpec((u, d, kv * hd), ("layers", "embed", "kv_fused")),
        "wo": PSpec((u, nh * hd, d), ("layers", "q_heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = PSpec((u, nh * hd), ("layers", "q_heads"), "zeros")
        t["bk"] = PSpec((u, kv * hd), ("layers", "kv_fused"), "zeros")
        t["bv"] = PSpec((u, kv * hd), ("layers", "kv_fused"), "zeros")
    if cfg.qk_norm and not cross:
        t["q_norm"] = PSpec((u, hd), ("layers", None), "ones")
        t["k_norm"] = PSpec((u, hd), ("layers", None), "ones")
    return t


def _ffn_template(cfg: ArchConfig, u: int,
                  layer_in_unit: int) -> Optional[Dict[str, PSpec]]:
    if cfg.d_ff == 0:
        return None
    d, f = cfg.d_model, cfg.d_ff
    moe = cfg.moe
    if moe is not None and layer_in_unit % moe.every_n == moe.every_n - 1:
        e = moe.n_experts
        # expert weights get their own logical axes, as in the reference
        return {
            "router": PSpec((u, d, e), ("layers", "embed", None), "small"),
            "w1": PSpec((u, e, d, f), ("layers", "experts", "moe_d",
                                       "moe_f")),
            "w3": PSpec((u, e, d, f), ("layers", "experts", "moe_d",
                                       "moe_f")),
            "w2": PSpec((u, e, f, d), ("layers", "experts", "moe_f",
                                       "moe_d")),
        }
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


def _unit_template(cfg: ArchConfig, u: int,
                   cross: bool = False) -> Dict[str, Any]:
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
        if cross:
            sub["ln_x"] = PSpec((u, cfg.d_model), ("layers", "embed"), "ones")
            sub["xattn"] = _attn_template(cfg, u, cross=True)
        unit[f"s{j}"] = sub
    return unit


def build_template(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    t: Dict[str, Any] = {
        "embed": PSpec((cfg.vocab, d), ("vocab", "embed"), "embed"),
        "final_norm": PSpec((d,), ("embed",), "ones"),
        "blocks": _unit_template(cfg, n_units(cfg), cross=cfg.enc_layers > 0),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.enc_layers:
        t["encoder"] = {
            "blocks": _unit_template(_encoder_cfg(cfg), cfg.enc_layers),
            "final_norm": PSpec((d,), ("embed",), "ones"),
        }
    return t


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, layer_pattern="A", moe=None, enc_layers=0,
                               n_layers=cfg.enc_layers, qkv_bias=False,
                               qk_norm=False)


# ---------------------------------------------------------------------------
# slot-batched building blocks
# ---------------------------------------------------------------------------


def _proj_qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
              positions: Optional[torch.Tensor]):
    """x (S, B, seq, D) -> q (S, B, seq, H, hd), k/v (S, B, seq, KV, hd):
    bias, heads, qk rms-norm, rope, in the reference's order."""
    hd, nh, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q, k, v = (slot_mm(x, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = (t + slot_bcast(p[b], t.dim())
                   for t, b in zip((q, k, v), ("bq", "bk", "bv")))
    q = q.reshape(*x.shape[:-1], nh, hd)
    k = k.reshape(*x.shape[:-1], kvh, hd)
    v = v.reshape(*x.shape[:-1], kvh, hd)
    if "q_norm" in p:
        q = rms_norm(q, slot_bcast(p["q_norm"], q.dim()), cfg.norm_eps)
        k = rms_norm(k, slot_bcast(p["k_norm"], k.dim()), cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn_apply(x: torch.Tensor, p: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> torch.Tensor:
    """The FFN on x (S, B, seq, D): the MoE FFN where the block has a
    router (each slot its own routing groups), else SwiGLU, one batched
    product per slot."""
    if "router" in p:
        return moe_ffn_slots(x, p, cfg.moe)
    s, d = x.shape[0], x.shape[-1]
    y = swiglu(x.reshape(s, -1, d), p["w1"], p["w3"], p["w2"])
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# sequence-mode forward (train / prefill) of one model
# ---------------------------------------------------------------------------


def _one_slot(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One model's block params as a single slot (views)."""
    return {k: w[None] for k, w in p.items()}


def _attention(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
               *, causal: bool = True) -> torch.Tensor:
    """Self-attention, x (B, S, D) -> (B, S, D); rope on the causal
    (decoder) side only, as in the reference."""
    positions = torch.arange(x.shape[1], device=x.device) if causal else None
    q, k, v = (t[0] for t in _proj_qkv(x[None], _one_slot(p), cfg,
                                        positions))
    o = flash_ops.gqa_attention(q, k, v, causal=causal)
    return o.reshape(*x.shape[:-1], cfg.n_heads * cfg.hd) @ p["wo"]


def _cross_attention(x: torch.Tensor, enc_out: torch.Tensor,
                     p: Dict[str, torch.Tensor],
                     cfg: ArchConfig) -> torch.Tensor:
    """Decoder x (B, S, D) attends to enc_out (B, T, D): plain torch."""
    b, s, _ = x.shape
    hd, nh, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    t = enc_out.shape[1]
    q = (x @ p["wq"]).reshape(b, s, nh, hd)
    k = (enc_out @ p["wk"]).reshape(b, t, kvh, hd)
    v = (enc_out @ p["wv"]).reshape(b, t, kvh, hd)
    o = causal_attention(q, k, v, causal=False)
    return o.reshape(b, s, nh * hd) @ p["wo"]


def _sublayer_seq(x: torch.Tensor, sub: Dict[str, Any], kind: str,
                  cfg: ArchConfig, enc_out: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    h = rms_norm(x, sub["ln1"], cfg.norm_eps)
    if kind == "A":
        x = x + _attention(h, sub["attn"], cfg, causal=causal)
    else:
        x = x + ssm_lib.mamba_block(h[None], _one_slot(sub["mamba"]),
                                    cfg)[0]
    if "xattn" in sub and enc_out is not None:
        h = rms_norm(x, sub["ln_x"], cfg.norm_eps)
        x = x + _cross_attention(h, enc_out, sub["xattn"], cfg)
    if "ffn" in sub:
        h = rms_norm(x, sub["ln2"], cfg.norm_eps)
        x = x + _ffn_apply(h[None], _one_slot(sub["ffn"]), cfg)[0]
    return x


def _units(tree) -> list:
    """The stacked block params as one tree per unit (views): one unbind
    per leaf, whose backward stacks the units' gradients in one op, where
    indexing each unit would add every unit's gradient into a zero-filled
    copy of the whole leaf."""
    if isinstance(tree, dict):
        per_key = {k: _units(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: per_key[k][u] for k in tree} for u in range(n)]
    return torch.unbind(tree, 0)


def _scan_units(x: torch.Tensor, blocks: Dict[str, Any], cfg: ArchConfig,
                enc_out: Optional[torch.Tensor] = None, *,
                causal: bool = True, remat: bool = False) -> torch.Tensor:
    """Every unit in turn (the reference's ``lax.scan``); ``remat``
    recomputes each unit's activations in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` around the unit)."""
    pat = pattern_of(cfg)

    def unit(xc, unit_params):
        for j, kind in enumerate(pat):
            xc = _sublayer_seq(xc, unit_params[f"s{j}"], kind, cfg, enc_out,
                               causal)
        return xc

    units = _units(blocks)
    if len(units) != n_units(cfg):
        raise ValueError(f"{len(units)} units of params, {n_units(cfg)} "
                         f"in {cfg.name}")
    for p in units:
        x = (checkpoint(unit, x, p, use_reentrant=False) if remat
             else unit(x, p))
    return x


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, *, remat: bool = False) -> torch.Tensor:
    """batch: tokens (B,S) integers [+ enc_frames (B,T,D) for audio] ->
    logits (B, S, V)."""
    x = params["embed"][batch["tokens"].long()]
    enc_out = None
    if cfg.enc_layers:
        e = batch["enc_frames"].to(x.dtype)
        e = _scan_units(e, params["encoder"]["blocks"], _encoder_cfg(cfg),
                        causal=False, remat=remat)
        enc_out = rms_norm(e, params["encoder"]["final_norm"], cfg.norm_eps)
    x = _scan_units(x, params["blocks"], cfg, enc_out, causal=True,
                    remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unembed


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, *, remat: bool = False) -> torch.Tensor:
    """Mean token cross-entropy: f32 logsumexp minus the gold logit."""
    logits = forward(params, batch, cfg, remat=remat).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# decode (serve_step) with per-sublayer caches
# ---------------------------------------------------------------------------


def cache_template(cfg: ArchConfig, batch: int, cache_len: int,
                   enc_len: int = 0) -> Dict[str, Any]:
    """PSpec tree of the decode cache (stacked over units), the
    reference's leaf for leaf: K/V caches for attention sublayers, the
    conv window and the f32 state for Mamba ones, cross K/V for every
    sublayer of the encoder-decoder arch."""
    u, hd, kvh = n_units(cfg), cfg.hd, cfg.n_kv_heads
    kv_axes = ("layers", "batch", "seq", None, "hd")
    blocks: Dict[str, Any] = {}
    for j, kind in enumerate(pattern_of(cfg)):
        if kind == "A":
            blocks[f"s{j}"] = {
                name: PSpec((u, batch, cache_len, kvh, hd), kv_axes, "zeros")
                for name in ("k", "v")}
        else:
            s = cfg.ssm
            d_in = s.d_inner(cfg.d_model)
            blocks[f"s{j}"] = {
                "conv": PSpec((u, batch, s.d_conv - 1, d_in + 2 * s.d_state),
                              ("layers", "batch", None, "ssm_in"), "zeros"),
                "h": PSpec((u, batch, s.n_heads(cfg.d_model), s.d_state,
                            s.head_dim),
                           ("layers", "batch", "nheads", None, None), "zeros",
                           dtype=torch.float32),
            }
        if cfg.enc_layers:
            for name in ("xk", "xv"):
                blocks[f"s{j}"][name] = PSpec((u, batch, enc_len, kvh, hd),
                                              kv_axes, "zeros")
    return {"blocks": blocks}


def _position(pos: Union[int, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """``pos`` as a 0-d int64 tensor on ``device``; an int is filled in
    there (no copy from the host)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long).reshape(())
    return torch.full((), pos, dtype=torch.long, device=device)


def _decode_sublayer(x: torch.Tensor, sub: Dict[str, Any],
                     cache_sub: Dict[str, torch.Tensor], kind: str,
                     cfg: ArchConfig, pos: torch.Tensor,
                     ring: int) -> torch.Tensor:
    """x (B,1,D); cache entries of one unit, written in place."""
    b = x.shape[0]
    hd, nh = cfg.hd, cfg.n_heads
    h = rms_norm(x, sub["ln1"], cfg.norm_eps)
    if kind == "A":
        # rope at the absolute position, before the keys are cached
        q, k, v = (t[0] for t in _proj_qkv(
            h[None], _one_slot(sub["attn"]), cfg,
            pos.reshape(1, 1, 1).expand(1, b, 1)))
        kc, vc = cache_sub["k"], cache_sub["v"]
        last = kc.shape[1] - 1
        # the reference's dynamic_update_slice clamps its start: without
        # a ring a position past the end writes the last slot
        slot = ring_index(pos, ring) if ring else pos.clamp(0, last)
        kc.index_copy_(1, slot.reshape(1), k.to(kc.dtype))
        vc.index_copy_(1, slot.reshape(1), v.to(vc.dtype))
        # once pos passes the cache (a full ring, or clamped) every slot
        # is valid
        o = decode_attention(q, kc, vc, pos.clamp(max=last))
        x = x + o.reshape(b, 1, nh * hd) @ sub["attn"]["wo"]
    else:
        o, conv, state = ssm_lib.mamba_step(h, sub["mamba"], cfg,
                                            cache_sub["conv"],
                                            cache_sub["h"])
        cache_sub["conv"].copy_(conv)
        cache_sub["h"].copy_(state)
        x = x + o
    if "xattn" in sub:
        hx = rms_norm(x, sub["ln_x"], cfg.norm_eps)
        q = (hx @ sub["xattn"]["wq"]).reshape(b, 1, nh, hd)
        o = decode_attention(q, cache_sub["xk"], cache_sub["xv"],
                             cache_sub["xk"].shape[1] - 1)
        x = x + o.reshape(b, 1, nh * hd) @ sub["xattn"]["wo"]
    if "ffn" in sub:
        hf = rms_norm(x, sub["ln2"], cfg.norm_eps)
        x = x + _ffn_apply(hf[None], _one_slot(sub["ffn"]), cfg)[0]
    return x


@torch.no_grad()
def serve_step(params: Dict[str, Any], cache: Dict[str, Any],
               tokens: torch.Tensor, pos: Union[int, torch.Tensor],
               cfg: ArchConfig, *,
               ring: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens (B,1) -> (logits (B,1,V), cache).

    ``pos`` is the tokens' position, a Python int or a 0-d integer tensor
    on the params' device (nothing is read back to the host). The cache
    is written in place and returned (the same tensors). ``ring=True``
    treats attention caches as sliding-window ring buffers.
    """
    pat = pattern_of(cfg)
    x = params["embed"][tokens.long()]
    pos = _position(pos, x.device)
    units = _units(params["blocks"])
    unit_caches = _units(cache["blocks"])
    if len(unit_caches) != len(units):
        raise ValueError(f"{len(unit_caches)} units of cache, {len(units)} "
                         f"of params")
    for unit_params, unit_cache in zip(units, unit_caches):
        for j, kind in enumerate(pat):
            c = unit_cache[f"s{j}"]
            ring_size = c["k"].shape[1] if ring and kind == "A" else 0
            x = _decode_sublayer(x, unit_params[f"s{j}"], c, kind, cfg, pos,
                                 ring_size)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unembed, cache


def encode_for_decode(params: Dict[str, Any], enc_frames: torch.Tensor,
                      cfg: ArchConfig) -> torch.Tensor:
    """Run the encoder once (non-causal self-attention through the
    flash-attention op) -> enc_out (B, T, D), for :func:`fill_cross_cache`."""
    e = _scan_units(enc_frames, params["encoder"]["blocks"],
                    _encoder_cfg(cfg), causal=False)
    return rms_norm(e, params["encoder"]["final_norm"], cfg.norm_eps)


@torch.no_grad()
def fill_cross_cache(params: Dict[str, Any], cache: Dict[str, Any],
                     enc_out: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """Write every unit's cross K/V of ``enc_out`` (B, T, D) into the
    cache's ``xk``/``xv`` (whose enc_len must be T), in place; returns the
    cache."""
    b, t, _ = enc_out.shape
    for j in range(len(pattern_of(cfg))):
        p = params["blocks"][f"s{j}"]["xattn"]
        sub = cache["blocks"][f"s{j}"]
        for w, name in (("wk", "xk"), ("wv", "xv")):
            if tuple(sub[name].shape[1:3]) != (b, t):
                raise ValueError(f"cache {name} of shape "
                                 f"{tuple(sub[name].shape)} for enc_out of "
                                 f"shape {tuple(enc_out.shape)}")
            # every unit's projection as one batched product
            y = torch.matmul(enc_out[None], p[w][:, None])
            sub[name].copy_(y.reshape(sub[name].shape))
    return cache
