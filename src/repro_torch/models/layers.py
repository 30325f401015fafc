"""Core layer primitives of the token models (port of
``repro.models.layers``), in plain PyTorch, plus the two slot-batching
helpers every block uses (:func:`slot_mm`, :func:`slot_bcast`).

``causal_attention`` is the plain multi-block attention the flash-attention
kernels are held against; the models run attention through
``repro_torch.kernels.flash_attention.ops``. Decode attention is not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def slot_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (S, ..., K) @ w (S, K, N) per slot -> (S, ..., N), as one batched
    product over the slots."""
    s, k = x.shape[0], x.shape[-1]
    y = torch.bmm(x.reshape(s, -1, k), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def slot_bcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-slot parameter (S, *rest) viewed as (S, 1, ..., 1, *rest) with
    ``ndim`` dims, to broadcast against slot-batched activations."""
    return w.reshape(w.shape[0], *([1] * (ndim - w.dim())), *w.shape[1:])


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k: (B,Sk,KV,hd) -> (B,H,Sq,Sk) with GQA groups."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return s.reshape(b, h, sq, k.shape[1])


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,H,Sq,Sk)  v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    b, h, sq, sk = p.shape
    kv = v.shape[2]
    pg = p.reshape(b, kv, h // kv, sq, sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v.to(p.dtype))
    return o.reshape(b, sq, h, v.shape[-1])


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, block_q: int = 1024, window: Optional[int] = None,
                     causal: bool = True) -> torch.Tensor:
    """Memory-bounded causal (optionally sliding-window) attention over
    query blocks, so the live score matrix is (B, H, block_q, Sk).

    q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd)
    """
    b, s, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    block_q = min(block_q, s)
    if s % block_q:
        raise ValueError(f"seq {s} is not a multiple of block_q {block_q}")
    kpos = torch.arange(sk, device=q.device)
    out = []
    for q0 in range(0, s, block_q):
        qpos = q0 + torch.arange(block_q, device=q.device)
        scores = _gqa_scores(q[:, q0:q0 + block_q], k) * scale
        mask = torch.ones((block_q, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out.append(_gqa_out(p, v))
    return torch.cat(out, dim=1)
