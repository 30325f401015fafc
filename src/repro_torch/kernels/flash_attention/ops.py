"""Differentiable flash attention (port of
``repro.kernels.flash_attention.ops``).

An ``autograd.Function`` whose forward is the forward kernel of
:mod:`.kernel` and whose backward is ``kernel.flash_attention_bwd`` (the
fused bf16 kernel, or the dq and dk/dv kernels; CUDA on the card, their
plain versions on the CPU). It saves ``(q, k, v, o, lse)`` as
the reference's custom VJP does, and computes ``delta = sum(do * o, -1)``
in torch, outside the kernels. :func:`gqa_attention` is the layout adapter
the models call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel


class _FlashAttention(torch.autograd.Function):
    """q, k, v (B, H, S, D) -> o (B, H, S, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = kernel.flash_attention(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq, dk, dv = kernel.flash_attention_bwd(q, k, v, do, lse, delta,
                                                ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Differentiable attention on kernel-layout (B, H, S, D) operands."""
    return _FlashAttention.apply(q, k, v, causal, window)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Layout adapter: q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd).

    Repeats KV heads to match the query heads (grouped-query attention;
    the repeat's gradient sums dk/dv per group) and hands the kernels
    (B, H, S, hd) views of the (B, S, H, hd) activations: no copy for the
    transposes, which the kernels read through their strides.
    """
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if rep > 1:
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    return attention(qt, kt, vt, causal=causal, window=window).transpose(1, 2)
