"""Plain PyTorch versions of the flash-attention kernels (forward and the
backward pair), on kernel-layout ``(B, H, S, D)`` operands of any strides.

The CPU path of every wrapper in :mod:`.kernel`, and the yardstick the
kernels are held against on the card. Operands are f32 or bf16; every
plain version computes in f32, as the Pallas kernels do, and rounds each
output once to the operands' dtype (lse stays f32). ``CALLS`` counts calls, so a run can
show that it never took this path on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

CALLS = {"flash_attention": 0, "flash_attention_bwd_dq": 0,
         "flash_attention_bwd_dkdv": 0}


def _mask(s: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k):
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D). fp32 softmax."""
    return attention_ref_lse(q, k, v, causal=causal, window=window)[0]


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """(o (B, H, S, D), lse (B, H, S) f32): the forward kernel's outputs.
    As the Pallas kernel does, P and P V stay f32 from any operand dtype,
    and o is rounded once to the operands' dtype (in f32 a no-op)."""
    CALLS["flash_attention"] += 1
    mask = _mask(q.shape[2], causal, window, q.device)
    scores = _scores(q, k).masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(v.dtype), lse.float()


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    mask = _mask(q.shape[2], causal, window, q.device)
    p = torch.where(mask, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_ref_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """dq (B, H, S, D) from the saved lse and ``delta = sum(do * o, -1)``:
    the dq kernel's output."""
    CALLS["flash_attention_bwd_dq"] += 1
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def attention_ref_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None):
    """(dk, dv), each (B, H, S, D): the dk/dv kernel's outputs."""
    CALLS["flash_attention_bwd_dkdv"] += 1
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * q.shape[-1] ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_ref_bwd(q, k, v, do, lse, delta, *, causal: bool = True,
                      window: Optional[int] = None):
    """Closed-form (dq, dk, dv) from the saved lse: both backward kernels'
    plain versions."""
    dq = attention_ref_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                              window=window)
    return (dq, *attention_ref_bwd_dkdv(q, k, v, do, lse, delta,
                                        causal=causal, window=window))
