"""Differentiable fused linear op: ``linear = act(x @ w + b)``.

The counterpart of ``repro.kernels.fused_linear.ops.linear``: an
``autograd.Function`` whose forward and backward are the three kernels of
:mod:`.kernel` (CUDA on the card, their plain versions on the CPU), with
the reference's residual policy: ``(x, w, y)`` for relu, where the backward
kernels rebuild the mask from the saved output, and ``(x, w)`` for none.

``linear`` takes one weight for every row (w (K, N), b (N,)) or one weight
per slot (x (S, ..., K), w (S, K, N), b (S, N)), so a slot-batched cohort
runs each fc layer as one launch. A per-slot weight may be an expanded
stride-0 view of a shared one: the kernels then read the shared matrix in
place and its gradient comes back per slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_linear import kernel


class _FusedLinear(torch.autograd.Function):
    """x (B, M, K), w (B, K, N), b (B, N) -> act(x @ w + b) (B, M, N)."""

    @staticmethod
    def forward(ctx, x, w, b, activation: str):
        y = kernel.fused_linear(x, w, b, activation)
        ctx.activation = activation
        if activation == "relu":
            ctx.save_for_backward(x, w, y)   # mask recovered from y > 0
        else:
            ctx.save_for_backward(x, w)      # identity: dz is dy
        return y

    @staticmethod
    def backward(ctx, dy):
        mask = ctx.activation
        if mask == "relu":
            x, w, y = ctx.saved_tensors
        else:
            (x, w), y = ctx.saved_tensors, None
        dx = (kernel.fused_linear_bwd_dx(dy, w, y, mask)
              if ctx.needs_input_grad[0] else None)
        dw, db = kernel.fused_linear_bwd_dw_db(x, dy, y, mask)
        return dx, dw, db, None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           activation: str = "relu") -> torch.Tensor:
    """Fused ``act(x @ w + b)`` with the kernels' backward, act in
    {none, relu}.

    w (K, N), b (N,): x is (..., K) and every row shares the weight (its
    rows fold into one GEMM). w (S, K, N), b (S, N): x is (S, ..., K) and
    slot s multiplies by w[s].
    """
    if activation not in ("none", "relu"):
        raise NotImplementedError(f"activation {activation!r}")
    k, n = w.shape[-2:]
    if w.dim() == 2:
        y = _FusedLinear.apply(x.reshape(1, -1, k), w.unsqueeze(0),
                               b.unsqueeze(0), activation)
    else:
        y = _FusedLinear.apply(x.reshape(x.shape[0], -1, k), w, b,
                               activation)
    return y.reshape(*x.shape[:-1], n)
