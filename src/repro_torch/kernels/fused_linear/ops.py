"""Differentiable fused linear op: ``linear = act(x @ w + b)``.

The counterpart of ``repro.kernels.fused_linear.ops.linear``: an
``autograd.Function`` whose forward and backward are the three kernels of
:mod:`.kernel` (CUDA on the card, their plain versions on the CPU), with
the reference's residual policy: ``(x, w, y)`` for relu, where the backward
kernels rebuild the mask from the saved output, ``(x, w)`` for none, and
``(x, w, b)`` for the smooth activations (silu, gelu), whose backward
rebuilds the pre-activation with one extra ``activation="none"`` forward
(the remat rule: one GEMM instead of an (M, N) buffer held per layer) and
hands the backward kernels a pre-multiplied ``dz`` with ``mask="none"``.
As in the reference's ``_linear_bwd``, that ``dz`` is cast to ``dy``'s
dtype, and ``dx``, ``dw`` and ``db`` come back in the dtypes of ``x``,
``w`` and ``dy`` (bf16 operands: bf16 gradients, which autograd carries
back through the cast to the f32 master weights).

``linear`` takes one weight for every row (w (K, N), b (N,)) or one weight
per slot (x (S, ..., K), w (S, K, N), b (S, N)), so a slot-batched cohort
runs each fc layer as one launch. A per-slot weight may be an expanded
stride-0 view of a shared one: the kernels then read the shared matrix in
place and its gradient comes back per slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_linear import kernel, ref


class _FusedLinear(torch.autograd.Function):
    """x (B, M, K), w (B, K, N), b (B, N) -> act(x @ w + b) (B, M, N)."""

    @staticmethod
    def forward(ctx, x, w, b, activation: str):
        y = kernel.fused_linear(x, w, b, activation)
        ctx.activation = activation
        if activation == "relu":
            ctx.save_for_backward(x, w, y)   # mask recovered from y > 0
        elif activation == "none":
            ctx.save_for_backward(x, w)      # identity: dz is dy
        else:
            ctx.save_for_backward(x, w, b)   # smooth: z rebuilt in backward
        return y

    @staticmethod
    def backward(ctx, dy):
        mask, y, dz = ctx.activation, None, dy
        if mask == "relu":
            x, w, y = ctx.saved_tensors
        elif mask == "none":
            x, w = ctx.saved_tensors
        else:
            x, w, b = ctx.saved_tensors
            z = kernel.fused_linear(x, w, b, "none")
            with torch.enable_grad():
                z.requires_grad_()
                (dz,) = torch.autograd.grad(ref.ACTS[mask](z), z, dy)
            dz, mask = dz.to(dy.dtype), "none"
        dx = (kernel.fused_linear_bwd_dx(dz, w, y, mask).to(x.dtype)
              if ctx.needs_input_grad[0] else None)
        dw, db = kernel.fused_linear_bwd_dw_db(x, dz, y, mask)
        return dx, dw.to(w.dtype), db.to(dy.dtype), None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           activation: str = "relu") -> torch.Tensor:
    """Fused ``act(x @ w + b)`` with the kernels' backward, act in
    {none, relu, silu, gelu} (gelu in its tanh form, as the reference's).

    w (K, N), b (N,): x is (..., K) and every row shares the weight (its
    rows fold into one GEMM). w (S, K, N), b (S, N): x is (S, ..., K) and
    slot s multiplies by w[s].
    """
    if activation not in ref.ACTS:
        raise NotImplementedError(f"activation {activation!r}")
    k, n = w.shape[-2:]
    if w.dim() == 2:
        y = _FusedLinear.apply(x.reshape(1, -1, k), w.unsqueeze(0),
                               b.unsqueeze(0), activation)
    else:
        y = _FusedLinear.apply(x.reshape(x.shape[0], -1, k), w, b,
                               activation)
    return y.reshape(*x.shape[:-1], n)
