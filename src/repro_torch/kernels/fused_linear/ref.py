"""Plain PyTorch versions of the three fused linear kernels.

The CPU path of every wrapper in :mod:`.kernel`, and the yardstick the
kernels are held against on the card. Shape-generic: 2-D operands or a
leading batch (slot) dimension, which may be an expanded stride-0 view.
``CALLS`` counts calls, so a run can show that it never took this path on
the card.

The reference's dtype semantics (``repro.kernels.fused_linear.ref``): the
operands are upcast to f32 and every product, sum, bias and activation is
taken in f32; only the result is rounded, ``y`` and ``dx`` to the operand
dtype, ``dw`` to ``x.dtype`` and ``db`` to ``dy.dtype``. For f32 operands
the casts are no-ops. A bf16 matmul's own accumulation is never relied
on: the upcast is explicit, on the CPU as on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# jax.nn.gelu's default is the tanh approximation; so is this gelu
ACTS = {
    "none": lambda z: z,
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
}

CALLS = {"fused_linear": 0, "fused_linear_bwd_dx": 0,
         "fused_linear_bwd_dw_db": 0}


def fused_linear_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     activation: str = "relu") -> torch.Tensor:
    """act(x @ w + b): x (..., M, K), w (..., K, N), b (..., N)."""
    CALLS["fused_linear"] += 1
    z = torch.matmul(x.float(), w.float()) + b.float().unsqueeze(-2)
    return ACTS[activation](z).to(x.dtype)


def _masked_dz(dy: torch.Tensor, y, mask: str) -> torch.Tensor:
    """f32 dz with the activation derivative applied from the saved output
    (``mask="relu"``: dz = dy * (y > 0)); ``mask="none"`` passes dy."""
    dz = dy.float()
    if mask == "relu":
        return dz * (y > 0).to(dz.dtype)
    return dz


def fused_linear_bwd_dx_ref(dy: torch.Tensor, w: torch.Tensor, y=None,
                            mask: str = "none") -> torch.Tensor:
    """dx (..., M, K) = (dy * mask(y)) @ w^T."""
    CALLS["fused_linear_bwd_dx"] += 1
    dz = _masked_dz(dy, y, mask)
    return torch.matmul(dz, w.float().transpose(-1, -2)).to(dy.dtype)


def fused_linear_bwd_dw_db_ref(x: torch.Tensor, dy: torch.Tensor, y=None,
                               mask: str = "none"):
    """(dw, db) = (x^T @ dz, sum_m dz)."""
    CALLS["fused_linear_bwd_dw_db"] += 1
    dz = _masked_dz(dy, y, mask)
    return (torch.matmul(x.float().transpose(-1, -2), dz).to(x.dtype),
            dz.sum(dim=-2).to(dy.dtype))
