"""Plain PyTorch versions of the three fused linear kernels.

The CPU path of every wrapper in :mod:`.kernel`, and the yardstick the
kernels are held against on the card. Shape-generic: 2-D operands or a
leading batch (slot) dimension, which may be an expanded stride-0 view.
``CALLS`` counts calls, so a run can show that it never took this path on
the card.
"""
from __future__ import annotations

import torch

ACTS = {
    "none": lambda z: z,
    "relu": torch.relu,
}

CALLS = {"fused_linear": 0, "fused_linear_bwd_dx": 0,
         "fused_linear_bwd_dw_db": 0}


def fused_linear_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     activation: str = "relu") -> torch.Tensor:
    """act(x @ w + b): x (..., M, K), w (..., K, N), b (..., N)."""
    CALLS["fused_linear"] += 1
    return ACTS[activation](torch.matmul(x, w) + b.unsqueeze(-2))


def _masked_dz(dy: torch.Tensor, y, mask: str) -> torch.Tensor:
    """dz with the activation derivative applied from the saved output
    (``mask="relu"``: dz = dy * (y > 0)); ``mask="none"`` passes dy."""
    if mask == "relu":
        return dy * (y > 0).to(dy.dtype)
    return dy


def fused_linear_bwd_dx_ref(dy: torch.Tensor, w: torch.Tensor, y=None,
                            mask: str = "none") -> torch.Tensor:
    """dx (..., M, K) = (dy * mask(y)) @ w^T."""
    CALLS["fused_linear_bwd_dx"] += 1
    return torch.matmul(_masked_dz(dy, y, mask), w.transpose(-1, -2))


def fused_linear_bwd_dw_db_ref(x: torch.Tensor, dy: torch.Tensor, y=None,
                               mask: str = "none"):
    """(dw, db) = (x^T @ dz, sum_m dz)."""
    CALLS["fused_linear_bwd_dw_db"] += 1
    dz = _masked_dz(dy, y, mask)
    return torch.matmul(x.transpose(-1, -2), dz), dz.sum(dim=-2)
