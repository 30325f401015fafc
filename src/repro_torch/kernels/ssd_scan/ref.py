"""Plain PyTorch version of the SSD chunked-scan kernel: the sequential
(non-chunked) SSM recurrence, numerically exact.

The CPU path of the wrapper in :mod:`.kernel` and the yardstick the kernel
is held against on the card. ``CALLS`` counts calls of :func:`ssd_ref`, the
plain version standing in for the kernel. :func:`ssd_sequential` is the
same recurrence uncounted: the op's backward runs autograd through it on
every device, as the reference's backward runs ``jax.vjp`` through its
oracle, so it is not a stand-in for the forward kernel.

``a_log`` is ``(n,)`` (one for every row) or ``(G, n)``: rows are grouped
by slot, row ``r`` using ``a_log[r // (B // G)]``, as the slot-batched
model lays them out.
"""
from __future__ import annotations

import torch

CALLS = {"ssd_scan": 0}


def decay_rates(a_log: torch.Tensor, bsz: int) -> torch.Tensor:
    """``-exp(a_log)`` as (n,) or per row (B, n)."""
    a = -torch.exp(a_log.float())
    if a.dim() == 1:
        return a
    groups = a.shape[0]
    if bsz % groups:
        raise ValueError(f"{bsz} rows do not split into {groups} slots")
    return a.repeat_interleave(bsz // groups, dim=0)


def ssd_sequential(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_ssm: torch.Tensor, c_ssm: torch.Tensor) -> torch.Tensor:
    """Sequential scan. xh (B,S,n,p); dt (B,S,n); b_ssm/c_ssm (B,S,ds)
    -> y (B,S,n,p)."""
    bsz, s, n, p = xh.shape
    ds = b_ssm.shape[-1]
    a = decay_rates(a_log, bsz)
    h = torch.zeros((bsz, n, ds, p), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t].float()                               # (B, n)
        dec = torch.exp(dt_t * a)
        upd = (dt_t[..., None, None] * b_ssm[:, t, None, :, None].float()
               * xh[:, t, :, None, :].float())
        h = h * dec[..., None, None] + upd                    # (B, n, ds, p)
        ys.append(torch.einsum("bnsp,bs->bnp", h, c_ssm[:, t].float()))
    return torch.stack(ys, dim=1).to(xh.dtype)


def ssd_ref(xh, dt, a_log, b_ssm, c_ssm) -> torch.Tensor:
    """The kernel's plain version: :func:`ssd_sequential`, counted."""
    CALLS["ssd_scan"] += 1
    return ssd_sequential(xh, dt, a_log, b_ssm, c_ssm)
