"""Plain PyTorch versions of the SSD scan kernels: the sequential
(non-chunked) SSM recurrence, numerically exact, and its adjoint.

The CPU path of the wrappers in :mod:`.kernel` and the yardstick the
kernels are held against on the card. :func:`ssd_sequential` is the
recurrence itself; it is reached only through :func:`ssd_ref` (the forward
kernel's plain version) and :func:`ssd_bwd_ref` (the backward kernel's:
autograd through it, as the reference's backward runs ``jax.vjp`` through
its oracle). ``CALLS`` counts both, so a run on the card can show that
neither ran there.

``a_log`` is ``(n,)`` (one for every row) or ``(G, n)``: rows are grouped
by slot, row ``r`` using ``a_log[r // (B // G)]``, as the slot-batched
model lays them out.
"""
from __future__ import annotations

import torch

CALLS = {"ssd_scan": 0, "ssd_scan_bwd": 0}


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


def ssd_bwd_ref(xh, dt, a_log, b_ssm, c_ssm, dy) -> tuple:
    """The backward kernel's plain version, counted: (dxh, ddt, da_log, db,
    dc), each in its input's dtype and shape, by autograd through
    :func:`ssd_sequential` with cotangent ``dy`` (a stride-0 expanded
    a_log gets its full-shape gradient)."""
    CALLS["ssd_scan_bwd"] += 1
    inputs = [t.detach().requires_grad_()
              for t in (xh, dt, a_log, b_ssm, c_ssm)]
    with torch.enable_grad():
        y = ssd_sequential(*inputs)
    return torch.autograd.grad(y, inputs, dy)
