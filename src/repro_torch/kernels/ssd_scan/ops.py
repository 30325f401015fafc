"""Differentiable SSD chunked scan (port of ``repro.kernels.ssd_scan.ops``).

An ``autograd.Function`` whose forward and backward are the kernels of
:mod:`.kernel` (CUDA on the card, their plain versions on the CPU). The op
saves its five inputs; its backward is ``kernel.ssd_scan_bwd``: on the card
the CUDA backward kernels (the adjoint of the chunked form, chunk by
chunk), on the CPU autograd through
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_sequential`; both are the exact
adjoint of the chunked forward, as the reference's ``jax.vjp`` through
``ssd_ref`` is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xh, dt, a_log, b_ssm, c_ssm, chunk: int):
        ctx.save_for_backward(xh, dt, a_log, b_ssm, c_ssm)
        ctx.chunk = chunk
        return kernel.ssd_scan(xh, dt, a_log, b_ssm, c_ssm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        return (*kernel.ssd_scan_bwd(*ctx.saved_tensors, dy,
                                     chunk=ctx.chunk), None)


def ssd(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b_ssm: torch.Tensor, c_ssm: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Differentiable chunked SSD scan: xh (B,S,n,p); dt (B,S,n); a_log
    (n,) or (G, n) per slot of B // G rows; b/c (B,S,ds) -> (B,S,n,p)."""
    return _SSD.apply(xh, dt, a_log, b_ssm, c_ssm, chunk)
