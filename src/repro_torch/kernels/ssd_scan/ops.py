"""Differentiable SSD chunked scan (port of ``repro.kernels.ssd_scan.ops``).

An ``autograd.Function`` whose forward is the kernel of :mod:`.kernel`
(CUDA on the card, its plain version on the CPU). There is no backward
kernel, in the reference or here: the op saves its five inputs and its
backward is autograd through the sequential recurrence
(:func:`~repro_torch.kernels.ssd_scan.ref.ssd_sequential`), the exact
adjoint of the chunked forward, as the reference's ``jax.vjp`` through
``ssd_ref`` is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel, ref


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xh, dt, a_log, b_ssm, c_ssm, chunk: int):
        ctx.save_for_backward(xh, dt, a_log, b_ssm, c_ssm)
        return kernel.ssd_scan(xh, dt, a_log, b_ssm, c_ssm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ref.ssd_sequential(*inputs)
        return (*torch.autograd.grad(y, inputs, dy), None)


def ssd(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b_ssm: torch.Tensor, c_ssm: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Differentiable chunked SSD scan: xh (B,S,n,p); dt (B,S,n); a_log
    (n,) or (G, n) per slot of B // G rows; b/c (B,S,ds) -> (B,S,n,p)."""
    return _SSD.apply(xh, dt, a_log, b_ssm, c_ssm, chunk)
