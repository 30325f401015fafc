"""Wrapper around the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

The counterpart of ``repro.kernels.ssd_scan.kernel.ssd_scan``: the Mamba-2
SSD forward over chunks of ``chunk`` steps, state carried across chunks.
xh (B, S, n, p), dt (B, S, n), b/c (B, S, ds) with any row and step strides
(the last dimension unit-stride); a_log (n,) for every row or (G, n), one
per slot of B // G consecutive rows (a stride-0 expanded view is read in
place). y (B, S, n, p) comes back contiguous.

Dispatch is by tensor device only: CPU tensors go to the plain version in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts the kernel's launches
and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu"

LAUNCHES = {"ssd_scan": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"ssd_scan_fwd": [_P] * 6 + [_I] * 8 + [_P, _P]}

# rows x head blocks below which heads get a block each: two blocks per SM
# of the H100's 132
_MIN_BLOCKS = 264


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _block_h(bsz: int, n: int) -> int:
    """Heads per block: up to 4 share one block's score matrix, unless that
    leaves too few blocks to fill the card."""
    for bh in (4, 2):
        if n % bh == 0 and bsz * (n // bh) >= _MIN_BLOCKS:
            return bh
    return 1


def _operand(t: torch.Tensor, ndim: int, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, "
                        f"not {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_ssm: torch.Tensor, c_ssm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """y (B, S, n, p) of the chunked SSD scan (chunk clamped to S)."""
    if not build.on_cuda("ssd_scan", xh, dt, a_log, b_ssm, c_ssm):
        return ref.ssd_ref(xh, dt, a_log, b_ssm, c_ssm)
    xh, dt = _operand(xh, 4, "xh"), _operand(dt, 3, "dt")
    b_ssm, c_ssm = _operand(b_ssm, 3, "b_ssm"), _operand(c_ssm, 3, "c_ssm")
    bsz, s, n, p = xh.shape
    ds = b_ssm.shape[-1]
    if (dt.shape != (bsz, s, n) or b_ssm.shape != (bsz, s, ds)
            or c_ssm.shape != b_ssm.shape):
        raise ValueError(f"shapes xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b_ssm.shape)}, c "
                         f"{tuple(c_ssm.shape)}")
    a2 = _operand(a_log if a_log.dim() == 2 else a_log[None], 2, "a_log")
    groups = a2.shape[0]
    if a2.shape[1] != n or bsz % groups:
        raise ValueError(f"a_log {tuple(a_log.shape)} for {bsz} rows of "
                         f"{n} heads")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    y = torch.empty((bsz, s, n, p), device=xh.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 10)(
        xh.stride(0), xh.stride(1), xh.stride(2), dt.stride(0), dt.stride(1),
        b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1),
        a2.stride(0) if groups > 1 else 0)
    if y.numel():
        build.launch(library(), "ssd_scan_fwd", "ssd_scan", LAUNCHES,
                     xh.device, xh.data_ptr(), dt.data_ptr(), a2.data_ptr(),
                     b_ssm.data_ptr(), c_ssm.data_ptr(), y.data_ptr(), bsz, s,
                     n, p, ds, chunk, _block_h(bsz, n), bsz // groups,
                     strides)
    return y
