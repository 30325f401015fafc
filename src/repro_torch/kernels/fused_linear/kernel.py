"""Wrappers around the fused linear CUDA kernels (``csrc/fused_linear.cu``).

The counterparts of ``repro.kernels.fused_linear.kernel``'s three Pallas
kernels. Every operand has a leading batch (slot) dimension: x (B, M, K),
w (B, K, N), b (B, N), dy and y (B, M, N). A weight or bias may be an
expanded view with batch stride 0 — one matrix shared by every slot, read
in place with no copy.

Dispatch is by tensor device only: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts the kernel launches of
each wrapper and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_linear import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_linear.cu"

LAUNCHES = {"fused_linear": 0, "fused_linear_bwd_dx": 0,
            "fused_linear_bwd_dw_db": 0}

_MASKS = ("none", "relu")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fused_linear_fwd": [_P] * 4 + [_I] * 4 + [_L] * 7 + [_I, _P],
    "fused_linear_bwd_dx": [_P] * 4 + [_I] * 4 + [_L] * 8 + [_I, _P],
    "fused_linear_bwd_dw_db": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I, _P],
}


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _on_cuda(*tensors) -> bool:
    return build.on_cuda("fused_linear", *tensors)


def _operand(t: torch.Tensor, ndim: int, name: str) -> torch.Tensor:
    """Check one CUDA operand; make its last dimension unit-stride."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, "
                        f"not {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_mask(mask: str, y) -> None:
    if mask not in _MASKS:
        raise NotImplementedError(
            f"mask {mask!r}: the CUDA kernels take none/relu")
    if mask == "relu" and y is None:
        raise ValueError("mask='relu' needs the saved forward output y")


def _launch(name: str, fn: str, device, *args) -> None:
    build.launch(library(), fn, name, LAUNCHES, device, *args)


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activation: str = "relu") -> torch.Tensor:
    """y (B, M, N) = act(x @ w + b), act in {none, relu} on the card."""
    if not _on_cuda(x, w, b):
        return ref.fused_linear_ref(x, w, b, activation)
    if activation not in _MASKS:
        raise NotImplementedError(
            f"activation {activation!r}: the CUDA kernel fuses none/relu only")
    x, w, b = _operand(x, 3, "x"), _operand(w, 3, "w"), _operand(b, 2, "b")
    nb, m, k = x.shape
    n = w.shape[2]
    if w.shape[:2] != (nb, k) or b.shape != (nb, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    y = torch.empty((nb, m, n), device=x.device, dtype=x.dtype)
    if y.numel():
        _launch("fused_linear", "fused_linear_fwd", x.device,
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                nb, m, k, n, x.stride(0), x.stride(1), w.stride(0),
                w.stride(1), b.stride(0), y.stride(0), y.stride(1),
                int(activation == "relu"))
    return y


def fused_linear_bwd_dx(dy: torch.Tensor, w: torch.Tensor,
                        y: torch.Tensor | None = None,
                        mask: str = "none") -> torch.Tensor:
    """dx (B, M, K) = (dy * mask(y)) @ w^T, w read in its (K, N) layout."""
    if not _on_cuda(dy, w, y):
        return ref.fused_linear_bwd_dx_ref(dy, w, y, mask)
    _check_mask(mask, y)
    dy, w = _operand(dy, 3, "dy"), _operand(w, 3, "w")
    relu = mask == "relu"
    y = _operand(y, 3, "y") if relu else dy
    nb, m, n = dy.shape
    k = w.shape[1]
    if w.shape != (nb, k, n) or y.shape != dy.shape:
        raise ValueError(f"shapes dy {tuple(dy.shape)}, w {tuple(w.shape)}")
    dx = torch.empty((nb, m, k), device=dy.device, dtype=dy.dtype)
    if dx.numel():
        _launch("fused_linear_bwd_dx", "fused_linear_bwd_dx", dy.device,
                dy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
                nb, m, k, n, dy.stride(0), dy.stride(1), y.stride(0),
                y.stride(1), w.stride(0), w.stride(1), dx.stride(0),
                dx.stride(1), int(relu))
    return dx


def fused_linear_bwd_dw_db(x: torch.Tensor, dy: torch.Tensor,
                           y: torch.Tensor | None = None,
                           mask: str = "none"):
    """(dw (B, K, N), db (B, N)) = (x^T @ dz, sum_m dz) in one pass."""
    if not _on_cuda(x, dy, y):
        return ref.fused_linear_bwd_dw_db_ref(x, dy, y, mask)
    _check_mask(mask, y)
    x, dy = _operand(x, 3, "x"), _operand(dy, 3, "dy")
    relu = mask == "relu"
    y = _operand(y, 3, "y") if relu else dy
    nb, m, n = dy.shape
    k = x.shape[2]
    if x.shape[:2] != (nb, m) or y.shape != dy.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    dw = torch.empty((nb, k, n), device=x.device, dtype=x.dtype)
    db = torch.empty((nb, n), device=x.device, dtype=x.dtype)
    if dw.numel():
        _launch("fused_linear_bwd_dw_db", "fused_linear_bwd_dw_db", x.device,
                x.data_ptr(), dy.data_ptr(), y.data_ptr(), dw.data_ptr(),
                db.data_ptr(), nb, m, k, n, x.stride(0), x.stride(1),
                dy.stride(0), dy.stride(1), y.stride(0), y.stride(1),
                dw.stride(0), dw.stride(1), db.stride(0), int(relu))
    return dw, db
