"""Wrappers around the flash-attention CUDA kernels
(``csrc/flash_attention.cu``).

The counterparts of ``repro.kernels.flash_attention.kernel``'s Pallas
kernels: the forward (o and the f32 log-sum-exp) and the backward pair,
dq and dk/dv. Operands are kernel-layout ``(B, H, S, D)`` with equal head
counts and any batch, head and sequence strides (the last dimension
unit-stride), so a transposed view of ``(B, S, H, D)`` activations is read
in place; outputs take the layout of the matching input. D is 32, 64 or
128 on the card; any S runs (ragged tiles are masked). ``window`` is the
sliding-window width (None: no window).

Dispatch is by tensor device only: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts the kernel launches of
each wrapper and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu"

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkdv": 0}

HEAD_DIMS = (32, 64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 4 + [_P, _F, _I, _I, _P]  # b, h, s, d, strides, scale,
#                                           causal, window, stream
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + _TAIL,
    "flash_attention_bwd_dq": [_P] * 7 + _TAIL,
    "flash_attention_bwd_dkdv": [_P] * 8 + _TAIL,
}


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _operands(names, *tensors):
    """Check the CUDA (B, H, S, D) operands; make each last dimension
    unit-stride."""
    shape = tensors[0].shape
    out = []
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, "
                            f"not {t.dtype}")
        if t.shape != shape or t.dim() != 4:
            raise ValueError(f"{name}: expected shape {tuple(shape)} "
                             f"(B, H, S, D), got {tuple(t.shape)}")
        out.append(t if t.stride(-1) == 1 else t.contiguous())
    d = shape[3]
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: the CUDA kernels take "
                                  f"{HEAD_DIMS}")
    return out


def _rows(t: torch.Tensor, b: int, h: int, s: int) -> torch.Tensor:
    """A (B, H, S) f32 row statistic as the contiguous block the kernels
    index by (b * H + h) * S + s."""
    if t.shape != (b, h, s):
        raise ValueError(f"expected ({b}, {h}, {s}), got {tuple(t.shape)}")
    return t.float().contiguous()


def _problem(q, window, causal, *tensors):
    """The shared tail of every C call: sizes, strides, scale and mask."""
    if window is not None and window < 1:
        raise ValueError(f"window {window}: expected None or >= 1")
    b, h, s, d = q.shape
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *[st for t in tensors for st in t.stride()[:3]])
    return (b, h, s, d, strides, d ** -0.5, int(causal),
            0 if window is None else int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None):
    """(o (B, H, S, D), lse (B, H, S) f32) of softmax attention."""
    if not build.on_cuda("flash_attention", q, k, v):
        return ref.attention_ref_lse(q, k, v, causal=causal, window=window)
    q, k, v = _operands("qkv", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    tail = _problem(q, window, causal, q, k, v, o)
    if o.numel():
        build.launch(library(), "flash_attention_fwd", "flash_attention",
                     LAUNCHES, q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), lse.data_ptr(), *tail)
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """dq (B, H, S, D) from the forward's lse and ``delta = sum(do * o,
    -1)``, both (B, H, S)."""
    if not build.on_cuda("flash_attention_bwd_dq", q, k, v, do, lse, delta):
        return ref.attention_ref_bwd_dq(q, k, v, do, lse, delta,
                                        causal=causal, window=window)
    q, k, v, do = _operands(("q", "k", "v", "do"), q, k, v, do)
    lse, delta = (_rows(t, *q.shape[:3]) for t in (lse, delta))
    dq = torch.empty_like(q)
    tail = _problem(q, window, causal, q, k, v, do, dq)
    if dq.numel():
        build.launch(library(), "flash_attention_bwd_dq",
                     "flash_attention_bwd_dq", LAUNCHES, q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail)
    return dq


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True,
                             window: Optional[int] = None):
    """(dk, dv), each (B, H, S, D), from the same residuals as dq."""
    if not build.on_cuda("flash_attention_bwd_dkdv", q, k, v, do, lse,
                         delta):
        return ref.attention_ref_bwd_dkdv(q, k, v, do, lse, delta,
                                          causal=causal, window=window)
    q, k, v, do = _operands(("q", "k", "v", "do"), q, k, v, do)
    lse, delta = (_rows(t, *q.shape[:3]) for t in (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tail = _problem(q, window, causal, q, k, v, do, dk, dv)
    if dk.numel():
        build.launch(library(), "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dkdv", LAUNCHES, q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *tail)
    return dk, dv
