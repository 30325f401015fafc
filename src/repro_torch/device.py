"""Device selection and the f32 numerics contract.

The port's entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises instead of
falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is
    no usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def use_f32_numerics() -> None:
    """Full-f32 matmuls and convolutions: no TF32 in cuBLAS or cuDNN.

    The reference data plane is f32 with f32 accumulation and holds a 1e-5
    contract that TF32's 10-bit mantissa does not survive. cuDNN runs f32
    convolutions in TF32 by default on Hopper, so the simulation sets both
    flags when it starts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
