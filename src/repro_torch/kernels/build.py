"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``kernels/*/csrc/`` is compiled on first use into a
shared library with a plain C interface (``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``), written to
``build/`` at the repository root under a name keyed by a hash of the
source and of the headers beside it (``csrc/*.cuh``, which the source
includes by relative path), so an edited source or header rebuilds and an
unchanged one loads at once.
:func:`build_all` starts one ``nvcc`` per source together and waits for
all of them. Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Sequence

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[pathlib.Path, ctypes.CDLL] = {}

# the operand dtypes the kernels take, and the suffix that names each
# kernel's C entry and launch counter for that dtype
DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources: Sequence[pathlib.Path]) -> None:
    """Compile every source whose library is missing, all in parallel."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, out, tmp, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(src: pathlib.Path, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``src``, built first if needed, with the C
    signatures in ``argtypes`` (name -> argument types) declared; every
    function returns a CUDA error code. Keyed by ``src`` as given: every
    kernel launch looks its library up here, and resolving a path costs a
    filesystem walk (over half a millisecond on the card's machine)."""
    lib = _LOADED.get(src)
    if lib is None:
        build_all([src])
        lib = ctypes.CDLL(str(_target(src)))
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _LOADED[src] = lib
    return lib


def copy_width(align: int, *strides, itemsize: int = 4) -> int:
    """The widest staging copy, in bytes, that a data pointer's alignment
    ``align`` (in bytes) and every stride (in elements) allow: 16, else 4,
    else (2-byte elements) 2. Every wrapper's launch plan reads its copy
    widths from here, for f32 and bf16 operands alike."""
    for width in (16, 4, 2):
        per = width // itemsize
        if (per and align % width == 0
                and all(s % per == 0 for s in strides)):
            return width
    raise ValueError(f"no copy width for {itemsize}-byte elements at "
                     f"alignment {align}")


def on_cuda(what: str, *tensors) -> bool:
    """True for CUDA operands, False for CPU ones (``None`` entries are
    skipped); raises on any other device or on a mix of devices."""
    dev = next(t.device for t in tensors if t is not None)
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return True


def launch(lib: ctypes.CDLL, fn: str, name: str, counts: Dict[str, int],
           device, *args, dtype: torch.dtype = torch.float32) -> None:
    """Call kernel entry ``fn`` of ``lib`` on ``device``'s current stream;
    raise if the launch failed, else count it under ``counts[name]``. For
    ``dtype``'s form both names take its suffix (:data:`DTYPES`)."""
    fn, name = fn + DTYPES[dtype], name + DTYPES[dtype]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    counts[name] += 1
