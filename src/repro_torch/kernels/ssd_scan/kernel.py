"""Wrapper around the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

The counterpart of ``repro.kernels.ssd_scan.kernel.ssd_scan``: the Mamba-2
SSD forward over chunks of ``chunk`` steps, state carried across chunks.
xh (B, S, n, p), dt (B, S, n), b/c (B, S, ds) with any row and step strides
(the last dimension unit-stride); a_log (n,) for every row or (G, n), one
per slot of B // G consecutive rows (a stride-0 expanded view is read in
place). y (B, S, n, p) comes back contiguous, in xh's dtype. xh, b and c
are all float32 or all bfloat16 (the kernel's bf16 form: every product,
decay and state in f32, y rounded once to bf16); dt is float32 in both,
as both packages compute it; a_log is any float dtype (a cast param under
bf16), upcast here as the Pallas kernel's ``astype`` does.

Dispatch is by tensor device only: CPU tensors go to the plain version in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts one per wrapper call
that reaches the card, also where the plan's chunk-parallel form makes
three launches (chunk states, the scan over them, the outputs).

How the kernel launches is decided here, in pure Python, by
:func:`ssd_plan` (heads per block, warps, sequential or chunk-parallel), so
the CPU tests can check every plan the card would run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu"

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bf16": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# the bf16 entry takes the same arguments as the f32 one
_ARGTYPES = {fn: [_P] * 8 + [_I] * 12 + [_P, _P]
             for fn in ("ssd_scan_fwd", "ssd_scan_fwd_bf16")}

# A grid of fewer blocks than BLOCKS_PER_SM x SMs leaves the card part idle.
BLOCKS_PER_SM = 2
# Steps, state rows or p columns per warp task (csrc/ssd_scan.cu kTile).
TILE = 32
# csrc/ssd_scan.cu kMaxThreads / 32
MAX_WARPS = 4
# Shared memory of a block, in floats: at most half an SM's 227 KB where
# heads share a block, and the opt-in maximum in any case.
SMEM_SHARE = 232448 // 4 // BLOCKS_PER_SM
SMEM_MAX = 232448 // 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round(v: int, to: int) -> int:
    return -(-v // to) * to


def smem_floats(chunk: int, p: int, ds: int, heads: int,
                state: bool) -> int:
    """The kernel's shared memory in floats (csrc/ssd_scan.cu ``layout``):
    c, b and the scores once per block; per head x, the decayed weights,
    the state where one enters a chunk (``state``), three per-step arrays
    and the total decay."""
    qr, pp, dsp = _round(chunk, 32), _round(p, 4), _round(ds, 4)
    per_head = qr * pp + qr * qr + (ds * pp if state else 0) + 3 * qr + 1
    return _round(qr * (dsp | 4) + chunk * dsp + qr * qr + heads * per_head,
                  4)


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """One wrapper call. A block takes one batch row and ``heads`` heads
    (they share the row's c b^T scores) with ``warps`` warps sharing the
    heads' tiles. ``chunk_parallel``: the three-pass form (each chunk's own
    end state in parallel, a scan over the ``chunks`` chunk states, the
    outputs in parallel) instead of one block walking a row's chunks in
    order. ``vec_x`` and ``vec_bc`` are the copy widths in bytes of x, and
    of b and c: 16 where the rows' pointers and strides allow it, else 4,
    else (bf16) 2."""
    heads: int
    warps: int
    chunk_parallel: bool
    chunks: int
    vec_x: int
    vec_bc: int


def ssd_plan(bsz: int, s: int, n: int, p: int, ds: int, chunk: int, *,
             sms: int, x_strides=(), bc_strides=(), x_aligned: bool = False,
             bc_aligned: bool = False, itemsize: int = 4) -> SsdPlan:
    """The launch plan for ``bsz`` rows of ``s`` steps, ``n`` heads of
    width ``p``, state width ``ds``, in chunks of ``chunk`` steps, on a card
    with ``sms`` SMs. Up to 4 heads share a block while the grid still
    fills the card; the chunk-parallel form where it does not and there
    are several chunks. ``x_strides`` (row, step, head) and ``bc_strides``
    (b's and c's row and step strides) with ``x_aligned`` / ``bc_aligned``
    (the pointers are 16-byte aligned; else taken as aligned to the element
    only) set the copy widths, counted in ``itemsize``-byte elements (4:
    f32, 2: bf16)."""
    target = BLOCKS_PER_SM * sms
    chunks = s // chunk
    heads = 1
    for hb in (4, 2):
        if (n % hb == 0 and bsz * (n // hb) >= target
                and smem_floats(chunk, p, ds, hb, chunks > 1) <= SMEM_SHARE):
            heads = hb
            break
    if smem_floats(chunk, p, ds, heads, chunks > 1) > SMEM_MAX:
        raise ValueError(f"chunk={chunk}, p={p}, ds={ds}: the block's "
                         "shared memory exceeds the card's")
    chunk_parallel = chunks > 1 and bsz * (n // heads) < target
    tasks = heads * _cdiv(chunk, TILE) * _cdiv(p, TILE)

    def vec(aligned, width, strides):
        return build.copy_width(16 if aligned else itemsize, width, *strides,
                                itemsize=itemsize)
    return SsdPlan(heads, max(1, min(MAX_WARPS, tasks)), chunk_parallel,
                   chunks, vec(x_aligned, p, x_strides),
                   vec(bc_aligned, ds, bc_strides))


def ssd_scan_plan(xh: torch.Tensor, b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                  chunk: int) -> SsdPlan:
    """The plan for these CUDA operands (unit last strides; ``chunk``
    already clamped to S)."""
    bsz, s, n, p = xh.shape
    return ssd_plan(
        bsz, s, n, p, b_ssm.shape[-1], chunk,
        sms=_sm_count(xh.device.index), x_strides=xh.stride()[:3],
        bc_strides=b_ssm.stride()[:2] + c_ssm.stride()[:2],
        x_aligned=xh.data_ptr() % 16 == 0,
        bc_aligned=b_ssm.data_ptr() % 16 == 0 and c_ssm.data_ptr() % 16 == 0,
        itemsize=xh.element_size())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _operand(t: torch.Tensor, ndim: int, name: str,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Check one CUDA operand: ``dtype`` (xh's for b and c, float32 for
    dt), ``ndim`` dims; make its last dimension unit-stride."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} here "
                        f"(xh, b and c share one dtype, float32 or "
                        f"bfloat16; dt is float32), not {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_ssm: torch.Tensor, c_ssm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """y (B, S, n, p) of the chunked SSD scan (chunk clamped to S)."""
    if not build.on_cuda("ssd_scan", xh, dt, a_log, b_ssm, c_ssm):
        return ref.ssd_ref(xh, dt, a_log, b_ssm, c_ssm)
    if xh.dtype not in build.DTYPES:
        raise TypeError(f"xh: the CUDA kernel takes float32 or bfloat16, "
                        f"not {xh.dtype}")
    xh, dt = _operand(xh, 4, "xh", xh.dtype), _operand(dt, 3, "dt")
    b_ssm = _operand(b_ssm, 3, "b_ssm", xh.dtype)
    c_ssm = _operand(c_ssm, 3, "c_ssm", xh.dtype)
    bsz, s, n, p = xh.shape
    ds = b_ssm.shape[-1]
    if (dt.shape != (bsz, s, n) or b_ssm.shape != (bsz, s, ds)
            or c_ssm.shape != b_ssm.shape):
        raise ValueError(f"shapes xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b_ssm.shape)}, c "
                         f"{tuple(c_ssm.shape)}")
    if not a_log.is_floating_point():
        raise TypeError(f"a_log: expected a float dtype, not {a_log.dtype}")
    # (G, n): the Pallas kernel's astype, on the small per-slot rates
    a2 = _operand((a_log if a_log.dim() == 2 else a_log[None]).float(), 2,
                  "a_log")
    groups = a2.shape[0]
    if a2.shape[1] != n or bsz % groups:
        raise ValueError(f"a_log {tuple(a_log.shape)} for {bsz} rows of "
                         f"{n} heads")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    y = torch.empty((bsz, s, n, p), device=xh.device, dtype=xh.dtype)
    if not y.numel():
        return y
    plan = ssd_scan_plan(xh, b_ssm, c_ssm, chunk)
    states = decays = None
    if plan.chunk_parallel:
        states = torch.empty(bsz * n * plan.chunks * ds * p,
                             device=xh.device, dtype=torch.float32)
        decays = torch.empty(bsz * n * plan.chunks, device=xh.device,
                             dtype=torch.float32)
    strides = (ctypes.c_longlong * 10)(
        xh.stride(0), xh.stride(1), xh.stride(2), dt.stride(0), dt.stride(1),
        b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1),
        a2.stride(0) if groups > 1 else 0)
    build.launch(library(), "ssd_scan_fwd", "ssd_scan", LAUNCHES, xh.device,
                 xh.data_ptr(), dt.data_ptr(), a2.data_ptr(),
                 b_ssm.data_ptr(), c_ssm.data_ptr(), y.data_ptr(),
                 None if states is None else states.data_ptr(),
                 None if decays is None else decays.data_ptr(), bsz, s, n, p,
                 ds, chunk, plan.heads, plan.warps, int(plan.chunk_parallel),
                 bsz // groups, plan.vec_x, plan.vec_bc, strides,
                 dtype=xh.dtype)
    return y
