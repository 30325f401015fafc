"""Wrappers around the SSD scan CUDA kernels (``csrc/ssd_scan.cu``).

:func:`ssd_scan` is the counterpart of
``repro.kernels.ssd_scan.kernel.ssd_scan``: the Mamba-2 SSD forward over
chunks of ``chunk`` steps, state carried across chunks. xh (B, S, n, p), dt
(B, S, n), b/c (B, S, ds) with any row and step strides (the last dimension
unit-stride); a_log (n,) for every row or (G, n), one per slot of B // G
consecutive rows (a stride-0 expanded view is read in place). y (B, S, n,
p) comes back contiguous, in xh's dtype. xh, b and c are all float32 or all
bfloat16 (the kernel's bf16 forms: every product, decay and state in f32, y
rounded once to bf16); dt is float32 in both, as both packages compute it;
a_log is float32 or bfloat16 (a cast param under bf16), read by the kernel
in its own dtype (any other float dtype is upcast here, as the Pallas
kernel's ``astype`` does).

:func:`ssd_scan_bwd` is the op's backward, which the reference leaves to
``jax.vjp`` through its sequential oracle: the adjoint of the chunked form,
(dxh, ddt, da_log, db, dc) from the same operands and the cotangent dy (xh's
dtype, any strides with a unit last one). dxh, db and dc come back in xh's
dtype, ddt in float32, da_log in a_log's dtype and shape.

Dispatch is by tensor device only: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors launch the kernels, which are built with ``nvcc``
at first use, or the call raises. ``LAUNCHES`` counts one per wrapper call
that reaches the card, also where the plan makes several launches (the
forward's chunk-parallel form: chunk states, the scan over them, the
outputs; the backward: the adjoint, then the ordered sums over head groups
and rows); ``KERNEL_LAUNCHES`` counts the backward's calls again by the
CUDA kernel its plan launched (the chunked or the tensor-core form).

How the kernels launch is decided here, in pure Python, by :func:`ssd_plan`
(the chunk the kernel runs, form, heads per block, warps, sequential or
chunk-parallel) and
:func:`ssd_bwd_plan` (tensor-core or chunked form, heads per block, copy
widths), so the CPU tests can check every plan the card would run.
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

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bf16": 0, "ssd_scan_bwd": 0,
            "ssd_scan_bwd_bf16": 0}
# the backward's calls again, by the CUDA kernel (form) the plan launched
KERNEL_LAUNCHES = {"ssd_bwd_chunk_kernel": 0, "ssd_bwd_mma_kernel": 0,
                   "ssd_bwd_tf32_kernel": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# each bf16 entry takes the same arguments as its f32 one
_ARGTYPES = {**{fn: [_P] * 8 + [_I] * 14 + [_P, _P]
                for fn in ("ssd_scan_fwd", "ssd_scan_fwd_bf16")},
             **{fn: [_P] * 14 + [_I] * 13 + [_P, _P]
                for fn in ("ssd_scan_bwd", "ssd_scan_bwd_bf16")}}

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
# The bf16 tensor-core form's one shape (csrc/ssd_scan.cu kMmaQ, kMmaDs,
# kMmaP): the FL path's chunk, state width and head width.
MMA_SHAPE = (32, 16, 32)
# The chunks the kernel runs a caller's chunk as where the caller's own does
# not fit in a block (mamba2-2.7b's and jamba's 256), largest first.
INNER_CHUNKS = (128, 64, 32)


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
    """One wrapper call. ``chunk`` is the caller's chunk, ``inner`` the one
    the kernel runs (see :func:`inner_chunk`), ``chunks`` the row's chunks
    of ``inner`` steps. ``form`` "fma": a block takes one batch row and
    ``heads`` heads (they share the row's c b^T scores) with ``warps``
    warps sharing the heads' tiles, products by FMA on f32 tiles. ``form``
    "mma" (bf16 at MMA_SHAPE, sequential): a persistent grid of one wave
    whose blocks walk rows through a two-deep cp.async ring of bf16 tiles,
    a warp per head (``heads`` = ``warps`` = n), products on bf16
    ``mma.sync``. ``chunk_parallel``: the three-pass form (each chunk's own
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
    chunk: int
    inner: int
    form: str = "fma"


def inner_chunk(s: int, p: int, ds: int, chunk: int) -> int:
    """The chunk the kernel runs for a caller's ``chunk`` over ``s``
    steps: the chunk itself where one head's block fits the card's shared
    memory (SMEM_MAX), else the largest of INNER_CHUNKS that divides it and
    fits. A chunk of 256 with a state width of 16 or more does not fit: its
    block keeps the 256 x 256 score block once a block and once a head.

    The result is the same function: y_t = sum over s <= t of (c_t . b_s)
    exp(cum_t - cum_s) dt_s x_s, each step's sum over every earlier step,
    whatever the chunk. A chunk only decides which of those terms the
    kernel sums as the quadratic dual form inside a chunk and which it
    carries through the state h across chunks, so the sub-chunks' state
    carried from one to the next (sequentially or by the chunk-parallel
    scan) gives the caller's chunk's outputs in another order of summation,
    within SSD_RTOL of scale (as the chunked form is of the sequential
    recurrence)."""
    def fits(q: int) -> bool:
        return smem_floats(q, p, ds, 1, s // q > 1) <= SMEM_MAX
    if fits(chunk):
        return chunk
    for q in INNER_CHUNKS:
        if q < chunk and chunk % q == 0 and fits(q):
            return q
    raise ValueError(f"chunk={chunk}, p={p}, ds={ds}: the block's shared "
                     f"memory exceeds the card's, and no inner chunk of "
                     f"{INNER_CHUNKS} divides the chunk and fits")


def ssd_plan(bsz: int, s: int, n: int, p: int, ds: int, chunk: int, *,
             sms: int, x_strides=(), bc_strides=(), x_aligned: bool = False,
             bc_aligned: bool = False, itemsize: int = 4) -> SsdPlan:
    """The launch plan for ``bsz`` rows of ``s`` steps, ``n`` heads of
    width ``p``, state width ``ds``, in chunks of ``chunk`` steps, on a card
    with ``sms`` SMs; the kernel runs chunks of :func:`inner_chunk`'s
    steps. bf16 at MMA_SHAPE (chunk, ds, p) with up to 8 heads,
    walked in order with 16-byte copies, takes the tensor-core form. The
    FMA form: up to 4 heads share a block while the grid still fills the
    card; the chunk-parallel form where it does not and there are several
    chunks. ``x_strides`` (row, step, head) and ``bc_strides``
    (b's and c's row and step strides) with ``x_aligned`` / ``bc_aligned``
    (the pointers are 16-byte aligned; else taken as aligned to the element
    only) set the copy widths, counted in ``itemsize``-byte elements (4:
    f32, 2: bf16)."""
    target = BLOCKS_PER_SM * sms
    inner = inner_chunk(s, p, ds, chunk)
    chunks = s // inner
    heads = 1
    for hb in (4, 2):
        if (n % hb == 0 and bsz * (n // hb) >= target
                and smem_floats(inner, p, ds, hb, chunks > 1) <= SMEM_SHARE):
            heads = hb
            break
    chunk_parallel = chunks > 1 and bsz * (n // heads) < target
    tasks = heads * _cdiv(inner, TILE) * _cdiv(p, TILE)

    def vec(aligned, width, strides):
        return build.copy_width(16 if aligned else itemsize, width, *strides,
                                itemsize=itemsize)
    vec_x, vec_bc = vec(x_aligned, p, x_strides), vec(bc_aligned, ds,
                                                      bc_strides)
    if (itemsize == 2 and (inner, ds, p) == MMA_SHAPE and n <= 8
            and not chunk_parallel and vec_x == vec_bc == 16):
        return SsdPlan(n, n, False, chunks, vec_x, vec_bc, chunk, inner,
                       "mma")
    return SsdPlan(heads, max(1, min(MAX_WARPS, tasks)), chunk_parallel,
                   chunks, vec_x, vec_bc, chunk, inner)


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
    """Check one CUDA operand: ``dtype`` (xh's for b, c and dy, float32 for
    dt), ``ndim`` dims; make its last dimension unit-stride."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} here "
                        f"(xh, b and c share one dtype, float32 or "
                        f"bfloat16; dt is float32), not {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _operands(xh, dt, a_log, b_ssm, c_ssm) -> tuple:
    """The checked CUDA operands of either kernel: (xh, dt, a2, b, c) with
    a2 the (G, n) rates in float32 or bfloat16 (another float dtype is
    upcast), each with a unit last stride."""
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
    a2 = a_log if a_log.dim() == 2 else a_log[None]
    if a2.dtype not in build.DTYPES:   # the Pallas kernel's astype
        a2 = a2.float()
    a2 = _operand(a2, 2, "a_log", a2.dtype)
    if a2.shape[1] != n or bsz % a2.shape[0]:
        raise ValueError(f"a_log {tuple(a_log.shape)} for {bsz} rows of "
                         f"{n} heads")
    return xh, dt, a2, b_ssm, c_ssm


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_ssm: torch.Tensor, c_ssm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """y (B, S, n, p) of the chunked SSD scan (chunk clamped to S; the
    kernel runs the plan's inner chunk, :func:`inner_chunk`)."""
    if not build.on_cuda("ssd_scan", xh, dt, a_log, b_ssm, c_ssm):
        return ref.ssd_ref(xh, dt, a_log, b_ssm, c_ssm)
    xh, dt, a2, b_ssm, c_ssm = _operands(xh, dt, a_log, b_ssm, c_ssm)
    bsz, s, n, p = xh.shape
    ds, groups = b_ssm.shape[-1], a2.shape[0]
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
                 ds, plan.inner, plan.heads, plan.warps,
                 int(plan.chunk_parallel),
                 bsz // groups, plan.vec_x, plan.vec_bc,
                 int(a2.dtype == torch.bfloat16), int(plan.form == "mma"),
                 strides, dtype=xh.dtype)
    return y


# The backward's chunk (csrc/ssd_scan.cu kBwdQ: lane = step) and its most
# warps a block (kBwdMaxThreads / 32: a warp per head)
BWD_CHUNK = 32
BWD_MAX_WARPS = 8
# The tensor-core backwards' cp.async rings (csrc/ssd_scan.cu kBwdRing,
# kTfRing)
BWD_RING = 2
TF32_RING = 1


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def bwd_smem_floats(p: int, ds: int, heads: int, state: bool) -> int:
    """The chunked backward's shared memory in floats (csrc/ssd_scan.cu
    ``bwd_layout``): c and b (rows of ds rounded up to 8, plus 4) and the
    32 x 33 scores once per block; per head x (then dX) and dy (rows of p
    rounded up to 4, or-ed with 4), a 32 x 33 step tile and four per-step
    vectors; where a row has several chunks (``state``), per head the
    entering state and G (ds rounded up to 4 rows) and two 32-row state
    products; each head's total decay."""
    q, pp, dsp = BWD_CHUNK, _round(p, 4) | 4, _round8(ds) | 4
    per_head = 2 * q * pp + q * 33 + 4 * q + 1
    if state:
        per_head += 2 * _round(ds, 4) * pp + 2 * q * dsp
    return _round(2 * q * dsp + q * 33 + heads * per_head, 4)


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    """One backward call. ``form`` "chunk": the adjoint of the chunked form
    in ``chunks`` chunks of ``chunk`` (32) steps, the last ragged where S is
    not a multiple; a block per (row, ``heads`` heads) of ``warps`` warps, a
    warp per head, products by FMA in f32 (bf16 loads widened). Where
    ``heads`` < n the heads are split across blocks and the second launch
    sums the head groups' db and dc partials in order. ``form`` "mma" (bf16)
    and "tf32" (f32), at one chunk of MMA_SHAPE: a persistent grid of one
    wave whose blocks walk rows through a ``ring``-deep cp.async ring, a
    warp per head (``heads`` = ``warps`` = n), products on ``mma.sync``
    (bf16, or 3xTF32). ``vec_x`` (x and dy) and ``vec_bc`` (b and c) are
    the copy widths in bytes."""
    form: str
    chunk: int
    chunks: int
    heads: int
    warps: int
    ring: int
    vec_x: int
    vec_bc: int


def ssd_bwd_plan(bsz: int, s: int, n: int, p: int, ds: int, *, sms: int,
                 x_strides=(), bc_strides=(), x_aligned: bool = False,
                 bc_aligned: bool = False, itemsize: int = 4) -> SsdBwdPlan:
    """The backward's plan for ``bsz`` rows of ``s`` steps, ``n`` heads of
    width ``p`` and state width ``ds`` on a card with ``sms`` SMs. One
    chunk of MMA_SHAPE (S, ds, p) with up to 8 heads and 16-byte copies
    takes a tensor-core form (bf16 "mma", f32 "tf32"). Otherwise the
    chunked form: all of a row's heads in one block (up to 8, the block's
    dS summed over them in order) where the rows alone give every SM a
    block, else a block per head (few rows over many chunks). ``x_strides``
    (x's and dy's row, step and head strides), ``bc_strides`` (b's and c's
    row and step strides) and ``x_aligned`` / ``bc_aligned`` (the pointers
    are 16-byte aligned) set the copy widths, counted in ``itemsize``-byte
    elements."""
    if p > 128:
        raise ValueError(f"p={p}: the backward kernel takes p <= 128")

    def vec(aligned, width, strides):
        return build.copy_width(16 if aligned else itemsize, width, *strides,
                                itemsize=itemsize)
    vec_x, vec_bc = vec(x_aligned, p, x_strides), vec(bc_aligned, ds,
                                                      bc_strides)
    chunks = _cdiv(s, BWD_CHUNK)
    if (s, ds, p) == MMA_SHAPE and n <= 8 and vec_x == vec_bc == 16:
        if itemsize == 2:
            return SsdBwdPlan("mma", BWD_CHUNK, 1, n, n, BWD_RING, vec_x,
                              vec_bc)
        return SsdBwdPlan("tf32", BWD_CHUNK, 1, n, n, TF32_RING, vec_x,
                          vec_bc)
    heads = n if n <= BWD_MAX_WARPS and bsz >= sms else 1
    if bwd_smem_floats(p, ds, heads, chunks > 1) > SMEM_MAX:
        heads = 1
    if bwd_smem_floats(p, ds, heads, chunks > 1) > SMEM_MAX:
        raise ValueError(f"p={p}, ds={ds}: the backward block's shared "
                         "memory exceeds the card's")
    return SsdBwdPlan("chunk", BWD_CHUNK, chunks, heads, max(heads, 4), 0,
                      vec_x, vec_bc)


def ssd_bwd_scan_plan(xh: torch.Tensor, b_ssm: torch.Tensor,
                      c_ssm: torch.Tensor, dy: torch.Tensor) -> SsdBwdPlan:
    """The backward's plan for these CUDA operands (unit last strides)."""
    bsz, s, n, p = xh.shape
    return ssd_bwd_plan(
        bsz, s, n, p, b_ssm.shape[-1], sms=_sm_count(xh.device.index),
        x_strides=xh.stride()[:3] + dy.stride()[:3],
        bc_strides=b_ssm.stride()[:2] + c_ssm.stride()[:2],
        x_aligned=xh.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0,
        bc_aligned=b_ssm.data_ptr() % 16 == 0 and c_ssm.data_ptr() % 16 == 0,
        itemsize=xh.element_size())


def _bwd_operands(xh, dt, a_log, b_ssm, c_ssm, dy) -> tuple:
    """:func:`_operands` plus dy: y's shape, in xh's dtype."""
    xh, dt, a2, b_ssm, c_ssm = _operands(xh, dt, a_log, b_ssm, c_ssm)
    dy = _operand(dy, 4, "dy", xh.dtype)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for y {tuple(xh.shape)}")
    return xh, dt, a2, b_ssm, c_ssm, dy


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                 dy: torch.Tensor) -> tuple:
    """(dxh, ddt, da_log, db, dc): the adjoint of the SSD scan at these
    operands for the cotangent ``dy`` of y (on the card the chunked form's
    adjoint, :func:`ssd_bwd_plan`; on the CPU autograd through the
    sequential recurrence)."""
    if not build.on_cuda("ssd_scan_bwd", xh, dt, a_log, b_ssm, c_ssm, dy):
        return ref.ssd_bwd_ref(xh, dt, a_log, b_ssm, c_ssm, dy)
    xh, dt, a2, b_ssm, c_ssm, dy = _bwd_operands(xh, dt, a_log, b_ssm,
                                                 c_ssm, dy)
    bsz, s, n, p = xh.shape
    ds, groups = b_ssm.shape[-1], a2.shape[0]
    dev, f32 = xh.device, torch.float32
    dxh = torch.empty((bsz, s, n, p), device=dev, dtype=xh.dtype)
    ddt = torch.empty((bsz, s, n), device=dev, dtype=f32)
    db = torch.empty((bsz, s, ds), device=dev, dtype=xh.dtype)
    dc = torch.empty((bsz, s, ds), device=dev, dtype=xh.dtype)
    da = torch.empty(a2.shape, device=dev, dtype=a2.dtype)
    if not dxh.numel():
        da.zero_()
    else:
        plan = ssd_bwd_scan_plan(xh, b_ssm, c_ssm, dy)
        states = (torch.empty(bsz * n * (plan.chunks - 1) * ds * p,
                              device=dev, dtype=f32)
                  if plan.chunks > 1 else None)
        part_bc = (torch.empty(2 * bsz * s * ds * (n // plan.heads),
                               device=dev, dtype=f32)
                   if plan.heads < n else None)
        part_da = torch.empty(bsz * n, device=dev, dtype=f32)
        strides = (ctypes.c_longlong * 13)(
            xh.stride(0), xh.stride(1), xh.stride(2), dt.stride(0),
            dt.stride(1), b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0),
            c_ssm.stride(1), dy.stride(0), dy.stride(1), dy.stride(2),
            a2.stride(0) if groups > 1 else 0)
        build.launch(library(), "ssd_scan_bwd", "ssd_scan_bwd", LAUNCHES, dev,
                     xh.data_ptr(), dt.data_ptr(), a2.data_ptr(),
                     b_ssm.data_ptr(), c_ssm.data_ptr(), dy.data_ptr(),
                     dxh.data_ptr(), ddt.data_ptr(), db.data_ptr(),
                     dc.data_ptr(), da.data_ptr(),
                     None if states is None else states.data_ptr(),
                     None if part_bc is None else part_bc.data_ptr(),
                     part_da.data_ptr(), bsz, s, n, p, ds, plan.heads,
                     plan.warps, bsz // groups, groups,
                     int(a2.dtype == torch.bfloat16), plan.vec_x,
                     plan.vec_bc, int(plan.form != "chunk"), strides,
                     dtype=xh.dtype)
        KERNEL_LAUNCHES[f"ssd_bwd_{plan.form}_kernel"] += 1
    da = (da if a_log.dim() == 2 else da[0]).to(a_log.dtype)
    return dxh, ddt, da, db, dc
