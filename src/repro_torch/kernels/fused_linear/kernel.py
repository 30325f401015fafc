"""Wrappers around the fused linear CUDA kernels (``csrc/fused_linear.cu``).

The counterparts of ``repro.kernels.fused_linear.kernel``'s three Pallas
kernels. Every operand has a leading batch (slot) dimension: x (B, M, K),
w (B, K, N), b (B, N), dy and y (B, M, N). A weight or bias may be an
expanded view with batch stride 0 — one matrix shared by every slot, read
in place with no copy.

Dispatch is by tensor device only: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts the kernel launches of
each wrapper and nothing else: one per wrapper call, also where the
forward's or dx's split-K plan makes it two launches (the partial
products and their ordered sum); bf16 launches count under the wrapper's
name with ``_bf16`` appended.

How the kernels launch is decided here, in pure Python, by
:func:`fwd_plan`, :func:`dx_plan` and :func:`dwdb_plan` (slot fold, split
count, copy widths), so the CPU tests can check every plan the card would
run.

Operands are float32 or bfloat16, all of one dtype per call (mixed dtypes
raise). bf16 operands launch the ``*_bf16`` entries of the same source:
bf16 tensor-core products accumulated in f32, bias and activation in f32,
and the result rounded to bf16 at the store, as the reference's kernels
do. Split-K partials stay f32 in both. A bf16 launch that fails raises,
as an f32 one does: there is no fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_linear import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_linear.cu"

LAUNCHES = {"fused_linear": 0, "fused_linear_bwd_dx": 0,
            "fused_linear_bwd_dw_db": 0, "fused_linear_bf16": 0,
            "fused_linear_bwd_dx_bf16": 0, "fused_linear_bwd_dw_db_bf16": 0}

_MASKS = ("none", "relu")
# activation codes of the forward kernel's epilogue
ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fused_linear_fwd": [_P] * 5 + [_I] * 4 + [_L] * 7 + [_I] * 5 + [_P],
    "fused_linear_bwd_dx": [_P] * 5 + [_I] * 4 + [_L] * 8 + [_I] * 5 + [_P],
    "fused_linear_bwd_dw_db": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I] * 3
                              + [_P],
}
# the bf16 entries take the same arguments as their f32 twins
_ARGTYPES.update({f"{fn}_bf16": types for fn, types in _ARGTYPES.items()})

# The kernels' tile shapes (csrc/fused_linear.cu): forward CTAs cover 96 x
# 64 of the output, 32 reduction steps per stage; dx CTAs 96 x 64 of dx, 32
# steps of the reduction N per stage; dw/db CTAs cover 128 x 64 of dw, 32
# rows of M per stage. The bf16 forms keep the CTA tiles and stage 64
# reduction steps (four m16n8k16 steps) in the forward and dx.
FWD_BM, FWD_BN, FWD_BK = 96, 64, 32
DX_BM, DX_BN, DX_BK = 96, 64, 32
DW_BK, DW_BN = 128, 64
BF16_BK = 64
# Every kernel's shared memory lets two CTAs share an SM: a grid of fewer
# than CTAS_PER_SM x SMs CTAs leaves the card part idle.
CTAS_PER_SM = 2
# Split a reduction no finer than this many steps per split.
MIN_SPLIT_K = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """One forward launch. With ``fold`` the slots are folded into one row
    axis: the kernel sees ``batch = 1`` slot of ``rows = B * M`` rows at row
    stride ``sxm``. Above 1, ``splits`` K ranges of ``k_chunk`` (a multiple
    of :data:`FWD_BK`) each sum into a scratch buffer; ``vec_x`` and
    ``vec_w`` are the copy widths of x and w in bytes (16, or 4 where one
    of the operand's strides or its pointer is not 16-byte aligned; bf16
    operands take 4-byte copies of two elements where the pointer and the
    strides are even, else 2-byte ones, one element at a time: cp.async
    moves 4, 8 or 16 bytes, so an odd row width of bf16 is copied by plain
    loads)."""
    fold: bool
    batch: int
    rows: int
    n: int
    sxb: int
    sxm: int
    splits: int
    k_chunk: int
    vec_x: int
    vec_w: int

    @property
    def grid(self) -> tuple:
        return (_cdiv(self.rows, FWD_BM), _cdiv(self.n, FWD_BN),
                self.batch * self.splits)


def _stage(f32_depth: int, itemsize: int) -> int:
    """Reduction steps per pipeline stage of the f32 or the bf16 form."""
    return f32_depth if itemsize == 4 else BF16_BK


def fwd_plan(nb: int, m: int, k: int, n: int, *, sxb: int, sxm: int,
             swb: int, swk: int, sbb: int, x_align: int, w_align: int,
             sms: int, itemsize: int = 4) -> FwdPlan:
    """The forward's launch plan for x (nb, m, k) @ w (nb, k, n) on a card
    with ``sms`` SMs; strides in elements, ``x_align`` / ``w_align``: the
    alignment in bytes of the operand's data pointer (at most 16);
    ``itemsize`` 4 (f32) or 2 (bf16)."""
    fold = nb > 1 and swb == 0 and sbb == 0 and (m == 1 or sxb == m * sxm)
    batch, rows = nb, m
    if fold:
        batch, rows, sxb, sxm = 1, nb * m, 0, (sxb if m == 1 else sxm)
    ctas = batch * _cdiv(rows, FWD_BM) * _cdiv(n, FWD_BN)
    splits, k_chunk = _split(ctas, k, _stage(FWD_BK, itemsize), sms)
    return FwdPlan(fold, batch, rows, n, sxb, sxm, splits, k_chunk,
                   build.copy_width(x_align, sxb, sxm, itemsize=itemsize),
                   build.copy_width(w_align, swb, swk, itemsize=itemsize))


def _split(ctas: int, depth: int, step: int, sms: int) -> tuple:
    """(splits, chunk) of a reduction of ``depth`` steps for a grid of
    ``ctas`` CTAs: split only where the grid is under CTAS_PER_SM x
    ``sms``, into chunks that are multiples of the stage depth ``step``
    and no shorter than MIN_SPLIT_K."""
    target, ctas = CTAS_PER_SM * sms, max(1, ctas)
    splits = 1
    if ctas < target:
        splits = max(1, min(_cdiv(target, ctas), depth // MIN_SPLIT_K))
    chunk = step * max(1, _cdiv(_cdiv(depth, splits), step))
    return max(1, _cdiv(depth, chunk)), chunk


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """One dx launch. With ``fold`` the slots (sharing one stride-0 w) are
    folded into one row axis: ``batch = 1`` slot of ``rows = B * M`` rows at
    row strides ``sdm`` (dy) and ``sym`` (y). Above 1, ``splits`` ranges of
    the reduction N, ``n_chunk`` deep (a multiple of :data:`DX_BK`), each
    sum into a scratch buffer; ``vec_dz`` (dy and y) and ``vec_w`` are copy
    widths in bytes as in :class:`FwdPlan`."""
    fold: bool
    batch: int
    rows: int
    k: int
    sdb: int
    sdm: int
    syb: int
    sym: int
    splits: int
    n_chunk: int
    vec_dz: int
    vec_w: int

    @property
    def grid(self) -> tuple:
        return (_cdiv(self.rows, DX_BM), _cdiv(self.k, DX_BN),
                self.batch * self.splits)


def dx_plan(nb: int, m: int, k: int, n: int, *, strides, swb: int, swk: int,
            dz_align: int, w_align: int, sms: int,
            itemsize: int = 4) -> DxPlan:
    """dx's launch plan for dz (nb, m, n) @ w (nb, k, n)^T on a card with
    ``sms`` SMs; ``strides``: the batch and row strides of dy and y (dy's
    again when there is no mask), in elements; ``dz_align``: the alignment
    in bytes of dy's and y's pointers, ``w_align``: of w's."""
    sdb, sdm, syb, sym = strides
    fold = nb > 1 and swb == 0 and (
        m == 1 or (sdb == m * sdm and syb == m * sym))
    batch, rows = nb, m
    if fold:
        batch, rows = 1, nb * m
        if m == 1:
            sdm, sym = sdb, syb
        sdb = syb = 0
    ctas = batch * _cdiv(rows, DX_BM) * _cdiv(k, DX_BN)
    splits, n_chunk = _split(ctas, n, _stage(DX_BK, itemsize), sms)
    return DxPlan(fold, batch, rows, k, sdb, sdm, syb, sym, splits, n_chunk,
                  build.copy_width(dz_align, sdb, sdm, syb, sym,
                                   itemsize=itemsize),
                  build.copy_width(w_align, swb, swk, itemsize=itemsize))


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One dw/db launch: a CTA per DW_BK x DW_BN dw tile of each slot, each
    summing all of M; K = 0 keeps the first K tile, whose CTAs write db.
    ``vec_x`` and ``vec_dz`` (dy and y) as in :class:`FwdPlan`."""
    batch: int
    k: int
    n: int
    vec_x: int
    vec_dz: int

    @property
    def grid(self) -> tuple:
        return (_cdiv(self.n, DW_BN), max(1, _cdiv(self.k, DW_BK)),
                self.batch)


def dwdb_plan(nb: int, m: int, k: int, n: int, *, strides, x_align: int,
              dz_align: int, itemsize: int = 4) -> DwPlan:
    """The dw/db launch plan; ``strides``: the batch and row strides of x,
    dy and y; ``x_align`` / ``dz_align``: the alignment in bytes of x's
    pointer, or of dy's and y's."""
    return DwPlan(nb, k, n,
                  build.copy_width(x_align, *strides[:2], itemsize=itemsize),
                  build.copy_width(dz_align, *strides[2:], itemsize=itemsize))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _align(*tensors) -> int:
    """The data pointers' common alignment in bytes, at most 16."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _on_cuda(*tensors) -> bool:
    return build.on_cuda("fused_linear", *tensors)


def _operand(t: torch.Tensor, ndim: int, name: str,
             dtype: torch.dtype) -> torch.Tensor:
    """Check one CUDA operand against the call's dtype ``dtype`` (the first
    operand's); make its last dimension unit-stride."""
    if dtype not in build.DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take float32 or "
                        f"bfloat16, not {dtype}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype} operand in a {dtype} call; the "
                        "CUDA kernels take one dtype per call")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_mask(mask: str, y) -> None:
    if mask not in _MASKS:
        raise NotImplementedError(
            f"mask {mask!r}: the CUDA kernels take none/relu")
    if mask == "relu" and y is None:
        raise ValueError("mask='relu' needs the saved forward output y")


def _launch(name: str, fn: str, dtype, device, *args) -> None:
    """Launch C entry ``fn``, or its ``_bf16`` twin for bf16 operands,
    counted under ``name`` (``_bf16`` appended likewise)."""
    build.launch(library(), fn, name, LAUNCHES, device, *args, dtype=dtype)


def fused_linear_plan(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> FwdPlan:
    """The forward's plan for these CUDA operands (unit last stride)."""
    nb, m, k = x.shape
    return fwd_plan(nb, m, k, w.shape[2], sxb=x.stride(0), sxm=x.stride(1),
                    swb=w.stride(0), swk=w.stride(1), sbb=b.stride(0),
                    x_align=_align(x), w_align=_align(w),
                    sms=_sm_count(x.device.index), itemsize=x.element_size())


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activation: str = "relu") -> torch.Tensor:
    """y (B, M, N) = act(x @ w + b), act in {none, relu, silu, gelu}."""
    if not _on_cuda(x, w, b):
        return ref.fused_linear_ref(x, w, b, activation)
    if activation not in ACT_CODES:
        raise NotImplementedError(f"activation {activation!r}")
    dt = x.dtype
    x, w, b = (_operand(x, 3, "x", dt), _operand(w, 3, "w", dt),
               _operand(b, 2, "b", dt))
    nb, m, k = x.shape
    n = w.shape[2]
    if w.shape[:2] != (nb, k) or b.shape != (nb, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    y = torch.empty((nb, m, n), device=x.device, dtype=x.dtype)
    if y.numel():
        plan = fused_linear_plan(x, w, b)
        part = (torch.empty(plan.splits * plan.batch * plan.rows * n,
                            device=x.device, dtype=torch.float32)
                if plan.splits > 1 else None)
        syb, sym = (0, n) if plan.fold else (y.stride(0), y.stride(1))
        _launch("fused_linear", "fused_linear_fwd", dt, x.device,
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(),
                plan.batch, plan.rows, k, n, plan.sxb, plan.sxm, w.stride(0),
                w.stride(1), b.stride(0), syb, sym, ACT_CODES[activation],
                plan.splits, plan.k_chunk, plan.vec_x, plan.vec_w)
    return y


def fused_linear_bwd_dx_plan(dy: torch.Tensor, w: torch.Tensor,
                             y: torch.Tensor) -> DxPlan:
    """dx's plan for these CUDA operands (``y`` is ``dy`` when no mask is
    applied)."""
    nb, m, n = dy.shape
    return dx_plan(nb, m, w.shape[1], n,
                   strides=(dy.stride(0), dy.stride(1), y.stride(0),
                            y.stride(1)),
                   swb=w.stride(0), swk=w.stride(1),
                   dz_align=_align(dy, y), w_align=_align(w),
                   sms=_sm_count(dy.device.index),
                   itemsize=dy.element_size())


def fused_linear_bwd_dx(dy: torch.Tensor, w: torch.Tensor,
                        y: torch.Tensor | None = None,
                        mask: str = "none") -> torch.Tensor:
    """dx (B, M, K) = (dy * mask(y)) @ w^T, w read in its (K, N) layout."""
    if not _on_cuda(dy, w, y):
        return ref.fused_linear_bwd_dx_ref(dy, w, y, mask)
    _check_mask(mask, y)
    dt = dy.dtype
    dy, w = _operand(dy, 3, "dy", dt), _operand(w, 3, "w", dt)
    relu = mask == "relu"
    y = _operand(y, 3, "y", dt) if relu else dy
    nb, m, n = dy.shape
    k = w.shape[1]
    if w.shape != (nb, k, n) or y.shape != dy.shape:
        raise ValueError(f"shapes dy {tuple(dy.shape)}, w {tuple(w.shape)}")
    dx = torch.empty((nb, m, k), device=dy.device, dtype=dy.dtype)
    if dx.numel():
        plan = fused_linear_bwd_dx_plan(dy, w, y)
        part = (torch.empty(plan.splits * plan.batch * plan.rows * k,
                            device=dy.device, dtype=torch.float32)
                if plan.splits > 1 else None)
        sxb, sxm = (0, k) if plan.fold else (dx.stride(0), dx.stride(1))
        _launch("fused_linear_bwd_dx", "fused_linear_bwd_dx", dt, dy.device,
                dy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
                None if part is None else part.data_ptr(), plan.batch,
                plan.rows, k, n, plan.sdb, plan.sdm, plan.syb, plan.sym,
                w.stride(0), w.stride(1), sxb, sxm, int(relu), plan.splits,
                plan.n_chunk, plan.vec_dz, plan.vec_w)
    return dx


def _dw_strides(x, dy, y) -> tuple:
    return (x.stride(0), x.stride(1), dy.stride(0), dy.stride(1),
            y.stride(0), y.stride(1))


def fused_linear_bwd_dw_db_plan(x: torch.Tensor, dy: torch.Tensor,
                                y: torch.Tensor) -> DwPlan:
    """The dw/db plan for these CUDA operands (``y`` is ``dy`` when no
    mask is applied)."""
    nb, m, k = x.shape
    return dwdb_plan(nb, m, k, dy.shape[2], strides=_dw_strides(x, dy, y),
                     x_align=_align(x), dz_align=_align(dy, y),
                     itemsize=x.element_size())


def fused_linear_bwd_dw_db(x: torch.Tensor, dy: torch.Tensor,
                           y: torch.Tensor | None = None,
                           mask: str = "none"):
    """(dw (B, K, N), db (B, N)) = (x^T @ dz, sum_m dz) in one pass."""
    if not _on_cuda(x, dy, y):
        return ref.fused_linear_bwd_dw_db_ref(x, dy, y, mask)
    _check_mask(mask, y)
    dt = x.dtype
    x, dy = _operand(x, 3, "x", dt), _operand(dy, 3, "dy", dt)
    relu = mask == "relu"
    y = _operand(y, 3, "y", dt) if relu else dy
    nb, m, n = dy.shape
    k = x.shape[2]
    if x.shape[:2] != (nb, m) or y.shape != dy.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    dw = torch.empty((nb, k, n), device=x.device, dtype=x.dtype)
    db = torch.empty((nb, n), device=x.device, dtype=dy.dtype)
    if db.numel():
        plan = fused_linear_bwd_dw_db_plan(x, dy, y)
        _launch("fused_linear_bwd_dw_db", "fused_linear_bwd_dw_db", dt,
                x.device, x.data_ptr(), dy.data_ptr(), y.data_ptr(),
                dw.data_ptr(), db.data_ptr(), nb, m, k, n,
                *_dw_strides(x, dy, y),
                dw.stride(0), dw.stride(1), db.stride(0), int(relu),
                plan.vec_x, plan.vec_dz)
    return dw, db
