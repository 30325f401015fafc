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
name with ``_bf16`` appended. ``KERNEL_LAUNCHES`` counts the same calls
by the CUDA kernel (the form) that each one ran.

How the kernels launch is decided here, in pure Python, by
:func:`fwd_plan`, :func:`dx_plan` and :func:`dwdb_plan` (slot fold, split
count, copy widths; for the bf16 backward the form, tile, stages and
cluster; for the bf16 forward its form, tile and stages), so the CPU
tests can check every plan the card would run. Given a ``backend``, as
the CUDA path gives them, they take the split counts and dw/db's CTA count
from the selection table (:mod:`repro_torch.kernels.autotune`, op
``fused_linear``, shape (nb, m, k, n)) where the table has an entry and
admits it, else their own rules.

Operands are float32 or bfloat16, all of one dtype per call (mixed dtypes
raise). bf16 operands launch the ``*_bf16`` entries of the same source:
bf16 tensor-core products accumulated in f32, bias and activation in f32,
and the result rounded to bf16 at the store, as the reference's kernels
do. Split-K partials stay f32 in both. A bf16 launch that fails raises,
as an f32 one does: there is no fallback to the plain version.

Each bf16 kernel has two forms. Where TMA can describe every operand
(:func:`tma_map`: 16-byte aligned pointers, strides of multiples of 8
elements) the forward, dx and dw/db launch their Hopper forms
(``form="tma"``: TMA rings, wgmma; dw/db also M <= :data:`TW_MR`);
elsewhere (fc3's 10-wide rows, odd widths, unaligned views) the
``mma.sync`` forms. The plan picks the form from the operands alone; a
tensor map that does not encode, like any failed launch, raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.fused_linear import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_linear.cu"

LAUNCHES = {"fused_linear": 0, "fused_linear_bwd_dx": 0,
            "fused_linear_bwd_dw_db": 0, "fused_linear_bf16": 0,
            "fused_linear_bwd_dx_bf16": 0, "fused_linear_bwd_dw_db_bf16": 0}

# the same launches by the CUDA kernel that ran: the f32 form, the bf16
# mma.sync form and the bf16 Hopper form of each wrapper
KERNEL_LAUNCHES = {f"{k}{form}_kernel": 0 for k in ("fwd", "dx", "dwdb")
                   for form in ("", "_bf16", "_tma")}

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
# the Hopper forms of the bf16 kernels: no copy widths; dw/db's CTA count
_ARGTYPES.update({
    "fused_linear_fwd_tma_bf16": [_P] * 5 + [_I] * 4 + [_L] * 7 + [_I] * 3
                                 + [_P],
    "fused_linear_bwd_dx_tma_bf16": [_P] * 5 + [_I] * 4 + [_L] * 8
                                    + [_I] * 4 + [_P],
    "fused_linear_bwd_dw_db_tma_bf16": [_P] * 5 + [_I] * 4 + [_L] * 9
                                       + [_I] * 2 + [_P],
})

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
# The Hopper forms (dx_tma_kernel, dwdb_tma_kernel; one CTA per SM): dx
# CTAs cover TX_BM rows x TX_BK columns of dx, the reduction N in TX_BN-deep
# stages, a ring of TX_STAGES; dw/db tiles are TW_KT x TW_NT of dw, the
# whole reduction M (at most TW_MR rows, in 16-row steps) staged at once, x
# in a ring of TW_STAGES. Neither runs in clusters: dx can pair its CTAs
# along K, multicasting dz and y (DxPlan.cluster = 2), but the pairs ran
# at half the speed on the H100 (tools/fused_linear_variants.py,
# tx_multicast), so the plans keep clusters of one.
TX_BM, TX_BK, TX_BN, TX_STAGES = 96, 192, 64, 4
TW_KT, TW_NT, TW_MR, TW_STAGES = 128, 128, 96, 2
# The forward's Hopper form (fwd_tma_kernel, one CTA per SM): CTAs cover
# TF_BM rows x TF_BN columns of y, the reduction K in TF_BK-deep stages of
# x and of w (64-column boxes, one per consumer warpgroup), a ring of
# TF_STAGES. The mma.sync forms' rings: FWD_STAGES (f32), BF16_FWD_STAGES.
TF_BM, TF_BN, TF_BK, TF_STAGES = 96, 192, 64, 4
FWD_STAGES, BF16_FWD_STAGES = 4, 3
# TMA: every box side at most 256 elements, and under the 128-byte swizzle
# an inner box side of at most 128 bytes
TMA_BOX_MAX, TMA_SWIZZLE_BYTES = 256, 128


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
    loads). ``form`` "tma" launches the bf16 Hopper form (TF_BM x TF_BN
    CTAs, stages of TF_BK, ``k_chunk`` a multiple of it; no copy widths),
    "mma_sync" the f32 or bf16 mma.sync form (FWD_BM x FWD_BN CTAs);
    ``itemsize`` is the operands' (4 f32, 2 bf16)."""
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
    form: str = "mma_sync"
    itemsize: int = 4

    @property
    def tile(self) -> tuple:
        """(rows of M, columns of N) of y per CTA."""
        return (TF_BM, TF_BN) if self.form == "tma" else (FWD_BM, FWD_BN)

    @property
    def stages(self) -> int:
        if self.form == "tma":
            return TF_STAGES
        return FWD_STAGES if self.itemsize == 4 else BF16_FWD_STAGES

    @property
    def grid(self) -> tuple:
        bm, bn = self.tile
        return (_cdiv(self.rows, bm), _cdiv(self.n, bn),
                self.batch * self.splits)


def _stage(f32_depth: int, itemsize: int) -> int:
    """Reduction steps per pipeline stage of the f32 or the bf16 form."""
    return f32_depth if itemsize == 4 else BF16_BK


def fwd_plan(nb: int, m: int, k: int, n: int, *, sxb: int, sxm: int,
             swb: int, swk: int, sbb: int, x_align: int, w_align: int,
             sms: int, itemsize: int = 4,
             backend: str | None = None) -> FwdPlan:
    """The forward's launch plan for x (nb, m, k) @ w (nb, k, n) on a card
    with ``sms`` SMs; strides in elements, ``x_align`` / ``w_align``: the
    alignment in bytes of the operand's data pointer (at most 16);
    ``itemsize`` 4 (f32) or 2 (bf16); ``backend``: the selection table's
    (its ``fwd_splits``), None for the rule alone."""
    splits = _tuned(nb, m, k, n, itemsize, backend).get("fwd_splits")
    fold = nb > 1 and swb == 0 and sbb == 0 and (m == 1 or sxb == m * sxm)
    batch, rows = nb, m
    if fold:
        batch, rows, sxb, sxm = 1, nb * m, 0, (sxb if m == 1 else sxm)
    vecs = (build.copy_width(x_align, sxb, sxm, itemsize=itemsize),
            build.copy_width(w_align, swb, swk, itemsize=itemsize))
    if itemsize == 2 and all(fwd_maps(batch, rows, k, n, sxb, sxm, swb, swk,
                                      x_align, w_align)):
        ctas = batch * _cdiv(rows, TF_BM) * _cdiv(n, TF_BN)
        splits, k_chunk = _split(ctas, k, TF_BK, sms, per_sm=1,
                                 splits=splits)
        return FwdPlan(fold, batch, rows, n, sxb, sxm, splits, k_chunk,
                       *vecs, form="tma", itemsize=itemsize)
    ctas = batch * _cdiv(rows, FWD_BM) * _cdiv(n, FWD_BN)
    splits, k_chunk = _split(ctas, k, _stage(FWD_BK, itemsize), sms,
                             splits=splits)
    return FwdPlan(fold, batch, rows, n, sxb, sxm, splits, k_chunk, *vecs,
                   itemsize=itemsize)


def fwd_maps(batch: int, rows: int, k: int, n: int, sxb: int, sxm: int,
             swb: int, swk: int, x_align: int, w_align: int) -> tuple:
    """The tensor maps of the forward's Hopper form (x, and w in boxes of
    a consumer warpgroup's 64 columns; slots folded as the plan folds
    them), each None where TMA cannot describe the operand. y leaves by
    the threads' stores, 16 bytes where its rows allow."""
    return (tma_map(k, rows, batch, sxm, sxb, TF_BK, TF_BM, x_align),
            tma_map(n, k, batch, swk, swb, 64, TF_BK, w_align))


def _tuned(nb: int, m: int, k: int, n: int, itemsize: int,
           backend: str | None):
    """The selection table's plan fields at this shape (none without a
    backend or on a miss)."""
    return autotune.blocks_for("fused_linear", (nb, m, k, n),
                               autotune.DTYPES[itemsize], backend)


def splits_ok(depth: int, splits) -> bool:
    """Whether a reduction of ``depth`` steps takes ``splits`` splits: 1 to
    ``depth // MIN_SPLIT_K`` of them (1 where that is 0)."""
    return type(splits) is int and 1 <= splits <= max(1,
                                                       depth // MIN_SPLIT_K)


def _split(ctas: int, depth: int, step: int, sms: int,
           per_sm: int = CTAS_PER_SM, splits=None) -> tuple:
    """(splits, chunk) of a reduction of ``depth`` steps for a grid of
    ``ctas`` CTAs: split only where the grid is under ``per_sm`` x ``sms``,
    into chunks that are multiples of the stage depth ``step`` and no
    shorter than MIN_SPLIT_K. With one CTA per SM (the Hopper forms) no
    more splits than fill one wave: a CTA past it would wait for a whole
    CTA's time. ``splits``: a selection table's count, taken instead of
    the rule's where :func:`splits_ok` admits it."""
    if not splits_ok(depth, splits):
        target, ctas = per_sm * sms, max(1, ctas)
        splits = 1
        if ctas < target:
            want = target // ctas if per_sm == 1 else _cdiv(target, ctas)
            splits = max(1, min(want, depth // MIN_SPLIT_K))
    chunk = step * max(1, _cdiv(_cdiv(depth, splits), step))
    return max(1, _cdiv(depth, chunk)), chunk


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """A bf16 operand as ``encode_bf16_3d`` (csrc/hopper.cuh) hands it to
    ``cuTensorMapEncodeTiled``: ``dims`` (inner, rows, batch) in elements,
    the byte ``strides`` of a row and of a batch matrix, and the ``box``
    (inner, rows, 1) copied per TMA load or store, 128-byte swizzled."""
    dims: tuple
    strides: tuple
    box: tuple


def tma_map(inner: int, rows: int, batch: int, row_stride: int,
            batch_stride: int, box_inner: int, box_rows: int,
            align: int) -> TmaMap | None:
    """The tensor map of a bf16 operand of ``batch`` x ``rows`` x ``inner``
    elements (strides in elements, unit inner stride; a batch stride of 0,
    one matrix for every slot, maps one matrix) whose pointer is aligned to
    ``align`` bytes, or None where TMA cannot describe it:
    cuTensorMapEncodeTiled takes a 16-byte aligned base, byte strides that
    are multiples of 16 below 2^40, dims of 1 to 2^32 and box sides of 1 to
    256 elements, the inner one at most the swizzle's 128 bytes. Rows that
    overlap (a row stride under the row, a batch stride under the matrix)
    are left to the mma.sync forms too."""
    if batch_stride == 0:
        batch, batch_stride = 1, rows * row_stride
    dims = (inner, rows, batch)
    strides = (2 * row_stride, 2 * batch_stride)
    box = (box_inner, box_rows, 1)
    ok = (align % 16 == 0
          and all(1 <= d <= 2 ** 32 for d in dims)
          and all(s % 16 == 0 and 0 < s < 2 ** 40 for s in strides)
          and row_stride >= inner
          and (batch == 1 or batch_stride >= rows * row_stride)
          and all(1 <= b <= TMA_BOX_MAX for b in box)
          and 2 * box_inner <= TMA_SWIZZLE_BYTES
          and (2 * box_inner) % 16 == 0)
    return TmaMap(dims, strides, box) if ok else None


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """One dx launch. With ``fold`` the slots (sharing one stride-0 w) are
    folded into one row axis: ``batch = 1`` slot of ``rows = B * M`` rows at
    row strides ``sdm`` (dy) and ``sym`` (y). Above 1, ``splits`` ranges of
    the reduction N, ``n_chunk`` deep (a multiple of :data:`DX_BK`), each
    sum into a scratch buffer; ``vec_dz`` (dy and y) and ``vec_w`` are copy
    widths in bytes as in :class:`FwdPlan`. ``form`` "tma" launches the
    Hopper form (TX_BM x TX_BK CTAs, stages of TX_BN, no copy widths;
    ``cluster`` 2 pairs the CTAs along K, where the K blocks pair up, to
    multicast dz and y), "mma_sync" the f32 or bf16 mma.sync form (DX_BM
    x DX_BN CTAs)."""
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
    form: str = "mma_sync"
    cluster: int = 1

    @property
    def tile(self) -> tuple:
        """(rows of M, columns of K) of dx per CTA."""
        return (TX_BM, TX_BK) if self.form == "tma" else (DX_BM, DX_BN)

    @property
    def stages(self) -> int:
        return TX_STAGES if self.form == "tma" else 2

    @property
    def grid(self) -> tuple:
        bm, bk = self.tile
        return (_cdiv(self.rows, bm), _cdiv(self.k, bk),
                self.batch * self.splits)


def dx_plan(nb: int, m: int, k: int, n: int, *, strides, swb: int, swk: int,
            dz_align: int, w_align: int, sms: int,
            itemsize: int = 4, backend: str | None = None) -> DxPlan:
    """dx's launch plan for dz (nb, m, n) @ w (nb, k, n)^T on a card with
    ``sms`` SMs; ``strides``: the batch and row strides of dy and y (dy's
    again when there is no mask), in elements; ``dz_align``: the alignment
    in bytes of dy's and y's pointers, ``w_align``: of w's; ``backend``:
    the selection table's (its ``dx_splits``)."""
    splits = _tuned(nb, m, k, n, itemsize, backend).get("dx_splits")
    sdb, sdm, syb, sym = strides
    fold = nb > 1 and swb == 0 and (
        m == 1 or (sdb == m * sdm and syb == m * sym))
    batch, rows = nb, m
    if fold:
        batch, rows = 1, nb * m
        if m == 1:
            sdm, sym = sdb, syb
        sdb = syb = 0
    vecs = (build.copy_width(dz_align, sdb, sdm, syb, sym, itemsize=itemsize),
            build.copy_width(w_align, swb, swk, itemsize=itemsize))
    if itemsize == 2 and all(dx_maps(batch, rows, k, n, sdb, sdm, syb, sym,
                                     swb, swk, dz_align, w_align)):
        ctas = batch * _cdiv(rows, TX_BM) * _cdiv(k, TX_BK)
        splits, n_chunk = _split(ctas, n, TX_BN, sms, per_sm=1,
                                 splits=splits)
        return DxPlan(fold, batch, rows, k, sdb, sdm, syb, sym, splits,
                      n_chunk, *vecs, form="tma")
    ctas = batch * _cdiv(rows, DX_BM) * _cdiv(k, DX_BN)
    splits, n_chunk = _split(ctas, n, _stage(DX_BK, itemsize), sms,
                             splits=splits)
    return DxPlan(fold, batch, rows, k, sdb, sdm, syb, sym, splits, n_chunk,
                  *vecs)


def dx_maps(batch: int, rows: int, k: int, n: int, sdb: int, sdm: int,
            syb: int, sym: int, swb: int, swk: int, dz_align: int,
            w_align: int, cluster: int = 1) -> tuple:
    """The tensor maps of dx's Hopper form (w, dy, y; slots folded as the
    plan folds them; each CTA of a cluster fetches 1 / ``cluster`` of the
    rows of dy and y), each None where TMA cannot describe the operand."""
    box_rows = TX_BM // cluster
    return (tma_map(n, k, batch, swk, swb, TX_BN, TX_BK, w_align),
            tma_map(n, rows, batch, sdm, sdb, TX_BN, box_rows, dz_align),
            tma_map(n, rows, batch, sym, syb, TX_BN, box_rows, dz_align))


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One dw/db launch. ``form`` "mma_sync": a CTA per DW_BK x DW_BN dw
    tile of each slot, each summing all of M; K = 0 keeps the first K tile,
    whose CTAs write db; ``vec_x`` and ``vec_dz`` (dy and y) as in
    :class:`FwdPlan`. ``form`` "tma": ``ctas`` persistent CTAs share the
    ``tiles`` TW_KT x TW_NT tiles of dw (slot, n-tile, k-tile; k fastest)
    in contiguous ranges; the CTA whose range holds a (slot, n-tile)'s
    k-tile 0 writes its db columns."""
    batch: int
    k: int
    n: int
    vec_x: int
    vec_dz: int
    form: str = "mma_sync"
    ctas: int = 0
    tiles: int = 0

    @property
    def tile(self) -> tuple:
        """(rows of K, columns of N) of dw per tile."""
        return (TW_KT, TW_NT) if self.form == "tma" else (DW_BK, DW_BN)

    @property
    def stages(self) -> int:
        return TW_STAGES if self.form == "tma" else 3

    cluster = 1

    @property
    def grid(self) -> tuple:
        if self.form == "tma":
            return (self.ctas, 1, 1)
        return (_cdiv(self.n, DW_BN), max(1, _cdiv(self.k, DW_BK)),
                self.batch)


def dwdb_plan(nb: int, m: int, k: int, n: int, *, strides, x_align: int,
              dz_align: int, itemsize: int = 4, sms: int = 132,
              backend: str | None = None) -> DwPlan:
    """The dw/db launch plan; ``strides``: the batch and row strides of x,
    dy and y; ``x_align`` / ``dz_align``: the alignment in bytes of x's
    pointer, or of dy's and y's; ``sms``: the card's SMs (an H100's 132 by
    default); ``backend``: the selection table's (its ``dw_ctas``, 1 to
    the tile count, for the Hopper form)."""
    vecs = (build.copy_width(x_align, *strides[:2], itemsize=itemsize),
            build.copy_width(dz_align, *strides[2:], itemsize=itemsize))
    if itemsize == 2 and 1 <= m <= TW_MR and all(
            dw_maps(nb, m, k, n, strides, x_align, dz_align)):
        tiles = nb * _cdiv(n, TW_NT) * _cdiv(k, TW_KT)
        ctas = _tuned(nb, m, k, n, itemsize, backend).get("dw_ctas")
        if not (type(ctas) is int and 1 <= ctas <= tiles):
            ctas = min(tiles, sms)
        return DwPlan(nb, k, n, *vecs, form="tma", ctas=ctas, tiles=tiles)
    return DwPlan(nb, k, n, *vecs)


def dw_maps(nb: int, m: int, k: int, n: int, strides, x_align: int,
            dz_align: int) -> tuple:
    """The tensor maps of dw/db's Hopper form (x, dy, y, and dw: contiguous
    (nb, k, n), allocated by the wrapper and so aligned, stored 64 rows at
    a time, a warpgroup's share of a tile), each None where TMA cannot
    describe the operand."""
    sxb, sxm, sdb, sdm, syb, sym = strides
    rows = 16 * _cdiv(m, 16)
    return (tma_map(k, m, nb, sxm, sxb, 64, rows, x_align),
            tma_map(n, m, nb, sdm, sdb, 64, rows, dz_align),
            tma_map(n, m, nb, sym, syb, 64, rows, dz_align),
            tma_map(n, k, nb, n, k * n, 64, 64, 16))


def _contiguous_plans(shape, itemsize: int, sms: int,
                      shared: bool = False) -> tuple:
    """The rules' forward, dx and dw/db plans at ``shape`` (nb, m, k, n)
    for contiguous, 16-byte aligned operands with a relu mask (``shared``:
    one weight and bias for every slot, stride-0 views)."""
    nb, m, k, n = shape
    swb, sbb = (0, 0) if shared else (k * n, n)
    return (fwd_plan(nb, m, k, n, sxb=m * k, sxm=k, swb=swb, swk=n, sbb=sbb,
                     x_align=16, w_align=16, sms=sms, itemsize=itemsize),
            dx_plan(nb, m, k, n, strides=(m * n, n, m * n, n), swb=swb,
                    swk=n, dz_align=16, w_align=16, sms=sms,
                    itemsize=itemsize),
            dwdb_plan(nb, m, k, n, strides=(m * k, k, m * n, n, m * n, n),
                      x_align=16, dz_align=16, itemsize=itemsize, sms=sms))


def entry_error(shape, itemsize: int, sms: int, fields) -> str | None:
    """Why a selection-table entry's ``fields`` are not admitted at
    ``shape`` (nb, m, k, n) on a card of ``sms`` SMs, for contiguous
    16-byte aligned operands of ``itemsize`` bytes; None where they are."""
    nb, m, k, n = shape
    dw = _contiguous_plans(shape, itemsize, sms)[2]
    for field, v in fields.items():
        if field in ("fwd_splits", "dx_splits"):
            depth = k if field == "fwd_splits" else n
            if not splits_ok(depth, v):
                return (f"{field}={v!r}: a reduction of {depth} takes 1 to "
                        f"{max(1, depth // MIN_SPLIT_K)} splits")
        elif field == "dw_ctas":
            if dw.form != "tma":
                return ("dw_ctas: dw/db's mma.sync form here has no CTA "
                        "count")
            if not (type(v) is int and 1 <= v <= dw.tiles):
                return f"dw_ctas={v!r}: 1 to {dw.tiles} CTAs"
        else:
            return f"unknown field {field!r}"
    return None


def table_choices(shape, itemsize: int, sms: int,
                  shared: bool = False) -> dict:
    """The admissible variants of the rules' plans at ``shape`` (nb, m, k,
    n), by wrapper: the forward's and dx's split counts (1 and the powers
    of 2 up to the most a reduction takes), dw/db's CTA count (the Hopper
    form only: a quarter, half, one and two waves of one CTA an SM, up to
    the tiles); the rules' own choice first in each (``shared``: at one
    weight for every slot, whose forward and dx fold the slots), and only
    the parts that have a choice."""
    nb, m, k, n = shape
    fwd, dx, dw = _contiguous_plans(shape, itemsize, sms, shared)

    def counts(first, most):
        return [first] + [c for c in (2 ** i for i in range(12))
                          if c <= most and c != first]
    parts = {
        "fwd": [{"fwd_splits": c} for c in counts(
            fwd.splits, max(1, k // MIN_SPLIT_K))],
        "dx": [{"dx_splits": c} for c in counts(
            dx.splits, max(1, n // MIN_SPLIT_K))],
    }
    if dw.form == "tma":
        more = {c for c in (sms // 4, sms // 2, sms, 2 * sms)
                if 1 <= c <= dw.tiles}
        parts["dw"] = [{"dw_ctas": c} for c in
                       [dw.ctas] + sorted(more - {dw.ctas})]
    return {part: v for part, v in parts.items() if len(v) > 1}


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


# each C entry's CUDA kernel, by the prefix of its name
_KERNEL_PREFIX = {"fused_linear_fwd": "fwd", "fused_linear_bwd_dx": "dx",
                  "fused_linear_bwd_dw_db": "dwdb"}


def _launch(name: str, fn: str, form: str, dtype, device, *args) -> None:
    """Launch C entry ``fn`` (``_tma`` appended for the Hopper ``form``),
    or its ``_bf16`` twin for bf16 operands, counted under ``name``
    (``_bf16`` appended likewise) and, in KERNEL_LAUNCHES, under the CUDA
    kernel of the form: ``fn``'s prefix (fwd, dx or dwdb) + ``_tma`` or,
    for the bf16 mma.sync form, ``_bf16`` + ``_kernel``."""
    tma = form == "tma"
    build.launch(library(), fn + "_tma" * tma, name, LAUNCHES, device, *args,
                 dtype=dtype)
    suffix = "_tma" if tma else build.DTYPES[dtype]
    KERNEL_LAUNCHES[f"{_KERNEL_PREFIX[fn]}{suffix}_kernel"] += 1


def fused_linear_plan(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> FwdPlan:
    """The forward's plan for these CUDA operands (unit last stride)."""
    nb, m, k = x.shape
    return fwd_plan(nb, m, k, w.shape[2], sxb=x.stride(0), sxm=x.stride(1),
                    swb=w.stride(0), swk=w.stride(1), sbb=b.stride(0),
                    x_align=_align(x), w_align=_align(w),
                    sms=_sm_count(x.device.index), itemsize=x.element_size(),
                    backend=autotune.backend_of(x))


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
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(),
                plan.batch, plan.rows, k, n, plan.sxb, plan.sxm, w.stride(0),
                w.stride(1), b.stride(0), syb, sym, ACT_CODES[activation],
                plan.splits, plan.k_chunk)
        vecs = () if plan.form == "tma" else (plan.vec_x, plan.vec_w)
        _launch("fused_linear", "fused_linear_fwd", plan.form, dt, x.device,
                *args, *vecs)
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
                   itemsize=dy.element_size(),
                   backend=autotune.backend_of(dy))


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
        args = (dy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
                None if part is None else part.data_ptr(), plan.batch,
                plan.rows, k, n, plan.sdb, plan.sdm, plan.syb, plan.sym,
                w.stride(0), w.stride(1), sxb, sxm, int(relu), plan.splits,
                plan.n_chunk)
        rest = ((plan.cluster,) if plan.form == "tma"
                else (plan.vec_dz, plan.vec_w))
        _launch("fused_linear_bwd_dx", "fused_linear_bwd_dx", plan.form, dt,
                dy.device, *args, *rest)
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
                     itemsize=x.element_size(),
                     sms=_sm_count(x.device.index),
                     backend=autotune.backend_of(x))


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
        args = (x.data_ptr(), dy.data_ptr(), y.data_ptr(), dw.data_ptr(),
                db.data_ptr(), nb, m, k, n, *_dw_strides(x, dy, y),
                dw.stride(0), dw.stride(1), db.stride(0), int(relu))
        rest = ((plan.ctas,) if plan.form == "tma"
                else (plan.vec_x, plan.vec_dz))
        _launch("fused_linear_bwd_dw_db", "fused_linear_bwd_dw_db",
                plan.form, dt, x.device, *args, *rest)
    return dw, db
