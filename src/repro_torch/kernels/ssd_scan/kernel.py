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
widths), so the CPU tests can check every plan the card would run. Given a
``backend``, as the CUDA path gives them, both take their free fields from
the selection table (:mod:`repro_torch.kernels.autotune`, op ``ssd_scan``,
shape (B, S, n, p, ds, chunk)) where the table has an entry and admits it:
the forward's inner chunk, heads per block, chunk-parallel form and
tensor-core form (``tc``), the backward's tensor-core form (``bwd_tc``)
and heads per block.

Both ops have a chunk-parallel tensor-core form ("tc") for few rows over
many chunks (mamba2-2.7b's step): Mamba-2's chunked decomposition over
chunks of TC_CHUNK steps, a block per (head, chunk, row), every product in
3xTF32 on ``mma.sync``. The forward launches three kernels (chunk states,
the state pass, the outputs), the backward four (chunk states and
cotangents, the state passes both ways, the chunks' adjoint, the ordered
sums); ``KERNEL_LAUNCHES`` counts each by wrapper and name
(:func:`tc_key`), since both wrappers launch the chunk states and the
state pass. Where that form refuses the shape (the forward's steps not
whole chunks of TC_CHUNK, p or ds not multiples of 16) the FMA forward's
chunk-parallel form (``ssd_kernel`` over each chunk, then
``ssd_chunk_scan_kernel``) and the chunked backward, a block per head,
take few rows over many chunks.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.ssd_scan import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu"

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bf16": 0, "ssd_scan_bwd": 0,
            "ssd_scan_bwd_bf16": 0}
TC_FWD_KERNELS = ("ssd_tc_state_kernel", "ssd_tc_pass_kernel",
                  "ssd_tc_out_kernel")
TC_BWD_KERNELS = ("ssd_tc_state_kernel", "ssd_tc_pass_kernel",
                  "ssd_tc_bwd_kernel")


def tc_key(wrapper: str, name: str) -> str:
    """``KERNEL_LAUNCHES``' key of tensor-core kernel ``name`` launched by
    ``wrapper`` (a ``LAUNCHES`` key)."""
    return f"{wrapper}:{name}"


# the backward's calls again, by the CUDA kernel (form) the plan launched,
# and both ops' chunk-parallel tensor-core forms, by wrapper and each
# kernel they launch
KERNEL_LAUNCHES = {"ssd_bwd_chunk_kernel": 0, "ssd_bwd_mma_kernel": 0,
                   "ssd_bwd_tf32_kernel": 0,
                   **{tc_key(w + dt, k): 0
                      for w, names in (("ssd_scan", TC_FWD_KERNELS),
                                       ("ssd_scan_bwd", TC_BWD_KERNELS))
                      for dt in ("", "_bf16") for k in names}}

_P, _I = ctypes.c_void_p, ctypes.c_int
# each bf16 entry takes the same arguments as its f32 one
_ARGTYPES = {**{fn: [_P] * 8 + [_I] * 14 + [_P, _P]
                for fn in ("ssd_scan_fwd", "ssd_scan_fwd_bf16")},
             **{fn: [_P] * 16 + [_I] * 13 + [_P, _P]
                for fn in ("ssd_scan_bwd", "ssd_scan_bwd_bf16")}}
# the C entries' form codes
_FORMS = {"fma": 0, "chunk": 0, "mma": 1, "tf32": 1, "tc": 2}

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
# The chunk-parallel tensor-core forms' chunk, warps a block of the
# outputs and of the adjoint (csrc/ssd_scan.cu kTcQ, kTcThreads / 32,
# kTcBwdThreads / 32) and the pitch of their step tiles (kTcTp)
TC_CHUNK = 64
TC_WARPS = 16
TC_BWD_WARPS = 16
_TC_TP = TC_CHUNK + 4


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
    ``mma.sync``. ``form`` "tc": the chunk-parallel tensor-core form, a
    block per (head, chunk of TC_CHUNK, row) of TC_WARPS warps, products in
    3xTF32. ``chunk_parallel``: the three-pass form (each chunk's own
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


def tc_smem_floats(p: int, ds: int, backward: bool) -> int:
    """The shared memory in floats of the tensor-core forms' largest block
    (csrc/ssd_scan.cu ``tc_state_layout``, ``tc_out_layout``,
    ``tc_bwd_layout``): the chunk states' block (b, x and, in the
    backward, c and dy), and the outputs' (c, b or h_in, x, W) or the
    adjoint's (c, b, x, dy, h_in, G, two step tiles, the per-step
    vectors)."""
    q = TC_CHUNK
    state = (1 + backward) * q * (ds + 8 + p + 8) + 4 * q
    if backward:
        last = (2 * q * (ds + 4) + 2 * q * (p + 4) + 2 * ds * (p + 4)
                + 2 * q * _TC_TP + (9 + 2 * _cdiv(ds, 32)) * q
                + TC_BWD_WARPS + 1)
    else:
        last = (q * (ds + 4) + max(q * (ds + 4), ds * (p + 8))
                + q * (p + 8) + q * _TC_TP + 3 * q)
    return max(state, last)


def tc_error(s: int, p: int, ds: int, backward: bool) -> str | None:
    """Why the tensor-core chunk-parallel form cannot take ``s`` steps of
    heads of width ``p`` and state width ``ds`` (several chunks of
    TC_CHUNK, whole m-tiles of p and ds, the blocks within SMEM_MAX); None
    where it can. The forward's steps must also fill whole chunks."""
    chunks = _cdiv(s, TC_CHUNK) if backward else s // TC_CHUNK
    if chunks < 2:
        return f"tc: S={s} is not several chunks of {TC_CHUNK}"
    if not backward and s % TC_CHUNK:
        return f"tc: S={s} is not a multiple of {TC_CHUNK}"
    if p % 16 or ds % 16:
        return f"tc: p={p} and ds={ds} must be multiples of 16"
    if tc_smem_floats(p, ds, backward) > SMEM_MAX:
        return (f"tc: p={p}, ds={ds}: a block's shared memory exceeds the "
                "card's")
    return None


# the tensor-core chunk-parallel form's fields in a forward plan
TC_FIELDS = {"inner": TC_CHUNK, "heads": 1, "chunk_parallel": True,
             "tc": True}


def _fma_rule(bsz: int, s: int, n: int, p: int, ds: int, chunk: int,
              sms: int) -> dict:
    """The FMA form's plan fields by the rules: up to 4 heads share a
    block while the grid still fills the card; chunk-parallel where it does
    not and there are several chunks."""
    target = BLOCKS_PER_SM * sms
    inner = inner_chunk(s, p, ds, chunk)
    heads = 1
    for hb in (4, 2):
        if (n % hb == 0 and bsz * (n // hb) >= target
                and smem_floats(inner, p, ds, hb, s // inner > 1)
                <= SMEM_SHARE):
            heads = hb
            break
    return {"inner": inner, "heads": heads,
            "chunk_parallel": s // inner > 1 and bsz * (n // heads) < target,
            "tc": False}


def ssd_plan(bsz: int, s: int, n: int, p: int, ds: int, chunk: int, *,
             sms: int, x_strides=(), bc_strides=(), x_aligned: bool = False,
             bc_aligned: bool = False, itemsize: int = 4,
             backend: str | None = None) -> SsdPlan:
    """The launch plan for ``bsz`` rows of ``s`` steps, ``n`` heads of
    width ``p``, state width ``ds``, in chunks of ``chunk`` steps, on a card
    with ``sms`` SMs; the kernel runs chunks of :func:`inner_chunk`'s
    steps. Where rows x heads cannot fill the card over several whole
    chunks of TC_CHUNK, the chunk-parallel tensor-core form
    (:func:`tc_error`; the result does not depend on the chunk, as
    :func:`inner_chunk` says, so it runs chunks of TC_CHUNK whatever the
    caller's). bf16 at MMA_SHAPE (chunk, ds, p) with up to 8
    heads, walked in order with 16-byte copies, takes the tensor-core form.
    The FMA form: up to 4 heads share a block while the grid still fills
    the card; the chunk-parallel form where it does not and there are
    several chunks. ``x_strides`` (row, step, head) and ``bc_strides``
    (b's and c's row and step strides) with ``x_aligned`` / ``bc_aligned``
    (the pointers are 16-byte aligned; else taken as aligned to the element
    only) set the copy widths, counted in ``itemsize``-byte elements (4:
    f32, 2: bf16). ``backend``: the selection table's, whose ``inner``,
    ``heads``, ``chunk_parallel`` and ``tc`` replace the rules' where
    :func:`fwd_choice_error` admits them (an entry without ``tc`` sets the
    FMA form's fields)."""
    fma = _fma_rule(bsz, s, n, p, ds, chunk, sms)
    tc = bsz * n < BLOCKS_PER_SM * sms and tc_error(s, p, ds, False) is None
    tuned = {k: v for k, v in _tuned(bsz, s, n, p, ds, chunk, itemsize,
                                     backend).items()
             if k not in ("bwd_heads", "bwd_tc")}
    if tuned:
        choice = {**(TC_FIELDS if tuned.get("tc") else fma), **tuned}
        if fwd_choice_error(s, n, p, ds, chunk, **choice) is None:
            tc = choice["tc"]
            fma = choice
    if tc:
        inner, heads, chunk_parallel = TC_CHUNK, 1, True
    else:
        inner, heads, chunk_parallel = (fma["inner"], fma["heads"],
                                        fma["chunk_parallel"])
    chunks = s // inner
    tasks = heads * _cdiv(inner, TILE) * _cdiv(p, TILE)

    def vec(aligned, width, strides):
        return build.copy_width(16 if aligned else itemsize, width, *strides,
                                itemsize=itemsize)
    vec_x, vec_bc = vec(x_aligned, p, x_strides), vec(bc_aligned, ds,
                                                      bc_strides)
    if tc:
        return SsdPlan(1, TC_WARPS, True, chunks, vec_x, vec_bc, chunk,
                       TC_CHUNK, "tc")
    if (itemsize == 2 and (inner, ds, p) == MMA_SHAPE and n <= 8
            and not chunk_parallel and vec_x == vec_bc == 16):
        return SsdPlan(n, n, False, chunks, vec_x, vec_bc, chunk, inner,
                       "mma")
    return SsdPlan(heads, max(1, min(MAX_WARPS, tasks)), chunk_parallel,
                   chunks, vec_x, vec_bc, chunk, inner)


def _tuned(bsz: int, s: int, n: int, p: int, ds: int, chunk: int,
           itemsize: int, backend: str | None):
    """The selection table's plan fields at this shape (none without a
    backend or on a miss)."""
    return autotune.blocks_for("ssd_scan", (bsz, s, n, p, ds, chunk),
                               autotune.DTYPES[itemsize], backend)


def fwd_choice_error(s: int, n: int, p: int, ds: int, chunk: int, *,
                     inner, heads, chunk_parallel, tc=False) -> str | None:
    """Why the forward cannot run ``inner``-step chunks of a caller's
    ``chunk`` with ``heads`` heads a block, chunk-parallel or not, in the
    tensor-core chunk-parallel form (``tc``) or not; None where it can: the
    inner chunk divides the chunk, the heads divide n, the block's shared
    memory fits (SMEM_MAX alone, SMEM_SHARE where heads share it) and the
    chunk-parallel form has several chunks; ``tc`` runs chunks of TC_CHUNK
    (whatever the caller's chunk) with one head a block, chunk-parallel,
    where :func:`tc_error` admits the shape."""
    if not isinstance(tc, bool):
        return f"tc={tc!r} is not a flag"
    if tc:
        if (inner, heads, chunk_parallel) != (TC_CHUNK, 1, True):
            return (f"tc: the tensor-core form runs inner={TC_CHUNK}, "
                    "heads=1, chunk-parallel")
        return tc_error(s, p, ds, False)
    if not (type(inner) is int and 1 <= inner <= chunk and chunk % inner == 0):
        return f"inner={inner!r} does not divide the chunk {chunk}"
    if not (type(heads) is int and 1 <= heads <= n and n % heads == 0):
        return f"heads={heads!r} does not divide n={n}"
    if not isinstance(chunk_parallel, bool):
        return f"chunk_parallel={chunk_parallel!r} is not a flag"
    limit = SMEM_MAX if heads == 1 else SMEM_SHARE
    if smem_floats(inner, p, ds, heads, s // inner > 1) > limit:
        return (f"inner={inner} heads={heads}: the block's shared memory "
                f"exceeds {4 * limit} bytes")
    if chunk_parallel and s // inner < 2:
        return "chunk_parallel: one chunk"
    return None


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
        itemsize=xh.element_size(),
        backend=autotune.backend_of(xh))


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
                 int(a2.dtype == torch.bfloat16), _FORMS[plan.form],
                 strides, dtype=xh.dtype)
    if plan.form == "tc":
        for name in TC_FWD_KERNELS:
            KERNEL_LAUNCHES[tc_key("ssd_scan" + build.DTYPES[xh.dtype],
                                   name)] += 1
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
    (bf16, or 3xTF32). ``form`` "tc": the chunk-parallel tensor-core form
    over ``chunks`` chunks of TC_CHUNK (the last ragged), a block per
    (head, chunk, row) of TC_BWD_WARPS warps, products in 3xTF32, the heads'
    db and dc and the chunks' da summed in order by the last launch.
    ``vec_x`` (x and dy) and ``vec_bc`` (b and c) are the copy widths in
    bytes."""
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
                 bc_aligned: bool = False, itemsize: int = 4,
                 chunk: int = 128,
                 backend: str | None = None) -> SsdBwdPlan:
    """The backward's plan for ``bsz`` rows of ``s`` steps, ``n`` heads of
    width ``p`` and state width ``ds`` on a card with ``sms`` SMs. One
    chunk of MMA_SHAPE (S, ds, p) with up to 8 heads and 16-byte copies
    takes a tensor-core form (bf16 "mma", f32 "tf32"). Where rows x heads
    cannot fill the card over several chunks of TC_CHUNK, the
    chunk-parallel tensor-core form "tc" (:func:`tc_error`). Otherwise the
    chunked form: all of a row's heads in one block (up to 8, the block's
    dS summed over them in order) where the rows alone give every SM a
    block, else a block per head (few rows over many chunks). ``x_strides``
    (x's and dy's row, step and head strides), ``bc_strides`` (b's and c's
    row and step strides) and ``x_aligned`` / ``bc_aligned`` (the pointers
    are 16-byte aligned) set the copy widths, counted in ``itemsize``-byte
    elements. ``backend``: the selection table's, whose ``bwd_tc`` and
    ``bwd_heads`` replace the rules' where :func:`bwd_choice_error` admits
    them (an entry of ``bwd_heads`` alone sets the chunked form's), at the
    forward's key (``chunk``: the forward's chunk, clamped to S; the
    backward itself runs chunks of BWD_CHUNK or TC_CHUNK)."""
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
    tc = bsz * n < BLOCKS_PER_SM * sms and tc_error(s, p, ds, True) is None
    tuned = {k: v for k, v in _tuned(bsz, s, n, p, ds, min(chunk, s),
                                     itemsize, backend).items()
             if k in ("bwd_tc", "bwd_heads")}
    if tuned and bwd_choice_error(s, n, p, ds, tuned) is None:
        tc = tuned.get("bwd_tc", False)
        heads = tuned.get("bwd_heads", heads)
    if tc:
        return SsdBwdPlan("tc", TC_CHUNK, _cdiv(s, TC_CHUNK), 1,
                          TC_BWD_WARPS, 0, vec_x, vec_bc)
    if bwd_smem_floats(p, ds, heads, chunks > 1) > SMEM_MAX:
        raise ValueError(f"p={p}, ds={ds}: the backward block's shared "
                         "memory exceeds the card's")
    return SsdBwdPlan("chunk", BWD_CHUNK, chunks, heads, max(heads, 4), 0,
                      vec_x, vec_bc)


def bwd_heads_error(s: int, n: int, p: int, ds: int, heads) -> str | None:
    """Why the chunked backward cannot take ``heads`` heads a block (a warp
    each, at most BWD_MAX_WARPS, dividing n, the block within SMEM_MAX);
    None where it can."""
    if not (type(heads) is int and 1 <= heads <= min(n, BWD_MAX_WARPS)
            and n % heads == 0):
        return (f"bwd_heads={heads!r}: 1 to {BWD_MAX_WARPS} heads that "
                f"divide n={n}")
    if bwd_smem_floats(p, ds, heads, _cdiv(s, BWD_CHUNK) > 1) > SMEM_MAX:
        return (f"bwd_heads={heads}: the block's shared memory exceeds the "
                "card's")
    return None


def bwd_choice_error(s: int, n: int, p: int, ds: int,
                     fields) -> str | None:
    """Why the backward cannot take a table's ``bwd_tc`` and ``bwd_heads``
    (the tensor-core chunk-parallel form where :func:`tc_error` admits the
    shape, with no heads; else the chunked form with ``bwd_heads``, where
    :func:`bwd_heads_error` admits them); None where it can."""
    tc = fields.get("bwd_tc", False)
    if not isinstance(tc, bool):
        return f"bwd_tc={tc!r} is not a flag"
    if tc:
        if "bwd_heads" in fields:
            return "bwd_heads: the tensor-core form takes a block per head"
        return tc_error(s, p, ds, True)
    if "bwd_heads" in fields:
        return bwd_heads_error(s, n, p, ds, fields["bwd_heads"])
    return None


def _contiguous_plans(shape, itemsize: int, sms: int) -> tuple:
    """The rules' forward and backward plans at ``shape`` (B, S, n, p, ds,
    chunk) for contiguous, 16-byte aligned x and b, c split from one row
    (the model's conv output: strides of n p + 2 ds)."""
    bsz, s, n, p, ds, chunk = shape
    row = n * p + 2 * ds
    kw = dict(sms=sms, x_strides=(s * row, row, p),
              bc_strides=(s * row, row) * 2, x_aligned=True,
              bc_aligned=(n * p * itemsize) % 16 == 0, itemsize=itemsize)
    return (ssd_plan(bsz, s, n, p, ds, chunk, **kw),
            ssd_bwd_plan(bsz, s, n, p, ds, **kw))


def entry_error(shape, itemsize: int, sms: int, fields) -> str | None:
    """Why a selection-table entry's ``fields`` are not admitted at
    ``shape`` (B, S, n, p, ds, chunk) on a card of ``sms`` SMs, for the
    model's operands (:func:`_contiguous_plans`); None where they are."""
    bsz, s, n, p, ds, chunk = shape
    fwd, bwd = _contiguous_plans(shape, itemsize, sms)
    unknown = set(fields) - {"inner", "heads", "chunk_parallel", "tc",
                             "bwd_heads", "bwd_tc"}
    if unknown:
        return f"unknown fields {sorted(unknown)}"
    choice = {k: v for k, v in fields.items()
              if k not in ("bwd_heads", "bwd_tc")}
    if choice:
        if fwd.form == "mma":
            return "the forward's tensor-core form here has no choice"
        rules = (TC_FIELDS if choice.get("tc") else
                 _fma_rule(bsz, s, n, p, ds, chunk, sms))
        why = fwd_choice_error(s, n, p, ds, chunk, **{**rules, **choice})
        if why is not None:
            return why
    bwd_fields = {k: v for k, v in fields.items()
                  if k in ("bwd_heads", "bwd_tc")}
    if bwd_fields:
        if bwd.form in ("mma", "tf32"):
            return f"the backward's {bwd.form} form here has no choice"
        return bwd_choice_error(s, n, p, ds, bwd_fields)
    return None


def table_choices(shape, itemsize: int, sms: int) -> dict:
    """The admissible variants of the rules' plans at ``shape`` (B, S, n,
    p, ds, chunk): the forward's (every inner chunk of INNER_CHUNKS and the
    chunk itself that divides the chunk, heads of 1, 2, 4 and 8 that divide
    n, either FMA form, and the tensor-core chunk-parallel form) and the
    backward's (the tensor-core chunk-parallel form, or the chunked form
    with 1, 2, 4, 8 heads that divide n); the rules' own first in each, and
    only the parts that have a choice."""
    bsz, s, n, p, ds, chunk = shape
    fwd, bwd = _contiguous_plans(shape, itemsize, sms)
    first = dict(inner=fwd.inner, heads=fwd.heads,
                 chunk_parallel=fwd.chunk_parallel, tc=fwd.form == "tc")
    bwd_first = ({"bwd_tc": True} if bwd.form == "tc" else
                 {"bwd_tc": False, "bwd_heads": bwd.heads})
    parts = {"fwd": [first], "bwd": [bwd_first]}
    if fwd.form != "mma":
        for inner in sorted({chunk, *INNER_CHUNKS}, reverse=True):
            for heads in (1, 2, 4, 8):
                for cp in (False, True):
                    c = dict(inner=inner, heads=heads, chunk_parallel=cp,
                             tc=False)
                    if (c != first and fwd_choice_error(
                            s, n, p, ds, chunk, **c) is None):
                        parts["fwd"].append(c)
        c = dict(inner=TC_CHUNK, heads=1, chunk_parallel=True, tc=True)
        if c != first and fwd_choice_error(s, n, p, ds, chunk, **c) is None:
            parts["fwd"].append(c)
    if bwd.form in ("chunk", "tc"):
        for c in ([{"bwd_tc": False, "bwd_heads": h} for h in (1, 2, 4, 8)]
                  + [{"bwd_tc": True}]):
            if c != bwd_first and bwd_choice_error(s, n, p, ds, c) is None:
                parts["bwd"].append(c)
    return {part: v for part, v in parts.items() if len(v) > 1}


def ssd_bwd_scan_plan(xh: torch.Tensor, b_ssm: torch.Tensor,
                      c_ssm: torch.Tensor, dy: torch.Tensor,
                      chunk: int = 128) -> SsdBwdPlan:
    """The backward's plan for these CUDA operands (unit last strides;
    ``chunk``: the forward's, which keys the selection table)."""
    bsz, s, n, p = xh.shape
    return ssd_bwd_plan(
        bsz, s, n, p, b_ssm.shape[-1], sms=_sm_count(xh.device.index),
        x_strides=xh.stride()[:3] + dy.stride()[:3],
        bc_strides=b_ssm.stride()[:2] + c_ssm.stride()[:2],
        x_aligned=xh.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0,
        bc_aligned=b_ssm.data_ptr() % 16 == 0 and c_ssm.data_ptr() % 16 == 0,
        itemsize=xh.element_size(), chunk=chunk,
        backend=autotune.backend_of(xh))


def _bwd_operands(xh, dt, a_log, b_ssm, c_ssm, dy) -> tuple:
    """:func:`_operands` plus dy: y's shape, in xh's dtype."""
    xh, dt, a2, b_ssm, c_ssm = _operands(xh, dt, a_log, b_ssm, c_ssm)
    dy = _operand(dy, 4, "dy", xh.dtype)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for y {tuple(xh.shape)}")
    return xh, dt, a2, b_ssm, c_ssm, dy


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                 dy: torch.Tensor, *, chunk: int = 128) -> tuple:
    """(dxh, ddt, da_log, db, dc): the adjoint of the SSD scan at these
    operands for the cotangent ``dy`` of y (on the card the chunked form's
    adjoint, :func:`ssd_bwd_plan`; on the CPU autograd through the
    sequential recurrence). ``chunk``: the forward's, which keys the
    selection table; the result does not depend on it."""
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
        plan = ssd_bwd_scan_plan(xh, b_ssm, c_ssm, dy, chunk)
        tc = plan.form == "tc"
        # the state entering each chunk (and G at each chunk's end): every
        # chunk's slot in the tensor-core form, all but the first's in the
        # chunked one
        slots = plan.chunks if tc else plan.chunks - 1
        states = (torch.empty(bsz * n * slots * ds * p, device=dev,
                              dtype=f32) if slots else None)
        grads = torch.empty_like(states) if tc else None
        decays = (torch.empty(bsz * n * plan.chunks, device=dev, dtype=f32)
                  if tc else None)
        part_bc = (torch.empty(2 * bsz * s * ds * (n // plan.heads),
                               device=dev, dtype=f32)
                   if plan.heads < n or tc else None)
        part_da = torch.empty(bsz * n * (plan.chunks if tc else 1),
                              device=dev, dtype=f32)
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
                     part_da.data_ptr(),
                     None if grads is None else grads.data_ptr(),
                     None if decays is None else decays.data_ptr(), bsz, s,
                     n, p, ds, plan.heads, plan.warps, bsz // groups, groups,
                     int(a2.dtype == torch.bfloat16), plan.vec_x,
                     plan.vec_bc, _FORMS[plan.form], strides,
                     dtype=xh.dtype)
        wrapper = "ssd_scan_bwd" + build.DTYPES[xh.dtype]
        for name in ([tc_key(wrapper, k) for k in TC_BWD_KERNELS] if tc
                     else [f"ssd_bwd_{plan.form}_kernel"]):
            KERNEL_LAUNCHES[name] += 1
    da = (da if a_log.dim() == 2 else da[0]).to(a_log.dtype)
    return dxh, ddt, da, db, dc
