"""Wrappers around the flash-attention CUDA kernels
(``csrc/flash_attention.cu``).

The counterparts of ``repro.kernels.flash_attention.kernel``'s Pallas
kernels: the forward (o and the f32 log-sum-exp; in bf16 at the FL path's
S <= 32, D = 32 a tensor-core kernel, ``fwd_short_mma_kernel``) and the
backward pair, dq and dk/dv, and :func:`flash_attention_bwd`, the
counterpart of the reference function of that name, which runs both
halves: in bf16 at the FL path's S <= 32, D = 32 one tensor-core kernel
for dq, dk and dv (``bwd_short_mma_kernel``), elsewhere the pair.
Operands are kernel-layout ``(B, H, S, D)`` with equal head
counts and any batch, head and sequence strides (the last dimension
unit-stride), so a transposed view of ``(B, S, H, D)`` activations is read
in place; outputs take the layout of the matching input. q, k, v and do
are all float32 or all bfloat16 (the kernels' bf16 forms: every product
and sum in f32, each output rounded once to bf16); lse and delta are
float32 in both. D is 32, 64, 80
or 128 on the card (256, which no config has, raises); any S runs (ragged
tiles are masked). ``window`` is the
sliding-window width (None: no window).

Dispatch is by tensor device only: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors launch the kernel, which is built with ``nvcc`` at
first use, or the call raises. ``LAUNCHES`` counts the kernel launches of
each wrapper and nothing else; ``KERNEL_LAUNCHES`` counts the launches
of the two bf16 tensor-core kernels (the forward's and the fused
backward's) again by CUDA kernel.

How every kernel launches is decided here, in pure Python, by
:func:`attention_plan`: the short form (a warp per (b, h) head, a lane per
row) where S <= 32 and D = 32, and there in bf16 the tensor-core forward
and fused backward (``"mma"``) where 16-byte copies apply, else the tiled
kernels (all three on the tensor cores in 3xTF32: ``fwd_tc_kernel``,
``dq_tc_kernel``, ``dkdv_tc_kernel``); heads per block and the staging
copy width. Given a ``backend``, as the CUDA path gives it, the plan takes
heads per block from the selection table (:mod:`repro_torch.kernels.
autotune`, op ``flash_attention``, shape (b, h, s, d)) where the table
has an entry and admits it. The CPU tests check every plan the card would
run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Optional, Sequence

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.flash_attention import ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu"

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkdv": 0, "flash_attention_bf16": 0,
            "flash_attention_bwd_dq_bf16": 0,
            "flash_attention_bwd_dkdv_bf16": 0,
            "flash_attention_bwd_bf16": 0}
# the bf16 tensor-core forward's and fused backward's launches again, by
# CUDA kernel
KERNEL_LAUNCHES = {"fwd_short_mma_kernel": 0, "bwd_short_mma_kernel": 0}

# the tiled kernels' instantiations (csrc ``fwd_entry``, ``dq_entry``,
# ``dkdv_entry``): multiples of 16, a score stage of d 32 wide or 16 at
# the end (D = 80: stablelm-3b)
HEAD_DIMS = (32, 64, 80, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROBLEM = [_I] * 4 + [_P, _F, _I, _I]  # b, h, s, d, strides, scale,
#                                           causal, window
_PLAN = [_I] * 3                        # form, heads per block, vec
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + _PROBLEM + _PLAN + [_P],
    "flash_attention_bwd_dq": [_P] * 7 + _PROBLEM + _PLAN + [_P],
    "flash_attention_bwd_dkdv": [_P] * 8 + _PROBLEM + _PLAN + [_P],
}
# the bf16 entries take the same arguments as their f32 twins
_ARGTYPES.update({f"{fn}_bf16": types for fn, types in _ARGTYPES.items()})
# the fused backward: bf16 only
_ARGTYPES["flash_attention_bwd_bf16"] = [_P] * 9 + _PROBLEM + _PLAN + [_P]
# the plan's form as the C entries take it (csrc kFormTiled, kFormShort,
# kFormMma)
_FORMS = {"tiled": 0, "short": 1, "mma": 2}

# The short form (csrc kShortMaxSeq, kShortD): a lane per row of a head.
SHORT_MAX_SEQ = 32
SHORT_HEAD_DIM = 32
# Warps (heads) per block of the short forms: one spreads the heads over
# the SMs most evenly (tools/flash_attention_variants.py, backward and
# forward alike: fastest or within 3 % of two at the round's and the
# statistics pass's shapes, 4 and 8 slower at both). csrc
# kMaxHeadsPerBlock bounds it.
HEADS_PER_BLOCK = 1
MAX_HEADS_PER_BLOCK = 8
# Heads per block of the bf16 tensor-core forms (two warps each), as
# measured (tools/flash_attention_variants.py --bwd, --fwd): in the fused
# backward one is 21-27 % and four 6-11 % slower at the round's, the
# statistics pass's and the non-causal 32's shapes; in the forward one is
# 24-36 %, four 3-10 % and eight 30-40 % slower at the round's and the
# statistics pass's.
MMA_HEADS_PER_BLOCK = 2
# The most heads a block of the tensor-core forms holds: the fused
# backward's 8 warps at two a head (csrc kMaxHeadsPerBlock /
# kBwdWarpsPerHead), the forward's bound too since one choice sets both.
MMA_MAX_HEADS_PER_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One wrapper call. ``form`` is ``"short"`` (a warp per (b, h) head,
    ``heads_per_block`` warps per block, staging copies of ``vec`` bytes:
    16 where every pointer and (b, h, s) stride allows it, else 4, else
    (bf16) 2; f32 by cp.async, bf16 by loads widened to f32 on their way
    into shared memory), ``"mma"`` (bf16 at the short form's shapes with
    16-byte copies, on bf16 ``mma.sync``, two warps a head,
    ``heads_per_block`` heads a block, operands staged as bf16 by
    cp.async: the forward's o and lse, or the backward's dq, dk and dv in
    one kernel)
    or ``"tiled"``: the tensor-core tiles of the forward, dq and dk/dv (a
    block of 4 warps per head and 64 query rows, or 64 key rows for dk/dv,
    staging copies of ``vec`` bytes by the same rule)."""
    form: str
    heads_per_block: int
    vec: int


def attention_plan(b: int, h: int, s: int, d: int, *,
                   strides: Sequence[int] = (), aligned: bool = False,
                   itemsize: int = 4,
                   backend: Optional[str] = None) -> AttentionPlan:
    """The plan of the forward and of the backward (one rule for both)
    for ``b`` x ``h`` heads of ``s`` rows of width ``d`` of
    ``itemsize``-byte elements (4: f32, 2: bf16). ``strides`` are the (b,
    h, s) element strides of every operand, ``aligned`` whether every
    pointer is 16-byte aligned (else it is taken as aligned to the element
    only); ``backend``: the selection table's, whose ``heads_per_block``
    the short forms take where :func:`heads_ok` admits it."""
    vec = build.copy_width(16 if aligned else itemsize, *strides,
                           itemsize=itemsize)
    if s <= SHORT_MAX_SEQ and d == SHORT_HEAD_DIM:
        form = "mma" if itemsize == 2 and vec == 16 else "short"
        hpb = autotune.blocks_for("flash_attention", (b, h, s, d),
                                  autotune.DTYPES[itemsize],
                                  backend).get("heads_per_block")
        if not heads_ok(form, hpb):
            hpb = MMA_HEADS_PER_BLOCK if form == "mma" else HEADS_PER_BLOCK
        return AttentionPlan(form, hpb, vec)
    return AttentionPlan("tiled", 1, vec)


def heads_ok(form: str, hpb) -> bool:
    """Whether a block of the short ``form`` ("short" or "mma") holds
    ``hpb`` heads; the tiled forms take one."""
    most = {"short": MAX_HEADS_PER_BLOCK, "mma": MMA_MAX_HEADS_PER_BLOCK}
    return type(hpb) is int and 1 <= hpb <= most.get(form, 1)


def entry_error(shape, itemsize: int, sms: int, fields) -> Optional[str]:
    """Why a selection-table entry's ``fields`` are not admitted at
    ``shape`` (b, h, s, d) for contiguous (B, H, S, D) operands of
    ``itemsize`` bytes, 16-byte aligned; None where they are. ``sms`` is
    not read: no attention plan sizes its grid by it."""
    plan = attention_plan(*shape, itemsize=itemsize, aligned=True)
    for field, v in fields.items():
        if field != "heads_per_block":
            return f"unknown field {field!r}"
        if plan.form == "tiled":
            return "heads_per_block: the tiled forms take one head a block"
        if not heads_ok(plan.form, v):
            return (f"heads_per_block={v!r}: not admitted by the "
                    f"{plan.form} form")
    return None


def table_choices(shape, itemsize: int, sms: int) -> dict:
    """The admissible heads per block at ``shape`` (b, h, s, d), forward
    and backward together: the rule's first, then 1, 2, 4 and 8 where the
    form admits them; none where the plan is tiled."""
    plan = attention_plan(*shape, itemsize=itemsize, aligned=True)
    if plan.form == "tiled":
        return {}
    return {"fwd+bwd": [{"heads_per_block": c} for c in
                        [plan.heads_per_block] + [c for c in (1, 2, 4, 8)
                        if c != plan.heads_per_block
                        and heads_ok(plan.form, c)]]}


def _plan_for(tensors) -> AttentionPlan:
    return attention_plan(
        *tensors[0].shape,
        strides=[st for t in tensors for st in t.stride()[:3]],
        aligned=all(t.data_ptr() % 16 == 0 for t in tensors),
        itemsize=tensors[0].element_size(),
        backend=autotune.backend_of(tensors[0]))


def attention_fwd_plan(*tensors: torch.Tensor) -> AttentionPlan:
    """The forward's plan for these (B, H, S, D) operands, q, k, v and o
    (unit last strides): ``"mma"`` is ``fwd_short_mma_kernel``'s."""
    return _plan_for(tensors)


def attention_bwd_plan(*tensors: torch.Tensor) -> AttentionPlan:
    """The backward's plan for these (B, H, S, D) operands, inputs and
    outputs (unit last strides): ``"mma"`` is the fused kernel's, which
    :func:`flash_attention_bwd` launches."""
    return _plan_for(tensors)


def _pair_plan(*tensors: torch.Tensor) -> AttentionPlan:
    """The plan of the dq or the dk/dv kernel: the backward's, with the FMA
    short form where the fused kernel would run."""
    plan = attention_bwd_plan(*tensors)
    if plan.form == "mma":
        return AttentionPlan("short", HEADS_PER_BLOCK, plan.vec)
    return plan


def library():
    """The built kernel library, with its C signatures declared."""
    return build.load(SOURCE, _ARGTYPES)


def _operands(names, *tensors):
    """Check the CUDA (B, H, S, D) operands, all of one dtype (float32 or
    bfloat16); make each last dimension unit-stride."""
    shape, dtype = tensors[0].shape, tensors[0].dtype
    out = []
    for name, t in zip(names, tensors):
        if t.dtype not in build.DTYPES:
            raise TypeError(f"{name}: the CUDA kernels take float32 or "
                            f"bfloat16, not {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, {names[0]} {dtype}: the "
                            "operands share one dtype")
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
    index by (b * H + h) * S + s (float32 for operands of either dtype)."""
    if t.dtype != torch.float32:
        raise TypeError(f"lse and delta are float32, not {t.dtype}")
    if t.shape != (b, h, s):
        raise ValueError(f"expected ({b}, {h}, {s}), got {tuple(t.shape)}")
    return t.contiguous()


def _problem(q, window, causal, *tensors):
    """The shared tail of every C call: sizes, strides, scale and mask."""
    if window is not None and window < 1:
        raise ValueError(f"window {window}: expected None or >= 1")
    b, h, s, d = q.shape
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *[st for t in tensors for st in t.stride()[:3]])
    return (b, h, s, d, strides, d ** -0.5, int(causal),
            0 if window is None else int(window))


def _plan_args(plan: AttentionPlan) -> tuple:
    return _FORMS[plan.form], plan.heads_per_block, plan.vec


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None):
    """(o (B, H, S, D), lse (B, H, S) f32) of softmax attention: where the
    plan is ``"mma"`` (bf16, S <= 32, D = 32, 16-byte copies) one launch
    of ``fwd_short_mma_kernel``, else the short or the tiled forward."""
    if not build.on_cuda("flash_attention", q, k, v):
        return ref.attention_ref_lse(q, k, v, causal=causal, window=window)
    q, k, v = _operands("qkv", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    tail = _problem(q, window, causal, q, k, v, o)
    if o.numel():
        plan = attention_fwd_plan(q, k, v, o)
        build.launch(library(), "flash_attention_fwd", "flash_attention",
                     LAUNCHES, q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), lse.data_ptr(), *tail,
                     *_plan_args(plan), dtype=q.dtype)
        if plan.form == "mma":
            KERNEL_LAUNCHES["fwd_short_mma_kernel"] += 1
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
        tail += _plan_args(_pair_plan(q, k, v, do, dq))
        build.launch(library(), "flash_attention_bwd_dq",
                     "flash_attention_bwd_dq", LAUNCHES, q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail,
                     dtype=q.dtype)
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
        tail += _plan_args(_pair_plan(q, k, v, do, dk, dv))
        build.launch(library(), "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dkdv", LAUNCHES, q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *tail, dtype=q.dtype)
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, causal: bool = True,
                        window: Optional[int] = None):
    """(dq, dk, dv), each (B, H, S, D), from the forward's lse and ``delta
    = sum(do * o, -1)``: the counterpart of the reference's
    ``flash_attention_bwd``. One launch of the fused kernel where the plan
    is ``"mma"`` (bf16, S <= 32, D = 32, 16-byte copies), else
    :func:`flash_attention_bwd_dq` then :func:`flash_attention_bwd_dkdv`."""
    if not build.on_cuda("flash_attention_bwd", q, k, v, do, lse, delta):
        return ref.attention_ref_bwd(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
    q, k, v, do = _operands(("q", "k", "v", "do"), q, k, v, do)
    lse, delta = (_rows(t, *q.shape[:3]) for t in (lse, delta))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    plan = attention_bwd_plan(q, k, v, do, dq, dk, dv)
    if plan.form != "mma":
        return (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                       window),
                *flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                          window))
    tail = _problem(q, window, causal, q, k, v, do, dq, dk, dv)
    if dq.numel():
        build.launch(library(), "flash_attention_bwd", "flash_attention_bwd",
                     LAUNCHES, q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *tail, *_plan_args(plan), dtype=q.dtype)
        KERNEL_LAUNCHES["bwd_short_mma_kernel"] += 1
    return dq, dk, dv
