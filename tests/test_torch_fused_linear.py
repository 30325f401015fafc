"""The port's fused linear kernels (plain versions, wrappers, autograd op)
held against ``repro.kernels.fused_linear`` on the same numpy inputs.

These run on the CPU, where every wrapper takes its plain PyTorch version;
the CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``. Tolerance: f32 on both sides with f32 accumulation,
atol = rtol = 1e-5 (the reference's own f32 contract); the two frameworks
sum in different orders, which costs a few ulps, far inside it.
"""
import importlib.util
import pathlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.fused_linear import ops as ref_ops  # noqa: E402
from repro.kernels.fused_linear import ref as ref_ref  # noqa: E402
from repro_torch.kernels.fused_linear import kernel, ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# M=1 (per-sample gradients), M=95 (the padded round width) and N=10
# (fc_last) are the main path's ragged shapes; (64, 128, 128) is aligned.
SHAPES = [(1, 64, 32), (95, 48, 10), (37, 70, 33), (64, 128, 128)]
# every activation of the reference's op; gelu is jax.nn.gelu's tanh form
ACTS = ["relu", "none", "silu", "gelu"]
# gelu's cotangents: XLA's CPU tanh is up to 3.8 ulp off the f64 value
# (PyTorch's 0.6), and the derivative's 1 - tanh^2 magnifies that near
# saturation: the reference's dz is up to 7.9e-6 off the exact derivative,
# the port's 2.6e-6. They are held to the reference's own f32 tolerance for
# smooth-activation gradients (tests/test_kernels.py); the forward value
# and every other activation keep TOL.
GELU_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _vjp_tol(act: str, i: int) -> dict:
    """Tolerance of output i of (y, dx, dw, db)."""
    return GELU_GRAD_TOL if act == "gelu" and i > 0 else TOL


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, b, dy


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_reference(shape, act):
    x, w, b, dy = _inputs(*shape)
    tx, tw, tb, tdy = map(torch.from_numpy, (x, w, b, dy))
    y_ref = np.array(ref_ref.fused_linear_ref(x, w, b, act))
    y = ref.fused_linear_ref(tx, tw, tb, act)
    np.testing.assert_allclose(_np(y), y_ref, **TOL)

    mask_y = y_ref if act == "relu" else None
    dx_ref = ref_ref.fused_linear_bwd_dx_ref(dy, w, mask_y, mask=act)
    dx = ref.fused_linear_bwd_dx_ref(
        tdy, tw, None if mask_y is None else torch.from_numpy(mask_y), act)
    np.testing.assert_allclose(_np(dx), np.asarray(dx_ref), **TOL)

    dw_ref, db_ref = ref_ref.fused_linear_bwd_dw_db_ref(x, dy, mask_y,
                                                        mask=act)
    dw, db = ref.fused_linear_bwd_dw_db_ref(
        tx, tdy, None if mask_y is None else torch.from_numpy(mask_y), act)
    np.testing.assert_allclose(_np(dw), np.asarray(dw_ref), **TOL)
    np.testing.assert_allclose(_np(db), np.asarray(db_ref), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_smooth_forward_matches_reference(shape, act):
    """The plain forward with the smooth activations (the kernel's epilogue
    computes the same functions) against the reference's."""
    x, w, b, _ = _inputs(*shape)
    y_ref = np.array(ref_ref.fused_linear_ref(x, w, b, act))
    y = ref.fused_linear_ref(*map(torch.from_numpy, (x, w, b)), act)
    np.testing.assert_allclose(_np(y), y_ref, **TOL)


def _port_vjp(x, w, b, dy, act):
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = ops.linear(tx, tw, tb, activation=act)
    y.backward(torch.from_numpy(dy))
    return _np(y), _np(tx.grad), _np(tw.grad), _np(tb.grad)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_reference_vjp(shape, act):
    """Forward and all three cotangents against the reference op's custom
    VJP (its "ref" impl, which runs at every shape). For silu and gelu both
    rebuild the pre-activation in the backward (remat) and pass a
    pre-multiplied dz with mask "none"."""
    x, w, b, dy = _inputs(*shape, seed=1)
    y_ref, vjp = jax.vjp(
        lambda a, c, d: ref_ops.linear(a, c, d, activation=act, impl="ref"),
        x, w, b)
    want = (y_ref, *vjp(jnp.asarray(dy)))
    for i, (got, exp) in enumerate(zip(_port_vjp(x, w, b, dy, act), want)):
        np.testing.assert_allclose(got, np.asarray(exp), **_vjp_tol(act, i))


@pytest.mark.parametrize("act", ACTS)
def test_op_matches_reference_pallas_interpret(act):
    """At an aligned shape the reference op runs its three Pallas kernels
    (interpret mode on the CPU): the port's op agrees with them."""
    x, w, b, dy = _inputs(64, 128, 128, seed=2)
    y_ref, vjp = jax.vjp(
        lambda a, c, d: ref_ops.linear(a, c, d, activation=act,
                                       impl="interpret"), x, w, b)
    want = (y_ref, *vjp(jnp.asarray(dy)))
    for i, (got, exp) in enumerate(zip(_port_vjp(x, w, b, dy, act), want)):
        np.testing.assert_allclose(got, np.asarray(exp), **_vjp_tol(act, i))


@pytest.mark.parametrize("act", ["relu", "none"])
def test_batched_wrappers_with_stride0_weights(act):
    """A batch of slots sharing one weight through an expanded stride-0 view
    equals the reference applied slot by slot; dw and db come back per
    slot."""
    s, m, k, n = 3, 95, 40, 10
    rng = np.random.default_rng(3)
    x = rng.normal(size=(s, m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    dy = rng.normal(size=(s, m, n)).astype(np.float32)
    tw = torch.from_numpy(w).expand(s, k, n)
    tb = torch.from_numpy(b).expand(s, n)
    assert tw.stride(0) == 0 and tb.stride(0) == 0
    y = kernel.fused_linear(torch.from_numpy(x), tw, tb, act)
    ty = y if act == "relu" else None
    dx = kernel.fused_linear_bwd_dx(torch.from_numpy(dy), tw, ty, act)
    dw, db = kernel.fused_linear_bwd_dw_db(torch.from_numpy(x),
                                           torch.from_numpy(dy), ty, act)
    for i in range(s):
        y_i = np.asarray(ref_ref.fused_linear_ref(x[i], w, b, act))
        np.testing.assert_allclose(_np(y[i]), y_i, **TOL)
        my = y_i if act == "relu" else None
        np.testing.assert_allclose(
            _np(dx[i]),
            np.asarray(ref_ref.fused_linear_bwd_dx_ref(dy[i], w, my, act)),
            **TOL)
        dw_i, db_i = ref_ref.fused_linear_bwd_dw_db_ref(x[i], dy[i], my, act)
        np.testing.assert_allclose(_np(dw[i]), np.asarray(dw_i), **TOL)
        np.testing.assert_allclose(_np(db[i]), np.asarray(db_i), **TOL)


def test_per_slot_and_shared_weight_op_forms():
    """linear with w (S, K, N) runs slot s on w[s]; with w (K, N) every row
    shares it and the weight gradient is the sum over slots."""
    s, m, k, n = 2, 5, 6, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(s, m, k, generator=g)
    w = torch.randn(s, k, n, generator=g, requires_grad=True)
    b = torch.randn(s, n, generator=g, requires_grad=True)
    y = ops.linear(x, w, b)
    for i in range(s):
        torch.testing.assert_close(y[i], torch.relu(x[i] @ w[i] + b[i]),
                                   **TOL)
    ws = torch.randn(k, n, generator=g, requires_grad=True)
    bs = torch.randn(n, generator=g, requires_grad=True)
    ops.linear(x, ws, bs, activation="none").sum().backward()
    torch.testing.assert_close(ws.grad,
                               x.reshape(-1, k).T @ torch.ones(s * m, n),
                               **TOL)
    torch.testing.assert_close(bs.grad, torch.full((n,), float(s * m)), **TOL)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain version and launch nothing; a device that
    is neither CPU nor CUDA raises rather than falling back."""
    before_l, before_c = dict(kernel.LAUNCHES), dict(ref.CALLS)
    x, w, b = torch.ones(1, 2, 3), torch.ones(1, 3, 4), torch.zeros(1, 4)
    kernel.fused_linear(x, w, b)
    assert kernel.LAUNCHES == before_l
    assert ref.CALLS["fused_linear"] == before_c["fused_linear"] + 1
    with pytest.raises(ValueError):
        kernel.fused_linear(x.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(NotImplementedError):
        ops.linear(x[0], w[0], b[0], activation="tanh")


# ---------------------------------------------------------------------------
# what the card cannot show here: the 3xTF32 arithmetic and the launch plan
# ---------------------------------------------------------------------------


def _rna_tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round f32 to TF32's 10 mantissa bits, to
    nearest with ties away from zero (on the magnitude bits)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tensor_core_product(a, b, terms: str) -> np.ndarray:
    """a (M, K) @ b (K, N) as mma.m16n8k8 takes it: each TF32 x TF32 product
    exact, the 8 of a k-step summed, then added to an f32 accumulator.
    ``terms`` "3x": small*big + big*small + big*big, in the kernel's order;
    "1x": big*big alone."""
    ab, bb = _rna_tf32(a), _rna_tf32(b)
    as_, bs = _rna_tf32(a - ab), _rna_tf32(b - bb)
    pairs = ([(as_, bb), (ab, bs), (ab, bb)] if terms == "3x"
             else [(ab, bb)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in pairs:
            step = pa[:, k0:k0 + 8].astype(np.float64) @ pb[k0:k0 + 8]
            acc = (acc + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("which", ["forward", "dw"])
def test_3xtf32_emulation_holds_the_kernel_tolerance(which):
    """The forward's (95, 4096) @ (4096, 256) with He-scaled weights and
    dw's x^T (256, 95) @ dz (95, 256): 3xTF32 stays within chip_smoke.py's
    kernel tolerance (1e-5 x the output scale) of the f64 product, and one
    TF32 product does not, so the check has teeth."""
    rng = np.random.default_rng(7)
    if which == "forward":
        a = rng.normal(size=(95, 4096)).astype(np.float32)
        b = (rng.normal(size=(4096, 256)) * np.sqrt(2 / 4096)).astype(
            np.float32)
    else:
        a = rng.normal(size=(95, 256)).astype(np.float32).T
        b = rng.normal(size=(95, 256)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    err3 = np.abs(_tensor_core_product(a, b, "3x") - exact).max()
    err1 = np.abs(_tensor_core_product(a, b, "1x") - exact).max()
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 > 1e-5 * scale, (err1, scale)


def _chip_smoke_cases():
    """chip_smoke.py's fused linear cases (it imports torch and the port
    only), as (B, M, K, N, shared)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [c[1:5] + (c[6],) for c in mod.CASES + mod.ACT_CASES]


# (B, M, K, N, shared): chip_smoke.py's cases and ragged shapes
PLAN_CASES = _chip_smoke_cases() + [
    (3, 37, 70, 33, False), (2, 1, 4097, 130, True), (5, 200, 1000, 65, False),
    (1, 95, 31, 7, False), (4, 95, 4096, 10, True), (7, 3, 0, 5, False),
]


def _aligned_fwd_plan(nb, m, k, n, **strides):
    """The forward's plan on a 132-SM card, every pointer 16-byte aligned."""
    return kernel.fwd_plan(nb, m, k, n, x_align=16, w_align=16,
                           sms=132, **strides)


def _contiguous_fwd_strides(nb, m, k, n, shared):
    return dict(sxb=m * k, sxm=k, swb=0 if shared else k * n, swk=n,
                sbb=0 if shared else n)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_fwd_plan_covers_every_output_once(case):
    """The forward's grid covers each output element of every slot once per
    split, and the splits' K ranges partition [0, K) into non-empty,
    FWD_BK-aligned pieces."""
    nb, m, k, n, shared = case
    plan = _aligned_fwd_plan(nb, m, k, n, **_contiguous_fwd_strides(*case))
    assert plan.batch * plan.rows == nb * m
    gx, gy, gz = plan.grid
    assert gz == plan.batch * plan.splits
    cover = np.zeros((plan.batch, plan.rows, n), np.int32)
    for bx in range(gx):
        for by in range(gy):
            for z in range(plan.batch):
                cover[z, bx * kernel.FWD_BM:(bx + 1) * kernel.FWD_BM,
                      by * kernel.FWD_BN:(by + 1) * kernel.FWD_BN] += 1
    assert (cover == 1).all()
    assert plan.k_chunk % kernel.FWD_BK == 0
    bounds = [(s * plan.k_chunk, min(k, (s + 1) * plan.k_chunk))
              for s in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert k == 0 or all(lo < hi for lo, hi in bounds)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_dwdb_plan_covers_every_output_once(case):
    """dw/db's grid covers each dw element of every slot once; db is
    written by the CTAs of the first K tile (there even when K = 0), which
    cover every column."""
    nb, m, k, n, _ = case
    plan = kernel.dwdb_plan(nb, m, k, n, x_align=16, dz_align=16,
                            strides=(m * k, k, m * n, n, m * n, n))
    gx, gy, gz = plan.grid
    assert gz == nb and gy >= 1
    cover = np.zeros((k, n), np.int32)
    for bx in range(gx):
        for by in range(gy):
            cover[by * kernel.DW_BK:(by + 1) * kernel.DW_BK,
                  bx * kernel.DW_BN:(bx + 1) * kernel.DW_BN] += 1
    assert (cover == 1).all()
    db_cover = np.zeros(n, np.int32)
    for bx in range(gx):
        db_cover[bx * kernel.DW_BN:(bx + 1) * kernel.DW_BN] += 1
    assert (db_cover == 1).all()


def test_fwd_plan_folds_only_shared_weights_over_row_contiguous_slots():
    nb, m, k, n = 12, 95, 4096, 4096
    shared = _contiguous_fwd_strides(nb, m, k, n, True)
    plan = _aligned_fwd_plan(nb, m, k, n, **shared)
    assert plan.fold and (plan.batch, plan.rows, plan.sxm) == (1, nb * m, k)
    for change in (dict(swb=k * n), dict(sbb=n), dict(sxb=96 * k)):
        plan = _aligned_fwd_plan(nb, m, k, n, **{**shared, **change})
        assert not plan.fold and (plan.batch, plan.rows) == (nb, m), change
    # one row per slot: the slot stride is the folded row stride
    one_row = _contiguous_fwd_strides(8, 1, k, n, True)
    plan = _aligned_fwd_plan(8, 1, k, n, **{**one_row, "sxm": 1,
                                            "sxb": k + 4})
    assert plan.fold and (plan.rows, plan.sxm) == (8, k + 4)
    plan = _aligned_fwd_plan(
        1, m, k, n, **_contiguous_fwd_strides(1, m, k, n, True))
    assert not plan.fold


@pytest.mark.parametrize("k,n,aligned,change,fwd_vec,dw_vec", [
    (4096, 4096, (1, 1), {}, (16, 16), (16, 16)),
    (4096, 10, (1, 1), {}, (16, 4), (16, 4)),       # fc3's 40-byte rows
    (70, 128, (1, 1), {}, (4, 16), (4, 16)),        # x rows of 70 floats
    (4096, 4096, (0, 1), {}, (4, 16), (4, 16)),     # x off 16 bytes
    (4096, 4096, (1, 0), {}, (16, 4), (16, 4)),     # w, dy, y off 16 bytes
    (4096, 4096, (1, 1), {"sxb": 95 * 4096 + 2}, (4, 16), (4, 16)),
    (4096, 4096, (1, 1), {"swb": 4096 * 4096 + 2}, (16, 4), (16, 16)),
    (4096, 12, (1, 1), {}, (16, 16), (16, 16)),     # ragged N, aligned rows
])
def test_plan_copy_width_is_16_bytes_only_where_aligned(k, n, aligned,
                                                        change, fwd_vec,
                                                        dw_vec):
    """Per operand: 16-byte copies only where its pointer and every one of
    its strides allow them (the second alignment flag stands for w in the
    forward and for dy and y in dw/db)."""
    strides = {**_contiguous_fwd_strides(6, 95, k, n, False), **change}
    x_align, w_align = (16 if a else 4 for a in aligned)
    plan = kernel.fwd_plan(6, 95, k, n, x_align=x_align, w_align=w_align,
                           sms=132, **strides)
    assert (plan.vec_x, plan.vec_w) == fwd_vec
    dw_strides = (strides["sxb"], k, 95 * n, n, 95 * n, n)
    plan = kernel.dwdb_plan(6, 95, k, n, strides=dw_strides,
                            x_align=x_align, dz_align=w_align)
    assert (plan.vec_x, plan.vec_dz) == dw_vec


def test_fwd_plan_splits_k_only_for_underfilled_grids():
    """fc2 of the round fills the card without a split; fc3 (N = 10) and
    the per-sample M = 1 pass split K."""
    def plan(nb, m, k, n, shared):
        return _aligned_fwd_plan(
            nb, m, k, n, **_contiguous_fwd_strides(nb, m, k, n, shared))
    assert plan(6, 95, 4096, 4096, False).splits == 1
    fc3 = plan(6, 95, 4096, 10, False)
    assert fc3.splits > 1 and fc3.k_chunk >= kernel.MIN_SPLIT_K
    assert plan(8, 1, 4096, 4096, True).splits > 1


# ---------------------------------------------------------------------------
# dx: the launch plan and the 3xTF32 arithmetic of the redesigned kernel
# ---------------------------------------------------------------------------


def _aligned_dx_plan(nb, m, k, n, shared, **change):
    """dx's plan on a 132-SM card for contiguous dy, y and w (w stride-0
    when ``shared``), every pointer 16-byte aligned; ``change`` overrides
    a stride or an alignment flag."""
    kw = dict(strides=(m * n, n, m * n, n), swb=0 if shared else k * n,
              swk=n, dz_align=16, w_align=16, sms=132)
    kw.update(change)
    return kernel.dx_plan(nb, m, k, n, **kw)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_dx_plan_covers_every_output_once(case):
    """dx's grid covers each dx element of every slot once per split, and
    the splits' N ranges partition [0, N) into non-empty, DX_BK-aligned
    pieces (N is dx's reduction)."""
    nb, m, k, n, shared = case
    plan = _aligned_dx_plan(*case)
    assert plan.batch * plan.rows == nb * m and plan.k == k
    gx, gy, gz = plan.grid
    assert gz == plan.batch * plan.splits
    cover = np.zeros((plan.batch, plan.rows, k), np.int32)
    for bx in range(gx):
        for by in range(gy):
            for z in range(plan.batch):
                cover[z, bx * kernel.DX_BM:(bx + 1) * kernel.DX_BM,
                      by * kernel.DX_BN:(by + 1) * kernel.DX_BN] += 1
    assert (cover == 1).all()
    assert plan.n_chunk % kernel.DX_BK == 0
    bounds = [(s * plan.n_chunk, min(n, (s + 1) * plan.n_chunk))
              for s in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert n == 0 or all(lo < hi for lo, hi in bounds)


def test_dx_plan_folds_only_shared_weights_over_row_contiguous_slots():
    nb, m, k, n = 12, 95, 4096, 4096
    plan = _aligned_dx_plan(nb, m, k, n, True)
    assert plan.fold and (plan.batch, plan.rows) == (1, nb * m)
    assert (plan.sdb, plan.sdm, plan.syb, plan.sym) == (0, n, 0, n)
    for change in (dict(swb=k * n), dict(strides=(96 * n, n, m * n, n)),
                   dict(strides=(m * n, n, 96 * n, n))):
        plan = _aligned_dx_plan(nb, m, k, n, True, **change)
        assert not plan.fold and (plan.batch, plan.rows) == (nb, m), change
    # one row per slot: the slot strides are the folded row strides
    plan = _aligned_dx_plan(8, 1, k, n, True,
                            strides=(n + 4, 1, n + 8, 1))
    assert plan.fold and (plan.rows, plan.sdm, plan.sym) == (8, n + 4, n + 8)
    assert not _aligned_dx_plan(1, m, k, n, True).fold


def test_dx_plan_splits_n_only_for_underfilled_grids():
    """The round's fc2 (384 CTAs) and the statistics pass's folded fc2 fill
    the card unsplit; the round's fc1 (48 CTAs), the evaluation's M = 232
    (24) and the per-sample pass's folded M = 1 (64) split N, each into
    enough CTAs to fill it."""
    target = kernel.CTAS_PER_SM * 132
    assert _aligned_dx_plan(6, 95, 4096, 4096, False).splits == 1
    assert _aligned_dx_plan(12, 95, 4096, 4096, True).splits == 1
    for case in [(6, 95, 512, 4096, False), (1, 232, 512, 4096, True),
                 (8, 1, 4096, 4096, True)]:
        plan = _aligned_dx_plan(*case)
        gx, gy, gz = plan.grid
        assert plan.splits > 1 and gx * gy * gz >= target, (case, plan)
        assert plan.n_chunk >= kernel.MIN_SPLIT_K
    # fc3's reduction is N = 10: nothing to split
    assert _aligned_dx_plan(6, 95, 4096, 10, False).splits == 1


@pytest.mark.parametrize("n,change,vec", [
    (4096, {}, (16, 16)),
    (10, {}, (4, 4)),                                 # fc3's 40-byte rows
    (4096, dict(dz_align=4), (4, 16)),                # dy or y off 16 bytes
    (4096, dict(w_align=4), (16, 4)),                 # w off 16 bytes
    (4096, dict(strides=(95 * 4096, 4096, 95 * 4096 + 2, 4096)), (4, 16)),
    (4096, dict(swb=4096 * 4096 + 2), (16, 4)),
    (12, {}, (16, 16)),                               # ragged N, aligned rows
])
def test_dx_plan_copy_width_is_16_bytes_only_where_aligned(n, change, vec):
    """dz's (dy and y) and w's copy widths: 16 bytes only where the
    operand's pointers and every one of its strides allow them."""
    plan = _aligned_dx_plan(6, 95, 4096, n, False, **change)
    assert (plan.vec_dz, plan.vec_w) == vec


def _dx_tensor_core_product(dz, w, n_chunk: int, stage: int,
                            terms: str) -> np.ndarray:
    """dz (M, N) @ w (K, N)^T as dx_kernel takes it: the TN operand order
    (both operands with the reduction N contiguous), per split of
    ``n_chunk`` steps a running f32 sum to which each ``stage``-deep
    stage's products are added once (the per-stage flush), the splits then
    summed in order in f32 (splitk_reduce_kernel)."""
    out = np.zeros((dz.shape[0], w.shape[0]), np.float32)
    for n0 in range(0, dz.shape[1], n_chunk):
        acc = np.zeros_like(out)
        for s0 in range(n0, min(dz.shape[1], n0 + n_chunk), stage):
            sl = slice(s0, min(s0 + stage, n0 + n_chunk))
            step = _tensor_core_product(dz[:, sl], w[:, sl].T, terms)
            acc = (acc + step).astype(np.float32)
        out = (out + acc).astype(np.float32)
    return out


@pytest.mark.parametrize("plan_case", [(1, 95, 256, 4096, False),
                                       (6, 95, 4096, 4096, False)],
                         ids=["split", "unsplit"])
def test_3xtf32_emulation_holds_the_dx_tolerance(plan_case):
    """dx's (95, 4096) dz (relu-masked dy) times w^T for 256 columns of a
    He-scaled w (K, 4096), with the per-stage flushes over N of the plan
    for one slot at K = 256 (4 CTAs: N split) or for the round's fc2 (384
    CTAs: unsplit): 3xTF32 stays within 1e-5 x the output scale of the f64
    product, one TF32 product does not."""
    plan = _aligned_dx_plan(*plan_case)
    assert (plan.splits > 1) == (plan_case[0] == 1)
    m, n, k = 95, 4096, 256
    rng = np.random.default_rng(11)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    dz = np.where(y > 0, dy, np.float32(0))
    w = (rng.normal(size=(k, n)) * np.sqrt(2 / plan_case[2])).astype(
        np.float32)
    exact = dz.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(exact).max()
    errs = {t: np.abs(_dx_tensor_core_product(dz, w, plan.n_chunk,
                                              kernel.DX_BK, t) - exact).max()
            for t in ("3x", "1x")}
    assert errs["3x"] <= 1e-5 * scale, (errs, scale)
    assert errs["1x"] > 1e-5 * scale, (errs, scale)


@pytest.mark.parametrize("mask", ["relu", "none"])
def test_bwd_dx_matches_reference_pallas_interpret(mask):
    """The port's dx wrapper on the CPU against the reference's dx kernel
    in Pallas interpret mode, with and without the relu mask."""
    rng = np.random.default_rng(12)
    m, k, n = 64, 256, 128
    dy = rng.normal(size=(m, n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * np.sqrt(2 / k)).astype(np.float32)
    from repro.kernels.fused_linear import kernel as ref_kernel
    my = y if mask == "relu" else None
    want = np.asarray(ref_kernel.fused_linear_bwd_dx(
        dy, w, my, mask=mask, interpret=True))
    got = kernel.fused_linear_bwd_dx(
        torch.from_numpy(dy)[None], torch.from_numpy(w)[None],
        None if my is None else torch.from_numpy(y)[None], mask)
    np.testing.assert_allclose(_np(got[0]), want, **TOL)


# ---------------------------------------------------------------------------
# the design-variant tools stay in step with the sources they edit
# ---------------------------------------------------------------------------

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["fused_linear_variants",
                                  "ssd_scan_variants",
                                  "flash_attention_variants"])
def test_variant_tool_substitutions_match_the_source(name):
    """Every text substitution of a variant tool finds its text exactly
    once in the CUDA source it edits (the tool raises on the card where one
    does not)."""
    mod = _tool(name)
    source = mod.kernel.SOURCE.read_text()
    for group in ("VARIANTS", "BF16_VARIANTS", "BWD_VARIANTS",
                  "BWD_TF32_VARIANTS", "BWD_BF16_VARIANTS",
                  "FWD_MMA_VARIANTS", "TB_VARIANTS", "TC_VARIANTS"):
        for variant, subs in getattr(mod, group, {}).items():
            for old, _ in subs:
                assert source.count(old) == 1, (group, variant, old)


def test_variant_tools_import_neither_jax_nor_reference():
    import os
    import subprocess
    import sys
    code = (
        "import importlib.util, sys\n"
        "for name in ('fused_linear_variants', 'ssd_scan_variants',\n"
        "             'flash_attention_variants'):\n"
        f"    spec = importlib.util.spec_from_file_location(name, "
        f"{str(TOOLS)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n")
    root = TOOLS.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
