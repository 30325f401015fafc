"""The port's bf16 mixed-precision data plane against ``repro``'s, on the
CPU: the fused linear plain versions and the autograd op in bf16, the
launch plans' bf16 copy widths, one mixed-precision cohort round, and
two-round ``Simulation(Scenario(dtype="bf16"))`` runs of the MLP and of
a narrow VGG-11.

Inputs are made with numpy and rounded to bf16 once, so both packages see
the same bf16 values. Tolerances, each with its reason:

- plain versions: both upcast to f32, form the same exact products and
  round once to bf16, summing in different orders: one bf16 ulp of the
  reference's element plus 1e-5 of the tensor's largest magnitude;
- the op's gradients: relu and none as the plain versions (dz is dy);
  silu and gelu take dz through the activation's derivative on bf16 z,
  which JAX evaluates op by op in bf16 and PyTorch in one f32 pass, so dx,
  dw and db are held to 2^-5 of the tensor's largest magnitude
  (``SMOOTH``). Measured over ``SHAPES``: the two differ by at most 1.6e-2
  of scale (gelu; silu 7.1e-3), the reference lying 1.5e-2 from the f64
  gradient and the port 7.1e-3;
- rounds and simulations: the reference's own bf16 contract
  (``tests/test_mixed_precision.py``: losses 5e-2, params 3e-2); the
  measured differences are far smaller and stated beside each test.
"""
import importlib.util
import pathlib
import re

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

from repro.fl import cohort as ref_cohort  # noqa: E402
from repro.fl import data as ref_data  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro.kernels.fused_linear import ops as ref_ops  # noqa: E402
from repro.kernels.fused_linear import ref as ref_ref  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.fl import cohort, data, sim  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_linear import kernel, ops, ref  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

RTOL = 1e-5
# the reference's bf16 contract (tests/test_mixed_precision.py:119,123)
LOSS_TOL = dict(atol=5e-2, rtol=5e-2)
PARAM_TOL = dict(atol=3e-2, rtol=3e-2)
# silu/gelu gradients, as a fraction of the tensor's largest magnitude
# (module docstring)
SMOOTH = 2 ** -5

# M=1, the padded round's M=95 with fc_last's N=10, ragged shapes, and odd
# row widths (K=33, N=7: rows of 66 and 14 bytes, which cp.async cannot
# copy 4 bytes at a time)
SHAPES = [(1, 64, 32), (95, 48, 10), (37, 70, 34), (64, 128, 128),
          (5, 33, 7)]
ACTS = ["relu", "none", "silu", "gelu"]


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and back to f32 (exact both ways)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(m, k))),
            _bf16(rng.normal(size=(k, n)) * np.sqrt(2.0 / k)),
            _bf16(rng.normal(size=(n,))), _bf16(rng.normal(size=(m, n))))


def _t(a):
    return torch.from_numpy(a).bfloat16()


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ulp(want: np.ndarray) -> np.ndarray:
    """The bf16 ulp of each element (8 significand bits)."""
    _, e = np.frexp(np.abs(want))
    return np.where(want == 0, 0.0, np.ldexp(1.0, e - 8))


def assert_bf16_close(got, want):
    """Each element within one bf16 ulp of ``want`` plus RTOL of the
    tensor's largest magnitude; both bf16."""
    assert got.dtype == torch.bfloat16
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    excess = np.abs(g - w) - _ulp(w)
    assert excess.max(initial=0.0) <= RTOL * np.abs(w).max(initial=0.0)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_reference_bf16(shape, act):
    """y for every activation; dx and dw/db with the relu mask (from the
    bf16 y > 0) or none, the mask the smooth activations' backward uses."""
    x, w, b, dy = _inputs(*shape)
    y_ref = ref_ref.fused_linear_ref(_j(x), _j(w), _j(b), act)
    y = ref.fused_linear_ref(_t(x), _t(w), _t(b), act)
    assert_bf16_close(y, y_ref)

    mask = act if act in ("relu", "none") else "none"
    my_ref, my = (y_ref, y) if mask == "relu" else (None, None)
    assert_bf16_close(ref.fused_linear_bwd_dx_ref(_t(dy), _t(w), my, mask),
                      ref_ref.fused_linear_bwd_dx_ref(_j(dy), _j(w), my_ref,
                                                      mask=mask))
    dw, db = ref.fused_linear_bwd_dw_db_ref(_t(x), _t(dy), my, mask)
    dw_ref, db_ref = ref_ref.fused_linear_bwd_dw_db_ref(_j(x), _j(dy),
                                                        my_ref, mask=mask)
    assert_bf16_close(dw, dw_ref)
    assert_bf16_close(db, db_ref)


def test_plain_versions_keep_f32_unchanged():
    """f32 operands: the upcasts are no-ops and the results are the plain
    f32 products, bit for bit."""
    x, w, b, dy = (torch.from_numpy(a) for a in _inputs(37, 70, 34, seed=3))
    y = ref.fused_linear_ref(x, w, b, "relu")
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.relu(x @ w + b))
    assert torch.equal(ref.fused_linear_bwd_dx_ref(dy, w, y, "relu"),
                       (dy * (y > 0).float()) @ w.T)
    dw, db = ref.fused_linear_bwd_dw_db_ref(x, dy)
    assert torch.equal(dw, x.T @ dy) and torch.equal(db, dy.sum(0))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_op_gradients_match_reference_vjp_bf16(shape, act):
    """``_FusedLinear`` in bf16 against ``jax.vjp`` of the reference op in
    bf16 ("ref" impl): y, dx, dw and db come back bf16, in the dtypes of
    y, x, w and dy, at the module's tolerances."""
    x, w, b, dy = _inputs(*shape, seed=1)
    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
    y = ops.linear(tx, tw, tb, activation=act)
    y.backward(_t(dy))
    got = (y, tx.grad, tw.grad, tb.grad)
    y_ref, vjp = jax.vjp(
        lambda a, c, d: ref_ops.linear(a, c, d, activation=act, impl="ref"),
        _j(x), _j(w), _j(b))
    want = (y_ref, *vjp(_j(dy)))
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        if i == 0 or act in ("relu", "none"):
            assert_bf16_close(g, r)
        else:
            err = np.abs(_f32(g) - _f32(r)).max()
            assert err <= SMOOTH * np.abs(_f32(r)).max()


@pytest.mark.parametrize("itemsize,strides,align,vec", [
    (2, (95 * 512, 512), 16, 16),      # aligned bf16 rows: 16-byte copies
    (2, (95 * 4100, 4100), 16, 4),     # rows of 8200 bytes: 4 bytes
    (2, (95 * 10, 10), 16, 4),         # fc3's N = 10: 20-byte rows
    (2, (95 * 512, 512), 4, 4),        # a pointer off 16 bytes
    (2, (95 * 33, 33), 16, 2),         # odd width: one bf16 at a time
    (2, (95 * 512, 512), 2, 2),        # a pointer off 4 bytes
    (4, (95 * 33, 33), 16, 4),         # f32 as before: never below 4
    (4, (95 * 512, 512), 16, 16),
    (4, (95 * 512, 512), 8, 4),
])
def test_copy_width_in_bytes_of_the_element(itemsize, strides, align, vec):
    """``copy_width`` counts copy widths in bytes of the element: an odd bf16
    row width takes the kernels' 2-byte path (plain loads, no cp.async),
    never a ValueError."""
    assert build.copy_width(align, *strides, itemsize=itemsize) == vec


def test_bf16_plans_for_odd_widths_and_stage_depth():
    """The bf16 plans: odd widths take 2-byte copies; a split reduction is
    cut in multiples of the bf16 stage depth (64), the f32 one in 32."""
    kw = dict(sxb=2 * 33 * 33, sxm=33, swb=33 * 7, swk=7, sbb=7,
              x_align=16, w_align=16, sms=132, itemsize=2)
    plan = kernel.fwd_plan(2, 33, 33, 7, **kw)
    assert (plan.vec_x, plan.vec_w) == (2, 2)
    dx = kernel.dx_plan(2, 33, 33, 7, strides=(33 * 7, 7, 33 * 7, 7),
                        swb=33 * 7, swk=7, dz_align=16, w_align=16,
                        sms=132, itemsize=2)
    assert (dx.vec_dz, dx.vec_w) == (2, 2)
    dw = kernel.dwdb_plan(2, 33, 33, 7, strides=(33 * 33, 33, 33 * 7, 7,
                                                 33 * 7, 7),
                          x_align=16, dz_align=16, itemsize=2)
    assert (dw.vec_x, dw.vec_dz) == (2, 2)
    # fc3 of the round: 6 CTAs want splitting, into 64-deep multiples
    fc3 = dict(sxb=95 * 4096, sxm=4096, swb=4096 * 10, swk=10, sbb=10,
               x_align=16, w_align=16, sms=132)
    b16 = kernel.fwd_plan(6, 95, 4096, 10, itemsize=2, **fc3)
    f32 = kernel.fwd_plan(6, 95, 4096, 10, **fc3)
    assert b16.splits > 1 and b16.k_chunk % 64 == 0
    assert f32.k_chunk % 32 == 0 and (b16.vec_x, b16.vec_w) == (16, 4)
    assert b16.splits * b16.k_chunk >= 4096 > (b16.splits - 1) * b16.k_chunk


def test_wrappers_refuse_mixed_dtypes():
    """A CUDA call checks that every operand has the first one's dtype
    before anything launches; here the check is reached directly."""
    x = torch.zeros(1, 2, 3, dtype=torch.bfloat16)
    assert kernel._operand(x, 3, "x", torch.bfloat16) is x
    with pytest.raises(TypeError, match="one dtype per call"):
        kernel._operand(x, 3, "x", torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel._operand(x.half(), 3, "x", torch.float16)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_slot"])
def test_bf16_conv_adds_its_bias_after_the_conv(shared):
    """One bf16 conv layer (relu(conv + b), NHWC slots), port against the
    reference on the same bf16 inputs: the conv's sum is rounded to bf16,
    then the bias added in bf16, in both. So an element differs only where
    the two frameworks' conv sums, taken in different orders, round to
    neighbouring bf16 values: by at most one ulp of the reference's conv
    sum plus one of the biased result (the add rounds again), at no more
    than 1e-3 of the elements (measured: 0 and 1 of 24,576, one weight and
    a weight per slot). A bias added inside the conv, before its one
    rounding, differs at 3,553 and 3,837 of them. Both branches: one
    weight for every slot, and a weight per slot (the grouped conv)."""
    from repro.models import vgg as ref_vgg
    from repro_torch.models import vgg
    rng = np.random.default_rng(5)
    s, nb, hw, c, co = 3, 4, 8, 16, 32
    per = 1 if shared else s
    x = _bf16(rng.normal(size=(s, nb, hw, hw, c)))
    w = _bf16(rng.normal(size=(per, 3, 3, c, co)) * np.sqrt(2 / (9 * c)))
    b = _bf16(rng.normal(size=(per, co)) * 0.5)
    want, conv = [], []
    for i in range(s):
        wi, bi = _j(w[0 if shared else i]), _j(b[0 if shared else i])
        want.append(_f32(ref_vgg._apply_layer("conv", {"w": wi, "b": bi},
                                              _j(x[i]))))
        conv.append(_f32(jax.lax.conv_general_dilated(
            _j(x[i]), wi, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))))
    want, conv = np.stack(want), np.stack(conv)
    tw, tb = _t(w).permute(0, 4, 3, 1, 2), _t(b)     # HWIO -> OIHW
    got = vgg._conv(_t(x), tw[0] if shared else tw, tb[0] if shared else tb)
    assert got.dtype == torch.bfloat16
    diff = np.abs(_f32(got) - want)
    assert (diff <= _ulp(conv) + _ulp(want)).all()
    assert (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# the mixed-precision round and simulation
# ---------------------------------------------------------------------------

MLP_SIZES = (3072, 32, 16, 10)
WIDTH = 0.0625
D_TILDE = np.array([5, 19, 12, 26, 8, 14])


def _np_params(model, seed):
    """The model's own seeded init (He-normal weights, zero biases) in the
    reference's layout (conv HWIO, fc (K, N))."""
    return params_to_numpy(model, model.init(
        torch.Generator().manual_seed(seed), "cpu"))


@pytest.mark.parametrize("family", ["vgg", "mlp"])
def test_cohort_round_bf16_matches_reference(family):
    """One bf16 cohort round from the same batch and the same f32 params:
    the new global params are f32 masters, and params, per-gateway and
    per-slot losses agree within the reference's bf16 contract (measured:
    VGG params 7.8e-4, losses 2.0e-3; MLP params 7.5e-9, losses 0)."""
    sizes = np.array([40, 95, 60, 130, 44, 71])
    args = (6, sizes, np.array([10, 2, 3, 1, 10, 2]))
    kw = dict(chi=0.8, test_size=100, seed=7)
    ds, rds = data.make_fl_dataset(*args, **kw), \
        ref_data.make_fl_dataset(*args, **kw)
    model, ref_model = ((sm.VGGSplitModel(WIDTH), ref_sm.VGGSplitModel(WIDTH))
                        if family == "vgg" else
                        (sm.MLPSplitModel(MLP_SIZES),
                         ref_sm.MLPSplitModel(MLP_SIZES)))
    np_params = _np_params(model, seed=11)
    layout = data.CohortLayout.build(D_TILDE, 4, 1)
    batch = data.sample_cohort_batch(np.random.default_rng(2), ds, [1, 3, 4],
                                     D_TILDE, layout=layout)
    ref_batch = ref_data.sample_cohort_batch(
        np.random.default_rng(2), rds, [1, 3, 4], D_TILDE,
        layout=ref_data.CohortLayout.build(D_TILDE, 4, 1))
    weights = np.zeros(4, np.float32)
    gw_onehot = np.zeros((4, 3), np.float32)
    for dev, slot in zip([1, 3, 4], batch.slot_of):
        weights[slot] = D_TILDE[dev]
        gw_onehot[slot, dev % 3] = 1.0
    l_n = np.array([3, 5, 0, 0])
    out = cohort.cohort_round(model, params_from_numpy(model, np_params,
                                                       "cpu"),
                              batch, l_n, weights, gw_onehot, k_iters=2,
                              lr=0.05, with_boundary=False,
                              compute_dtype="bf16", device="cpu")
    ref_out = ref_cohort.cohort_round(
        ref_model, [{k: jnp.asarray(v) for k, v in p.items()}
                    for p in np_params],
        ref_batch, l_n, weights, gw_onehot, k_iters=2, lr=0.05,
        with_boundary=False, compute_dtype="bf16")
    assert all(v.dtype == torch.float32 for p in out[0] for v in p.values())
    for g, r in zip(params_to_numpy(model, out[0]), ref_out[0]):
        for k in g:
            np.testing.assert_allclose(g[k], np.asarray(r[k]), **PARAM_TOL)
    for got, want in zip(out[1:4], ref_out[1:4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    # the bf16 round really differs from the f32 one
    f32 = cohort.cohort_round(model, params_from_numpy(model, np_params,
                                                       "cpu"),
                              batch, l_n, weights, gw_onehot, k_iters=2,
                              lr=0.05, with_boundary=False, device="cpu")
    assert not torch.equal(f32[3], out[3])


SIM = dict(max_dataset=400, k_iters=2, sigma_samples=2, rounds=2,
           eval_every=2, dtype="bf16")


@pytest.mark.parametrize("kw", [dict(model="mlp"), dict(width_mult=WIDTH)],
                         ids=["mlp", "vgg"])
def test_bf16_simulation_matches_reference(kw):
    """Two rounds of ``Simulation(Scenario(dtype="bf16"))`` from the
    reference's weights and statistics: identical trained gateways,
    decisions and queues; losses and params within the reference's bf16
    contract (measured: MLP losses 2.4e-7, params 9e-8; narrow VGG losses
    1.9e-2, params 6.2e-4, with each conv's bias added after the conv in
    bf16 as the reference adds it; 1.2e-2 and 8.6e-4 with the bias inside
    the conv: one conv layer now agrees to the bit at all but about 1 in
    25,000 elements, and what remains lies in the bf16 backward's sums),
    with f32 masters."""
    sc = dict(SIM, **kw)
    r = ref_sim.Simulation(ref_sim.Scenario(**sc))
    p0 = [{k: np.array(v) for k, v in p.items()} for p in r.params]
    rng0 = r.rng.bit_generator.state
    want = list(r.rounds())
    s = sim.Simulation(sim.Scenario(**sc), r.stats, device="cpu",
                       init_params=p0)
    s.rng.bit_generator.state = rng0
    got = list(s.rounds())
    assert s.workload.gamma == r.workload.gamma    # 16-bit uploads priced
    for g, w in zip(got, want):
        assert g.trained == w.trained
        np.testing.assert_array_equal(g.selected, w.selected)
        np.testing.assert_array_equal(g.l_n, w.l_n)
        np.testing.assert_array_equal(g.queues, w.queues)
        assert g.delay == w.delay
        np.testing.assert_allclose(g.losses, w.losses, **LOSS_TOL)
    assert any(g.trained for g in got)
    assert all(v.dtype == torch.float32 for p in s.params
               for v in p.values())
    for g, w in zip(params_to_numpy(s.plan, s.params), r.params):
        for k in g:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **PARAM_TOL)


# ---------------------------------------------------------------------------
# the Hopper forms of the bf16 backward (dx_tma_kernel, dwdb_tma_kernel):
# what the card cannot show here, their plans, tensor maps and arithmetic
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, M, K, N, shared): chip_smoke.py's bf16 cases and ragged shapes
TMA_CASES = [c[1:5] + (c[6],) for c in _chip_smoke().BF16_CASES] + [
    (3, 37, 200, 136, False), (2, 1, 4097, 264, True), (5, 96, 1000, 72,
                                                        False),
    (1, 95, 64, 8, False), (7, 3, 0, 16, False)]


def _bf16_dx_plan(nb, m, k, n, shared, **change):
    kw = dict(strides=(m * n, n, m * n, n), swb=0 if shared else k * n,
              swk=n, dz_align=16, w_align=16, sms=132, itemsize=2)
    kw.update(change)
    return kernel.dx_plan(nb, m, k, n, **kw)


def _bf16_dw_plan(nb, m, k, n, **change):
    kw = dict(strides=(m * k, k, m * n, n, m * n, n), x_align=16,
              dz_align=16, itemsize=2, sms=132)
    kw.update(change)
    return kernel.dwdb_plan(nb, m, k, n, **kw)


def _bf16_fwd_plan(nb, m, k, n, shared, **change):
    kw = dict(sxb=m * k, sxm=k, swb=0 if shared else k * n, swk=n,
              sbb=0 if shared else n, x_align=16, w_align=16, sms=132,
              itemsize=2)
    kw.update(change)
    return kernel.fwd_plan(nb, m, k, n, **kw)


@pytest.mark.parametrize("case", TMA_CASES, ids=str)
def test_bf16_forward_plans_cover_every_output_once(case):
    """Whichever form the plan picks: the forward's grid covers each y
    element of every slot (folded into rows where the weights are shared)
    once per split, and the splits partition K into stage-deep pieces, so
    no TMA box of a split reads past its range except at K itself."""
    nb, m, k, n, shared = case
    plan = _bf16_fwd_plan(*case)
    bm, bn = plan.tile
    gx, gy, gz = plan.grid
    assert gz == plan.batch * plan.splits and plan.batch * plan.rows == nb * m
    cover = np.zeros((plan.batch, plan.rows, n), np.int32)
    for bx in range(gx):
        for by in range(gy):
            cover[:, bx * bm:(bx + 1) * bm, by * bn:(by + 1) * bn] += 1
    assert (cover == 1).all()
    assert plan.k_chunk % (kernel.TF_BK if plan.form == "tma"
                           else kernel.BF16_BK) == 0
    assert k == 0 or (plan.splits * plan.k_chunk >= k
                      > (plan.splits - 1) * plan.k_chunk)


def test_bf16_forward_form_follows_the_operands_layout():
    """The forward's Hopper form at the round's fc1 and fc2 and at the
    statistics and per-sample passes' shared fc2 (slots folded into rows),
    the mma.sync form at fc3's N = 10, the odd width, views off 16-byte
    alignment and strides that are no multiple of 8; the f32 plans keep
    their form and tiles. The round's fc2 and fc1 are one wave of 132 CTAs
    of 96 x 192, with no split."""
    for case in [(6, 95, 512, 4096, False), (6, 95, 4096, 4096, False),
                 (12, 95, 4096, 4096, True), (8, 1, 4096, 4096, True),
                 (1, 232, 512, 4096, True)]:
        plan = _bf16_fwd_plan(*case)
        assert plan.form == "tma" and plan.stages == kernel.TF_STAGES, case
        assert plan.tile == (kernel.TF_BM, kernel.TF_BN)
    for case in [(6, 95, 4096, 10, False), (12, 95, 4096, 10, True),
                 (2, 33, 33, 7, False), (7, 3, 0, 16, False)]:
        plan = _bf16_fwd_plan(*case)
        assert plan.form == "mma_sync", case
        assert plan.stages == kernel.BF16_FWD_STAGES
    fc1 = (6, 95, 512, 4096, False)
    for change in (dict(x_align=8), dict(w_align=8), dict(sxm=516,
                                                          sxb=95 * 516),
                   dict(swk=4100)):
        assert _bf16_fwd_plan(*fc1, **change).form == "mma_sync", change
    for case in [fc1, (6, 95, 4096, 4096, False)]:
        plan = _bf16_fwd_plan(*case)
        assert plan.grid == (1, 22, 6) and plan.splits == 1
        f32 = _bf16_fwd_plan(*case, itemsize=4)
        assert (f32.form, f32.tile, f32.stages) == (
            "mma_sync", (kernel.FWD_BM, kernel.FWD_BN), kernel.FWD_STAGES)
        assert f32.grid == (1, 64, 6) and f32.splits == 1
    stats = _bf16_fwd_plan(12, 95, 4096, 4096, True)
    assert stats.fold and stats.grid == (12, 22, 1)
    # a grid under one wave splits K, to one wave and no more
    sigma = _bf16_fwd_plan(8, 1, 4096, 4096, True)
    gx, gy, gz = sigma.grid
    assert sigma.fold and sigma.splits > 1 and gx * gy * gz <= 132
    assert _bf16_fwd_plan(1, 232, 512, 4096, True).splits == 2


@pytest.mark.parametrize("case", TMA_CASES, ids=str)
def test_bf16_backward_plans_cover_every_output_once(case):
    """Whichever form the plan picks: dx's grid covers each dx element of
    every slot once per split, the splits partitioning N in stage-deep
    pieces; dw/db's persistent CTAs (Hopper form) cover each dw tile once
    between them, and each (slot, n-tile)'s k-tile 0, whose CTA writes db,
    once; the mma.sync form's grid as before."""
    nb, m, k, n, shared = case
    plan = _bf16_dx_plan(*case)
    bm, bk = plan.tile
    gx, gy, gz = plan.grid
    assert gz == plan.batch * plan.splits and plan.batch * plan.rows == nb * m
    cover = np.zeros((plan.batch, plan.rows, k), np.int32)
    for bx in range(gx):
        for by in range(gy):
            cover[:, bx * bm:(bx + 1) * bm, by * bk:(by + 1) * bk] += 1
    assert (cover == 1).all()
    assert plan.n_chunk % (kernel.TX_BN if plan.form == "tma"
                           else kernel.BF16_BK) == 0
    assert plan.splits * plan.n_chunk >= n > (plan.splits - 1) * plan.n_chunk

    dw = _bf16_dw_plan(nb, m, k, n)
    kt, nt = dw.tile
    cover = np.zeros((nb, k, n), np.int32)
    db_cover = np.zeros((nb, n), np.int32)
    if dw.form == "tma":
        ktiles, ntiles = -(-k // kt), -(-n // nt)
        assert dw.tiles == nb * ktiles * ntiles
        assert dw.grid == (dw.ctas, 1, 1) and dw.ctas == min(dw.tiles, 132)
        for c in range(dw.ctas):
            begin, end = dw.tiles * c // dw.ctas, dw.tiles * (c + 1) // dw.ctas
            for t in range(begin, end):
                ki, ni, slot = t % ktiles, t // ktiles % ntiles, \
                    t // ktiles // ntiles
                cover[slot, ki * kt:(ki + 1) * kt, ni * nt:(ni + 1) * nt] += 1
                if ki == 0:
                    db_cover[slot, ni * nt:(ni + 1) * nt] += 1
    else:
        gx, gy, gz = dw.grid
        for bx in range(gx):
            for by in range(gy):
                cover[:, by * kt:(by + 1) * kt, bx * nt:(bx + 1) * nt] += 1
            db_cover[:, bx * nt:(bx + 1) * nt] += 1
    assert (cover == 1).all() and (db_cover == 1).all()


def test_bf16_backward_form_follows_the_operands_layout():
    """The Hopper form wherever TMA can describe every operand, else the
    mma.sync form: fc3's N = 10 (20-byte rows), the odd width, a pointer
    off 16 bytes, a stride that is no multiple of 8, dw/db's M > 96, f32,
    and empty K or N."""
    round_fc = [(6, 95, 512, 4096, False), (6, 95, 4096, 4096, False),
                (12, 95, 4096, 4096, True), (8, 1, 4096, 4096, True)]
    for case in round_fc:
        assert _bf16_dx_plan(*case).form == "tma", case
        assert _bf16_dw_plan(*case[:4]).form == "tma", case
    for case in [(6, 95, 4096, 10, False), (2, 33, 33, 7, False)]:
        assert _bf16_dx_plan(*case).form == "mma_sync", case
        assert _bf16_dw_plan(*case[:4]).form == "mma_sync", case
    fc2 = (6, 95, 4096, 4096, False)
    for change in (dict(dz_align=8), dict(w_align=8),
                   dict(strides=(95 * 4100, 4100, 95 * 4096, 4096)),
                   dict(swk=4100), dict(itemsize=4)):
        assert _bf16_dx_plan(*fc2, **change).form == "mma_sync", change
    for change in (dict(x_align=8), dict(dz_align=8),
                   dict(strides=(95 * 4096 + 4, 4096, 95 * 4096, 4096,
                                 95 * 4096, 4096)), dict(itemsize=4)):
        assert _bf16_dw_plan(*fc2[:4], **change).form == "mma_sync", change
    # one CTA per SM: a split fills one wave and no more
    for case in round_fc + [(1, 232, 512, 4096, True)]:
        gx, gy, gz = _bf16_dx_plan(*case).grid
        assert gx * gy * gz <= 132 or _bf16_dx_plan(*case).splits == 1
    assert _bf16_dx_plan(6, 95, 512, 4096, False).splits == 7
    # no clusters: the multicast pairs measured slower
    assert all(_bf16_dx_plan(*case).cluster == 1 for case in round_fc)
    assert _bf16_dw_plan(1, 232, 512, 4096).form == "mma_sync"   # M > 96
    assert _bf16_dw_plan(1, 96, 512, 4096).form == "tma"
    assert _bf16_dw_plan(7, 3, 0, 16).form == "mma_sync"         # K = 0
    # a stride-0 w that does not fold (slots not row-contiguous) maps one
    # matrix for every slot
    plan = _bf16_dx_plan(6, 95, 4096, 4096, True,
                         strides=(96 * 4096, 4096, 96 * 4096, 4096))
    assert plan.form == "tma" and not plan.fold
    w_map = kernel.dx_maps(6, 95, 4096, 4096, 96 * 4096, 4096, 96 * 4096,
                           4096, 0, 4096, 16, 16)[0]
    assert w_map.dims == (4096, 4096, 1)


@pytest.mark.parametrize("case", [(6, 95, 512, 4096, False),
                                  (6, 95, 4096, 4096, False),
                                  (12, 95, 4096, 4096, True),
                                  (8, 1, 4096, 4096, True)], ids=str)
def test_tma_maps_are_valid_for_the_encoder(case):
    """The maps the Hopper forms encode at the round's, the statistics
    pass's and the per-sample pass's shapes: dims of 1 to 2^32, byte
    strides of multiples of 16 below 2^40, boxes of at most 256 elements a
    side whose inner side is the 128-byte swizzle row; the boxes are the
    kernels' tiles, so the bytes each stage expects are what TMA
    delivers."""
    nb, m, k, n, shared = case
    dx = _bf16_dx_plan(*case)
    maps = kernel.dx_maps(dx.batch, dx.rows, k, n, dx.sdb, dx.sdm, dx.syb,
                          dx.sym, 0 if shared else k * n, n, 16, 16,
                          dx.cluster)
    maps += kernel.dw_maps(nb, m, k, n, (m * k, k, m * n, n, m * n, n), 16,
                           16)
    for tm in maps:
        assert tm is not None
        assert all(1 <= d <= 2 ** 32 for d in tm.dims)
        assert all(s % 16 == 0 and s < 2 ** 40 for s in tm.strides)
        assert all(1 <= b <= 256 for b in tm.box) and tm.box[2] == 1
        assert 2 * tm.box[0] == 128
    w_map, dz_map, y_map = maps[:3]
    assert w_map.box[:2] == (kernel.TX_BN, kernel.TX_BK)
    assert dz_map.box[:2] == y_map.box[:2] == (
        kernel.TX_BN, kernel.TX_BM // dx.cluster)
    # one dx stage: w, and the cluster's dz and y boxes, 128-byte rows
    assert 2 * (w_map.box[0] * w_map.box[1] + dx.cluster * (
        dz_map.box[0] * dz_map.box[1] + y_map.box[0] * y_map.box[1])) == \
        128 * (kernel.TX_BK + 2 * kernel.TX_BM)
    rows = 16 * -(-m // 16)
    assert rows <= kernel.TW_MR
    # x, dy and y: the whole reduction; dw: a warpgroup's 64 rows
    assert [tm.box[1] for tm in maps[3:]] == [rows] * 3 + [64]
    # a pair along K (cluster 2) fetches half of dz's and y's rows each
    pair = kernel.dx_maps(dx.batch, dx.rows, k, n, dx.sdb, dx.sdm, dx.syb,
                          dx.sym, 0 if shared else k * n, n, 16, 16, 2)
    assert pair[0] == w_map and pair[1].box[:2] == pair[2].box[:2] == (
        kernel.TX_BN, kernel.TX_BM // 2)
    # the forward's Hopper form: x in 96 x 64 boxes, w in a warpgroup's
    # 64 columns; one stage is the three w boxes and the x box, 128-byte
    # rows
    fwd = _bf16_fwd_plan(*case)
    fwd_maps = kernel.fwd_maps(fwd.batch, fwd.rows, k, n, fwd.sxb, fwd.sxm,
                               0 if shared else k * n, n, 16, 16)
    for tm in fwd_maps:
        assert tm is not None
        assert all(1 <= d <= 2 ** 32 for d in tm.dims)
        assert all(s % 16 == 0 and s < 2 ** 40 for s in tm.strides)
        assert all(1 <= b <= 256 for b in tm.box) and tm.box[2] == 1
        assert 2 * tm.box[0] == 128
    x_map, fw_map = fwd_maps
    assert x_map.box[:2] == (kernel.TF_BK, kernel.TF_BM)
    assert fw_map.box[:2] == (64, kernel.TF_BK)
    assert x_map.dims[1] == fwd.rows
    assert 2 * (kernel.TF_BN // 64 * fw_map.box[0] * fw_map.box[1]
                + x_map.box[0] * x_map.box[1]) == \
        128 * (kernel.TF_BN + kernel.TF_BM)
    # the maps refuse what the encoder would
    assert kernel.tma_map(4096, 95, 6, 4096, 95 * 4096, 64, 96, 8) is None
    assert kernel.tma_map(10, 95, 6, 10, 950, 64, 96, 16) is None
    assert kernel.tma_map(4096, 95, 6, 4096, 95 * 4096, 128, 96, 16) is None
    assert kernel.tma_map(4096, 95, 6, 4096, 95 * 4096, 64, 257, 16) is None
    assert kernel.tma_map(0, 95, 6, 8, 95 * 8, 64, 96, 16) is None


def test_tma_tile_constants_match_the_source():
    """The plans' tile constants are the CUDA source's."""
    src = kernel.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
    assert kernel.TX_BK == 64 * const("kTxGroups")
    assert (kernel.TX_BM, kernel.TX_BN, kernel.TX_STAGES) == (
        const("kTxBM"), const("kTxBN"), const("kTxStages"))
    assert kernel.TW_KT == 64 * const("kTwGroups")
    assert (kernel.TW_NT, kernel.TW_MR, kernel.TW_STAGES) == (
        const("kTwNT"), const("kTwMR"), const("kTwStages"))
    assert kernel.TF_BN == 64 * const("kTfGroups")
    assert (kernel.TF_BM, kernel.TF_BK, kernel.TF_STAGES) == (
        const("kTfBM"), const("kTfBK"), const("kTfStages"))
    assert (kernel.FWD_STAGES, kernel.BF16_FWD_STAGES) == (
        const("kFwdStages"), const("kBfFwdStages"))


def _trunc_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a + b rounded toward zero to f32: a tensor core's accumulation at
    its least exact (it may drop the bits a round-to-nearest add keeps)."""
    s = a.astype(np.float64) + b.astype(np.float64)
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _wgmma_product(a: np.ndarray, b: np.ndarray, stage: int, order: str):
    """a (M, R) @ b (P, R)^T, the reduction R along both operands' rows,
    in the Hopper forms' order (dx: dz @ w^T; the forward: x @ w, b = w^T):
    each wgmma k-step's 16 products exact, added to its accumulator with
    truncation; ``order`` "stage": a zeroed set per ``stage``-deep stage,
    added to the running sum with a round-to-nearest f32 add (the kernels'
    per-stage add); "chain": every k-step into the running sum; "bf16":
    the running sum kept in bf16 (a control that must fail)."""
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    step = np.zeros_like(acc)
    for n0 in range(0, a.shape[1], 16):
        prod = a[:, n0:n0 + 16].astype(np.float64) @ \
            b[:, n0:n0 + 16].T.astype(np.float64)
        if order == "chain":
            acc = _trunc_add(acc, prod)
        elif order == "bf16":
            acc = _bf16(_trunc_add(acc, prod))
        else:
            step = _trunc_add(np.zeros_like(acc) if n0 % stage == 0
                              else step, prod)
            if (n0 + 16) % stage == 0:
                acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("which", ["dx"] + [f"fwd_{act}" for act in ACTS])
def test_wgmma_stage_add_emulation_holds_the_bf16_tolerance(which):
    """dx at the round's fc2 depth (N = 4096) for 128 columns, and the
    forward at its depth (K = 4096) for 128 columns with its bias and each
    activation, applied in f32 to the sum before the one rounding: the
    per-stage f32 add over 64-deep stages lies within one bf16 ulp plus
    RTOL of the scale of the plain version (f32 matmul, one rounding), and
    its sum closer to the f64 product than one chain of all 256 k-steps; a
    bf16 running sum does not hold, so the check has teeth."""
    rng = np.random.default_rng(13)
    m, depth, cols = 95, 4096, 128
    if which == "dx":
        dy = _bf16(rng.normal(size=(m, depth)))
        y = _bf16(rng.normal(size=(m, depth)))
        a = np.where(y > 0, dy, np.float32(0))
        b = _bf16(rng.normal(size=(cols, depth)) * np.sqrt(2 / depth))
        want = _f32(ref.fused_linear_bwd_dx_ref(
            _t(dy)[None], _t(b)[None], _t(y)[None], "relu")[0])
        stage, epilogue = kernel.TX_BN, lambda acc: acc
    else:
        act = which.removeprefix("fwd_")
        a = _bf16(rng.normal(size=(m, depth)))
        w = _bf16(rng.normal(size=(depth, cols)) * np.sqrt(2 / depth))
        bias = _bf16(rng.normal(size=(cols,)))
        b = np.ascontiguousarray(w.T)
        want = _f32(ref.fused_linear_ref(_t(a), _t(w), _t(bias), act))
        stage = kernel.TF_BK

        def epilogue(acc):
            z = torch.from_numpy(acc) + torch.from_numpy(bias)
            return ref.ACTS[act](z).numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    scale = np.abs(want).max()
    errs = {}
    for order in ("stage", "chain", "bf16"):
        acc = _wgmma_product(a, b, stage, order)
        got = epilogue(acc)
        excess = np.abs(_bf16(got) - want) - _ulp(want)
        errs[order] = (excess.max() / scale,
                       np.abs(acc - exact).max() / np.abs(exact).max())
    assert errs["stage"][0] <= RTOL, errs
    assert errs["stage"][1] < errs["chain"][1], errs
    assert errs["bf16"][0] > RTOL, errs
