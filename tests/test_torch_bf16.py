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
                              lr=0.05, compute_dtype="bf16", device="cpu")
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
                              lr=0.05, device="cpu")
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
    1.2e-2, params 8.6e-4), with f32 masters."""
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
