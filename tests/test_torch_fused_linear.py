"""The port's fused linear kernels (plain versions, wrappers, autograd op)
held against ``repro.kernels.fused_linear`` on the same numpy inputs.

These run on the CPU, where every wrapper takes its plain PyTorch version;
the CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``. Tolerance: f32 on both sides with f32 accumulation,
atol = rtol = 1e-5 (the reference's own f32 contract); the two frameworks
sum in different orders, which costs a few ulps, far inside it.
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

from repro.kernels.fused_linear import ops as ref_ops  # noqa: E402
from repro.kernels.fused_linear import ref as ref_ref  # noqa: E402
from repro_torch.kernels.fused_linear import kernel, ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# M=1 (per-sample gradients), M=95 (the padded round width) and N=10
# (fc_last) are the main path's ragged shapes; (64, 128, 128) is aligned.
SHAPES = [(1, 64, 32), (95, 48, 10), (37, 70, 33), (64, 128, 128)]


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


def _port_vjp(x, w, b, dy, act):
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = ops.linear(tx, tw, tb, activation=act)
    y.backward(torch.from_numpy(dy))
    return _np(y), _np(tx.grad), _np(tw.grad), _np(tb.grad)


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_reference_vjp(shape, act):
    """Forward and all three cotangents against the reference op's custom
    VJP (its "ref" impl, which runs at every shape)."""
    x, w, b, dy = _inputs(*shape, seed=1)
    y_ref, vjp = jax.vjp(
        lambda a, c, d: ref_ops.linear(a, c, d, activation=act, impl="ref"),
        x, w, b)
    want = (y_ref, *vjp(jnp.asarray(dy)))
    for got, exp in zip(_port_vjp(x, w, b, dy, act), want):
        np.testing.assert_allclose(got, np.asarray(exp), **TOL)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_op_matches_reference_pallas_interpret(act):
    """At an aligned shape the reference op runs its three Pallas kernels
    (interpret mode on the CPU): the port's op agrees with them."""
    x, w, b, dy = _inputs(64, 128, 128, seed=2)
    y_ref, vjp = jax.vjp(
        lambda a, c, d: ref_ops.linear(a, c, d, activation=act,
                                       impl="interpret"), x, w, b)
    want = (y_ref, *vjp(jnp.asarray(dy)))
    for got, exp in zip(_port_vjp(x, w, b, dy, act), want):
        np.testing.assert_allclose(got, np.asarray(exp), **TOL)


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
        ops.linear(x[0], w[0], b[0], activation="silu")
