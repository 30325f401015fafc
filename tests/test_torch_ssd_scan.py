"""The port's SSD scan (plain versions, wrapper, autograd op, chunked CPU
form) held against ``repro.kernels.ssd_scan`` and ``repro.models.ssm`` on
the same numpy inputs.

These run on the CPU, where the wrapper takes its plain version; the
reference runs its Pallas kernel in interpret mode over several chunks, so
the state is carried across chunks. The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``.

Tolerance: 1e-4 absolute and relative, the reference's own SSD tolerance
(``tests/test_kernels.py``): the sequential recurrence, the chunked dual
form and the kernel sum over steps in different orders and through
different exponentials of cumulative decays.
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

from repro.kernels.ssd_scan import kernel as ref_kernel  # noqa: E402
from repro.kernels.ssd_scan import ops as ref_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as ref_ref  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel, ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)

# (B, S, n, p, ds, chunk): four chunks; the FL path's single chunk
SHAPES = [(2, 128, 4, 16, 8, 32), (3, 32, 4, 32, 16, 32)]


def _inputs(b, s, n, p, ds, seed=0, groups=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, n, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, n)))).astype(np.float32)
    a_shape = (n,) if groups == 0 else (groups, n)
    a_log = (rng.normal(size=a_shape) * 0.5).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, ds)).astype(np.float32)
              for _ in range(2))
    return xh, dt, a_log, bm, cm


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_chunked_match_reference(shape):
    """ssd_ref (the kernel's plain version) and ssd_chunked (the CPU model
    path) against the Pallas kernel in interpret mode and the reference's
    ssd_chunked and sequential oracle."""
    *dims, chunk = shape
    args = _inputs(*dims, seed=chunk + dims[1])
    want = np.asarray(ref_kernel.ssd_scan(*args, chunk=chunk, block_h=2,
                                          interpret=True))
    want_chunked, want_h = ref_ssm.ssd_chunked(*args, chunk)
    np.testing.assert_allclose(np.asarray(want_chunked), want, **TOL)
    np.testing.assert_allclose(np.asarray(ref_ref.ssd_ref(*args)), want,
                               **TOL)
    targs = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(_np(kernel.ssd_scan(*targs, chunk=chunk)),
                               want, **TOL)
    got, h = ssm.ssd_chunked(*targs, chunk)
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(h), np.asarray(want_h), **TOL)


def test_op_gradients_match_reference():
    """Output and all five cotangents of the port's op against jax.vjp
    through the reference's op with its Pallas forward in interpret mode
    (both backwards run through the sequential recurrence)."""
    args = _inputs(2, 64, 4, 16, 8, seed=5)
    dy = np.random.default_rng(6).normal(size=(2, 64, 4, 16)).astype(
        np.float32)
    y_ref, vjp = jax.vjp(
        lambda *a: ref_ops.ssd(*a, chunk=32, block_h=2, impl="interpret"),
        *args)
    want = (y_ref, *vjp(jnp.asarray(dy)))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y = ops.ssd(*targs, chunk=32)
    y.backward(torch.from_numpy(dy))
    for got, exp in zip([y] + [t.grad for t in targs], want):
        np.testing.assert_allclose(_np(got), np.asarray(exp), **TOL)


def test_per_slot_a_log_groups_rows():
    """a_log (G, n) applies slot g's rates to rows [g*B/G, (g+1)*B/G): each
    group equals the reference on that group alone, for the plain version,
    the chunked form and the op's gradient; a stride-0 expanded a_log
    equals the shared (n,) one."""
    xh, dt, a_log, bm, cm = _inputs(6, 64, 4, 16, 8, seed=9, groups=3)
    t = [torch.from_numpy(a) for a in (xh, dt, a_log, bm, cm)]
    got = _np(kernel.ssd_scan(*t))
    got_chunked = _np(ssm.ssd_chunked(*t, 32)[0])
    for g in range(3):
        rows = slice(2 * g, 2 * g + 2)
        want = np.asarray(ref_ref.ssd_ref(xh[rows], dt[rows], a_log[g],
                                          bm[rows], cm[rows]))
        np.testing.assert_allclose(got[rows], want, **TOL)
        np.testing.assert_allclose(got_chunked[rows], want, **TOL)

    ta = torch.from_numpy(a_log).requires_grad_()
    ops.ssd(t[0], t[1], ta, t[3], t[4], chunk=32).sum().backward()
    for g in range(3):
        rows = slice(2 * g, 2 * g + 2)
        want = jax.grad(lambda a: ref_ref.ssd_ref(
            xh[rows], dt[rows], a, bm[rows], cm[rows]).sum())(a_log[g])
        np.testing.assert_allclose(_np(ta.grad[g]), np.asarray(want), **TOL)

    shared = torch.from_numpy(a_log[0])
    expanded = shared.expand(3, 4)
    assert expanded.stride(0) == 0
    torch.testing.assert_close(kernel.ssd_scan(t[0], t[1], expanded, *t[3:]),
                               kernel.ssd_scan(t[0], t[1], shared, *t[3:]),
                               rtol=0, atol=0)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain version and launch nothing; the op's
    backward recomputes through the uncounted recurrence; a device that is
    neither CPU nor CUDA raises."""
    t = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 8, 4)]
    before_l, before_c = dict(kernel.LAUNCHES), dict(ref.CALLS)
    t[0].requires_grad_()
    ops.ssd(*t, chunk=32).sum().backward()
    assert kernel.LAUNCHES == before_l
    assert ref.CALLS["ssd_scan"] == before_c["ssd_scan"] + 1
    with pytest.raises(ValueError):
        kernel.ssd_scan(*(a.detach().to("meta") for a in t))
