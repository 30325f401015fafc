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


# ---------------------------------------------------------------------------
# the redesigned kernel's plan and order of work, which the card cannot show
# here
# ---------------------------------------------------------------------------


def _chip_smoke_ssd_cases():
    """chip_smoke.py's SSD cases (it imports torch and the port only), as
    (rows, S, n, p, ds, chunk)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {c[0]: c[1:7] for c in mod.SSD_CASES}


@pytest.mark.parametrize("label,want", [
    # the FL round and statistics pass: 4 heads share a block's scores,
    # a warp per head, one chunk walked in place
    ("round", (4, 4, False)),
    ("stats", (4, 4, False)),
    # 2 rows x 8 heads cannot fill 132 SMs: the three-pass form, a block
    # per (row, head, chunk) with 2 x 2 output tiles of 32 for 4 warps
    ("multi-chunk", (1, 4, True)),
    ("long rows", (4, 4, False)),
])
def test_ssd_plan_for_chip_smoke_cases(label, want):
    rows, s, n, p, ds, chunk = _chip_smoke_ssd_cases()[label]
    plan = kernel.ssd_plan(rows, s, n, p, ds, chunk, sms=132)
    assert (plan.heads, plan.warps, plan.chunk_parallel) == want
    assert plan.chunks == s // chunk
    assert kernel.smem_floats(chunk, p, ds, plan.heads,
                              plan.chunks > 1) <= kernel.SMEM_SHARE


@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_plan_for_test_shapes(shape):
    """The file's shapes have few rows: heads get a block each; the
    4-chunk shape takes the chunk-parallel form, the single chunk cannot."""
    b, s, n, p, ds, chunk = shape
    plan = kernel.ssd_plan(b, s, n, p, ds, chunk, sms=132)
    assert plan.heads == 1 and plan.warps == 1
    assert plan.chunk_parallel == (s // chunk > 1)
    # a chunk whose block cannot fit in shared memory is refused
    with pytest.raises(ValueError):
        kernel.ssd_plan(b, 1024, n, 128, 128, 1024, sms=132)


LOG2E = 1.4426950408889634


def _warp_scan_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis as ssd_kernel's warp_scan takes
    it: Hillis-Steele shifts of 1, 2, 4, 8, 16 within each 32 steps, then
    the previous 32 steps' total added."""
    out, carry = [], torch.zeros_like(v[..., :1])
    for q0 in range(0, v.shape[-1], 32):
        w = v[..., q0:q0 + 32].clone()
        off = 1
        while off < 32:
            w[..., off:] = w[..., off:] + w[..., :-off].clone()
            off *= 2
        w = w + carry
        out.append(w)
        carry = w[..., -1:]
    return torch.cat(out, dim=-1)


def _kernel_chunk(x, dt, rate, b, c, h, *, outputs=True, update=True):
    """One chunk of one row's heads in ssd_kernel's order of work: x (Q,
    n, p), dt (Q, n), rate (n,), b and c (Q, ds), h (n, ds, p) the state
    entering the chunk or None (zero). Returns (y or None, the chunk's end
    state from h, or None when not updated, exp(cum_last))."""
    q = x.shape[0]
    # the kernel keeps the cumsum in log2 units and exponentiates with exp2
    cum = _warp_scan_cumsum((dt * rate).T) * LOG2E     # (n, Q)
    last = cum[:, -1:]
    ecum, wk = torch.exp2(cum), torch.exp2(last - cum) * dt.T
    y = None
    if outputs:
        scores = torch.tril(c @ b.T)                    # (Q, Q)
        causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
        dec = torch.where(causal,
                          torch.exp2(cum[:, :, None] - cum[:, None, :]),
                          torch.zeros(()))
        wts = scores * dec * dt.T[:, None, :]           # (n, Q, Q)
        y = torch.einsum("hqk,khp->qhp", wts, x)
        if h is not None:
            y = y + ecum.T[..., None] * torch.einsum("qs,hsp->qhp", c, h)
    new_h = None
    if update:
        upd = torch.einsum("ks,kh,khp->hsp", b, wk.T, x)
        new_h = upd if h is None else h * torch.exp2(last)[..., None] + upd
    return y, new_h, torch.exp2(last[:, 0])


def _kernel_emulation(xh, dt, a_log, bm, cm, chunk, chunk_parallel):
    """The kernel's forms, one row at a time: sequential (the state carried
    through the row's chunks, not updated after the last) or the three-pass
    chunk-parallel form (each chunk's own end state from zero, the scan
    over chunk states, the outputs). Returns y and the number of state
    updates per row."""
    bsz, s, n, _ = xh.shape
    rates = ref.decay_rates(torch.from_numpy(a_log), bsz)
    rates = rates.expand(bsz, n) if rates.dim() == 1 else rates
    x, d, b, c = (torch.from_numpy(a) for a in (xh, dt, bm, cm))
    chunks, ys, updates = s // chunk, [], 0
    for r in range(bsz):
        parts = [(x[r, i * chunk:(i + 1) * chunk],
                  d[r, i * chunk:(i + 1) * chunk], rates[r],
                  b[r, i * chunk:(i + 1) * chunk],
                  c[r, i * chunk:(i + 1) * chunk]) for i in range(chunks)]
        out = []
        if chunk_parallel:
            own = [_kernel_chunk(*pt, None, outputs=False)
                   for pt in parts[:-1]]
            updates += len(own)
            h, h_in = None, []
            for i in range(chunks):
                h_in.append(h)
                if i + 1 < chunks:
                    st, dec = own[i][1], own[i][2]
                    h = st if h is None else h * dec[:, None, None] + st
            out = [_kernel_chunk(*pt, h_in[i], update=False)[0]
                   for i, pt in enumerate(parts)]
        else:
            h = None
            for i, pt in enumerate(parts):
                y, new_h, _ = _kernel_chunk(*pt, h, update=i + 1 < chunks)
                updates += new_h is not None
                out.append(y)
                h = new_h
        ys.append(torch.cat(out, dim=0))
    return torch.stack(ys).numpy(), updates // bsz


@pytest.mark.parametrize("chunk_parallel", [False, True],
                         ids=["sequential", "chunk_parallel"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_order_of_work_matches_reference_pallas(shape, chunk_parallel):
    """A plain-torch emulation of ssd_kernel's order of work (warp-scan
    cumsum in log2 units, exp2 of differences for the decayed weights, the
    inter term from the carried or scanned state, no state update after a
    row's last chunk) against the reference's Pallas kernel in interpret
    mode, in both forms, over four chunks and over the FL path's one."""
    *dims, chunk = shape
    args = _inputs(*dims, seed=chunk + dims[1] + 1)
    want = np.asarray(ref_kernel.ssd_scan(*args, chunk=chunk, block_h=2,
                                          interpret=True))
    got, updates = _kernel_emulation(*args, chunk, chunk_parallel)
    assert updates == dims[1] // chunk - 1
    np.testing.assert_allclose(got, want, **TOL)


def test_warp_scan_cumsum_is_the_cumsum():
    v = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 96)).astype(np.float32))
    torch.testing.assert_close(_warp_scan_cumsum(v), torch.cumsum(v, -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change,vec", [
    ({}, (16, 16)),
    (dict(x_aligned=False), (4, 16)),
    (dict(bc_aligned=False), (16, 4)),
    (dict(x_strides=(32 * 162, 162, 32)), (4, 16)),   # steps 162 floats
    (dict(bc_strides=(32 * 160, 160, 32 * 160, 158)), (16, 4)),
])
def test_ssd_plan_copy_width_is_16_bytes_only_where_aligned(change, vec):
    """x's, and b's and c's, staging copies are 16 bytes only where the
    pointers and every row and step stride allow them (chip_smoke's split
    views of one (rows, 32, 160) conv output are aligned)."""
    kw = dict(sms=132, x_strides=(32 * 160, 160, 32),
              bc_strides=(32 * 160, 160, 32 * 160, 160), x_aligned=True,
              bc_aligned=True)
    kw.update(change)
    plan = kernel.ssd_plan(570, 32, 4, 32, 16, 32, **kw)
    assert (plan.vec_x, plan.vec_bc) == vec
    # widths that are not a multiple of 4 floats take 4-byte copies
    odd = kernel.ssd_plan(570, 32, 4, 30, 14, 32, **{**kw, **change})
    assert (odd.vec_x, odd.vec_bc) == (4, 4)
