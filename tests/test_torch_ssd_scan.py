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
# two chunks of 256 (mamba2-2.7b's and jamba's chunk), which the kernel
# runs as sub-chunks of 128 (kernel.inner_chunk)
LONG_SHAPES = [(1, 512, 4, 32, 16, 256)]
# the card's contract (chip_smoke.py SSD_RTOL): the kernel's sums within
# 1e-4 of the output's largest magnitude. Over a chunk of 256 the kernel's
# exp2 of differences of 256-step cumulative decays lose a few ulps of
# those decays, so single small elements of the kernel's order of work can
# miss TOL's elementwise 1e-4 (1.4e-4 at 0.02) while the error stays under
# 1e-5 of scale.
SSD_RTOL = 1e-4


def _close_to_scale(got, want, rtol=SSD_RTOL):
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


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


@pytest.mark.parametrize("shape", SHAPES + LONG_SHAPES)
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


def test_chunked_form_gradients_are_finite_at_chunk_256():
    """The CPU model path's chunked form at chunk 256: its cotangents are
    finite and within SSD_RTOL of scale of ``jax.vjp`` through the
    reference's sequential oracle, where the reference's own chunked form
    gives NaN (exp(cum_q - cum_k) above the diagonal overflows before its
    mask zeroes it; the port masks the exponent instead, the same forward
    values)."""
    args = _inputs(1, 256, 2, 16, 8, seed=11)
    dy = np.random.default_rng(12).normal(size=(1, 256, 2, 16)).astype(
        np.float32)
    def cotangents(f):
        return jax.jit(lambda *a: jax.vjp(f, *a)[1](jnp.asarray(dy)))(*args)
    want = cotangents(ref_ref.ssd_ref)
    ref_grads = cotangents(lambda *a: ref_ssm.ssd_chunked(*a, 256)[0])
    # its dt and a_log cotangents, which reach the exponent
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_grads[1:3])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, _ = ssm.ssd_chunked(*targs, 256)
    y.backward(torch.from_numpy(dy))
    for t, w in zip(targs, want):
        assert torch.isfinite(t.grad).all()
        _close_to_scale(_np(t.grad), np.asarray(w))


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
    """CPU tensors take the plain versions and launch nothing: the op's
    forward and backward each count one plain call; a device that is
    neither CPU nor CUDA raises."""
    t = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 8, 4)]
    before_l, before_c = dict(kernel.LAUNCHES), dict(ref.CALLS)
    t[0].requires_grad_()
    ops.ssd(*t, chunk=32).sum().backward()
    assert kernel.LAUNCHES == before_l
    assert ref.CALLS["ssd_scan"] == before_c["ssd_scan"] + 1
    assert ref.CALLS["ssd_scan_bwd"] == before_c["ssd_scan_bwd"] + 1
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
    ("round", (4, 4, False, "fma")),
    ("stats", (4, 4, False, "fma")),
    # 2 rows x 8 heads cannot fill 132 SMs: the tensor-core chunk-parallel
    # form, a block of 16 warps per (head, chunk, row)
    ("multi-chunk", (1, 16, True, "tc")),
    # 480 steps are not whole chunks of 64: the FMA chunk-parallel form
    # over 15 chunks of 32, a warp per 32 columns of p
    ("ragged chunks", (1, 2, True, "fma")),
    ("long rows", (4, 4, False, "fma")),
    # 66 rows x 4 heads fill the card, 66 rows alone do not share blocks:
    # a block per head, walked in order
    ("head blocks", (1, 1, False, "fma")),
    # mamba2-2.7b's step: one row of 80 heads, chunk 256 run as 64 sub-
    # chunks of 64 (ds 128) in the tensor-core chunk-parallel form
    ("mamba2 4096", (1, 16, True, "tc")),
])
def test_ssd_plan_for_chip_smoke_cases(label, want):
    rows, s, n, p, ds, chunk = _chip_smoke_ssd_cases()[label]
    plan = kernel.ssd_plan(rows, s, n, p, ds, chunk, sms=132)
    assert (plan.heads, plan.warps, plan.chunk_parallel, plan.form) == want
    assert plan.chunk == chunk and plan.chunks == s // plan.inner
    assert plan.inner == (64 if chunk == 256 else chunk)
    if plan.form == "tc":
        assert kernel.tc_smem_floats(p, ds, False) <= kernel.SMEM_MAX
        return
    # within half an SM; only a sub-chunked head's block takes more
    smem = kernel.smem_floats(plan.inner, p, ds, plan.heads,
                              plan.chunks > 1)
    assert smem <= kernel.SMEM_SHARE or (
        plan.inner < chunk and plan.heads == 1 and smem <= kernel.SMEM_MAX)


@pytest.mark.parametrize("shape", SHAPES + LONG_SHAPES)
def test_ssd_plan_for_test_shapes(shape):
    """The file's shapes have few rows: heads get a block each; the
    multi-chunk shapes take the chunk-parallel form, the single chunk
    cannot. A chunk of 256 runs in the tensor-core chunk-parallel form, as
    sub-chunks of 64 (sixteen warps a block)."""
    b, s, n, p, ds, chunk = shape
    plan = kernel.ssd_plan(b, s, n, p, ds, chunk, sms=132)
    inner = kernel.TC_CHUNK if chunk == 256 else chunk
    assert (plan.chunk, plan.inner, plan.chunks) == (chunk, inner,
                                                     s // inner)
    assert plan.form == ("tc" if chunk == 256 else "fma")
    assert plan.heads == 1 and plan.warps == {32: 1, 256: 16}[chunk]
    assert plan.chunk_parallel == (s // inner > 1)
    # no inner chunk fits (p = ds = 256: even 32 steps overflow), or none
    # divides the chunk (80 steps at p = ds = 128 overflow, and none of
    # 128, 64 and 32 divides 80): refused
    with pytest.raises(ValueError, match="no inner chunk"):
        kernel.ssd_plan(b, 1024, n, 256, 256, 1024, sms=132)
    with pytest.raises(ValueError, match="no inner chunk"):
        kernel.ssd_plan(b, 960, n, 128, 128, 80, sms=132)


@pytest.mark.parametrize("s,chunk,form", [
    (256, 32, "tc"), (512, 128, "tc"), (4096, 256, "tc"),
    # steps not whole chunks of 64: the FMA chunk-parallel form
    (480, 32, "fma"), (200, 40, "fma"),
    # one chunk of 64: nothing to run in parallel
    (64, 32, "fma")])
def test_tc_forward_takes_whole_chunks_of_64_at_any_chunk(s, chunk, form):
    """The tensor-core forward runs chunks of TC_CHUNK whatever the
    caller's chunk (the same function): the rules and a table's ``tc``
    take it wherever the steps are several whole chunks of 64, else the
    FMA forms, chunk-parallel where there are several chunks."""
    plan = kernel.ssd_plan(2, s, 8, 32, 16, chunk, sms=132)
    assert plan.form == form
    assert plan.chunk_parallel == (s // plan.inner > 1)
    assert plan.inner == (kernel.TC_CHUNK if form == "tc" else chunk)
    why = kernel.fwd_choice_error(s, 8, 32, 16, chunk, **kernel.TC_FIELDS)
    assert (why is None) == (form == "tc")


def test_tc_launch_counts_are_kept_per_wrapper():
    """Both wrappers launch the chunk states and the state pass, so the
    tensor-core kernels' counts are keyed by wrapper (each dtype's) and
    kernel, and chip_smoke's kernels line lists each wrapper's own."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for wrapper, names in (("ssd_scan", kernel.TC_FWD_KERNELS),
                           ("ssd_scan_bwd", kernel.TC_BWD_KERNELS)):
        assert wrapper in kernel.LAUNCHES
        for dt in ("", "_bf16"):
            for name in names:
                assert kernel.tc_key(wrapper + dt, name) in \
                    kernel.KERNEL_LAUNCHES
        listed = [f for f in mod.LISTED_FORMS[wrapper] if ":" in f]
        assert listed == [kernel.tc_key(wrapper, k) for k in names]
    assert not any(k in kernel.KERNEL_LAUNCHES
                   for k in kernel.TC_FWD_KERNELS + kernel.TC_BWD_KERNELS)


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


@pytest.mark.parametrize("dims", [(1, 512, 4, 32, 16), (1, 512, 2, 64, 128)],
                         ids=["inner128", "inner64"])
def test_sub_chunk_plan_order_of_work_matches_reference_at_chunk_256(dims):
    """The FMA form's plan at chunk 256 (the kernel's sub-chunks of 128,
    or of 64 at mamba2-2.7b's ds = 128 and p = 64; a selection table's
    choice, where the rules take the tensor-core form) in the kernel's
    order of work, chunk-parallel and walked in order, against the
    reference's Pallas kernel at chunk 256 in interpret mode: the same
    function, summed in another order, within SSD_RTOL of scale."""
    args = _inputs(*dims, seed=256 + dims[3])
    want = np.asarray(ref_kernel.ssd_scan(*args, chunk=256, block_h=2,
                                          interpret=True))
    assert kernel.ssd_plan(*dims, 256, sms=132).form == "tc"
    fma = kernel._fma_rule(*dims, 256, 132)
    assert fma["inner"] == (128 if dims[4] == 16 else 64)
    assert fma["chunk_parallel"]
    for chunk_parallel in (True, False):
        got, updates = _kernel_emulation(*args, fma["inner"], chunk_parallel)
        assert updates == dims[1] // fma["inner"] - 1
        _close_to_scale(got, want)


@pytest.mark.parametrize("arch,inner", [("mamba2-2.7b", 64),
                                        ("jamba-v0.1-52b", 128)])
def test_ssd_plan_at_full_configs_chunk_256(arch, inner):
    """mamba2-2.7b's (80 heads of 64, ds 128) and jamba's (128 heads of
    64, ds 16) SSD at their chunk of 256, one row of SHAPES["train_4k"]'s
    4096 steps: the tensor-core chunk-parallel forms over 64 chunks of 64,
    forward and backward, whose blocks fit the card; the FMA form's
    sub-chunk (``inner``), a selection table's choice, fits too (chunk
    256 itself would need 222,980 floats at mamba2's widths)."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    s_cfg = cfg.ssm
    n, p, ds = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state
    assert s_cfg.chunk_size == 256
    plan = kernel.ssd_plan(1, 4096, n, p, ds, 256, sms=132)
    assert (plan.chunk, plan.inner, plan.chunks) == (256, kernel.TC_CHUNK,
                                                     4096 // kernel.TC_CHUNK)
    assert plan.chunk_parallel and plan.form == "tc" and plan.heads == 1
    for backward in (False, True):
        assert kernel.tc_smem_floats(p, ds, backward) <= kernel.SMEM_MAX
    assert kernel.smem_floats(256, p, ds, 1, True) > kernel.SMEM_MAX
    assert kernel._fma_rule(1, 4096, n, p, ds, 256, 132)["inner"] == inner
    assert kernel.smem_floats(inner, p, ds, 1, True) <= kernel.SMEM_MAX
    bwd = kernel.ssd_bwd_plan(1, 4096, n, p, ds, sms=132)
    assert (bwd.form, bwd.chunk, bwd.chunks) == (
        "tc", kernel.TC_CHUNK, 4096 // kernel.TC_CHUNK)


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


# ---------------------------------------------------------------------------
# the backward: its plain version against the reference's jax.vjp, the
# kernel's plan and order of work, the wrapper's checks and the op's route
# ---------------------------------------------------------------------------

GRADS = ("dxh", "ddt", "da_log", "db", "dc")


def _assert_grads(got, want, what=""):
    """Each cotangent within SSD_RTOL (1e-4) of its own largest magnitude:
    the reference's SSD tolerance, as the chip holds the kernel."""
    for name, g, w in zip(GRADS, got, want):
        g, w = _np(g) if isinstance(g, torch.Tensor) else g, np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL["rtol"], (what, name, err)


def _ref_vjp(xh, dt, a_log, bm, cm, dy):
    _, vjp = jax.vjp(ref_ref.ssd_ref, xh, dt, a_log, bm, cm)
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_version_matches_reference_vjp(shape):
    """ssd_bwd_ref (the backward kernel's plain version) against jax.vjp of
    the reference's sequential ssd_ref, all five cotangents, over four
    chunks and over the FL path's one."""
    *dims, _ = shape
    args = _inputs(*dims, seed=dims[1] + 3)
    dy = np.random.default_rng(dims[1]).normal(size=dims[:4]).astype(
        np.float32)
    before = ref.CALLS["ssd_scan_bwd"]
    got = ref.ssd_bwd_ref(*(torch.from_numpy(a) for a in args + (dy,)))
    assert ref.CALLS["ssd_scan_bwd"] == before + 1
    _assert_grads(got, _ref_vjp(*args, dy))


def test_bwd_plain_version_per_slot_and_shared_rates():
    """a_log (G, n): slot g's gradient is the reference's on its rows
    alone; a stride-0 expanded a_log gets a (G, n) gradient whose sum over
    slots is the reference's shared-rate gradient."""
    xh, dt, a_log, bm, cm = _inputs(6, 64, 4, 16, 8, seed=12, groups=3)
    dy = np.random.default_rng(13).normal(size=xh.shape).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xh, dt, a_log, bm, cm, dy)]
    got = ref.ssd_bwd_ref(*t)
    assert got[2].shape == (3, 4)
    for g in range(3):
        rows = slice(2 * g, 2 * g + 2)
        want = _ref_vjp(xh[rows], dt[rows], a_log[g], bm[rows], cm[rows],
                        dy[rows])
        _assert_grads([got[0][rows], got[1][rows], got[2][g], got[3][rows],
                       got[4][rows]], want, f"slot {g}")
    shared = t[2][0].expand(3, 4)
    assert shared.stride(0) == 0
    got = ref.ssd_bwd_ref(t[0], t[1], shared, *t[3:])
    assert got[2].shape == (3, 4)
    want = _ref_vjp(xh, dt, a_log[0], bm, cm, dy)
    _assert_grads([got[0], got[1], got[2].sum(0), got[3], got[4]], want)


def _bwd_emulation(xh, dt, a_log, bm, cm, dy, heads=None):
    """ssd_bwd_chunk_kernel's order of work for every row at once, in f32:
    chunks of 32 steps (the last zero-padded past S); per head group of
    ``heads`` heads a forward sweep saving the state entering each chunk,
    then the reverse walk over chunks. Per chunk and head: the warp-scan
    cumsum in log2 units, dW = dY X^T, one pass down each column (W, the
    column sums of dW o S o L, M's suffix sums, dS), the straddle R_j =
    sum_{k < j} sum_{q >= j} M[q][k] read back from the suffix sums, dX =
    W^T dY, and the state terms (u X G^T, e dY h_in^T, <G, h_in>) where the
    chunk has them; dS summed over the group's heads in order before dB and
    dC, the state terms after; G carried to the chunk before. The head
    groups' dB and dC, and a slot's rows' a dL/da, summed in order."""
    x, d, b, c, gy = (torch.from_numpy(v) for v in (xh, dt, bm, cm, dy))
    bsz, s, n, p = x.shape
    ds = b.shape[-1]
    heads = heads or n
    a2 = torch.from_numpy(a_log)
    a2 = a2 if a2.dim() == 2 else a2[None]
    rate = ref.decay_rates(a2, bsz)                      # (B, n)
    q = kernel.BWD_CHUNK
    chunks = -(-s // q)

    def chunk(t, ci):
        v = t[:, ci * q:(ci + 1) * q]
        return torch.cat([v, v.new_zeros((bsz, q - v.shape[1])
                                          + v.shape[2:])], 1)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))  # [q][k]: q >= k
    below = torch.tril(torch.ones(q, q), -1)              # [j][k]: k < j
    dx, ddt = torch.zeros(bsz, s, n, p), torch.zeros(bsz, s, n)
    part_bc = torch.zeros(2, n // heads, bsz, s, ds)
    da = torch.zeros(bsz, n)
    for grp in range(n // heads):
        group = range(grp * heads, (grp + 1) * heads)
        h_in = {}
        for h in group:
            st = torch.zeros(bsz, ds, p)
            for ci in range(chunks - 1):
                xc, dc_, bc = chunk(x[:, :, h], ci), chunk(d[:, :, h], ci), \
                    chunk(b, ci)
                cum = _warp_scan_cumsum(dc_ * rate[:, h, None]) * LOG2E
                u = torch.exp2(cum[:, -1:] - cum) * dc_
                st = (st * torch.exp2(cum[:, -1])[:, None, None]
                      + torch.einsum("bks,bkp->bsp", bc, u[..., None] * xc))
                h_in[h, ci + 1] = st
        g_state = {h: torch.zeros(bsz, ds, p) for h in group}
        for ci in reversed(range(chunks)):
            c0 = ci * q
            qv = min(q, s - c0)
            has_g, has_h = ci + 1 < chunks, ci > 0
            cc, bc = chunk(c, ci), chunk(b, ci)
            scores = cc @ bc.transpose(1, 2)              # S[q][k]
            ds_sum = torch.zeros(bsz, q, q)
            pb_sum, pc_sum = torch.zeros(bsz, q, ds), torch.zeros(bsz, q, ds)
            for h in group:
                xc, dc_, dyc = (chunk(t[:, :, h], ci) for t in (x, d, gy))
                a = rate[:, h, None]
                cum = _warp_scan_cumsum(dc_ * a) * LOG2E   # (B, Q)
                last = cum[:, -1:]
                u, e = torch.exp2(last - cum) * dc_, torch.exp2(cum)
                dw = dyc @ xc.transpose(1, 2)             # dW[q][k]
                lq = torch.where(tri, torch.exp2(torch.where(
                    tri, cum[:, :, None] - cum[:, None, :], 0.0)), 0.0)
                sl = scores * lq
                w = sl * dc_[:, None, :]
                dm = dw * sl
                ddt1 = dm.sum(1)
                # tile[k][j] = sum_{q >= j} M[q][k] (suffix sums down column
                # k); R_j = sum_{k < j} tile[k][j]
                suffix = torch.flip(torch.cumsum(torch.flip(
                    dm * dc_[:, None, :], [1]), 1), [1])   # [j][k]
                r_straddle = (suffix * below).sum(2)
                ds_sum = ds_sum + dw * lq * dc_[:, None, :]
                dxc = w.transpose(1, 2) @ dyc
                v = r = hg = torch.zeros(bsz, 1)
                if has_g:
                    pb = xc @ g_state[h].transpose(1, 2)  # X G^T
                    v = (bc * pb).sum(-1)
                    pb_sum = pb_sum + u[..., None] * pb
                    dxc = dxc + u[..., None] * (bc @ g_state[h])
                if has_h:
                    pc = dyc @ h_in[h, ci].transpose(1, 2)  # dY h_in^T
                    r = e * (cc * pc).sum(-1)
                    pc_sum = pc_sum + e[..., None] * pc
                    if has_g:
                        hg = (g_state[h] * h_in[h, ci]).sum((1, 2))[:, None]
                r_suffix = torch.flip(torch.cumsum(torch.flip(
                    r.expand(bsz, q), [1]), 1), [1])
                uv = torch.cumsum((u * v).expand(bsz, q), 1)
                before = torch.cat([torch.zeros(bsz, 1), uv[:, :-1]], 1)
                d_a = r_straddle + r_suffix + before + torch.exp2(last) * hg
                ddt[:, c0:c0 + qv, h] = (ddt1 + torch.exp2(last - cum) * v
                                         + a * d_a)[:, :qv]
                da[:, h] += (dc_ * d_a).sum(1)
                dx[:, c0:c0 + qv, h] = dxc[:, :qv]
                if has_h:
                    g_state[h] = (torch.exp2(last)[..., None] * g_state[h]
                                  + cc.transpose(1, 2) @ (e[..., None] * dyc))
            part_bc[0, grp, :, c0:c0 + qv] = (ds_sum.transpose(1, 2) @ cc
                                              + pb_sum)[:, :qv]
            part_bc[1, grp, :, c0:c0 + qv] = (ds_sum @ bc + pc_sum)[:, :qv]
    db, dc = part_bc[0, 0], part_bc[1, 0]
    for grp in range(1, n // heads):
        db, dc = db + part_bc[0, grp], dc + part_bc[1, grp]
    part = (rate * da).reshape(a2.shape[0], -1, n)
    dlog = torch.zeros(a2.shape)
    for r in range(part.shape[1]):
        dlog = dlog + part[:, r]
    return dx, ddt, dlog if a_log.ndim == 2 else dlog[0], db, dc


@pytest.mark.parametrize("seq,heads,groups", [
    (32, None, 0),     # the FL path's one chunk, a block's heads
    (32, 1, 3),        # ... heads split across blocks, a_log per slot
    (128, None, 3),    # four chunks: the sweep and the state terms
    (128, 1, 0),
    (75, None, 0),     # a ragged last chunk (11 steps)
    (75, 1, 3),
], ids=lambda v: str(v))
def test_bwd_kernel_order_of_work_matches_plain_version(seq, heads, groups):
    """The chunked backward's order of work against ssd_bwd_ref and the
    reference's vjp (per slot where a_log is per slot), each gradient at
    1e-4 of its own scale."""
    args = _inputs(6, seq, 4, 16, 8, seed=seq + groups, groups=groups)
    dy = np.random.default_rng(seq).normal(size=args[0].shape).astype(
        np.float32)
    got = _bwd_emulation(*args, dy, heads=heads)
    _assert_grads(got, ref.ssd_bwd_ref(*(torch.from_numpy(a)
                                         for a in args + (dy,))))
    if groups == 0:
        _assert_grads(got, _ref_vjp(*args, dy))
        return
    xh, dt, a_log, bm, cm = args
    for g in range(groups):
        rows = slice(2 * g, 2 * g + 2)
        want = _ref_vjp(xh[rows], dt[rows], a_log[g], bm[rows], cm[rows],
                        dy[rows])
        _assert_grads([got[0][rows], got[1][rows], got[2][g], got[3][rows],
                       got[4][rows]], want, f"slot {g}")


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to TF32 as rna_tf32 does: 10 mantissa bits, ties away."""
    bits = (v.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _mm3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(eq, a, b) in 3xTF32: each operand split into a TF32 big part
    and the TF32 rounding of the rest, small * small dropped, the small
    products first."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm)
            + torch.einsum(eq, ab, bb))


def _bwd_tf32_emulation(xh, dt, a_log, bm, cm, dy):
    """ssd_bwd_tf32_kernel's arithmetic for each row and head, one chunk of
    32 steps, in f32: S^T = B C^T, dW^T = X dY^T, dX = W^T dY and the
    head-summed dS times C and B, each product in 3xTF32; W^T, dS^T, M and
    ddt's first term from the accumulators; the straddle R_j."""
    x, d, b, c, gy = (torch.from_numpy(v) for v in (xh, dt, bm, cm, dy))
    a2 = torch.from_numpy(a_log)
    a2 = a2 if a2.dim() == 2 else a2[None]
    bsz, q, n, _ = x.shape
    rate = ref.decay_rates(a2, bsz)
    cum = (_warp_scan_cumsum((d * rate[:, None]).transpose(1, 2))
           * LOG2E)                                          # (B, n, Q)
    dk = d.transpose(1, 2)
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool))   # [k][q]
    lq = torch.where(upper, torch.exp2(torch.where(
        upper, cum[..., None, :] - cum[..., :, None], 0.0)), 0.0)
    st = _mm3("bks,bqs->bkq", b, c)[:, None]                 # S^T
    dwt = _mm3("bknp,bqnp->bnkq", x, gy)                     # dW^T
    sl = st * lq
    wt = sl * dk[..., None]
    dm = dwt * sl
    suffix = torch.flip(torch.cumsum(torch.flip(dm * dk[..., None], [-1]),
                                     -1), [-1])
    r_straddle = (suffix * torch.triu(torch.ones(q, q), 1)).sum(-2)
    ddt = (dm.sum(-1) + rate[..., None] * r_straddle).transpose(1, 2)
    dx = _mm3("bnkq,bqnp->bknp", wt, gy)
    dst = dwt * lq * dk[..., None]
    dsum = dst[:, 0]
    for h in range(1, n):
        dsum = dsum + dst[:, h]
    db = _mm3("bkq,bqs->bks", dsum, c)
    dc = _mm3("bkq,bks->bqs", dsum, b)
    part = (rate * (dk * r_straddle).sum(-1)).reshape(a2.shape[0], -1, n)
    dlog = torch.zeros(a2.shape)
    for r in range(part.shape[1]):
        dlog = dlog + part[:, r]
    return dx, ddt, dlog if a_log.ndim == 2 else dlog[0], db, dc


@pytest.mark.parametrize("groups", [0, 3])
def test_bwd_tf32_form_arithmetic_matches_reference(groups):
    """The f32 tensor-core backward's arithmetic (every product in 3xTF32)
    at its one shape (S = 32, ds 16, p 32) against ssd_bwd_ref and the
    reference's vjp (per slot where a_log is per slot), each gradient at
    1e-4 of its own scale; one TF32 product alone does not hold that."""
    args = _inputs(6, 32, 4, 32, 16, seed=50 + groups, groups=groups)
    dy = np.random.default_rng(51).normal(size=args[0].shape).astype(
        np.float32)
    got = _bwd_tf32_emulation(*args, dy)
    _assert_grads(got, ref.ssd_bwd_ref(*(torch.from_numpy(a)
                                         for a in args + (dy,))))
    xh, dt, a_log, bm, cm = args
    for g in range(max(groups, 1)):
        rows = slice(2 * g, 2 * g + 2) if groups else slice(None)
        want = _ref_vjp(xh[rows], dt[rows], a_log[g] if groups else a_log,
                        bm[rows], cm[rows], dy[rows])
        _assert_grads([got[0][rows], got[1][rows],
                       got[2][g] if groups else got[2], got[3][rows],
                       got[4][rows]], want, f"slot {g}")


def _straddle(m: torch.Tensor) -> torch.Tensor:
    """R_j = sum_{q >= j > k} M[q][k] as the kernels take it: suffix sums
    down each column k into tile[k][j], then lane j's sum over k < j."""
    q = m.shape[0]
    tile = torch.flip(torch.cumsum(torch.flip(m, [0]), 0), [0]).T
    return torch.stack([tile[:j, j].sum() for j in range(q)])


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_straddle_equals_row_minus_column_sums(seed):
    """The straddle sum equals, in f64, the reverse cumsum of M's row sums
    minus that of its column sums (the form the kernels avoid: there the
    diagonal and most of each sum cancel)."""
    m = torch.tril(torch.from_numpy(np.random.default_rng(seed).normal(
        size=(32, 32))))
    rows = torch.flip(torch.cumsum(torch.flip(m.sum(1), [0]), 0), [0])
    cols = torch.flip(torch.cumsum(torch.flip(m.sum(0), [0]), 0), [0])
    torch.testing.assert_close(_straddle(m), rows - cols, rtol=1e-12,
                               atol=1e-12)
    # and it is M summed over q >= j > k, term by term
    want = torch.stack([m[j:, :j].sum() for j in range(32)])
    torch.testing.assert_close(_straddle(m), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("label,want", [
    # the FL round and statistics pass: one chunk at (32, 16, 32), the f32
    # tensor-core form (3xTF32), a warp per head, one row staged at a time
    ("round", ("tf32", 1, 4, 4, 1)),
    ("stats", ("tf32", 1, 4, 4, 1)),
    # 2 rows x 8 heads cannot fill 132 SMs: the tensor-core chunk-parallel
    # form, a block of 16 warps per (head, chunk, row), the heads' dB and
    # dC partials summed by the last launch; 8 chunks of 64
    ("multi-chunk", ("tc", 8, 1, 16, 0)),
    # 480 steps: 7 chunks of 64 and a ragged last one of 32
    ("ragged chunks", ("tc", 8, 1, 16, 0)),
    # 264 rows fill the card: all heads a block, 4 chunks
    ("long rows", ("chunk", 4, 4, 4, 0)),
    # 66 rows do not give every SM a block: a block per head, the heads'
    # dB and dC partials summed by the second launch
    ("head blocks", ("chunk", 4, 1, 4, 0)),
])
def test_ssd_bwd_plan_for_chip_smoke_cases(label, want):
    """The plan at chip_smoke's operands: x, b and c split views of one
    (rows, S, n p + 2 ds) conv output, dy contiguous, all 16-byte aligned;
    with 4-byte copies only, every case but the tensor-core chunk-parallel
    one (which takes them) takes the chunked form."""
    rows, s, n, p, ds, _ = _chip_smoke_ssd_cases()[label]
    width = n * p + 2 * ds
    kw = dict(sms=132, x_strides=(s * width, width, p, s * n * p, n * p, p),
              bc_strides=(s * width, width) * 2, x_aligned=True,
              bc_aligned=True)
    plan = kernel.ssd_bwd_plan(rows, s, n, p, ds, **kw)
    assert (plan.form, plan.chunks, plan.heads, plan.warps,
            plan.ring) == want
    tc = plan.form == "tc"
    assert plan.chunk == (64 if tc else 32)
    assert (plan.vec_x, plan.vec_bc) == (16, 16)
    assert (kernel.tc_smem_floats(p, ds, True) if tc else
            kernel.bwd_smem_floats(p, ds, plan.heads,
                                   plan.chunks > 1)) <= kernel.SMEM_MAX
    plain = kernel.ssd_bwd_plan(rows, s, n, p, ds, sms=132)
    assert (plain.form, plain.heads, plain.vec_x) == (
        "tc" if tc else "chunk", want[2], 4)


def test_ssd_bwd_plan_limits():
    """p above 128 is refused; a short or ragged sequence is one chunk or a
    partial last one; more heads than a block's 8 warps split; a state too
    wide for shared memory is refused."""
    with pytest.raises(ValueError, match="p <= 128"):
        kernel.ssd_bwd_plan(2, 32, 1, 160, 16, sms=132)
    assert kernel.ssd_bwd_plan(2, 3, 1, 32, 16, sms=132).chunks == 1
    assert kernel.ssd_bwd_plan(2, 33, 1, 32, 16, sms=132).chunks == 2
    assert kernel.ssd_bwd_plan(500, 32, 16, 32, 16, sms=132).heads == 1
    assert kernel.ssd_bwd_plan(500, 32, 8, 32, 16, sms=132).warps == 8
    assert kernel.ssd_bwd_plan(500, 32, 2, 32, 16, sms=132).warps == 4
    with pytest.raises(ValueError, match="shared memory"):
        kernel.ssd_bwd_plan(2, 64, 1, 128, 256, sms=132)


def test_bwd_wrapper_checks_operands():
    """The backward's CUDA-side checks, reached here on CPU tensors: dy in
    xh's dtype and y's shape, b and c in xh's dtype, dt in f32, a_log of
    n rates or (G, n) with G dividing B; a bf16 a_log is read as it is, a
    float16 one upcast."""
    xh, dt, a_log, bm, cm = (torch.from_numpy(a)
                             for a in _inputs(4, 32, 2, 8, 4, groups=2))
    dy = torch.zeros_like(xh)
    got = kernel._bwd_operands(xh, dt, a_log, bm, cm, dy)
    assert got[2].shape == (2, 2) and got[5] is dy
    with pytest.raises(TypeError):
        kernel._bwd_operands(xh, dt, a_log, bm, cm, dy.bfloat16())
    with pytest.raises(ValueError, match="dy"):
        kernel._bwd_operands(xh, dt, a_log, bm, cm, dy[:, :16])
    with pytest.raises(TypeError):
        kernel._bwd_operands(xh, dt.double(), a_log, bm, cm, dy)
    with pytest.raises(TypeError):
        kernel._bwd_operands(xh, dt, a_log, bm.bfloat16(), cm, dy)
    with pytest.raises(ValueError, match="a_log"):
        kernel._bwd_operands(xh, dt, torch.zeros(3, 2), bm, cm, dy)
    with pytest.raises(ValueError, match="shapes"):
        kernel._bwd_operands(xh, dt[:, :, :1], a_log, bm, cm, dy)
    with pytest.raises(TypeError, match="float dtype"):
        kernel._bwd_operands(xh, dt, a_log.int(), bm, cm, dy)
    assert kernel._bwd_operands(xh, dt, a_log.bfloat16(), bm, cm,
                                dy)[2].dtype == torch.bfloat16
    assert kernel._bwd_operands(xh, dt, a_log.half(), bm, cm,
                                dy)[2].dtype == torch.float32
    # a transposed dy is made unit-stride in its last dim
    dyt = torch.zeros(4, 32, 8, 2).transpose(2, 3)
    assert kernel._bwd_operands(xh, dt, a_log, bm, cm,
                                dyt)[5].stride(-1) == 1


def test_op_backward_goes_through_the_backward_wrapper(monkeypatch):
    """_SSD.backward calls kernel.ssd_scan_bwd once with the saved inputs,
    dy and the forward's chunk (which keys the selection table), and passes
    its five gradients through: the op's gradients are the wrapper's (on
    the CPU, its plain version, counted)."""
    t = [torch.from_numpy(a).requires_grad_()
         for a in _inputs(2, 32, 2, 8, 4, seed=3, groups=2)]
    seen = []
    real = kernel.ssd_scan_bwd

    def spy(*args, **kwargs):
        seen.append(args)
        assert kwargs == {"chunk": 32}
        return real(*args, **kwargs)
    monkeypatch.setattr(kernel, "ssd_scan_bwd", spy)
    before = ref.CALLS["ssd_scan_bwd"]
    dy = torch.randn(2, 32, 2, 8)
    ops.ssd(*t, chunk=32).backward(dy)
    assert len(seen) == 1 and ref.CALLS["ssd_scan_bwd"] == before + 1
    assert all(a is b or torch.equal(a, b) for a, b in zip(seen[0][:5], t))
    assert torch.equal(seen[0][5], dy)
    want = real(*(a.detach() for a in t), dy)
    for a, w in zip(t, want):
        assert torch.equal(a.grad, w)


# ---------------------------------------------------------------------------
# the chunk-parallel tensor-core forms (ssd_tc_*_kernel): chunks of 64, a
# block per (head, chunk, row), every product in 3xTF32
# ---------------------------------------------------------------------------


def _tc_chunks(t: torch.Tensor, q: int) -> torch.Tensor:
    """(B, S, ...) -> (B, chunks, q, ...), the last chunk zero-padded."""
    bsz, s = t.shape[:2]
    pad = -s % q
    t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], 1)
    return t.reshape((bsz, -1, q) + t.shape[2:])


def _tc_scan(dt_c: torch.Tensor, rate: torch.Tensor) -> tuple:
    """tc_scan for every (row, chunk, head): dt_c (B, C, Q, n), rate (B,
    n) -> cum (log2 units), u, e (B, C, n, Q) and cum_last (B, C, n)."""
    d = dt_c.permute(0, 1, 3, 2)
    cum = _warp_scan_cumsum(d * rate[:, None, :, None]) * LOG2E
    last = cum[..., -1]
    return cum, torch.exp2(last[..., None] - cum) * d, torch.exp2(cum), last


def _tc_pass(own: torch.Tensor, dec: torch.Tensor, back: bool):
    """ssd_tc_pass_kernel over (B, C, n, ds, p) terms and (B, C, n) decays:
    in chunk order h_in[c + 1] = h_in[c] dec[c] + s_c, or in reverse
    G[c - 1] = G[c] dec[c] + g_c; each slot replaced by the state entering
    (or the cotangent leaving) its chunk."""
    out, h = torch.zeros_like(own), torch.zeros_like(own[:, 0])
    chunks = own.shape[1]
    for ci in (reversed(range(chunks)) if back else range(chunks)):
        out[:, ci] = h
        has = ci >= 1 if back else ci + 1 < chunks
        h = h * dec[:, ci, :, None, None] + (own[:, ci] if has else 0.0)
    return out


def _tc_states(x, dt, rate, b, c=None, dy=None):
    """ssd_tc_state_kernel then the state pass: each chunk's own end state
    B^T (u X) (and with c, dy its boundary cotangent C^T (e dY)) in
    3xTF32, then h_in (and G). x (B, C, Q, n, p), dt (B, C, Q, n), b and c
    (B, C, Q, ds)."""
    cum, u, e, last = _tc_scan(dt, rate)
    dec = torch.exp2(last)
    ux = u.permute(0, 1, 3, 2)[..., None] * x            # (B, C, Q, n, p)
    h_in = _tc_pass(_mm3("bcks,bcknp->bcnsp", b, ux), dec, False)
    g_out = None
    if c is not None:
        edy = e.permute(0, 1, 3, 2)[..., None] * dy
        g_out = _tc_pass(_mm3("bcqs,bcqnp->bcnsp", c, edy), dec, True)
    return cum, u, e, last, h_in, g_out


def _tc_fwd_emulation(xh, dt, a_log, bm, cm):
    """The forward's chunk-parallel tensor-core form in its order of work:
    chunk states and decays, the state pass, then per chunk y = e (C
    h_in) + W X with W = (C B^T) exp2(cum_q - cum_k) dt_k for k <= q, every
    product in 3xTF32."""
    q = kernel.TC_CHUNK
    x, d, b, c = (torch.from_numpy(v) for v in (xh, dt, bm, cm))
    bsz, s = x.shape[:2]
    rate = ref.decay_rates(torch.from_numpy(a_log), bsz)
    rate = rate.expand(bsz, x.shape[2]) if rate.dim() == 1 else rate
    xc, dc, bc, cc = (_tc_chunks(t, q) for t in (x, d, b, c))
    cum, _, e, _, h_in, _ = _tc_states(xc, dc, rate, bc)
    lower = torch.tril(torch.ones(q, q, dtype=torch.bool))
    scores = _mm3("bcqs,bcks->bcqk", cc, bc)[:, :, None]   # (B, C, 1, Q, Q)
    dec = torch.where(lower, torch.exp2(torch.where(
        lower, cum[..., :, None] - cum[..., None, :], 0.0)), 0.0)
    w = scores * dec * dc.permute(0, 1, 3, 2)[..., None, :]
    y = (e.permute(0, 1, 3, 2)[..., None]
         * _mm3("bcqs,bcnsp->bcqnp", cc, h_in)
         + _mm3("bcnqk,bcknp->bcqnp", w, xc))
    return y.reshape(bsz, -1, *y.shape[3:])[:, :s].numpy()


@pytest.mark.parametrize("shape", [(2, 256, 4, 16, 16, 64),
                                   (1, 512, 2, 32, 32, 256)],
                         ids=["four_chunks", "chunk256"])
def test_tc_fwd_order_of_work_matches_reference_pallas(shape):
    """The forward's chunk-parallel tensor-core form (chunks of 64: four,
    and a caller's chunk of 256 run as eight sub-chunks) in its order of
    work against the reference's Pallas kernel in interpret mode, within
    SSD_RTOL of scale; the plan takes that form there."""
    *dims, chunk = shape
    args = _inputs(*dims, seed=chunk + dims[1] + 7)
    want = np.asarray(ref_kernel.ssd_scan(*args, chunk=chunk, block_h=2,
                                          interpret=True))
    plan = kernel.ssd_plan(*dims, chunk, sms=132)
    assert (plan.form, plan.inner, plan.chunks) == (
        "tc", kernel.TC_CHUNK, dims[1] // kernel.TC_CHUNK)
    _close_to_scale(_tc_fwd_emulation(*args), want)


def _tc_bwd_emulation(xh, dt, a_log, bm, cm, dy):
    """The backward's chunk-parallel tensor-core form in its order of work
    (ssd_tc_state_kernel, ssd_tc_pass_kernel both ways, ssd_tc_bwd_kernel,
    ssd_bwd_sum_kernel): chunks of 64, the last zero-padded past S. Per
    (row, head, chunk) with its h_in and G: S^T = B C^T and dW^T = X dY^T;
    W^T, M^T, dS^T and ddt's first term from them; the straddle R_j; dX =
    u (B G) + W^T dY, dC_h = e (dY h_in^T) + dS B, dB_h = u (X G^T) + dS^T
    C, r and v from the state products; dA, ddt and the chunk's a dL/da.
    Then dB and dC summed over heads in order, da over a slot's rows and
    chunks in order. Every product in 3xTF32."""
    q = kernel.TC_CHUNK
    x, d, b, c, gy = (torch.from_numpy(v) for v in (xh, dt, bm, cm, dy))
    bsz, s, n, _ = x.shape
    a2 = torch.from_numpy(a_log)
    a2 = a2 if a2.dim() == 2 else a2[None]
    rate = ref.decay_rates(a2, bsz)                          # (B, n)
    xc, dc, bc, cc, dyc = (_tc_chunks(t, q) for t in (x, d, b, c, gy))
    chunks = xc.shape[1]
    cum, u, e, last, h_in, g_out = _tc_states(xc, dc, rate, bc, cc, dyc)
    dk = dc.permute(0, 1, 3, 2)                              # (B, C, n, Q)
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool))   # [k][q]
    lq = torch.where(upper, torch.exp2(torch.where(
        upper, cum[..., None, :] - cum[..., :, None], 0.0)), 0.0)
    st = _mm3("bcks,bcqs->bckq", bc, cc)[:, :, None]         # S^T
    dwt = _mm3("bcknp,bcqnp->bcnkq", xc, dyc)                # dW^T
    sl = st * lq
    wt = sl * dk[..., None]
    dm = dwt * sl
    ddt1 = dm.sum(-1)
    mt = dm * dk[..., None]
    dst = dwt * lq * dk[..., None]
    # suffix sums along each row k of M^T over q > k, then column sums
    # over k < j
    strict = torch.triu(torch.ones(q, q), 1)
    suffix = torch.flip(torch.cumsum(torch.flip(mt * strict, [-1]), -1),
                        [-1])
    r_straddle = (suffix * strict).sum(-2)
    ut, et = u[..., None], e[..., None]                      # (B, C, n, Q, 1)
    pb = _mm3("bcknp,bcnsp->bcnks", xc, g_out)               # X G^T
    pc = _mm3("bcqnp,bcnsp->bcnqs", dyc, h_in)               # dY h_in^T
    dx = (ut * _mm3("bcks,bcnsp->bcnkp", bc, g_out)
          + _mm3("bcnkq,bcqnp->bcnkp", wt, dyc))
    dc_h = et * pc + _mm3("bcnkq,bcks->bcnqs", dst, bc)
    db_h = ut * pb + _mm3("bcnkq,bcqs->bcnks", dst, cc)
    v = (bc[:, :, None] * pb).sum(-1)                        # (B, C, n, Q)
    r = e * (cc[:, :, None] * pc).sum(-1)
    hg = (g_out * h_in).sum((-2, -1))                        # (B, C, n)
    r_suffix = torch.flip(torch.cumsum(torch.flip(r, [-1]), -1), [-1])
    uv = torch.cumsum(u * v, -1)
    before = torch.cat([torch.zeros_like(uv[..., :1]), uv[..., :-1]], -1)
    d_a = (r_straddle + r_suffix + before
           + (torch.exp2(last) * hg)[..., None])
    rate_c = rate[:, None, :, None]
    ddt = ddt1 + torch.exp2(last[..., None] - cum) * v + rate_c * d_a
    part_da = rate[:, None] * (dk * d_a).sum(-1)             # (B, C, n)

    def unchunk(t):                                          # (B, C, n, Q, w)
        t = t.permute(0, 1, 3, 2, 4).reshape(bsz, chunks * q, n, -1)
        return t[:, :s]
    db, dc_ = unchunk(db_h)[:, :, 0], unchunk(dc_h)[:, :, 0]
    for h in range(1, n):
        db, dc_ = db + unchunk(db_h)[:, :, h], dc_ + unchunk(dc_h)[:, :, h]
    part = part_da.permute(0, 2, 1).reshape(a2.shape[0], -1, n, chunks)
    dlog = torch.zeros(a2.shape)
    for rr in range(part.shape[1]):
        for ci in range(chunks):
            dlog = dlog + part[:, rr, :, ci]
    return (unchunk(dx), unchunk(ddt[..., None])[..., 0],
            dlog if a_log.ndim == 2 else dlog[0], db, dc_)


@pytest.fixture(scope="module", params=[(256, 0), (200, 3), (130, 3)],
                ids=["four_chunks", "ragged_per_slot", "ragged_3"])
def tc_bwd_case(request):
    """One case's operands, the emulated tensor-core backward, the plain
    version's gradients and the reference's vjp (per slot where a_log is
    per slot): 6 rows, 3 heads of 16, ds 16."""
    seq, groups = request.param
    args = _inputs(6, seq, 3, 16, 16, seed=seq + groups, groups=groups)
    dy = np.random.default_rng(seq + 1).normal(size=args[0].shape).astype(
        np.float32)
    got = _tc_bwd_emulation(*args, dy)
    plain = ref.ssd_bwd_ref(*(torch.from_numpy(a) for a in args + (dy,)))
    xh, dt, a_log, bm, cm = args
    slots = [slice(None)] if groups == 0 else [
        slice(2 * g, 2 * g + 2) for g in range(groups)]
    want = [_ref_vjp(xh[rows], dt[rows], a_log[g] if groups else a_log,
                     bm[rows], cm[rows], dy[rows])
            for g, rows in enumerate(slots)]
    return seq, groups, slots, got, plain, want


def test_tc_bwd_order_of_work_matches_plain_and_reference(tc_bwd_case):
    """The backward's chunk-parallel tensor-core form (several chunks of
    64, a ragged last one, a_log per slot, every head its own block summed
    in order) in its order of work against ssd_bwd_ref and the reference's
    vjp, each gradient at 1e-4 of its own scale; the plan takes that form
    there."""
    seq, groups, slots, got, plain, want = tc_bwd_case
    _assert_grads(got, plain)
    for g, rows in enumerate(slots):
        _assert_grads([got[0][rows], got[1][rows],
                       got[2][g] if groups else got[2], got[3][rows],
                       got[4][rows]], want[g], f"slot {g}")
    plan = kernel.ssd_bwd_plan(6, seq, 3, 16, 16, sms=132)
    assert (plan.form, plan.chunk, plan.chunks, plan.heads) == (
        "tc", kernel.TC_CHUNK, -(-seq // kernel.TC_CHUNK), 1)
