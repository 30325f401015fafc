"""The token models' bf16 data plane against ``repro``'s, on the CPU: the
flash-attention and SSD plain versions and autograd ops in bf16 against
the reference's Pallas kernels in interpret mode, the launch plans' bf16
copy widths, the wrappers' dtype checks, and two-round
``Simulation(Scenario(model="transformer"|"ssm", dtype="bf16"))`` runs.

Inputs are made with numpy and rounded to bf16 once, so both packages see
the same bf16 values. Tolerances, each with its reason:

- plain versions and ops: both packages upcast on load, compute in f32 and
  round each output once to bf16, summing in different orders: one bf16
  ulp of the reference's element plus ``FA_RTOL`` (2e-5, the reference's
  f32 attention tolerance) or ``SSD_RTOL`` (1e-4, its SSD tolerance) of the
  tensor's largest magnitude; lse (f32) within FA_RTOL of its scale;
- simulations: the reference's own bf16 contract
  (``tests/test_mixed_precision.py``: losses 5e-2, params 3e-2), absolute:
  the SSM's zero-initialised leaves (dt_bias, conv_b, a_log) move by about
  1e-4 in two rounds, so a difference relative to their own scale means
  nothing. The measured differences are stated beside each test.
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

from repro.fl import sim as ref_sim  # noqa: E402
from repro.kernels.flash_attention import kernel as ref_fa  # noqa: E402
from repro.kernels.flash_attention import ops as ref_fa_ops  # noqa: E402
from repro.kernels.ssd_scan import kernel as ref_ssd  # noqa: E402
from repro.kernels.ssd_scan import ops as ref_ssd_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as ref_ssd_ref  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

# the kernels' tolerances on the card (chip_smoke.py FA_RTOL, SSD_RTOL)
FA_RTOL = 2e-5
SSD_RTOL = 1e-4
# the reference's bf16 contract (tests/test_mixed_precision.py:119,124),
# absolute (module docstring)
LOSS_ATOL = 5e-2
PARAM_ATOL = 3e-2

# (B, H, S, D, causal, window): the FL round's shape at 8 rows, the short
# form's ragged S with a window and its non-causal case, and a tiled shape
FA_SHAPES = [(8, 2, 32, 32, True, None), (4, 2, 20, 32, True, 8),
             (4, 2, 32, 32, False, None), (2, 2, 64, 64, True, None)]
# (B, S, n, p, ds, chunk): the FL path's single chunk, and four chunks
SSD_SHAPES = [(4, 32, 4, 32, 16, 32), (2, 128, 4, 16, 8, 32)]


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and back to f32 (exact both ways)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


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


def bf16_excess(got, want) -> float:
    """max(|got - want| - ulp(want)) over the tensor's largest magnitude:
    at most ``rtol`` when every element lies within one bf16 ulp of the
    reference's plus ``rtol`` of the scale. Both bf16."""
    assert got.dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    return float((np.abs(g - w) - _ulp(w)).max(initial=0.0)
                 / max(np.abs(w).max(initial=0.0), 1e-30))


def _fa_inputs(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.normal(size=(b, h, s, d))) for _ in range(4)]


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FA_SHAPES)
def test_attention_plain_versions_match_reference_bf16(case):
    """o and lse against the Pallas forward, dq, dk and dv against the
    Pallas backward pair from the same residuals, all in bf16."""
    b, h, s, d, causal, window = case
    q, k, v, do = _fa_inputs(b, h, s, d, seed=s + d)
    o_ref, lse_ref = ref_fa.flash_attention(
        _j(q), _j(k), _j(v), causal=causal, window=window, interpret=True,
        return_lse=True)
    o, lse = fa_ref.attention_ref_lse(_t(q), _t(k), _t(v), causal=causal,
                                      window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert bf16_excess(o, o_ref) <= FA_RTOL
    lse_ref = np.array(lse_ref)
    assert np.abs(lse.numpy() - lse_ref).max() \
        <= FA_RTOL * np.abs(lse_ref).max()

    delta = np.sum(_f32(o_ref) * do, axis=-1)
    dq_ref, dk_ref, dv_ref = ref_fa.flash_attention_bwd(
        _j(q), _j(k), _j(v), _j(do), lse_ref, delta, causal=causal,
        window=window, interpret=True)
    got = fa_ref.attention_ref_bwd(
        _t(q), _t(k), _t(v), _t(do), torch.from_numpy(lse_ref),
        torch.from_numpy(delta), causal=causal, window=window)
    for g, w in zip(got, (dq_ref, dk_ref, dv_ref)):
        assert bf16_excess(g, w) <= FA_RTOL


def _ssd_inputs(b, s, n, p, ds, seed):
    """xh, b and c on the bf16 grid, dt f32 (both packages compute it in
    f32), a_log on the bf16 grid (a cast param under bf16)."""
    rng = np.random.default_rng(seed)
    xh = _bf16(rng.normal(size=(b, s, n, p)))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, n)))).astype(np.float32)
    a_log = _bf16(rng.normal(size=(n,)) * 0.5)
    bm, cm = (_bf16(rng.normal(size=(b, s, ds))) for _ in range(2))
    return xh, dt, a_log, bm, cm


def _ssd_args(xh, dt, a_log, bm, cm, to):
    """The scan's operands for one package: dt stays f32."""
    return to(xh), (torch.from_numpy(dt) if to is _t else jnp.asarray(dt)), \
        to(a_log), to(bm), to(cm)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_version_matches_reference_bf16(shape):
    """ssd_ref (the kernel's plain version) with bf16 xh, b, c and a_log and
    f32 dt against the Pallas kernel in interpret mode."""
    *dims, chunk = shape
    args = _ssd_inputs(*dims, seed=chunk + dims[1])
    want = ref_ssd.ssd_scan(*_ssd_args(*args, _j), chunk=chunk,
                            interpret=True)
    got = ssd_ref.ssd_ref(*_ssd_args(*args, _t))
    assert bf16_excess(got, want) <= SSD_RTOL


def _attention_f32_before(q, k, v, causal, window):
    """attention_ref_lse as it stood before it took bf16 operands."""
    mask = fa_ref._mask(q.shape[2], causal, window, q.device)
    scores = fa_ref._scores(q, k).masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v), lse.float()


def _ssd_f32_before(xh, dt, a_log, b_ssm, c_ssm):
    """The sequential recurrence as ssd_ref computes it in f32."""
    a = -torch.exp(a_log.float())
    h = torch.zeros((xh.shape[0], xh.shape[2], b_ssm.shape[-1], xh.shape[3]))
    ys = []
    for t in range(xh.shape[1]):
        dt_t = dt[:, t].float()
        upd = (dt_t[..., None, None] * b_ssm[:, t, None, :, None].float()
               * xh[:, t, :, None, :].float())
        h = h * torch.exp(dt_t * a)[..., None, None] + upd
        ys.append(torch.einsum("bnsp,bs->bnp", h, c_ssm[:, t].float()))
    return torch.stack(ys, dim=1).to(xh.dtype)


@pytest.mark.parametrize("which", ["attention", "ssd"])
def test_f32_plain_versions_are_bit_identical_to_before(which):
    """The bf16 semantics change nothing in f32: the attention forward and
    the SSD plain versions give exactly their earlier f32 results."""
    rng = np.random.default_rng(5)
    if which == "attention":
        q, k, v = (torch.from_numpy(rng.normal(size=(3, 2, 32, 32))
                                    .astype(np.float32)) for _ in range(3))
        for causal, window in ((True, None), (True, 8), (False, None)):
            got = fa_ref.attention_ref_lse(q, k, v, causal=causal,
                                           window=window)
            want = _attention_f32_before(q, k, v, causal, window)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        xh, dt, a_log, bm, cm = (torch.from_numpy(a.astype(np.float32))
                                 for a in _ssd_inputs(2, 64, 4, 16, 8, 3))
        assert torch.equal(ssd_ref.ssd_ref(xh, dt, a_log, bm, cm),
                           _ssd_f32_before(xh, dt, a_log, bm, cm))


# ---------------------------------------------------------------------------
# the autograd ops against the reference's custom VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8)])
def test_attention_op_gradients_match_reference_bf16(causal, window):
    """o and the q/k/v gradients of flash_ops.attention in bf16 against
    jax.vjp through the reference's op on its Pallas kernels in interpret
    mode: one bf16 ulp plus FA_RTOL of scale, the gradients in bf16."""
    q, k, v, do = _fa_inputs(4, 2, 32, 32, seed=11)

    def f(q, k, v):
        return ref_fa_ops.attention(q, k, v, causal=causal, window=window,
                                    impl="interpret")
    o_ref, vjp = jax.vjp(f, _j(q), _j(k), _j(v))
    grads_ref = vjp(_j(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = fa_ops.attention(tq, tk, tv, causal=causal, window=window)
    o.backward(_t(do))
    assert bf16_excess(o, o_ref) <= FA_RTOL
    for g, w in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        assert g.dtype == torch.bfloat16
        assert bf16_excess(g, w) <= FA_RTOL


def test_ssd_op_gradients_match_reference_bf16():
    """y and all five cotangents of ssd_ops.ssd with bf16 xh, b, c and
    a_log and f32 dt against jax.vjp through the reference's op (Pallas
    forward in interpret mode; both backwards run through the sequential
    recurrence): one bf16 ulp plus SSD_RTOL of scale, dt's f32 cotangent
    within SSD_RTOL of its scale; each cotangent in its input's dtype."""
    b, s, n, p, ds, chunk = SSD_SHAPES[0]
    args = _ssd_inputs(b, s, n, p, ds, seed=9)
    dy = _bf16(np.random.default_rng(10).normal(size=(b, s, n, p)))

    def f(*a):
        return ref_ssd_ops.ssd(*a, chunk=chunk, impl="interpret")
    y_ref, vjp = jax.vjp(f, *_ssd_args(*args, _j))
    grads_ref = vjp(_j(dy))
    targs = [t.requires_grad_() for t in _ssd_args(*args, _t)]
    y = ssd_ops.ssd(*targs, chunk=chunk)
    y.backward(_t(dy))
    assert bf16_excess(y, y_ref) <= SSD_RTOL
    for t, w in zip(targs, grads_ref):
        assert t.grad.dtype == t.dtype
        if t.dtype == torch.bfloat16:
            assert bf16_excess(t.grad, w) <= SSD_RTOL
        else:
            w = np.asarray(w)
            assert np.abs(t.grad.numpy() - w).max() \
                <= SSD_RTOL * np.abs(w).max()


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_bwd_plain_version_matches_reference_bf16(shape):
    """ssd_bwd_ref (the backward kernel's plain version) with bf16 xh, b,
    c, a_log and dy and f32 dt against jax.vjp of the reference's
    sequential ssd_ref: the bf16 cotangents within one bf16 ulp plus
    SSD_RTOL of scale, dt's f32 one within SSD_RTOL of its scale, each in
    its input's dtype."""
    b, s, n, p, ds, _ = shape
    args = _ssd_inputs(b, s, n, p, ds, seed=s + 7)
    dy = _bf16(np.random.default_rng(s).normal(size=(b, s, n, p)))
    _, vjp = jax.vjp(ref_ssd_ref.ssd_ref, *_ssd_args(*args, _j))
    want = vjp(_j(dy))
    got = ssd_ref.ssd_bwd_ref(*_ssd_args(*args, _t), _t(dy))
    for t, g, w in zip(_ssd_args(*args, _t), got, want):
        assert g.dtype == t.dtype and g.shape == t.shape
        if g.dtype == torch.bfloat16:
            assert bf16_excess(g, w) <= SSD_RTOL
        else:
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= SSD_RTOL * np.abs(w).max()


def _split(v: torch.Tensor) -> tuple:
    """An f32 tensor as ssd_mma_kernel's split_bf16x2 takes it: the bf16
    rounding and the bf16 rounding of what it left out."""
    big = v.bfloat16().float()
    return big, (v - big).bfloat16().float()


def _mma_emulation(xh, dt, a_log, bm, cm, chunk=32):
    """ssd_mma_kernel's arithmetic for each row and head in f32 from bf16
    operands: the scores c b^T (exact bf16 products), W = scores
    exp2(cum_q - cum_k) dt_k split into bf16 big and small parts, each
    multiplied by x; the inter term exp2(cum_q) c (h split likewise); the
    state updated as h exp2(cum_last) + (b wk, split)^T x; y rounded once
    to bf16."""
    x, b, c = (torch.from_numpy(v) for v in (xh, bm, cm))
    d = torch.from_numpy(dt)
    rate = -torch.exp(torch.from_numpy(a_log))               # (n,)
    bsz, s, n, p = x.shape
    ys = torch.zeros(bsz, s, n, p)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        cum2 = torch.cumsum(d[:, sl] * rate, dim=1) * LOG2E   # (B, Q, n)
        last2 = cum2[:, -1:]
        scores = torch.einsum("bqs,bks->bqk", c[:, sl], b[:, sl])
        dec = torch.exp2(cum2[:, :, None] - cum2[:, None, :])  # (B,q,k,n)
        w = torch.where(causal[None, :, :, None],
                        scores[..., None] * dec * d[:, sl][:, None], 0.0)
        wb, wsm = _split(w)
        y = (torch.einsum("bqkn,bknp->bqnp", wsm, x[:, sl])
             + torch.einsum("bqkn,bknp->bqnp", wb, x[:, sl]))
        if ci:
            hb, hsm = _split(h)
            inter = (torch.einsum("bqs,bnsp->bqnp", c[:, sl], hsm)
                     + torch.einsum("bqs,bnsp->bqnp", c[:, sl], hb))
            y = torch.exp2(cum2)[..., None] * inter + y
        ys[:, sl] = y
        if ci + 1 < s // chunk:
            wk = torch.exp2(last2 - cum2) * d[:, sl]           # (B, Q, n)
            ab, asm = _split(b[:, sl, None, :] * wk[..., None])  # (B,k,n,s)
            upd = (torch.einsum("bkns,bknp->bnsp", asm, x[:, sl])
                   + torch.einsum("bkns,bknp->bnsp", ab, x[:, sl]))
            h = upd if ci == 0 else h * torch.exp2(last2[:, 0])[
                ..., None, None] + upd
    return ys.bfloat16()


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.mark.parametrize("seq", [32, 128])
def test_ssd_mma_form_arithmetic_matches_reference_bf16(seq):
    """The bf16 tensor-core form's arithmetic (W and the state in split
    bf16 parts on the tensor cores) at its one shape (chunk 32, ds 16,
    p 32), in one chunk and over four, against the reference's Pallas
    kernel in interpret mode: one bf16 ulp plus SSD_RTOL of scale."""
    args = _ssd_inputs(4, seq, 4, 32, 16, seed=seq + 1)
    want = ref_ssd.ssd_scan(*_ssd_args(*args, _j), chunk=32, interpret=True)
    assert bf16_excess(_mma_emulation(*args), want) <= SSD_RTOL


def _bwd_mma_emulation(xh, dt, a_log, bm, cm, dy):
    """ssd_bwd_mma_kernel's arithmetic for each row and head, one chunk of
    32 steps, in f32 from bf16 operands: S^T = B C^T and dW^T = X dY^T from
    exact bf16 products; W^T = S^T exp2(cum_q - cum_k) dt_k split into bf16
    big and small parts, each multiplied by dY; ddt's first term the row
    sums of dW^T o S^T o L; the straddle R_j from M = dW^T o W^T; dS^T =
    dW^T exp2(cum_q - cum_k) dt_k summed over heads in order, split in two,
    times C and B; dx, db and dc rounded once to bf16, ddt f32, da_log in
    a_log's dtype."""
    x, b, c, gy = (torch.from_numpy(v) for v in (xh, bm, cm, dy))
    d = torch.from_numpy(dt)
    a2 = torch.from_numpy(a_log)
    a2 = a2 if a2.dim() == 2 else a2[None]
    bsz, q, n, _ = x.shape
    rate = ssd_ref.decay_rates(a2, bsz)                      # (B, n)
    cum = (torch.cumsum(d * rate[:, None], 1) * LOG2E).transpose(1, 2)
    dk = d.transpose(1, 2)                                   # (B, n, Q)
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool))   # [k][q]
    lq = torch.where(upper, torch.exp2(torch.where(
        upper, cum[..., None, :] - cum[..., :, None], 0.0)), 0.0)
    st = torch.einsum("bks,bqs->bkq", b, c)[:, None]         # S^T
    dwt = torch.einsum("bknp,bqnp->bnkq", x, gy)             # dW^T
    sl = st * lq
    wt = sl * dk[..., None]
    dm = dwt * sl
    ddt1 = dm.sum(-1)
    suffix = torch.flip(torch.cumsum(torch.flip(dm * dk[..., None], [-1]),
                                     -1), [-1])              # tile[k][j]
    r_straddle = (suffix * torch.triu(torch.ones(q, q), 1)).sum(-2)
    ddt = (ddt1 + rate[..., None] * r_straddle).transpose(1, 2)
    wb, wsm = _split(wt)
    dx = (torch.einsum("bnkq,bqnp->bknp", wsm, gy)
          + torch.einsum("bnkq,bqnp->bknp", wb, gy))
    dst = dwt * lq * dk[..., None]
    dsum = dst[:, 0]
    for h in range(1, n):
        dsum = dsum + dst[:, h]
    big, small = _split(dsum)
    db = (torch.einsum("bkq,bqs->bks", small, c)
          + torch.einsum("bkq,bqs->bks", big, c))
    dc = (torch.einsum("bkq,bks->bqs", small, b)
          + torch.einsum("bkq,bks->bqs", big, b))
    part = (rate * (dk * r_straddle).sum(-1)).reshape(a2.shape[0], -1, n)
    dlog = torch.zeros(a2.shape)
    for r in range(part.shape[1]):
        dlog = dlog + part[:, r]
    dlog = dlog if a_log.ndim == 2 else dlog[0]
    return (dx.bfloat16(), ddt, dlog.bfloat16(), db.bfloat16(),
            dc.bfloat16())


@pytest.mark.parametrize("groups", [0, 3])
def test_ssd_bwd_mma_form_arithmetic_matches_reference_bf16(groups):
    """The bf16 tensor-core backward's arithmetic (W^T and the head-summed
    dS in split bf16 parts on the tensor cores) at its one shape (S = 32,
    ds 16, p 32), against jax.vjp of the reference's ssd_ref (a_log shared)
    or the port's plain version (a_log per slot): each bf16 gradient within
    one bf16 ulp plus SSD_RTOL of its scale, ddt (f32) within SSD_RTOL."""
    xh, dt, a_log, bm, cm = _ssd_inputs(6, 32, 4, 32, 16, seed=40 + groups)
    if groups:
        a_log = _bf16(np.random.default_rng(groups).normal(
            size=(groups, 4)) * 0.5)
    dy = _bf16(np.random.default_rng(41).normal(size=xh.shape))
    got = _bwd_mma_emulation(xh, dt, a_log, bm, cm, dy)
    targs = _ssd_args(xh, dt, a_log, bm, cm, _t)
    if groups:
        want = ssd_ref.ssd_bwd_ref(*targs, _t(dy))
    else:
        _, vjp = jax.vjp(ref_ssd_ref.ssd_ref,
                         *_ssd_args(xh, dt, a_log, bm, cm, _j))
        want = vjp(_j(dy))
    for t, g, w in zip(targs, got, want):
        assert g.shape == t.shape
        if t.dtype == torch.bfloat16:
            assert bf16_excess(g, w if groups == 0 else
                               _j(w.float().numpy())) <= SSD_RTOL
        else:
            w = _f32(w)
            assert np.abs(g.numpy() - w).max() <= SSD_RTOL * np.abs(w).max()


def _fa_bwd_mma_emulation(q, k, v, do, lse, delta, causal, window,
                          parts=2):
    """bwd_short_mma_kernel's arithmetic for each (b, h) head in f32 from
    bf16 operands: S^T = K Q^T and dP^T = V dO^T from exact bf16 products;
    P^T = exp2(S^T * (scale log2 e) - lse_i log2 e) (0 where (i, j) is not
    visible) and dS^T = P^T (dP^T - delta_i); each split into ``parts`` bf16 parts (2:
    the rounding and the rounding of what it left out; 1: the rounding
    alone), each part times dO, Q or K (dV = P^T dO, dK = dS^T Q * scale,
    dQ = dS K * scale), small part first; each output rounded once to
    bf16."""
    q, k, v, do, lse, delta = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in (q, k, v, do, lse, delta))
    s, d = q.shape[2:]
    scale = d ** -0.5
    vis = fa_ref._mask(s, causal, window, "cpu").T          # [j][i]
    st = torch.einsum("bhjd,bhid->bhji", k, q)
    dpt = torch.einsum("bhjd,bhid->bhji", v, do)
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    pt = torch.where(vis, torch.exp2(st * scale2
                                     - (lse * LOG2E)[..., None, :]), 0.0)
    dst = pt * (dpt - delta[..., None, :])

    def times(x, eq, y):
        big, small = _split(x)
        terms = (small, big) if parts == 2 else (big,)
        out = torch.einsum(eq, terms[0], y)
        for term in terms[1:]:
            out = out + torch.einsum(eq, term, y)
        return out
    dv = times(pt, "bhji,bhid->bhjd", do)
    dk = times(dst, "bhji,bhid->bhjd", q) * scale
    dq = times(dst, "bhji,bhjd->bhid", k) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _fa_bwd_reference(case, seed):
    """Inputs, lse and delta, and the reference's (dq, dk, dv) from its
    Pallas kernels in interpret mode, all in bf16."""
    b, h, s, d, causal, window = case
    q, k, v, do = _fa_inputs(b, h, s, d, seed=seed)
    o_ref, lse_ref = ref_fa.flash_attention(
        _j(q), _j(k), _j(v), causal=causal, window=window, interpret=True,
        return_lse=True)
    lse_ref = np.array(lse_ref)
    delta = np.sum(_f32(o_ref) * do, axis=-1)
    want = ref_fa.flash_attention_bwd(
        _j(q), _j(k), _j(v), _j(do), lse_ref, delta, causal=causal,
        window=window, interpret=True)
    return (q, k, v, do, lse_ref, delta), want


# (B, H, S, D, causal, window): the FL round's shape at 4 rows, a ragged S
# with a window, and S = 32 non-causal
FA_MMA_SHAPES = [(4, 2, 32, 32, True, None), (4, 2, 20, 32, True, 8),
                 (4, 2, 32, 32, False, None)]


@pytest.mark.parametrize("case", FA_MMA_SHAPES)
def test_attention_bwd_mma_form_arithmetic_matches_reference_bf16(case):
    """The fused bf16 backward's arithmetic (P^T and dS^T in split bf16
    parts on the tensor cores) against the reference's flash_attention_bwd
    in interpret mode: dq, dk and dv each within one bf16 ulp plus FA_RTOL
    of its scale."""
    args, want = _fa_bwd_reference(case, seed=60 + case[2])
    got = _fa_bwd_mma_emulation(*args, *case[4:])
    for g, w in zip(got, want):
        assert bf16_excess(g, w) <= FA_RTOL


def _fa_fwd_mma_emulation(q, k, v, causal, window, parts=2):
    """fwd_short_mma_kernel's arithmetic for each (b, h) head in f32 from
    bf16 operands: S = Q K^T from exact bf16 products; the row max m of S
    over the visible keys; p = exp2(S c - m c) with c = scale log2 e, the
    product and the difference rounded once (the kernel's fma; here in
    f64, rounded to f32), 0 where (i, j) is not visible, and l = sum p, in
    f32; P V from ``parts`` bf16 parts of p (2: the rounding and the
    rounding of what it left out, small part first; 1: the rounding
    alone); o = P V * (1 / max(l, 1e-30)) rounded once to bf16, lse =
    m c ln 2 + log(max(l, 1e-30)) in f32."""
    q, k, v = (torch.from_numpy(np.asarray(a, np.float32)) for a in (q, k, v))
    s, d = q.shape[2:]
    vis = fa_ref._mask(s, causal, window, "cpu")             # [i][j]
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * LOG2E
    sc = torch.where(vis, torch.einsum("bhid,bhjd->bhij", q, k), -1e30)
    mc = sc.max(-1).values * c
    arg = (sc.double() * c.double() - mc.double()[..., None]).float()
    p = torch.where(vis, torch.exp2(arg), 0.0)
    denom = torch.clamp(p.sum(-1), min=1e-30)
    big, small = _split(p)
    terms = (small, big) if parts == 2 else (big,)
    acc = torch.einsum("bhij,bhjd->bhid", terms[0], v)
    for term in terms[1:]:
        acc = acc + torch.einsum("bhij,bhjd->bhid", term, v)
    o = (acc * (1.0 / denom)[..., None]).bfloat16()
    return o, mc * LN2 + torch.log(denom)


def _fa_fwd_reference(case, seed):
    """Inputs and the reference's (o, lse) from its Pallas forward in
    interpret mode, in bf16."""
    b, h, s, d, causal, window = case
    q, k, v, _ = _fa_inputs(b, h, s, d, seed=seed)
    o_ref, lse_ref = ref_fa.flash_attention(
        _j(q), _j(k), _j(v), causal=causal, window=window, interpret=True,
        return_lse=True)
    return (q, k, v), (o_ref, np.array(lse_ref))


# (B, H, S, D, causal, window): the FL round's shape at 4 rows, non-causal,
# a ragged S with a window, and a single row
FA_FWD_MMA_SHAPES = [(4, 2, 32, 32, True, None), (4, 2, 32, 32, False, None),
                     (4, 2, 20, 32, True, 8), (4, 2, 1, 32, True, None)]


@pytest.mark.parametrize("case", FA_FWD_MMA_SHAPES)
def test_attention_fwd_mma_form_arithmetic_matches_reference_bf16(case):
    """The bf16 tensor-core forward's arithmetic (exp2 of log2(e)-scaled
    scores, P in two bf16 parts) against the reference's flash_attention in
    interpret mode: o within one bf16 ulp plus FA_RTOL of its scale, lse
    within FA_RTOL of its scale."""
    args, (o_ref, lse_ref) = _fa_fwd_reference(case, seed=70 + case[2])
    o, lse = _fa_fwd_mma_emulation(*args, *case[4:])
    assert bf16_excess(o, o_ref) <= FA_RTOL
    assert np.abs(lse.numpy() - lse_ref).max() \
        <= FA_RTOL * np.abs(lse_ref).max()


def test_attention_fwd_mma_form_needs_both_parts():
    """P V from P's bf16 rounding alone lies beyond that limit at the
    round's shape: the error the second part removes is one this test can
    see."""
    case = FA_FWD_MMA_SHAPES[0]
    args, (o_ref, _) = _fa_fwd_reference(case, seed=70 + case[2])
    o, _ = _fa_fwd_mma_emulation(*args, *case[4:], parts=1)
    assert bf16_excess(o, o_ref) > 10 * FA_RTOL


def test_attention_bwd_mma_form_needs_both_parts():
    """One bf16 part of P^T and dS^T alone (the rounding, not its
    remainder) lies beyond that limit at the round's shape: the error the
    split removes is one this test can see."""
    case = FA_MMA_SHAPES[0]
    args, want = _fa_bwd_reference(case, seed=60 + case[2])
    got = _fa_bwd_mma_emulation(*args, *case[4:], parts=1)
    assert max(bf16_excess(g, w) for g, w in zip(got, want)) > 10 * FA_RTOL


# ---------------------------------------------------------------------------
# the launch plans' bf16 copy widths and the wrappers' dtype checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize,s,d,aligned,form", [
    (2, 32, 32, True, "mma"),      # the FL round's bf16 backward
    (2, 1, 32, True, "mma"),
    (2, 20, 32, True, "mma"),
    (4, 32, 32, True, "short"),    # f32 keeps the FMA short form
    (2, 32, 32, False, "short"),   # 2-byte copies: the FMA short form
    (2, 33, 32, True, "tiled"),    # past the short form's rows
    (2, 32, 64, True, "tiled"),
])
def test_attention_bwd_plan_mma_form(itemsize, s, d, aligned, form):
    """The fused tensor-core backward exactly where bf16, S <= 32, D = 32
    and 16-byte copies all hold; the forward takes its tensor-core form
    there too."""
    strides = (s * 2 * d, d, 2 * d) * 4
    plan = fa.attention_plan(570, 2, s, d, strides=strides, aligned=aligned,
                             itemsize=itemsize)
    assert plan.form == form
    if form == "mma":
        assert plan.vec == 16
        assert 1 <= plan.heads_per_block <= fa.MAX_HEADS_PER_BLOCK
    fwd = fa.attention_plan(570, 2, s, d, strides=strides, aligned=aligned,
                            itemsize=itemsize)
    assert fwd.form == form


@pytest.mark.parametrize("itemsize,s,d,strides,aligned,want", [
    # the FL round's bf16 forward, S = 1 and a ragged S: the tensor-core
    # form, 16-byte copies
    (2, 32, 32, (2048, 32, 64), True, ("mma", 16)),
    (2, 1, 32, (64, 32, 64), True, ("mma", 16)),
    (2, 20, 32, (1280, 32, 64), True, ("mma", 16)),
    # f32: the FMA short form
    (4, 32, 32, (2048, 32, 64), True, ("short", 16)),
    # bf16 with 4- or 2-byte copies: the FMA short form
    (2, 32, 32, (2050, 34, 66), True, ("short", 4)),
    (2, 32, 32, (2048, 32, 65), True, ("short", 2)),
    (2, 32, 32, (2048, 32, 64), False, ("short", 2)),
    # past the short form's rows or head dim: the tiled form
    (2, 33, 32, (2112, 32, 64), True, ("tiled", 16)),
    (2, 32, 64, (4096, 64, 128), True, ("tiled", 16)),
])
def test_attention_fwd_plan_mma_form(itemsize, s, d, strides, aligned, want):
    """The bf16 forward takes fwd_short_mma_kernel exactly where bf16,
    S <= 32, D = 32 and 16-byte copies all hold, with
    MMA_HEADS_PER_BLOCK heads a block."""
    plan = fa.attention_plan(570, 2, s, d, strides=strides * 4,
                             aligned=aligned, itemsize=itemsize)
    assert (plan.form, plan.vec) == want
    if plan.form == "mma":
        assert plan.heads_per_block == fa.MMA_HEADS_PER_BLOCK
        assert 1 <= plan.heads_per_block <= fa.MAX_HEADS_PER_BLOCK


def test_fl_path_bf16_forward_plan_is_the_mma_form():
    """The FL round's bf16 q, k, v and o, (B, H, S, D) views of (B, S, H,
    D) activations, take the tensor-core forward; the same views in f32
    keep the FMA short form."""
    views = [torch.empty(570, 32, 2, 32, dtype=torch.bfloat16)
             .transpose(1, 2) for _ in range(4)]
    assert fa.attention_fwd_plan(*views) == fa.AttentionPlan(
        "mma", fa.MMA_HEADS_PER_BLOCK, 16)
    assert fa.attention_fwd_plan(*(t.float() for t in views)).form == \
        "short"


def test_attention_pair_plan_keeps_the_fma_short_form():
    """The dq and dk/dv wrappers, where the fused kernel's plan applies,
    launch their FMA short forms (off the op's path, held on the card)."""
    views = [torch.empty(570, 32, 2, 32, dtype=torch.bfloat16)
             .transpose(1, 2) for _ in range(5)]
    assert fa.attention_bwd_plan(*views).form == "mma"
    plan = fa._pair_plan(*views)
    assert (plan.form, plan.heads_per_block, plan.vec) == (
        "short", fa.HEADS_PER_BLOCK, 16)


@pytest.mark.parametrize("itemsize,strides,aligned,vec", [
    # the FL path: (B, S, H, D) = (570, 32, 2, 32) activations, rows of 64
    (2, (2048, 32, 64), True, 16),
    (4, (2048, 32, 64), True, 16),
    (2, (2050, 34, 66), True, 4),      # even strides, not multiples of 8
    (4, (2050, 34, 66), True, 4),
    (2, (2048, 32, 65), True, 2),      # an odd row stride: one bf16 a copy
    (2, (2048, 32, 64), False, 2),     # a pointer off 16 bytes
    (4, (2048, 32, 64), False, 4),
])
def test_attention_plan_bf16_copy_width(itemsize, strides, aligned, vec):
    """16-byte copies of bf16 need every stride a multiple of 8 elements
    and every pointer 16-byte aligned; f32 as before, multiples of 4. The
    backward at the short form's shape takes the fused tensor-core form in
    bf16 with 16-byte copies, the FMA short form otherwise."""
    plan = fa.attention_plan(570, 2, 32, 32, strides=strides * 4,
                             aligned=aligned, itemsize=itemsize)
    form = "mma" if (itemsize, vec) == (2, 16) else "short"
    assert (plan.form, plan.vec) == (form, vec)
    fwd = fa.attention_plan(2, 2, 64, 64, strides=strides * 4,
                            aligned=aligned, itemsize=itemsize)
    assert (fwd.form, fwd.vec) == ("tiled", vec)
    # the tiled backward stages by the same rule
    bwd = fa.attention_plan(2, 2, 64, 64, strides=strides * 4,
                            aligned=aligned, itemsize=itemsize)
    assert (bwd.form, bwd.vec) == ("tiled", vec)


def test_fl_path_bf16_plans_take_16_byte_copies():
    """The FL round's bf16 operands: q, k, v and o as (B, H, S, D) views of
    (B, S, H, D) activations (rows of 64 elements), and the SSD's x, b and
    c as split views of one (rows, 32, 160) conv output (offsets 0, 128
    and 144)."""
    views = [torch.empty(570, 32, 2, 32, dtype=torch.bfloat16)
             .transpose(1, 2) for _ in range(4)]
    assert fa.attention_fwd_plan(*views).vec == 16
    assert fa.attention_bwd_plan(*views).vec == 16
    conv = torch.empty(570, 32, 160, dtype=torch.bfloat16)
    x = conv[..., :128].reshape(570, 32, 4, 32)
    bm, cm = conv[..., 128:144], conv[..., 144:]
    plan = ssd.ssd_plan(570, 32, 4, 32, 16, 32, sms=132,
                        x_strides=x.stride()[:3],
                        bc_strides=bm.stride()[:2] + cm.stride()[:2],
                        x_aligned=x.data_ptr() % 16 == 0,
                        bc_aligned=(bm.data_ptr() % 16 == 0
                                    and cm.data_ptr() % 16 == 0),
                        itemsize=2)
    assert (plan.vec_x, plan.vec_bc) == (16, 16)


@pytest.mark.parametrize("itemsize,step,ds,vec", [
    (2, 160, 16, (16, 16)),
    (2, 162, 16, (4, 4)),       # steps of 162 elements: pairs only
    (2, 161, 16, (2, 2)),       # an odd step: one bf16 at a time
    (2, 160, 12, (16, 4)),      # b and c rows of 12: not a multiple of 8
    (4, 160, 12, (16, 16)),     # ... which is a multiple of 4 floats
    (4, 162, 16, (4, 4)),
])
def test_ssd_plan_bf16_copy_width(itemsize, step, ds, vec):
    """x's, and b's and c's, copy widths count in elements of their dtype:
    16 bytes of bf16 need the row width and every stride a multiple of 8."""
    plan = ssd.ssd_plan(570, 32, 4, 32, ds, 32, sms=132,
                        x_strides=(32 * step, step, 32),
                        bc_strides=(32 * step, step, 32 * step, step),
                        x_aligned=True, bc_aligned=True, itemsize=itemsize)
    assert (plan.vec_x, plan.vec_bc) == vec


@pytest.mark.parametrize("rows,seq,p,ds,aligned,want", [
    # the FL path's round and statistics pass, and four chunks of it: the
    # tensor-core form, a warp per head
    (570, 32, 32, 16, True, ("mma", 4, 4)),
    (1140, 32, 32, 16, True, ("mma", 4, 4)),
    (264, 128, 32, 16, True, ("mma", 4, 4)),
    # another shape, or 16-byte copies impossible: the FMA form
    (570, 32, 64, 16, True, ("fma", 4, 4)),
    (570, 32, 32, 32, True, ("fma", 4, 4)),
    (570, 32, 32, 16, False, ("fma", 4, 4)),
    # few rows over whole chunks of 64: the chunk-parallel tensor-core
    # form, a block of 16 warps per (head, chunk, row)
    (2, 128, 32, 16, True, ("tc", 1, 16)),
    # few rows over chunks that are not whole chunks of 64: the
    # chunk-parallel FMA form
    (2, 96, 32, 16, True, ("fma", 1, 1)),
])
def test_ssd_plan_bf16_form(rows, seq, p, ds, aligned, want):
    """bf16 at chunk 32, ds 16, p 32 with 16-byte copies, walked in order,
    runs ssd_mma_kernel; few rows over several whole chunks of 64 the
    tensor-core chunk-parallel form, in f32 too; everything else, and f32
    otherwise, the FMA form."""
    width = 4 * p + 2 * ds
    kw = dict(sms=132, x_strides=(seq * width, width, p),
              bc_strides=(seq * width, width) * 2, x_aligned=aligned,
              bc_aligned=aligned)
    plan = ssd.ssd_plan(rows, seq, 4, p, ds, 32, itemsize=2, **kw)
    assert (plan.form, plan.heads, plan.warps) == want
    assert ssd.ssd_plan(rows, seq, 4, p, ds, 32, itemsize=4,
                        **kw).form == ("tc" if want[0] == "tc" else "fma")


@pytest.mark.parametrize("rows,seq,p,ds,aligned,want", [
    # the FL path's round and statistics pass: one chunk at (32, 16, 32),
    # the tensor-core form, a warp per head, a ring of two rows
    (570, 32, 32, 16, True, ("mma", 4, 4, 2)),
    (1140, 32, 32, 16, True, ("mma", 4, 4, 2)),
    # several chunks, a ragged one, another shape, or 16-byte copies
    # impossible: the chunked form (bf16 loads widened, f32 arithmetic)
    (264, 128, 32, 16, True, ("chunk", 4, 4, 0)),
    (570, 33, 32, 16, True, ("chunk", 4, 4, 0)),
    (570, 32, 64, 16, True, ("chunk", 4, 4, 0)),
    (570, 32, 32, 16, False, ("chunk", 4, 4, 0)),
    # few rows of one chunk: still the tensor-core form, a block a row;
    # few rows over several chunks of 64: the chunk-parallel tensor-core
    # form, a block of 16 warps per (head, chunk, row)
    (2, 32, 32, 16, True, ("mma", 4, 4, 2)),
    (2, 128, 32, 16, True, ("tc", 1, 16, 0)),
])
def test_ssd_bwd_plan_bf16_form(rows, seq, p, ds, aligned, want):
    """bf16 at one chunk of (32, 16, 32) with 16-byte copies of x, dy, b and
    c runs ssd_bwd_mma_kernel (f32 there ssd_bwd_tf32_kernel); several
    chunks of 64 where the rows cannot fill the card the chunk-parallel
    tensor-core form; everything else the chunked form."""
    width = 4 * p + 2 * ds
    kw = dict(sms=132, x_strides=(seq * width, width, p) * 2,
              bc_strides=(seq * width, width) * 2, x_aligned=aligned,
              bc_aligned=aligned)
    plan = ssd.ssd_bwd_plan(rows, seq, 4, p, ds, itemsize=2, **kw)
    assert (plan.form, plan.heads, plan.warps, plan.ring) == want
    # f32 takes its own tensor-core form (3xTF32) where bf16 takes mma
    assert ssd.ssd_bwd_plan(rows, seq, 4, p, ds, itemsize=4, **kw).form == (
        "tf32" if plan.form == "mma" else plan.form)


def test_attention_operands_refuse_a_mix_of_dtypes():
    """q in bf16 with k in f32 raises TypeError (no cast), as do bf16 lse or
    delta; one dtype throughout passes."""
    q = torch.zeros(2, 2, 32, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share one dtype"):
        fa._operands(("q", "k", "v"), q, q.float(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._operands(("q", "k", "v"), q.half(), q.half(), q.half())
    assert all(t.dtype == torch.bfloat16
               for t in fa._operands(("q", "k", "v"), q, q, q))
    with pytest.raises(TypeError, match="float32"):
        fa._rows(torch.zeros(2, 2, 32, dtype=torch.bfloat16), 2, 2, 32)


def test_ssd_operands_refuse_a_mix_of_dtypes():
    """b in f32 beside bf16 xh raises TypeError; dt in f32 beside bf16 xh
    is the contract and passes."""
    xh = torch.zeros(2, 32, 4, 32, dtype=torch.bfloat16)
    b32 = torch.zeros(2, 32, 16)
    with pytest.raises(TypeError):
        ssd._operand(b32, 3, "b_ssm", xh.dtype)
    assert ssd._operand(b32.bfloat16(), 3, "b_ssm", xh.dtype).dtype \
        == torch.bfloat16
    dt = torch.zeros(2, 32, 4)
    assert ssd._operand(dt, 3, "dt").dtype == torch.float32
    with pytest.raises(TypeError):
        ssd._operand(dt.bfloat16(), 3, "dt")


# ---------------------------------------------------------------------------
# two bf16 rounds of the token models against the reference
# ---------------------------------------------------------------------------

SIM = dict(max_dataset=400, k_iters=2, sigma_samples=2, rounds=2,
           eval_every=2, dtype="bf16")


@pytest.mark.parametrize("model", ["transformer", "ssm"])
def test_bf16_token_simulation_matches_reference(model):
    """Two rounds of ``Simulation(Scenario(model=..., dtype="bf16"))`` from
    the reference's weights and statistics: identical trained gateways,
    selections, l_n, queues and delays; losses and params within the
    reference's absolute bf16 contract (measured: transformer losses
    1.1e-3, params 5.5e-5; SSM losses 2.7e-3, params 1.1e-3, both largest
    in the embedding), with f32 masters."""
    sc = dict(SIM, model=model)
    r = ref_sim.Simulation(ref_sim.Scenario(**sc))
    p0 = [jax.tree.map(np.asarray, p) for p in r.params]
    rng0 = r.rng.bit_generator.state
    want = list(r.rounds())
    s = sim.Simulation(sim.Scenario(**sc), r.stats, device="cpu",
                       init_params=p0)
    s.rng.bit_generator.state = rng0
    got = list(s.rounds())
    for g, w in zip(got, want):
        assert g.trained == w.trained
        np.testing.assert_array_equal(g.selected, w.selected)
        np.testing.assert_array_equal(g.l_n, w.l_n)
        np.testing.assert_array_equal(g.queues, w.queues)
        assert g.delay == w.delay
        np.testing.assert_allclose(g.losses, w.losses, rtol=0,
                                   atol=LOSS_ATOL)
    assert any(g.trained for g in got)
    assert all(v.dtype == torch.float32 for p in s.params
               for v in p.values())
    got_p = params_to_numpy(s.plan, s.params)
    assert len(got_p) == len(r.params)
    for g, w in zip(got_p, r.params):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL)
