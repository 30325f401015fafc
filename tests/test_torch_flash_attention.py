"""The port's flash attention (plain versions, wrappers, autograd op)
held against ``repro.kernels.flash_attention`` on the same numpy inputs.

These run on the CPU, where every wrapper takes its plain PyTorch version;
the reference runs its Pallas kernels in interpret mode, at shapes of
several 64-row tiles so the online softmax crosses tiles and the causal and
window masks skip and cut tiles. The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.

Tolerance: 2e-5 absolute and relative, the reference's own f32 attention
tolerance (``TOL[f32]`` in ``tests/test_kernels.py``): the online softmax
sums over k-tiles in another order than the one-shot softmax.
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

from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK = 64

# (B, H, S, D, causal, window): causal over 4 tiles, a window that cuts
# tiles, non-causal, the FL path's single half tile (S = 32, D = 32), and
# stablelm-3b's head dim of 80, causal over 4 tiles and with a window
CASES = [(1, 2, 256, 32, True, None), (1, 2, 256, 64, True, 100),
         (2, 1, 128, 32, False, None), (3, 2, 32, 32, True, None),
         (1, 2, 256, 80, True, None), (2, 1, 128, 80, True, 48)]


def _qkv_do(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(4)]


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("case", CASES)
def test_forward_and_backward_match_reference_kernels(case):
    """o and lse against the Pallas forward, dq/dk/dv against the Pallas
    backward pair, from the same residuals."""
    b, h, s, d, causal, window = case
    q, k, v, do = _qkv_do(b, h, s, d, seed=s + d)
    blk = min(BLOCK, s)
    o_ref, lse_ref = ref_kernel.flash_attention(
        q, k, v, causal=causal, window=window, block_q=blk, block_k=blk,
        interpret=True, return_lse=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = kernel.flash_attention(tq, tk, tv, causal, window)
    np.testing.assert_allclose(_np(o), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_ref), **TOL)

    delta = np.sum(do * np.asarray(o_ref), axis=-1)
    dq_ref, dk_ref, dv_ref = ref_kernel.flash_attention_bwd(
        q, k, v, do, lse_ref, delta, causal=causal, window=window,
        block_q=blk, block_k=blk, interpret=True)
    args = (tq, tk, tv, tdo, torch.from_numpy(np.array(lse_ref)),
            torch.from_numpy(delta))
    dq = kernel.flash_attention_bwd_dq(*args, causal, window)
    dk, dv = kernel.flash_attention_bwd_dkdv(*args, causal, window)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_gqa_gradients_match_reference(causal, window):
    """Forward and q/k/v gradients through the port's gqa_attention (KV
    heads repeated, dk/dv summed per group) against jax.grad through the
    reference's, which runs its Pallas kernels in interpret mode."""
    rng = np.random.default_rng(7)
    b, s, h, kv, hd = 1, 128, 4, 2, 32
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(b, s, h, hd)).astype(np.float32)

    def f(q, k, v):
        return ref_ops.gqa_attention(q, k, v, causal=causal, window=window,
                                     block_q=BLOCK, block_k=BLOCK,
                                     impl="interpret")
    o_ref, vjp = jax.vjp(f, q, k, v)
    grads_ref = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ops.gqa_attention(tq, tk, tv, causal=causal, window=window)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(o), np.asarray(o_ref), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_plain_multi_block_attention_matches_reference():
    """layers.causal_attention (the plain oracle, query blocks of 64) and
    the op agree with the reference's causal_attention, GQA and window."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 128, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 128, 2, 32)).astype(np.float32)
            for _ in range(2))
    for window in (None, 40):
        want = np.asarray(ref_layers.causal_attention(
            q, k, v, block_q=64, window=window))
        got = layers.causal_attention(*map(torch.from_numpy, (q, k, v)),
                                      block_q=64, window=window)
        np.testing.assert_allclose(_np(got), want, **TOL)
        op = ops.gqa_attention(*map(torch.from_numpy, (q, k, v)),
                               window=window)
        np.testing.assert_allclose(_np(op), want, **TOL)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain versions and launch nothing; a device
    that is neither CPU nor CUDA raises rather than falling back."""
    before_l, before_c = dict(kernel.LAUNCHES), dict(ref.CALLS)
    q = torch.ones(1, 1, 4, 32)
    o, lse = kernel.flash_attention(q, q, q)
    kernel.flash_attention_bwd_dkdv(q, q, q, q, lse, lse)
    assert kernel.LAUNCHES == before_l
    assert ref.CALLS["flash_attention"] == before_c["flash_attention"] + 1
    assert ref.CALLS["flash_attention_bwd_dkdv"] == \
        before_c["flash_attention_bwd_dkdv"] + 1
    with pytest.raises(ValueError):
        kernel.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_wrapper_is_the_plain_version_on_cpu(dtype):
    """flash_attention_bwd on CPU tensors is attention_ref_bwd, bit for bit,
    and launches nothing."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _qkv_do(3, 2, 20, 32, seed=7))
    o, lse = kernel.flash_attention(q, k, v, True, 8)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    before_l, before_k = dict(kernel.LAUNCHES), dict(kernel.KERNEL_LAUNCHES)
    got = kernel.flash_attention_bwd(q, k, v, do, lse, delta, True, 8)
    want = ref.attention_ref_bwd(q, k, v, do, lse, delta, causal=True,
                                 window=8)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    assert kernel.LAUNCHES == before_l
    assert kernel.KERNEL_LAUNCHES == before_k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_forward_on_cpu_is_the_plain_version(dtype):
    """_FlashAttention.forward on CPU tensors (bf16 at the tensor-core
    form's shape too) is attention_ref_lse's o, bit for bit, through one
    plain call, and launches nothing."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv_do(3, 2, 32, 32, seed=9)[:3])
    before_l, before_k = dict(kernel.LAUNCHES), dict(kernel.KERNEL_LAUNCHES)
    before_c = ref.CALLS["flash_attention"]
    o = ops.attention(q, k, v, causal=True, window=None)
    assert ref.CALLS["flash_attention"] == before_c + 1
    assert kernel.LAUNCHES == before_l
    assert kernel.KERNEL_LAUNCHES == before_k
    want, _ = ref.attention_ref_lse(q, k, v, causal=True, window=None)
    assert o.dtype == dtype and torch.equal(o, want)


def test_op_backward_goes_through_the_fused_wrapper(monkeypatch):
    """_FlashAttention.backward calls kernel.flash_attention_bwd once per
    backward, and its gradients are that wrapper's."""
    calls = []
    fused = kernel.flash_attention_bwd

    def spy(*args):
        calls.append(args[-2:])
        return fused(*args)
    monkeypatch.setattr(kernel, "flash_attention_bwd", spy)
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do(2, 2, 32, 32, 8))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = ops.attention(qg, kg, vg, causal=True, window=None)
    o.backward(do)
    assert calls == [(True, None)]
    o_ref, lse = kernel.flash_attention(q, k, v, True, None)
    delta = torch.sum(do * o_ref, dim=-1)
    want = fused(q, k, v, do, lse, delta, True, None)
    for g, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the backward's launch plan and the short form's order of work, which the
# card cannot show here
# ---------------------------------------------------------------------------


def _chip_smoke_fa_cases():
    """chip_smoke.py's attention cases (it imports torch and the port
    only), as label -> (B, H, S, D, causal, window)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {c[0]: c[1:] for c in mod.FA_CASES}


def _plan_of(t):
    """The plan for (B, H, S, D) views ``t`` as the wrapper computes it
    (fresh CPU allocations are 16-byte aligned too)."""
    return kernel.attention_bwd_plan(*t)


def _bshd_views(b, h, s, d, n=5):
    """``n`` (B, H, S, D) views of (B, S, H, D) activations, as the model
    hands them to the kernels."""
    return [torch.empty(b, s, h, d).transpose(1, 2) for _ in range(n)]


@pytest.mark.parametrize("label,want", [
    # the FL path: a warp and a block per head, 16-byte copies of the
    # (B, S, H, D) activations' 128-byte rows
    ("round", ("short", 1, 16)),
    ("stats", ("short", 1, 16)),
    ("sigma M=1", ("short", 1, 16)),
    # a ragged S and a non-causal mask are the short form too
    ("S=20 window 8", ("short", 1, 16)),
    ("full 32", ("short", 1, 16)),
    # S > 32 or D != 32: the tensor-core tiles, with 16-byte copies of the
    # aligned views
    ("causal 1024", ("tiled", 1, 16)),
    ("window 256", ("tiled", 1, 16)),
    ("full 256", ("tiled", 1, 16)),
    ("tiled S=100 D=32", ("tiled", 1, 16)),
    # the LM step's attention (granite-moe-1b-a400m at seq 4096)
    ("lm 4096", ("tiled", 1, 16)),
    # the serve path's encoder (seamless-m4t-medium, 16 frames, D = 64)
    ("serve encoder", ("tiled", 1, 16)),
    # stablelm-3b's step: 32 heads of 80 at seq 4096, 160-byte bf16 and
    # 320-byte f32 rows
    ("lm stablelm 4096", ("tiled", 1, 16)),
])
def test_attention_plan_for_chip_smoke_cases(label, want):
    b, h, s, d, _, _ = _chip_smoke_fa_cases()[label]
    plan = _plan_of(_bshd_views(b, h, s, d))
    assert (plan.form, plan.heads_per_block, plan.vec) == want
    assert plan.heads_per_block <= kernel.MAX_HEADS_PER_BLOCK


@pytest.mark.parametrize("case", CASES)
def test_attention_plan_for_test_shapes(case):
    """The short form exactly where S <= 32 and D = 32."""
    b, h, s, d, _, _ = case
    plan = _plan_of(_bshd_views(b, h, s, d))
    assert plan.form == ("short" if s <= 32 and d == 32 else "tiled")


@pytest.mark.parametrize("s,d,form", [(1, 32, "short"), (32, 32, "short"),
                                      (33, 32, "tiled"), (32, 64, "tiled"),
                                      (16, 128, "tiled"), (16, 80, "tiled"),
                                      (4096, 80, "tiled")])
def test_attention_plan_short_form_bounds(s, d, form):
    assert kernel.attention_plan(570, 2, s, d).form == form


def test_attention_plan_copy_width_is_16_bytes_only_where_aligned():
    """16-byte staging copies need every pointer and every (b, h, s)
    stride 16-byte aligned; an odd row stride from a sliced view, or an
    unaligned pointer, takes 4-byte copies."""
    b, h, s, d = 570, 2, 32, 32
    views = _bshd_views(b, h, s, d)
    assert _plan_of(views).vec == 16
    # (B, S, H*D + 1) activations sliced to H*D columns: row stride 65
    sliced = torch.empty(b, s, h * d + 1)[..., :h * d].unflatten(
        -1, (h, d)).transpose(1, 2)
    assert sliced.stride()[2] == h * d + 1
    plan = _plan_of([sliced] + views[1:])
    assert (plan.form, plan.vec) == ("short", 4)
    strides = [st for x in views for st in x.stride()[:3]]
    unaligned = kernel.attention_plan(b, h, s, d, strides=strides,
                                      aligned=False)
    assert (unaligned.form, unaligned.vec) == ("short", 4)


def _visible(q, k, causal, window):
    vis = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                     dtype=torch.bool)
    if causal:
        vis &= k <= q
    if window is not None:
        vis &= k > q - window
    return vis


def _dot4(a, x):
    """The kernel's ``dot2``: four partial sums over d = m (mod 4), each in
    order of d, summed pairwise at the end."""
    prod = (a * x).unflatten(-1, (a.shape[-1] // 4, 4))
    parts = torch.zeros(prod.shape[:-2] + (4,))
    for c in range(prod.shape[-2]):
        parts = parts + prod[..., c, :]
    return (parts[..., 0] + parts[..., 1]) + (parts[..., 2] + parts[..., 3])


def _lanes(x, s):
    """A warp's 32 lanes of row registers: rows past S are zero (the
    kernel fills lanes past the sequence end with zeros)."""
    out = torch.zeros(x.shape[:2] + (32,) + x.shape[3:])
    out[:, :, :s] = x[:, :, :s]
    return out


def _short_dq(q, k, v, do, lse, delta, s, causal, window):
    """dq in the short form's order of work on 32-row operands of which
    rows [0, s) are real: lane i holds q_i and do_i, walks keys j = 0 ..
    s-1 in order (rows past s are never read), and a masked pair adds
    exactly 0."""
    scale = q.shape[-1] ** -0.5
    qr, dor = _lanes(q, s), _lanes(do, s)
    lse_i, delta_i = _lanes(lse, s), _lanes(delta, s)
    lane = torch.arange(32)
    acc = torch.zeros_like(qr)
    for j in range(s):
        kj, vj = k[:, :, j:j + 1], v[:, :, j:j + 1]
        sc, dp = _dot4(qr, kj), _dot4(dor, vj)
        vis = _visible(lane, torch.tensor(j), causal, window) & (lane < s)
        p = torch.where(vis, torch.exp(sc * scale - lse_i), 0.0)
        acc = acc + (p * (dp - delta_i))[..., None] * kj
    return (acc * scale)[:, :, :s]


def _short_dkdv(q, k, v, do, lse, delta, s, causal, window):
    """dk, dv in the short form's order of work: lane j holds k_j and v_j,
    walks queries i = 0 .. s-1 in order with lse_i and delta_i taken from
    lane i."""
    scale = q.shape[-1] ** -0.5
    kr, vr = _lanes(k, s), _lanes(v, s)
    lane = torch.arange(32)
    dk, dv = torch.zeros_like(kr), torch.zeros_like(vr)
    for i in range(s):
        qi, doi = q[:, :, i:i + 1], do[:, :, i:i + 1]
        sc, dp = _dot4(kr, qi), _dot4(vr, doi)
        vis = _visible(torch.tensor(i), lane, causal, window) & (lane < s)
        p = torch.where(vis, torch.exp(sc * scale - lse[:, :, i:i + 1]), 0.0)
        ds = p * (dp - delta[:, :, i:i + 1])
        dv = dv + p[..., None] * doi
        dk = dk + ds[..., None] * qi
    return (dk * scale)[:, :, :s], dv[:, :, :s]


@pytest.mark.parametrize("s,causal,window", [(32, True, None), (20, True, 8),
                                             (32, False, None)])
def test_short_form_order_of_work_matches_reference_pallas(s, causal,
                                                           window):
    """A plain-torch emulation of the short form (lane per row, keys or
    queries in order, masked pairs exactly 0, the loop stopping at S)
    against the reference's flash_attention_bwd in interpret mode. The
    rows past S of the emulation's 32-row operands are NaN: they would
    poison every output if any were read."""
    b, h, d = 3, 2, 32
    q, k, v, do = _qkv_do(b, h, s, d, seed=100 + s)
    o_ref, lse_ref = ref_kernel.flash_attention(
        q, k, v, causal=causal, window=window, block_q=s, block_k=s,
        interpret=True, return_lse=True)
    delta = np.sum(do * np.asarray(o_ref), axis=-1)
    dq_ref, dk_ref, dv_ref = ref_kernel.flash_attention_bwd(
        q, k, v, do, lse_ref, delta, causal=causal, window=window,
        block_q=s, block_k=s, interpret=True)

    def pad(a):
        out = np.full(a.shape[:2] + (32,) + a.shape[3:], np.nan, np.float32)
        out[:, :, :s] = a
        return torch.from_numpy(out)
    args = [pad(a) for a in (q, k, v, do, np.asarray(lse_ref), delta)]
    dq = _short_dq(*args, s, causal, window)
    dk, dv = _short_dkdv(*args, s, causal, window)
    assert kernel.attention_plan(b, h, s, d).form == "short"
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _launchable(plan, s, d, forward) -> bool:
    """The plan is one the C entries take (csrc short_plan_ok and the
    tiled entries' check of their copy width): the short form within S <=
    32, D = 32, 1-8 heads per block and 4- or 16-byte copies; the forward's
    bf16 tensor-core form there with 16-byte copies; the tiled forms,
    forward and backward, with 4- or 16-byte copies."""
    if plan.form in ("short", "mma"):
        return (s <= kernel.SHORT_MAX_SEQ and d == kernel.SHORT_HEAD_DIM
                and 1 <= plan.heads_per_block <= kernel.MAX_HEADS_PER_BLOCK
                and plan.vec in ((16,) if plan.form == "mma" else (4, 16))
                and (forward or plan.form == "short"))
    return plan.form == "tiled" and plan.vec in (4, 16)


def test_variant_tool_plans_are_launchable():
    """Every plan variant of tools/flash_attention_variants.py, forward and
    backward, is one the C entries take, and each forward variant runs the
    form it is meant to."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "flash_attention_variants.py")
    spec = importlib.util.spec_from_file_location("_fa_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = _chip_smoke_fa_cases()
    for label in mod.CASES:
        b, h, s, d, _, _ = cases[label]
        base = _plan_of(_bshd_views(b, h, s, d))
        assert base.form == "short"
        for name, change in mod.PLANS.items():
            plan = base if change is None else change(base)
            assert _launchable(plan, s, d, forward=False), name
    for label in mod.SHORT_CASES + mod.TILED_CASES:
        b, h, s, d, _, _ = cases[label]
        base = kernel.attention_fwd_plan(*_bshd_views(b, h, s, d, n=4))
        short = label in mod.SHORT_CASES
        assert base.form == ("short" if short else "tiled"), label
        plans = mod.FWD_PLANS if short else mod.FWD_TILED_PLANS
        for name, change in plans.items():
            plan = base if change is None else change(base, b, h, s)
            assert _launchable(plan, s, d, forward=True), (label, name)
            assert plan.form == ("tiled" if name == "tiled_form"
                                 else base.form), (label, name)


def test_variant_tool_fwd_mma_plans_are_launchable():
    """Every plan variant of the bf16 tensor-core forward in
    tools/flash_attention_variants.py --fwd is one the C entry takes, at
    each of chip_smoke.py's five aligned cases of S <= 32, D = 32, whose
    bf16 forward plan is "mma", and stays in that form."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "flash_attention_variants.py")
    spec = importlib.util.spec_from_file_location("_fa_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mma = 0
    for label, (b, h, s, d, _, _) in _chip_smoke_fa_cases().items():
        if label in mod.chip_smoke.FA_UNALIGNED:
            continue   # views off 16-byte alignment: the FMA short form
        views = [torch.empty(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
                 for _ in range(4)]
        base = kernel.attention_fwd_plan(*views)
        if base.form != "mma":
            continue
        mma += 1
        for name, change in mod.FWD_MMA_PLANS.items():
            plan = change(base)
            assert plan.form == "mma", (label, name)
            assert _launchable(plan, s, d, forward=True), (label, name)
    assert mma == 5


# ---------------------------------------------------------------------------
# the forward's launch plan, its short form's order of work and its
# tensor-core form's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label,want", [
    # the FL path: the short form, a warp per head, 16-byte copies
    ("round", ("short", 1, 16)),
    ("stats", ("short", 1, 16)),
    ("sigma M=1", ("short", 1, 16)),
    ("S=20 window 8", ("short", 1, 16)),
    ("full 32", ("short", 1, 16)),
    # the tensor-core tiles, with 16-byte copies of the aligned views
    ("causal 1024", ("tiled", 1, 16)),
    ("window 256", ("tiled", 1, 16)),
    ("full 256", ("tiled", 1, 16)),
    ("tiled S=100 D=32", ("tiled", 1, 16)),
    # the serve path's encoder: S = 16 < one 64-row tile, D = 64
    ("serve encoder", ("tiled", 1, 16)),
])
def test_forward_plan_for_chip_smoke_cases(label, want):
    b, h, s, d, _, _ = _chip_smoke_fa_cases()[label]
    plan = kernel.attention_fwd_plan(*_bshd_views(b, h, s, d, n=4))
    assert (plan.form, plan.heads_per_block, plan.vec) == want


@pytest.mark.parametrize("s,d,form", [(1, 32, "short"), (32, 32, "short"),
                                      (33, 32, "tiled"), (32, 64, "tiled"),
                                      (16, 128, "tiled")])
def test_forward_plan_short_form_bounds(s, d, form):
    plan = kernel.attention_plan(570, 2, s, d)
    assert plan.form == form
    assert _launchable(plan, s, d, forward=True)


def test_forward_plan_copy_width_is_16_bytes_only_where_aligned():
    """The forward's copies follow the backward's rule, in both forms: an
    odd row stride from a sliced view, or an unaligned pointer, takes
    4-byte copies."""
    for s, d, form in ((32, 32, "short"), (96, 64, "tiled")):
        b, h = 12, 2
        views = _bshd_views(b, h, s, d, n=4)
        assert kernel.attention_fwd_plan(*views).vec == 16
        sliced = torch.empty(b, s, h * d + 1)[..., :h * d].unflatten(
            -1, (h, d)).transpose(1, 2)
        plan = kernel.attention_fwd_plan(sliced, *views[1:])
        assert (plan.form, plan.vec) == (form, 4)
        strides = [st for x in views for st in x.stride()[:3]]
        unaligned = kernel.attention_plan(b, h, s, d, strides=strides,
                                          aligned=False)
        assert (unaligned.form, unaligned.vec) == (form, 4)


def _short_fwd(q, k, v, s, causal, window):
    """o, lse in the forward short form's order of work on 32-row operands
    of which rows [0, s) are real: lane i holds q_i; pass 1 walks keys j =
    0 .. s-1 in order, s_ij = (q_i . k_j) * scale and m_i = the max over
    the visible j; pass 2 walks them again: p = exp(s_ij - m_i) (exactly 0
    where masked), l_i += p, acc_i += p * v_j; o_i = acc_i * (1 /
    max(l_i, 1e-30)), lse_i = m_i + log(max(l_i, 1e-30)). Rows past s are
    never read."""
    scale = q.shape[-1] ** -0.5
    qr = _lanes(q, s)
    lane = torch.arange(32)
    m = torch.full(qr.shape[:3], -1e30)
    scores = []
    for j in range(s):
        sc = _dot4(qr, k[:, :, j:j + 1]) * scale
        vis = _visible(lane, torch.tensor(j), causal, window) & (lane < s)
        m = torch.where(vis, torch.maximum(m, sc), m)
        scores.append(sc)
    l_sum, acc = torch.zeros_like(m), torch.zeros_like(qr)
    for j in range(s):
        vis = _visible(lane, torch.tensor(j), causal, window) & (lane < s)
        p = torch.where(vis, torch.exp(scores[j] - m), 0.0)
        l_sum = l_sum + p
        acc = acc + p[..., None] * v[:, :, j:j + 1]
    denom = torch.clamp(l_sum, min=1e-30)
    o = acc * (1.0 / denom)[..., None]
    return o[:, :, :s], (m + torch.log(denom))[:, :, :s]


@pytest.mark.parametrize("s,causal,window", [(32, True, None), (20, True, 8),
                                             (32, False, None)])
def test_forward_short_form_order_of_work_matches_reference_pallas(
        s, causal, window):
    """A plain-torch emulation of the forward's short form (a lane per row,
    a scores pass and an accumulation pass over the keys in order, masked
    pairs exactly 0, the loops stopping at S) against the reference's
    flash_attention in interpret mode, o and lse. The rows past S of the
    emulation's 32-row operands are NaN: they would poison every output if
    any were read."""
    b, h, d = 3, 2, 32
    q, k, v, _ = _qkv_do(b, h, s, d, seed=200 + s)
    o_ref, lse_ref = ref_kernel.flash_attention(
        q, k, v, causal=causal, window=window, block_q=s, block_k=s,
        interpret=True, return_lse=True)

    def pad(a):
        out = np.full(a.shape[:2] + (32,) + a.shape[3:], np.nan, np.float32)
        out[:, :, :s] = a
        return torch.from_numpy(out)
    o, lse = _short_fwd(pad(q), pad(k), pad(v), s, causal, window)
    assert kernel.attention_plan(b, h, s, d).form == "short"
    np.testing.assert_allclose(_np(o), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_ref), **TOL)


def _fused_linear_tests():
    """tests/test_torch_fused_linear.py, for its 3xTF32 helpers
    (``_rna_tf32``, ``_tensor_core_product``)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().with_name(
        "test_torch_fused_linear.py")
    spec = importlib.util.spec_from_file_location("_fl_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tc_keys() -> int:
    """The tiled forward's keys per tile (csrc kTcKeys)."""
    import re
    found = re.search(r"constexpr int kTcKeys = (\d+);",
                      kernel.SOURCE.read_text())
    return int(found.group(1))


def _tc_forward(q, k, v, causal, window, terms="3x"):
    """o, lse of (B, H, S, D) f32 numpy operands in the tensor-core tiled
    forward's arithmetic (csrc fwd_tc_kernel): a warp's 16 query rows walk
    the key tiles they can see (key_tiles, kTcKeys keys); per tile, S = the
    sum over 32-wide stages of d of four chained 3xTF32 k-steps, each stage
    added to S in f32; the online softmax in base 2 (scores times scale *
    log2 e, p = 2^(s - m), masked pairs exactly 0, lse = m ln 2 + log l);
    P V as the tile's chained k-steps, reaching acc in one fused f32 add,
    acc = acc * alpha + P V. ``terms`` "1x": one TF32 product instead of
    three."""
    tcp = _fused_linear_tests()._tensor_core_product
    b, h, s, d = q.shape
    scale = np.float32(d ** -0.5) * np.float32(np.log2(np.e))
    keys = _tc_keys()
    pad = -(-s // keys) * keys + 16
    o = np.zeros_like(q)
    lse = np.zeros((b, h, s), np.float32)
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh = (np.zeros((pad, d), np.float32) for _ in range(3))
            qh[:s], kh[:s], vh[:s] = q[bi, hi], k[bi, hi], v[bi, hi]
            for w0 in range(0, s, 16):
                rows = np.arange(w0, w0 + 16)[:, None]
                last = min(w0 + 16, s) - 1
                lo = max(0, w0 - window + 1) // keys if window else 0
                hi_t = last // keys + 1 if causal else -(-s // keys)
                m = np.full(16, -1e30, np.float32)
                l_sum = np.zeros(16, np.float32)
                acc = np.zeros((16, d), np.float32)
                for kt in range(lo, hi_t):
                    k0 = kt * keys
                    cols = np.arange(k0, k0 + keys)[None, :]
                    sc = np.zeros((16, keys), np.float32)
                    for d0 in range(0, d, 32):
                        stage = tcp(qh[w0:w0 + 16, d0:d0 + 32],
                                    kh[k0:k0 + keys, d0:d0 + 32].T, terms)
                        sc = (sc + stage).astype(np.float32)
                    vis = (rows < s) & (cols < s)
                    if causal:
                        vis &= cols <= rows
                    if window:
                        vis &= cols > rows - window
                    sc = np.where(vis, sc * scale, np.float32(-1e30))
                    m_new = np.maximum(m, sc.max(1))
                    alpha = np.exp2(m - m_new).astype(np.float32)
                    p = np.where(vis, np.exp2(sc - m_new[:, None]),
                                 0).astype(np.float32)
                    l_sum = (alpha * l_sum + p.sum(1)).astype(np.float32)
                    pv = tcp(p, vh[k0:k0 + keys], terms)
                    acc = (acc.astype(np.float64) * alpha[:, None]
                           + pv).astype(np.float32)
                    m = m_new
                n = min(16, s - w0)
                denom = np.maximum(l_sum, np.float32(1e-30))
                o[bi, hi, w0:w0 + n] = (acc / denom[:, None])[:n]
                lse[bi, hi, w0:w0 + n] = (m * np.float32(np.log(2))
                                          + np.log(denom))[:n]
    return o, lse


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48)])
def test_forward_3xtf32_emulation_matches_reference_pallas(causal, window):
    """The tensor-core forward's arithmetic (numpy emulation: rna_tf32
    split, three products per k-step, a per-stage f32 add for S, the
    softmax in base 2 and a per-key-tile fused f32 add for P V with the
    online rescale) against
    the reference's flash_attention in interpret mode at two 64-key tiles
    and eight 16-row warps per head, o and lse, at the file's TOL (the
    reference's f32 attention tolerance). One TF32 product instead of three
    misses TOL, so the check has teeth."""
    b, h, s, d = 1, 2, 128, 64
    q, k, v, _ = _qkv_do(b, h, s, d, seed=300 + (window or 0))
    o_ref, lse_ref = ref_kernel.flash_attention(
        q, k, v, causal=causal, window=window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, return_lse=True)
    o, lse = _tc_forward(q, k, v, causal, window)
    np.testing.assert_allclose(o, np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse, np.asarray(lse_ref), **TOL)
    o1, _ = _tc_forward(q, k, v, causal, window, terms="1x")
    assert not np.allclose(o1, np.asarray(o_ref), **TOL)


# ---------------------------------------------------------------------------
# the tiled backward's tensor-core arithmetic (dq_tc_kernel, dkdv_tc_kernel)
# ---------------------------------------------------------------------------


def _tb_split_min_d() -> int:
    """The head dim from which the tiled backward splits each streamed
    tile between two warps (csrc kTbSplitMinD)."""
    import re
    found = re.search(r"constexpr int kTbSplitMinD = (\d+);",
                      kernel.SOURCE.read_text())
    return int(found.group(1))


def _tb_scores(tcp, a, b, terms):
    """a (16, D) against b (n, D): per 32-wide stage of d, the stage's
    chained 3xTF32 k-steps (``tcp``, ``_tensor_core_product``), then added
    to the scores in f32."""
    sc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for d0 in range(0, a.shape[1], 32):
        stage = tcp(a[:, d0:d0 + 32], b[:, d0:d0 + 32].T, terms)
        sc = (sc + stage).astype(np.float32)
    return sc


def _tb_p(sc, scale2, lse2, vis):
    """p = exp2(fma(s, scale * log2 e, -lse * log2 e)), exactly 0 where
    masked (the fma's product is exact in f64)."""
    arg = (sc.astype(np.float64) * scale2 - lse2).astype(np.float32)
    return np.where(vis, np.exp2(arg), np.float32(0)).astype(np.float32)


def _tb_backward(q, k, v, do, lse, delta, causal, window, terms="3x"):
    """dq, dk, dv of (B, H, S, D) f32 numpy operands in the tensor-core
    tiled backward's order of work (csrc dq_tc_kernel, dkdv_tc_kernel): a
    warp's 16 rows (queries for dq, keys for dk/dv) walk the 64-row tiles
    of the other operand they can see (key_tiles, query_tiles), each tile
    split between two warps' halves from D = kTbSplitMinD; per tile, the
    scores (S and dP; S^T and dP^T) with a per-stage f32 add, P in base 2,
    dS = P * (dP - delta) in f32, and each second product (dS K; P^T dO and
    dS^T Q) chained over the tile's k-steps with dS / P split into TF32
    parts, then added to the half's accumulator in one f32 add; the halves
    summed at the end, dq and dk times scale at the store. ``terms`` "1x":
    one TF32 product instead of three."""
    tcp = _fused_linear_tests()._tensor_core_product
    b, h, s, d = q.shape
    log2e = np.float32(np.log2(np.e))
    scale = np.float32(d ** -0.5)
    scale2 = np.float32(scale * log2e)
    tile = _tc_keys()
    halves = 2 if d >= _tb_split_min_d() else 1
    part = tile // halves
    n_tiles = -(-s // tile)
    pad = n_tiles * tile + 16
    grads = [np.zeros_like(q) for _ in range(3)]
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh, doh = (np.zeros((pad, d), np.float32)
                               for _ in range(4))
            lse2, dl = np.zeros(pad, np.float32), np.zeros(pad, np.float32)
            for full, x in zip((qh, kh, vh, doh), (q, k, v, do)):
                full[:s] = x[bi, hi]
            lse2[:s] = (lse[bi, hi] * log2e).astype(np.float32)
            dl[:s] = delta[bi, hi]
            for w0 in range(0, s, 16):
                rows = np.arange(w0, w0 + 16)
                last = min(w0 + 16, s) - 1
                # dq: the warp's queries against the key tiles they see
                lo = max(0, w0 - window + 1) // tile if window else 0
                hi_t = last // tile + 1 if causal else n_tiles
                acc = [np.zeros((16, d), np.float32) for _ in range(halves)]
                for kt in range(lo, hi_t):
                    for hf in range(halves):
                        cols = kt * tile + hf * part + np.arange(part)
                        vis = _visible(torch.from_numpy(rows[:, None]),
                                       torch.from_numpy(cols[None, :]),
                                       causal, window).numpy()
                        vis &= (rows[:, None] < s) & (cols[None, :] < s)
                        sc = _tb_scores(tcp, qh[rows], kh[cols], terms)
                        dp = _tb_scores(tcp, doh[rows], vh[cols], terms)
                        p = _tb_p(sc, scale2, lse2[rows, None], vis)
                        ds = (p * (dp - dl[rows, None])).astype(np.float32)
                        acc[hf] = (acc[hf] + tcp(ds, kh[cols], terms)
                                   ).astype(np.float32)
                dq = sum(acc[1:], acc[0]).astype(np.float32)
                # dk/dv: the warp's keys against the query tiles that see
                # them
                lo = w0 // tile if causal else 0
                hi_t = (min(n_tiles, (last + window - 1) // tile + 1)
                        if window else n_tiles)
                dk = [np.zeros((16, d), np.float32) for _ in range(halves)]
                dv = [np.zeros((16, d), np.float32) for _ in range(halves)]
                for qt in range(lo, hi_t):
                    for hf in range(halves):
                        cols = qt * tile + hf * part + np.arange(part)
                        vis = _visible(torch.from_numpy(cols[None, :]),
                                       torch.from_numpy(rows[:, None]),
                                       causal, window).numpy()
                        vis &= (rows[:, None] < s) & (cols[None, :] < s)
                        sc = _tb_scores(tcp, kh[rows], qh[cols], terms)
                        p = _tb_p(sc, scale2, lse2[None, cols], vis)
                        dv[hf] = (dv[hf] + tcp(p, doh[cols], terms)
                                  ).astype(np.float32)
                        dp = _tb_scores(tcp, vh[rows], doh[cols], terms)
                        ds = (p * (dp - dl[None, cols])).astype(np.float32)
                        dk[hf] = (dk[hf] + tcp(ds, qh[cols], terms)
                                  ).astype(np.float32)
                n = min(16, s - w0)
                for out, x, mul in ((grads[0], dq, scale),
                                    (grads[1], sum(dk[1:], dk[0]), scale),
                                    (grads[2], sum(dv[1:], dv[0]),
                                     np.float32(1))):
                    out[bi, hi, w0:w0 + n] = (x * mul).astype(
                        np.float32)[:n]
    return grads


@pytest.fixture(scope="module")
def tiled_bwd_reference():
    """The reference's Pallas backward (interpret mode) at (1, 2, 128, 64),
    causal and causal with a window of 48: window -> (the kernels'
    arguments, dq, dk and dv), one run of each for the module."""
    out = {}
    for window in (None, 48):
        q, k, v, do = _qkv_do(1, 2, 128, 64, seed=400 + (window or 0))
        o_ref, lse_ref = ref_kernel.flash_attention(
            q, k, v, causal=True, window=window, block_q=BLOCK,
            block_k=BLOCK, interpret=True, return_lse=True)
        delta = np.sum(do * np.asarray(o_ref), axis=-1)
        grads = ref_kernel.flash_attention_bwd(
            q, k, v, do, lse_ref, delta, causal=True, window=window,
            block_q=BLOCK, block_k=BLOCK, interpret=True)
        out[window] = ((q, k, v, do, np.asarray(lse_ref), delta),
                       [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("window", [None, 48])
def test_tiled_backward_3xtf32_emulation_matches_reference_pallas(
        tiled_bwd_reference, window):
    """The tensor-core tiled backward's arithmetic (numpy emulation: 16-row
    warps, 64-row tiles, S and dP with a per-stage f32 add, P in base 2, dS
    split into TF32 parts, a per-tile f32 add into each accumulator)
    against the reference's flash_attention_bwd in interpret mode, dq, dk
    and dv at the file's TOL (the reference's f32 attention tolerance). One
    TF32 product instead of three misses TOL in every output, so the check
    has teeth."""
    args, want = tiled_bwd_reference[window]
    got = _tb_backward(*args, True, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    one = _tb_backward(*args, True, window, terms="1x")
    for g, w in zip(one, want):
        assert not np.allclose(g, w, **TOL)


def test_tiled_backward_3xtf32_emulation_matches_plain_ragged():
    """The same emulation against the port's plain versions
    (attention_ref_bwd_dq, attention_ref_bwd_dkdv) at a ragged S = 100
    (a half-empty second tile, masked on load and store), D = 32, causal
    with a window of 40."""
    b, h, s, d, window = 1, 2, 100, 32, 40
    q, k, v, do = _qkv_do(b, h, s, d, seed=500)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.attention_ref_lse(tq, tk, tv, causal=True, window=window)
    delta = (tdo * o).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta)
    want = (ref.attention_ref_bwd_dq(*args, causal=True, window=window),
            *ref.attention_ref_bwd_dkdv(*args, causal=True, window=window))
    got = _tb_backward(q, k, v, do, _np(lse), _np(delta), True, window)
    assert kernel.attention_plan(b, h, s, d).form == "tiled"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, _np(w), **TOL)


# ---------------------------------------------------------------------------
# head dim 80 (stablelm-3b): the tiled kernels' pitches, shared memory and
# arithmetic where D is an odd multiple of 16
# ---------------------------------------------------------------------------


def _pitch_rules() -> dict:
    """The residue rules of the tiled kernels' pitches in the source:
    {"qk" | "v" | "tb": (res, mod)}, a pitch the least >= D that is res mod
    mod (csrc pitch_at)."""
    import re
    src = kernel.SOURCE.read_text()
    tc = re.search(r"qk = pitch_at\(D, (\d+), (\d+)\), v = pitch_at\(D, "
                   r"(\d+), (\d+)\)", src)
    tb = re.search(r"int p = pitch_at\(D, (\d+), (\d+)\)", src)
    return {"qk": (int(tc.group(1)), int(tc.group(2))),
            "v": (int(tc.group(3)), int(tc.group(4))),
            "tb": (int(tb.group(1)), int(tb.group(2)))}


def _pitch(d: int, rule) -> int:
    res, mod = rule
    return d + (res - d) % mod


def _conflict_free(words) -> bool:
    """One shared-memory request of 32-bit words (a warp's, or a
    half-warp's 64-bit one) touches each of the 32 banks at most once."""
    banks = [w % 32 for w in words]
    return len(set(banks)) == len(banks)


@pytest.mark.parametrize("d", kernel.HEAD_DIMS)
def test_tiled_pitches_are_free_of_bank_conflicts(d):
    """Every fragment load of the tiled kernels at each head dim, with the
    pitches the source's residue rules give (D = 80: 88 for Q and K, 84
    for V and the backward's tiles, as at every D = 0 mod 16 D + 8 and
    D + 4): the forward's float2 loads of Q and K along d (half-warps of
    lanes 4g + t: row g, words 2t and 2t + 1), its V loads along rows
    (rows 2t and 2t + 1, column g), the backward's loads along d (row g,
    columns t and t + 4) and along rows; and each kernel's block within
    the H100's 227 KB of shared memory. A pitch of D alone conflicts."""
    rules = _pitch_rules()
    pqk, pv, ptb = (_pitch(d, rules[k]) for k in ("qk", "v", "tb"))
    if d == 80:
        assert (pqk, pv, ptb) == (88, 84, 84)
    lanes = [(g, t) for g in range(8) for t in range(4)]
    for half in (lanes[:16], lanes[16:]):
        assert _conflict_free([g * pqk + 2 * t + i for g, t in half
                               for i in (0, 1)])
    for hh in (0, 1):
        assert _conflict_free([(2 * t + hh) * pv + g for g, t in lanes])
        assert _conflict_free([(2 * t + hh) * ptb + g for g, t in lanes])
    for col in (0, 4):
        assert _conflict_free([g * ptb + t + col for g, t in lanes])
    assert not _conflict_free([g * d + t for g, t in lanes])
    keys, stages = _tc_keys(), 2
    fwd = keys * pqk + stages * keys * (pqk + pv)
    dq = (2 + 2 * stages) * keys * ptb
    dkdv = 2 * keys * ptb + stages * (2 * keys * ptb + 2 * keys)
    assert 4 * max(fwd, dq, dkdv) <= 227 * 1024


@pytest.fixture(scope="module")
def head_dim_80_reference():
    """The reference's Pallas forward and backward (interpret mode) at
    (1, 1, 128, 80), causal: (q, k, v, do, lse, delta) and (o, dq, dk,
    dv), one run for the module."""
    q, k, v, do = _qkv_do(1, 1, 128, 80, seed=800)
    o_ref, lse_ref = ref_kernel.flash_attention(
        q, k, v, causal=True, block_q=BLOCK, block_k=BLOCK, interpret=True,
        return_lse=True)
    delta = np.sum(do * np.asarray(o_ref), axis=-1)
    grads = ref_kernel.flash_attention_bwd(
        q, k, v, do, lse_ref, delta, causal=True, block_q=BLOCK,
        block_k=BLOCK, interpret=True)
    return ((q, k, v, do, np.asarray(lse_ref), delta),
            [np.asarray(o_ref)] + [np.asarray(g) for g in grads])


def test_forward_3xtf32_emulation_at_head_dim_80(head_dim_80_reference):
    """The tiled forward's arithmetic at D = 80, where the scores' last
    stage of d is 16 wide (two k-steps, still added to S in f32 on its
    own), against the reference's Pallas forward: o and lse at TOL."""
    (q, k, v, _, lse_ref, _), (o_ref, *_) = head_dim_80_reference
    o, lse = _tc_forward(q, k, v, True, None)
    np.testing.assert_allclose(o, o_ref, **TOL)
    np.testing.assert_allclose(lse, lse_ref, **TOL)


def test_tiled_backward_3xtf32_emulation_at_head_dim_80(
        head_dim_80_reference):
    """The tiled backward's order of work at D = 80 (unsplit: 80 is below
    kTbSplitMinD) against the reference's Pallas backward: dq, dk and dv at
    TOL."""
    assert 80 < _tb_split_min_d()
    args, (_, *want) = head_dim_80_reference
    got = _tb_backward(*args, True, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_head_dim_256_is_refused():
    """D = 256, which no config has, has no instantiation: the wrappers
    raise on the card rather than fall back to a plain version."""
    assert 256 not in kernel.HEAD_DIMS
    q = torch.empty(1, 2, 64, 256)
    with pytest.raises(NotImplementedError, match="head dim 256"):
        kernel._operands("qkv", q, q, q)
