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
# tiles, non-causal, and the FL path's single half tile (S = 32, D = 32)
CASES = [(1, 2, 256, 32, True, None), (1, 2, 256, 64, True, 100),
         (2, 1, 128, 32, False, None), (3, 2, 32, 32, True, None)]


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
