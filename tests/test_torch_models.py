"""The port's split models (VGG-11, MLP) against ``repro.models`` on the
same numpy weights and inputs, at a narrow width.

Tolerance for logits, losses and gradients: atol = rtol = 1e-5 (the
reference's f32 contract); the convs run in XLA on one side and in
PyTorch's CPU convolution on the other, whose summation orders differ by a
few ulps. Split-vs-unsplit inside the port runs the same operations, so
it is held to 1e-6.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.fl import split as ref_split  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.core.costmodel import VGG11_PLAN  # noqa: E402
from repro_torch.fl import split  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTH = 0.0625


def np_vgg_params(width, seed, classes=10):
    """Reference-layout (HWIO conv, (K, N) fc) VGG-11 weights from numpy,
    with nonzero biases so the bias paths are exercised."""
    rng = np.random.default_rng(seed)
    params, ci, hw = [], 3, 32
    for item in VGG11_PLAN:
        if item == "M":
            params.append({})
            hw //= 2
            continue
        co = max(1, int(item * width))
        params.append({"w": rng.normal(size=(3, 3, ci, co))
                       * math.sqrt(2.0 / (ci * 9)),
                       "b": rng.normal(size=(co,)) * 0.1})
        ci = co
    fc1 = max(16, int(4096 * width))
    for si, so in ((ci * hw * hw, fc1), (fc1, fc1), (fc1, classes)):
        params.append({"w": rng.normal(size=(si, so)) * math.sqrt(2.0 / si),
                       "b": rng.normal(size=(so,)) * 0.1})
    return [{k: v.astype(np.float32) for k, v in p.items()} for p in params]


def np_mlp_params(sizes, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(si, so)) * math.sqrt(2.0 / si))
             .astype(np.float32),
             "b": (rng.normal(size=(so,)) * 0.1).astype(np.float32)}
            for si, so in zip(sizes[:-1], sizes[1:])]


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _ref_value_and_grads(model, np_params, x, y):
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]
    logits = model.forward(params, jnp.asarray(x))
    loss, g = jax.value_and_grad(
        lambda p: model.loss(model.forward(p, jnp.asarray(x)),
                             jnp.asarray(y)))(params)
    return (np.asarray(logits), float(loss),
            [{k: np.asarray(v) for k, v in p.items()} for p in g])


def _port_value_and_grads(model, np_params, x, y):
    params = params_from_numpy(model, np_params, device="cpu")
    for t in split.leaves(params):
        t.requires_grad_()
    logits = model.forward(params, torch.from_numpy(x))
    loss = model.loss(logits, torch.from_numpy(y))
    g = torch.autograd.grad(loss, split.leaves(params))
    return (logits.detach().numpy(), float(loss.detach()),
            params_to_numpy(model, split._like(list(g), params)))


def _assert_params_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], **tol)


def test_params_numpy_roundtrip_and_layout():
    model = sm.VGGSplitModel(width_mult=WIDTH)
    np_params = np_vgg_params(WIDTH, seed=0)
    params = params_from_numpy(model, np_params, device="cpu")
    w0 = params[0]["w"]
    assert w0.shape == (4, 3, 3, 3)                      # OIHW
    assert float(w0[2, 1, 0, 2]) == float(np_params[0]["w"][0, 2, 1, 2])
    back = params_to_numpy(model, params)
    for p, q in zip(back, np_params):
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(p[k], q[k])


@pytest.mark.parametrize("family", ["vgg", "mlp"])
def test_logits_loss_and_grads_match_reference(family):
    if family == "vgg":
        ref_model = ref_sm.VGGSplitModel(width_mult=WIDTH)
        model = sm.VGGSplitModel(width_mult=WIDTH)
        np_params = np_vgg_params(WIDTH, seed=1)
    else:
        sizes = (3072, 32, 16, 10)
        ref_model, model = ref_sm.MLPSplitModel(sizes), sm.MLPSplitModel(sizes)
        np_params = np_mlp_params(sizes, seed=1)
    x, y = _batch(6)
    r_logits, r_loss, r_grads = _ref_value_and_grads(ref_model, np_params,
                                                     x, y)
    logits, loss, grads = _port_value_and_grads(model, np_params, x, y)
    np.testing.assert_allclose(logits, r_logits, **TOL)
    assert loss == pytest.approx(r_loss, rel=1e-5, abs=1e-5)
    _assert_params_close(grads, r_grads, **TOL)


def test_masked_loss_and_costs_match_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    mask[2] = 0.0                                        # an empty slot
    ref_model, model = ref_sm.VGGSplitModel(WIDTH), sm.VGGSplitModel(WIDTH)
    got = model.masked_loss(*map(torch.from_numpy, (logits, labels, mask)))
    for s in range(3):
        want = ref_model.masked_loss(logits[s], labels[s], mask[s])
        assert float(got[s]) == pytest.approx(float(want), rel=1e-6,
                                              abs=1e-7)
    assert float(got[2]) == 0.0
    assert [vars(a) for a in model.layer_costs()] == \
        [vars(b) for b in ref_model.layer_costs()]
    assert model.valid_cuts == ref_model.valid_cuts
    assert model.block_kinds == ref_model.block_kinds


def test_slot_batched_forward_equals_per_model():
    """Per-slot weights (grouped conv, batched fc) and shared weights folded
    into one batch both give each slot's single-model logits, to the 1e-5
    contract: the grouped convolution takes another CPU algorithm than the
    plain one, a few ulps apart."""
    model = sm.VGGSplitModel(width_mult=WIDTH)
    slots = [params_from_numpy(model, np_vgg_params(WIDTH, seed=s), "cpu")
             for s in range(3)]
    stacked = [{k: torch.stack([p[i][k] for p in slots]) for k in layer}
               for i, layer in enumerate(slots[0])]
    x = torch.from_numpy(np.stack([_batch(4, seed=s)[0] for s in range(3)]))
    out = model.forward_slots(stacked, x)
    shared = model.forward_slots(slots[0], x)
    for s in range(3):
        torch.testing.assert_close(out[s], model.forward(slots[s], x[s]),
                                   **TOL)
        torch.testing.assert_close(shared[s], model.forward(slots[0], x[s]),
                                   **TOL)


def test_split_step_equals_unsplit_at_every_cut():
    """split_sgd_step at each of the 17 VGG cuts equals one unsplit SGD
    step; one cut is also held against the reference's split step."""
    model = sm.VGGSplitModel(width_mult=WIDTH)
    np_params = np_vgg_params(WIDTH, seed=3)
    params = params_from_numpy(model, np_params, device="cpu")
    x, y = map(torch.from_numpy, _batch(4, seed=3))
    lr = 0.05
    want, want_loss = split.local_train(model, params, x, y, 0, 1, lr)
    assert len(model.valid_cuts) == 17
    for cut in model.valid_cuts:
        got, loss = split.split_sgd_step(model, params, (x, y), cut, lr)
        assert float(loss) == pytest.approx(want_loss, rel=1e-6)
        _assert_params_close(params_to_numpy(model, got),
                             params_to_numpy(model, want),
                             atol=1e-6, rtol=1e-6)
    ref_model = ref_sm.VGGSplitModel(width_mult=WIDTH)
    r_new, r_loss = ref_split.split_sgd_step(
        ref_model, [{k: jnp.asarray(v) for k, v in p.items()}
                    for p in np_params],
        (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())), 8, lr)
    assert float(r_loss) == pytest.approx(want_loss, rel=1e-5)
    _assert_params_close(params_to_numpy(model, want),
                         [{k: np.asarray(v) for k, v in p.items()}
                          for p in r_new], **TOL)


def test_registry_builds_seeded_models():
    class Spec:
        width_mult, classes, mlp_hidden = WIDTH, 10, (32, 16)
    g = torch.Generator().manual_seed(0)
    model, params, costs = registry.build_fl_model("vgg", g, Spec, "cpu")
    assert isinstance(model, sm.VGGSplitModel)
    assert [p["w"].shape for p in params if p][-1] == (256, 10)
    assert len(costs) == model.n_blocks
    again = registry.build_fl_model(
        "vgg", torch.Generator().manual_seed(0), Spec, "cpu")[1]
    for a, b in zip(split.leaves(params), split.leaves(again)):
        assert torch.equal(a, b)
    model, params, _ = registry.build_fl_model("mlp", g, Spec, "cpu")
    assert model.sizes == (3072, 32, 16, 10)
    # every FL model the reference registers builds (moe since M5's FL
    # item); an unknown name raises
    model, _, costs = registry.build_fl_model("moe", g, Spec, "cpu")
    assert model.cfg is sm.FL_MOE and model.seq_len == 32
    assert len(costs) == model.n_blocks
    with pytest.raises(KeyError):
        registry.build_fl_model("nope", g, Spec, "cpu")
