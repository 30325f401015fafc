"""The port's host data plane and cohort engine against ``repro.fl``.

Datasets and packed cohort batches come from the same numpy generator in
the same order, so they are compared byte for byte. One cohort round and
the statistics pass run from the same numpy weights on both sides;
tolerance: params, losses and counts to atol = rtol = 1e-5 (the
reference's f32 contract; XLA's and PyTorch's CPU convolutions and
reductions sum in different orders); sigma, delta and L, which are norms of
differences of whole-model gradients and divide by a step of size lr,
to rtol 1e-4.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.fl import cohort as ref_cohort  # noqa: E402
from repro.fl import data as ref_data  # noqa: E402
from repro.fl import roles as ref_roles  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.core.costmodel import VGG11_PLAN  # noqa: E402
from repro_torch.fl import cohort, data, roles  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTH = 0.0625
N_DEV = 6


def np_vgg_params(width, seed, classes=10):
    """Reference-layout (HWIO conv, (K, N) fc) VGG-11 weights from numpy."""
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


@pytest.fixture(scope="module")
def datasets():
    sizes = np.array([40, 95, 60, 130, 44, 71])
    q = np.array([10, 2, 3, 1, 10, 2])
    args = (N_DEV, sizes, q)
    kw = dict(chi=0.8, test_size=100, seed=7)
    return (data.make_fl_dataset(*args, **kw),
            ref_data.make_fl_dataset(*args, **kw))


def _assert_same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_same_batch(b, rb):
    for f in ("x", "y", "mask"):
        _assert_same_array(getattr(b, f), getattr(rb, f))


def test_dataset_byte_identical(datasets):
    ds, rds = datasets
    for a, b in zip(ds.x_dev + ds.y_dev + ds.classes_of,
                    rds.x_dev + rds.y_dev + rds.classes_of):
        _assert_same_array(a, b)
    _assert_same_array(ds.x_test, rds.x_test)
    _assert_same_array(ds.y_test, rds.y_test)


D_TILDE = np.array([5, 19, 12, 26, 8, 14])


@pytest.mark.parametrize("tiers", [1, 2, "auto"])
def test_cohort_batches_byte_identical(datasets, tiers):
    ds, rds = datasets
    layout = data.CohortLayout.build(D_TILDE, 4, tiers)
    rlayout = ref_data.CohortLayout.build(D_TILDE, 4, tiers)
    assert dataclasses.astuple(layout) == dataclasses.astuple(rlayout)
    assert data.CohortLayout.auto_tiers(D_TILDE, 4) == \
        ref_data.CohortLayout.auto_tiers(D_TILDE, 4)
    rng, rrng = np.random.default_rng(1), np.random.default_rng(1)
    for ids in ([1, 3, 4], [0, 2, 5, 3], []):
        b = data.sample_cohort_batch(rng, ds, ids, D_TILDE, layout=layout)
        rb = ref_data.sample_cohort_batch(rrng, rds, ids, D_TILDE,
                                          layout=rlayout)
        np.testing.assert_array_equal(b.slot_of, rb.slot_of)
        for t, rt in zip(b.tiers, rb.tiers):
            _assert_same_batch(t, rt)
        z = data.zero_slot_rows(b, [0])
        rz = ref_data.zero_slot_rows(rb, [0])
        for t, rt in zip(z.tiers, rz.tiers):
            _assert_same_batch(t, rt)
    # the all-devices and packed single-width layouts, and plain batches
    for kw in (dict(pad_to=26), dict(pad_to=26, capacity=4)):
        _assert_same_batch(
            data.sample_cohort_batch(rng, ds, [2, 0], D_TILDE, **kw),
            ref_data.sample_cohort_batch(rrng, rds, [2, 0], D_TILDE, **kw))
    for a, b in zip(data.sample_batch(rng, ds, 3, 20),
                    ref_data.sample_batch(rrng, rds, 3, 20)):
        _assert_same_array(a, b)


def _jax_params(np_params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]


def _assert_params_close(got, want, **tol):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **tol)


MLP_SIZES = (3072, 32, 16, 10)


def np_mlp_params(sizes, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(si, so)) * math.sqrt(2.0 / si))
             .astype(np.float32),
             "b": (rng.normal(size=(so,)) * 0.1).astype(np.float32)}
            for si, so in zip(sizes[:-1], sizes[1:])]


def _models(family):
    if family == "vgg":
        return (sm.VGGSplitModel(WIDTH), ref_sm.VGGSplitModel(WIDTH),
                np_vgg_params(WIDTH, seed=11))
    return (sm.MLPSplitModel(MLP_SIZES), ref_sm.MLPSplitModel(MLP_SIZES),
            np_mlp_params(MLP_SIZES, seed=11))


@pytest.mark.parametrize("family,tiers", [("vgg", 1), ("vgg", 2),
                                          ("mlp", 1)])
def test_cohort_round_matches_reference(datasets, family, tiers):
    ds, rds = datasets
    model, ref_model, np_params = _models(family)
    layout = data.CohortLayout.build(D_TILDE, 4, tiers)
    batch = data.sample_cohort_batch(np.random.default_rng(2), ds,
                                     [1, 3, 4], D_TILDE, layout=layout)
    ref_batch = ref_data.sample_cohort_batch(
        np.random.default_rng(2), rds, [1, 3, 4], D_TILDE,
        layout=ref_data.CohortLayout.build(D_TILDE, 4, tiers))
    # partition points within the model's blocks: the boundary telemetry
    # reports the activation at each slot's cut
    l_n = np.array([3, min(5, model.n_blocks), 0, 0])
    weights = np.zeros(4, np.float32)
    gw_onehot = np.zeros((4, 3), np.float32)
    for dev, slot in zip([1, 3, 4], batch.slot_of):
        weights[slot] = D_TILDE[dev]
        gw_onehot[slot, dev % 3] = 1.0
    # both packages' defaults: with_boundary=True (F6)
    out = cohort.cohort_round(model, params_from_numpy(model, np_params,
                                                       "cpu"),
                              batch, l_n, weights, gw_onehot, k_iters=2,
                              lr=0.05, device="cpu")
    ref_out = ref_cohort.cohort_round(ref_model, _jax_params(np_params),
                                      ref_batch, l_n, weights, gw_onehot,
                                      k_iters=2, lr=0.05)
    _assert_params_close(params_to_numpy(model, out[0]), ref_out[0], **TOL)
    for got, want in zip(out[1:5], ref_out[1:5]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(out[3][3]) == 0.0                  # the empty slot
    assert float(out[4][3]) == 0.0 and (out[4][:3] > 0).all()
    with pytest.raises(ValueError, match="partition points"):
        cohort.cohort_round(model, params_from_numpy(model, np_params, "cpu"),
                            batch, l_n + model.n_blocks, weights, gw_onehot,
                            k_iters=1, lr=0.05, device="cpu")


def test_cohort_stats_match_reference(datasets):
    ds, rds = datasets
    model, ref_model = sm.VGGSplitModel(WIDTH), ref_sm.VGGSplitModel(WIDTH)
    np_params = np_vgg_params(WIDTH, seed=12)
    batch = data.sample_cohort_batch(np.random.default_rng(3), ds,
                                     range(N_DEV), D_TILDE,
                                     int(D_TILDE.max()))
    ref_batch = ref_data.sample_cohort_batch(np.random.default_rng(3), rds,
                                             range(N_DEV), D_TILDE,
                                             int(D_TILDE.max()))
    mix = np.array([40, 95, 60, 130, 44, 71]) / 440.0
    got = cohort.cohort_stats(model, params_from_numpy(model, np_params,
                                                       "cpu"),
                              batch, mix, 0.01, 3, device="cpu")
    want = ref_cohort.cohort_stats(ref_model, _jax_params(np_params),
                                   ref_batch, mix, 0.01, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


def test_fedavg_matches_reference():
    rng = np.random.default_rng(4)
    models = [[{"w": rng.normal(size=(3, 2)).astype(np.float32),
                "b": rng.normal(size=(2,)).astype(np.float32)}, {}]
              for _ in range(3)]
    weights = np.array([1.0, 3.0, 4.0])
    tmodels = [[{k: torch.from_numpy(v) for k, v in p.items()} for p in m]
               for m in models]
    jmodels = [_jax_params(m) for m in models]
    for got, want in ((roles.fedavg(tmodels, weights),
                       ref_roles.fedavg(jmodels, weights)),
                      (cohort.buffer_fedavg(tmodels, weights),
                       ref_cohort.buffer_fedavg(jmodels, weights))):
        _assert_params_close([{k: v.numpy() for k, v in p.items()}
                              for p in got], want, atol=1e-6, rtol=1e-6)


def test_shop_floor_round_matches_reference(datasets):
    """A gateway's sequential shop floor (per-device K-epoch SGD, then the
    shop-floor FedAvg) from the same batch stream."""
    ds, rds = datasets
    model, ref_model, np_params = _models("mlp")
    devs = [roles.Device(i, 0, 100, int(D_TILDE[i])) for i in (0, 3)]
    rdevs = [ref_roles.Device(i, 0, 100, int(D_TILDE[i])) for i in (0, 3)]
    got = roles.Gateway(0, devs).shop_floor_round(
        model, params_from_numpy(model, np_params, "cpu"), ds,
        np.array([1, 2]), 2, 0.05, np.random.default_rng(5))
    want = ref_roles.Gateway(0, rdevs).shop_floor_round(
        ref_model, _jax_params(np_params), rds, np.array([1, 2]), 2, 0.05,
        np.random.default_rng(5))
    _assert_params_close(params_to_numpy(model, got[0]), want[0], **TOL)
    assert got[1] == pytest.approx(want[1], rel=1e-5, abs=1e-5)
    assert got[2] == want[2]
