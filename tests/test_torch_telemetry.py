"""The port's boundary-activation telemetry and per-gateway shop-floor
models against ``repro.fl``: ``cohort_round(with_boundary=True,
with_gateway_models=True)``, ``Simulation.rounds(boundary=True)`` and
``CohortEngine.shop_floor_round``, from the reference's own weights,
batches and statistics.

Tolerances: f32 boundary RMS, gateway models, params and losses at atol =
rtol = 1e-5 (the reference's f32 contract; the two frameworks sum in
different orders). bf16 rounds at the reference's bf16 contract
(``tests/test_mixed_precision.py``: params 3e-2, losses 5e-2): the boundary
pass itself runs in f32 on the trained f32 masters, in both packages, so
its RMS differs only as far as those params do, and is held at the params'
3e-2 (measured: narrow VGG 6.7e-3 of scale, the transformer 2.4e-4, the
MLP 1.1e-7; gateway models 2.5e-3, 5.7e-4 and 7.5e-9). Decisions and
queues bit-identical.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import inspect  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.fl import cohort as ref_cohort  # noqa: E402
from repro.fl import data as ref_data  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.fl import cohort, data, sim  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
WIDTH = 0.0625
MLP_SIZES = (3072, 32, 16, 10)
SIZES = np.array([40, 95, 60, 130, 44, 71])
D_TILDE = np.array([5, 19, 12, 26, 8, 14])
SEQ = 32


def _models(family):
    if family == "vgg":
        return sm.VGGSplitModel(WIDTH), ref_sm.VGGSplitModel(WIDTH)
    if family == "mlp":
        return sm.MLPSplitModel(MLP_SIZES), ref_sm.MLPSplitModel(MLP_SIZES)
    return (sm.SeqSplitModel(sm.FL_TRANSFORMER, SEQ),
            ref_sm.SeqSplitModel(ref_sm.FL_TRANSFORMER, SEQ))


def _datasets(family):
    if family == "transformer":
        args, kw = (6, SIZES), dict(seq_len=SEQ, chi=0.7, seed=3)
        return (data.make_token_fl_dataset(*args, **kw),
                ref_data.make_token_fl_dataset(*args, **kw))
    args = (6, SIZES, np.array([10, 2, 3, 1, 10, 2]))
    kw = dict(chi=0.8, test_size=100, seed=7)
    return (data.make_fl_dataset(*args, **kw),
            ref_data.make_fl_dataset(*args, **kw))


def _np_params(ref_model, seed):
    return jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(seed)))


def _per_gateway(model, gw_models, m):
    return params_to_numpy(model, [{k: v[m] for k, v in p.items()}
                                   for p in gw_models])


def _assert_trees_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["vgg", "mlp", "transformer"])
def test_cohort_round_boundary_and_gateway_models_match_reference(
        family, dtype):
    """One round over three devices of two gateways in a two-tier layout
    (one empty slot), every slot at its own cut: the boundary RMS per slot
    (0 for the empty one) and the per-gateway shop-floor models."""
    ds, rds = _datasets(family)
    model, ref_model = _models(family)
    np_params = _np_params(ref_model, seed=11)
    layout = data.CohortLayout.build(D_TILDE, 4, 2)
    batch = data.sample_cohort_batch(np.random.default_rng(2), ds,
                                     [1, 3, 4], D_TILDE, layout=layout)
    ref_batch = ref_data.sample_cohort_batch(
        np.random.default_rng(2), rds, [1, 3, 4], D_TILDE,
        layout=ref_data.CohortLayout.build(D_TILDE, 4, 2))
    weights = np.zeros(4, np.float32)
    gw_onehot = np.zeros((4, 2), np.float32)
    l_n = np.zeros(4, int)
    for dev, slot, cut in zip([1, 3, 4], batch.slot_of,
                              [model.min_cut, model.n_blocks // 2,
                               model.n_blocks]):
        weights[slot] = D_TILDE[dev]
        gw_onehot[slot, dev % 2] = 1.0
        l_n[slot] = cut
    kw = dict(k_iters=2, lr=0.05, with_boundary=True,
              with_gateway_models=True, compute_dtype=dtype)
    out = cohort.cohort_round(model, params_from_numpy(model, np_params,
                                                       "cpu"),
                              batch, l_n, weights, gw_onehot, device="cpu",
                              **kw)
    ref_out = ref_cohort.cohort_round(
        ref_model, jax.tree.map(jnp.asarray, np_params), ref_batch, l_n,
        weights, gw_onehot, **kw)
    tol = TOL if dtype == "f32" else BF16_TOL
    boundary = out[4].numpy()
    np.testing.assert_allclose(boundary, np.asarray(ref_out[4]), **tol)
    empty = weights == 0
    assert (boundary[empty] == 0).all() and (boundary[~empty] > 0).all()
    assert all(v.shape[0] == 2 for p in out[5] for v in p.values())
    for m in range(2):
        _assert_trees_close(
            _per_gateway(model, out[5], m),
            [jax.tree.map(lambda a: a[m], p) for p in ref_out[5]], **tol)


def test_cohort_round_reports_boundary_by_default():
    """F6: ``with_boundary`` defaults to True, as the reference's does."""
    for fn in (cohort.cohort_round, ref_cohort.cohort_round):
        assert inspect.signature(fn).parameters[
            "with_boundary"].default is True


SC = dict(width_mult=WIDTH, max_dataset=400, k_iters=2, sigma_samples=2,
          rounds=2, eval_every=2)


def test_rounds_boundary_match_reference():
    """Two rounds of narrow VGG's ``rounds(boundary=True)`` from the
    reference's weights, statistics and batch stream: each record's (N,)
    boundary RMS, zero on the devices that did not train."""
    sc = SC
    r = ref_sim.Simulation(ref_sim.Scenario(**sc))
    p0 = jax.tree.map(np.asarray, r.params)
    rng0 = r.rng.bit_generator.state
    want = list(r.rounds(boundary=True))
    s = sim.Simulation(sim.Scenario(**sc), r.stats, device="cpu",
                       init_params=p0)
    s.rng.bit_generator.state = rng0
    got = list(s.rounds(boundary=True))
    assert any(g.trained for g in got)
    for g, w in zip(got, want):
        assert g.trained == w.trained
        np.testing.assert_array_equal(g.queues, w.queues)
        np.testing.assert_allclose(g.losses, w.losses, **TOL)
        assert g.boundary_rms.shape == (s.net.cfg.n_devices,)
        np.testing.assert_allclose(g.boundary_rms, w.boundary_rms, **TOL)
        trained = np.isin(s.net.assign, g.trained)
        assert (g.boundary_rms[~trained] == 0).all()
        assert (g.boundary_rms[trained] > 0).all()


def _all_devices_mid_cut(s):
    device_ids = [dev.idx for gw in s.gateways for dev in gw.devices]
    l_n = np.full(s.net.cfg.n_devices, s.plan.n_blocks // 2, dtype=int)
    return device_ids, l_n


def test_shop_floor_round_matches_sequential_gateways():
    """The cohort engine's shop-floor round against the port's own
    per-gateway sequential loop from the same rng seed (Fig. 2's path)."""
    s = sim.Simulation(sim.Scenario(model="mlp", rounds=1, max_dataset=400),
                       device="cpu")
    device_ids, l_n = _all_devices_mid_cut(s)
    _, gw_models, gw_loss, _ = s.engine.shop_floor_round(
        s, device_ids, l_n, params=s.params, rng=np.random.default_rng(17))
    rng = np.random.default_rng(17)
    for m, gw in enumerate(s.gateways):
        l_splits = np.asarray([l_n[d.idx] for d in gw.devices])
        combined, loss, _ = gw.shop_floor_round(
            s.plan, s.params, s.ds, l_splits, s.scenario.k_iters,
            s.scenario.lr, rng)
        for got, want in zip(gw_models, combined):
            for k in got:
                np.testing.assert_allclose(got[k][m].numpy(),
                                           want[k].numpy(), atol=1e-5)
        assert float(gw_loss[m]) == pytest.approx(loss, abs=1e-4)


def test_shop_floor_round_matches_reference():
    """``CohortEngine.shop_floor_round`` against the reference's from its
    weights and one rng seed: the returned batch byte for byte, the global
    and per-gateway models and the gateway losses at 1e-5."""
    sc = dict(model="mlp", rounds=1, max_dataset=400)
    r = ref_sim.Simulation(ref_sim.Scenario(**sc))
    p0 = jax.tree.map(np.asarray, r.params)
    s = sim.Simulation(sim.Scenario(**sc), r.stats, device="cpu",
                       init_params=p0)
    device_ids, l_n = _all_devices_mid_cut(s)
    got = s.engine.shop_floor_round(s, device_ids, l_n,
                                    rng=np.random.default_rng(5))
    want = r.engine.shop_floor_round(r, device_ids, l_n,
                                     rng=np.random.default_rng(5))
    for f in ("x", "y", "mask"):
        assert getattr(got[3], f).tobytes() == getattr(want[3], f).tobytes()
    _assert_trees_close(params_to_numpy(s.plan, got[0]),
                        jax.tree.map(np.asarray, want[0]), **TOL)
    for m in range(s.net.cfg.n_gateways):
        _assert_trees_close(_per_gateway(s.plan, got[1], m),
                            [jax.tree.map(lambda a: np.asarray(a[m]), p)
                             for p in want[1]], **TOL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **TOL)
