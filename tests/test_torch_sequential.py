"""The port's sequential engine (the per-device loop kept as the parity
reference) and the deprecated ``FLTrainer``/``FLConfig`` shim, against
``repro.fl`` and against the port's own cohort engine.

Tolerances: against the reference, the statistics at rtol 1e-4 (norms of
differences of whole-model gradients over a step of size lr, summed in
another order by each framework); with the reference's statistics the
control plane sees identical inputs, so decisions, queues and delays are
bit-identical, and losses and params agree at atol = rtol = 1e-5 (the
reference's f32 contract). Sequential against cohort inside the port: the
reference's own rtol 1e-3, atol 1e-4 for the statistics and 1e-3 for the
losses (``tests/test_cohort.py``).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.fl.trainer import FLConfig, FLTrainer  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SC = dict(model="mlp", max_dataset=400, k_iters=2, sigma_samples=2,
          rounds=2, eval_every=2, engine="sequential")


@pytest.fixture(scope="module")
def reference():
    r = ref_sim.Simulation(ref_sim.Scenario(**SC))
    out = dict(params0=jax.tree.map(np.asarray, r.params),
               rng0=r.rng.bit_generator.state, stats=r.stats, sim=r)
    out["records"] = list(r.rounds())
    out["final"] = jax.tree.map(np.asarray, r.params)
    return out


def test_sequential_stats_match_reference(reference):
    s = sim.Simulation(sim.Scenario(**SC), device="cpu",
                       init_params=reference["params0"])
    assert s.rng.bit_generator.state == reference["rng0"]
    for f in ("sigma", "delta", "lipschitz", "d_tilde"):
        got, want = getattr(s.stats, f), getattr(reference["stats"], f)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_sequential_rounds_match_reference(reference):
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu",
                       init_params=reference["params0"])
    s.rng.bit_generator.state = reference["rng0"]
    records = list(s.rounds())
    assert any(rec.trained for rec in records)
    for got, want in zip(records, reference["records"]):
        np.testing.assert_array_equal(got.selected, want.selected)
        assert got.trained == want.trained
        np.testing.assert_array_equal(got.l_n, want.l_n)
        assert got.delay == want.delay and got.cum_delay == want.cum_delay
        np.testing.assert_array_equal(got.queues, want.queues)
        np.testing.assert_allclose(got.losses, want.losses, **TOL)
        assert got.boundary_rms is None and want.boundary_rms is None
    for g, w in zip(params_to_numpy(s.plan, s.params), reference["final"]):
        for k in g:
            np.testing.assert_allclose(g[k], w[k], **TOL)
    assert s.rng.bit_generator.state == \
        reference["sim"].rng.bit_generator.state


def test_bf16_with_the_sequential_engine_raises():
    """As the reference: the sequential engine runs f32 only, and says so
    rather than train in f32 under a bf16-priced upload."""
    with pytest.raises(ValueError, match="sequential"):
        sim.Simulation(sim.Scenario(**dict(SC, dtype="bf16")), device="cpu")
    with pytest.raises(ValueError, match="sequential"):
        ref_sim.Simulation(ref_sim.Scenario(**dict(SC, dtype="bf16")))


def test_estimate_stats_cohort_matches_sequential():
    tr = FLTrainer(FLConfig(model="mlp", rounds=1, seed=1, max_dataset=400,
                            sigma_samples=2), device="cpu")
    params = tr.bs.params
    # re-seed the rng so both estimators sample identical batches
    tr.rng = np.random.default_rng(123)
    b = tr.estimate_stats(params, engine="cohort")
    tr.rng = np.random.default_rng(123)
    c = tr.estimate_stats(params, engine="sequential")
    for f in ("sigma", "delta", "lipschitz"):
        np.testing.assert_allclose(getattr(b, f), getattr(c, f), rtol=1e-3,
                                   atol=1e-4)


def test_trainer_cohort_engine_matches_sequential_run():
    """The full loop: both engines give the same trajectory."""
    cfg = dict(model="mlp", rounds=3, eval_every=3, seed=0, max_dataset=400)
    cohort = FLTrainer(FLConfig(**cfg, engine="cohort"),
                       device="cpu").run("ddsra")
    seq = FLTrainer(FLConfig(**cfg, engine="sequential"),
                    device="cpu").run("ddsra")
    np.testing.assert_allclose(cohort.losses, seq.losses, atol=1e-3)
    assert abs(cohort.accuracy[-1] - seq.accuracy[-1]) < 0.02
    np.testing.assert_array_equal(cohort.participation, seq.participation)


# ---------------------------------------------------------------------------
# FLTrainer shim
# ---------------------------------------------------------------------------

SHIM = dict(model="mlp", rounds=2, eval_every=2, seed=0, max_dataset=400)


def test_trainer_shim_matches_simulation():
    cfg = FLConfig(**SHIM)
    res_sim = sim.Simulation(cfg.to_scenario(), device="cpu").run()
    res_shim = FLTrainer(cfg, device="cpu").run()
    assert res_shim.accuracy == res_sim.accuracy
    assert res_shim.losses == res_sim.losses
    assert res_shim.cum_delay == res_sim.cum_delay
    np.testing.assert_array_equal(res_shim.participation,
                                  res_sim.participation)


def test_trainer_shim_internals_stay_mutable():
    """Legacy sweep idiom: poking tr.bs.params / tr.rng must still reach the
    underlying simulation (the shim shares state, not copies)."""
    tr = FLTrainer(FLConfig(**SHIM), device="cpu")
    fresh = np.random.default_rng(1)
    tr.rng = fresh
    assert tr.sim.rng is fresh
    tr.bs.params = tr.sim._init_params
    assert tr.sim.params is tr.sim._init_params
    assert tr.gamma is tr.sim.gamma


def test_trainer_shim_boundary_telemetry():
    tr = FLTrainer(FLConfig(**SHIM, boundary_telemetry=True), device="cpu")
    tr.run("ddsra")
    assert tr.last_boundary_rms is not None
    assert tr.last_boundary_rms.shape == (tr.net.cfg.n_devices,)


def test_trainer_engine_override_is_per_call():
    """``run(engine=...)`` trains that call on the named engine and then
    restores the configured one."""
    tr = FLTrainer(FLConfig(**SHIM), device="cpu")
    assert tr.sim.engine.name == "cohort"
    res = tr.run("ddsra", engine="sequential")
    assert tr.sim.engine.name == "cohort"
    want = sim.Simulation(FLConfig(**SHIM).to_scenario(), device="cpu")
    want.engine = sim.make_engine("sequential")
    ref = want.run("ddsra")
    assert res.losses == ref.losses
    np.testing.assert_array_equal(res.participation, ref.participation)
