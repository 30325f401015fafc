"""The port's Simulation against ``repro.fl.sim`` on the default scenario,
cut to a CPU-sized width, dataset and depth, from the reference's own
initial weights.

Tolerances: the statistics (sigma, delta, L) to rtol 1e-4 — norms of
differences of whole-model gradients over a step of size lr, summed in
another order by each framework. With the reference's statistics injected
the control plane sees identical inputs, so decisions, queues and delays
must be bit-identical; losses and params to atol = rtol = 1e-5 (the
reference's f32 contract); test accuracy to one image in a thousand (a
near-tie argmax may flip under a few-ulp difference).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402
import inspect  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.fl import cohort  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
SC = dict(width_mult=0.0625, max_dataset=400, k_iters=2, sigma_samples=2,
          rounds=2, eval_every=2)


def _np_params(params):
    return [{k: np.array(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def reference():
    s = ref_sim.Simulation(ref_sim.Scenario(**SC))
    out = dict(params0=_np_params(s.params), rng0=s.rng.bit_generator.state,
               stats=s.stats, sim=s)
    out["records"] = list(s.rounds())
    out["final"] = _np_params(s.params)
    return out


def test_setup_and_stats_match_reference(reference):
    r = reference["sim"]
    s = sim.Simulation(sim.Scenario(**SC), device="cpu",
                       init_params=reference["params0"])
    # the same numpy streams were consumed in the same order
    assert s.rng.bit_generator.state == reference["rng0"]
    np.testing.assert_array_equal(s.d_sizes, r.d_sizes)
    np.testing.assert_array_equal(s.d_tilde, r.d_tilde)
    assert s.cohort_capacity == r.cohort_capacity
    for f in dataclasses.fields(s.workload):
        np.testing.assert_array_equal(getattr(s.workload, f.name),
                                      getattr(r.workload, f.name))
    for f in ("sigma", "delta", "lipschitz"):
        np.testing.assert_allclose(getattr(s.stats, f),
                                   getattr(reference["stats"], f), rtol=1e-4)
    np.testing.assert_array_equal(s.stats.d_tilde, reference["stats"].d_tilde)

    # reset() replays a fresh run exactly
    first = list(s.rounds())
    s.reset()
    again = list(s.rounds())
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.queues, b.queues)
        np.testing.assert_array_equal(a.losses, b.losses)
        assert a.accuracy == b.accuracy


def test_rounds_match_reference_with_its_stats(reference):
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu",
                       init_params=reference["params0"])
    # no estimation draws were consumed: continue from the reference's
    # post-estimation batch stream
    s.rng.bit_generator.state = reference["rng0"]
    r = reference["sim"]
    np.testing.assert_array_equal(s.phi, r.phi)
    np.testing.assert_array_equal(s.gamma, r.gamma)
    records = list(s.rounds())
    assert len(records) == len(reference["records"]) == SC["rounds"]
    for got, want in zip(records, reference["records"]):
        np.testing.assert_array_equal(got.selected, want.selected)
        assert got.trained == want.trained
        np.testing.assert_array_equal(got.l_n, want.l_n)
        assert got.delay == want.delay and got.cum_delay == want.cum_delay
        np.testing.assert_array_equal(got.queues, want.queues)
        assert got.failures == want.failures
        np.testing.assert_allclose(got.losses, want.losses, **TOL)
        assert (got.accuracy is None) == (want.accuracy is None)
        if want.accuracy is not None:
            assert abs(got.accuracy - want.accuracy) <= 1e-3
    assert any(rec.trained for rec in records)
    got = params_to_numpy(s.plan, s.params)
    for g, w in zip(got, reference["final"]):
        for k in g:
            np.testing.assert_allclose(g[k], w[k], **TOL)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state


def test_scenario_json_interchange():
    ref = ref_sim.Scenario(width_mult=1.0, rounds=3, tiers="auto")
    port = sim.Scenario.from_json(ref.to_json())
    assert port == sim.Scenario(width_mult=1.0, rounds=3, tiers="auto")
    assert port.to_json() == ref.to_json()
    assert sim.Scenario.from_json(port.to_json()) == port


def test_unported_options_raise():
    """What the port refuses, with the reference's errors: the traced plane
    on the sequential engine and fault axes on a synchronous engine (they
    run on ``engine="async"``); the sharded engine builds (ROADMAP.md M9
    is ported), with no process group as a one-rank mesh."""
    for kw, err, match in (
            (dict(data_plane="traced", engine="sequential"), ValueError,
             "cannot honor data_plane='traced'"),
            (dict(churn=0.1), ValueError, "synchronous"),
            (dict(churn=0.1, engine="sharded"), ValueError, "synchronous")):
        with pytest.raises(err, match=match):
            sim.Simulation(sim.Scenario(**SC, **kw), device="cpu")
    s = sim.Simulation(sim.Scenario(**SC, engine="async", churn=0.1),
                       device="cpu")
    assert s.engine.name == "async" and s.faults.active
    s = sim.Simulation(sim.Scenario(**SC, engine="sharded"), device="cpu")
    assert s.engine.name == "sharded" and s.engine._shard_count(s) == 1


@pytest.mark.parametrize("name,item", [("sharded", "M9")])
def test_unported_engines_raise_naming_their_item(name, item):
    """F5, then M9: the reference registers this engine, which the port
    built under that ROADMAP.md item; it builds now, no engine is left
    unported, and an unknown name still raises."""
    assert name in ref_sim.ENGINES and name in sim.ENGINES
    assert item not in sim.UNPORTED_ENGINES.values()
    eng = sim.make_engine(name)
    assert isinstance(eng, sim.ENGINES[name]) and eng.name == name
    with pytest.raises(ValueError, match="unknown engine"):
        sim.make_engine("nope")


def test_every_reference_engine_but_sharded_is_registered():
    """The async (M8) and sharded (M9) engines are ported: every engine the
    reference registers is the port's, and the port registers no other."""
    assert set(ref_sim.ENGINES) == set(sim.ENGINES)
    assert sim.UNPORTED_ENGINES == {}
    eng = sim.make_engine("async")
    assert eng.supports_faults and not eng.supports_fused
    assert not sim.make_engine("cohort").supports_faults
    sharded = sim.make_engine("sharded")
    assert isinstance(sharded, sim.CohortEngine)
    assert sharded.supports_fused and sharded.supports_traced_data
    assert sharded.supported_dtypes == ref_sim.ENGINES[
        "sharded"].supported_dtypes


def test_engine_api_matches_reference(reference):
    """F5 and F7: ``run`` takes ``boundary`` and the cohort engine has
    ``shop_floor_round``, as in the reference; ``state_dict`` and
    ``load_state_dict`` are engine methods (None and a no-op on both
    engines), not Simulation's; each engine states its dtypes."""
    for ref_fn, fn in ((ref_sim.Simulation.run, sim.Simulation.run),
                       (ref_sim.Simulation.rounds, sim.Simulation.rounds),
                       (ref_sim.CohortEngine.shop_floor_round,
                        sim.CohortEngine.shop_floor_round),
                       (ref_sim.Engine.run_round, sim.Engine.run_round),
                       (ref_sim.Engine.train_round, sim.Engine.train_round)):
        assert list(inspect.signature(fn).parameters) == \
            list(inspect.signature(ref_fn).parameters), fn
    for cls in (sim.Simulation, ref_sim.Simulation):
        assert not hasattr(cls, "state_dict")
        assert not hasattr(cls, "load_state_dict")
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu")
    for name in ("cohort", "sequential"):
        eng = sim.make_engine(name)
        assert eng.supported_dtypes == ref_sim.ENGINES[name].supported_dtypes
        assert eng.state_dict(s) is None
        assert eng.load_state_dict(s, {}, "unused", 0) is None
    res = s.run(boundary=False)
    assert len(res.cum_delay) == SC["rounds"]


def test_padding_stats_match_reference(reference):
    """The cohort engine's padded-vs-real sample counts after the
    reference's two rounds, from its statistics and batch stream; a
    restart zeroes them, as the reference's does."""
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu",
                       init_params=reference["params0"])
    s.rng.bit_generator.state = reference["rng0"]
    assert s.padding_stats == {"real_samples": 0.0, "padded_samples": 0.0}
    list(s.rounds())
    assert s.padding_stats == reference["sim"].padding_stats
    assert s.padding_stats["padded_samples"] > s.padding_stats[
        "real_samples"] > 0
    s.restart()
    assert s.padding_stats == {"real_samples": 0.0, "padded_samples": 0.0}


@pytest.mark.parametrize("name,kwargs,match", [
    ("fused_rounds", dict(policy="loss_driven"), "reads_losses"),
    ("run_fused", dict(policy="loss_driven"), "reads_losses"),
    ("sweep", dict(v_values=[0.01]), "traced-decide"),
    ("data_key", None, None),              # a property
], ids=["fused_rounds--M7", "run_fused--M7", "sweep--", "data_key--M7"])
def test_unported_api_raises_not_implemented(reference, name, kwargs, match):
    """The reference's Simulation API that was the port's last to come
    (the fused loop, ROADMAP.md M7; ``sweep``, M6) is ported: each member
    behaves as the reference's. ``fused_rounds`` and ``run_fused`` refuse
    a policy that reads training losses, and ``sweep`` this scenario's
    host policy, with the reference's errors; ``data_key`` is the
    reference's key data."""
    assert hasattr(ref_sim.Simulation, name)
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu")
    if match is None:
        assert np.array_equal(
            getattr(s, name).numpy(),
            np.asarray(jax.random.key_data(getattr(reference["sim"], name))))
        return
    with pytest.raises(ValueError, match=match):
        getattr(s, name)(**kwargs)
    r = ref_sim.Simulation(ref_sim.Scenario(**SC), reference["stats"])
    with pytest.raises(ValueError, match=match):
        getattr(r, name)(**kwargs)


def test_estimate_stats_by_engine_name(reference):
    """``estimate_stats(engine="cohort")`` is the cohort engine's estimator,
    as the reference's ``make_engine`` gives it: the same statistics as the
    default from the same seed."""
    by_name, default = (
        sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu")
        for _ in range(2))
    got = by_name.estimate_stats(engine="cohort")
    want = default.estimate_stats()
    for field in ("sigma", "delta", "lipschitz", "d_tilde"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError):
        sim.Simulation(sim.Scenario(**SC))
    with pytest.raises(RuntimeError):
        sm.VGGSplitModel(width_mult=0.0625).init(torch.Generator())
    with pytest.raises(RuntimeError):
        cohort.cohort_stats(None, [], None, None, 0.01, 2)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, import without pulling
    in jax or any module of the reference package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location("
        f"'chip_smoke', {str(REPO / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('fl.sim', 'fl.trainer', 'checkpoint.store', "
        "'configs.base', 'models.layers', "
        "'models.model', 'models.ssm', 'kernels.flash_attention.kernel', "
        "'kernels.flash_attention.ops', 'kernels.ssd_scan.kernel', "
        "'kernels.ssd_scan.ops'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
