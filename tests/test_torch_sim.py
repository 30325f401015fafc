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


def test_unported_options_raise(reference):
    for kw, err in ((dict(dtype="bf16"), NotImplementedError),
                    (dict(data_plane="traced"), NotImplementedError),
                    (dict(churn=0.1), ValueError),
                    (dict(engine="sequential"), ValueError)):
        with pytest.raises(err):
            sim.Simulation(sim.Scenario(**SC, **kw), device="cpu")
    s = sim.Simulation(sim.Scenario(**SC), reference["stats"], device="cpu")
    with pytest.raises(NotImplementedError):
        next(s.rounds(boundary=True))


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
        "for m in ('fl.sim', 'configs.base', 'models.layers', "
        "'models.model', 'models.ssm', 'kernels.flash_attention.kernel', "
        "'kernels.flash_attention.ops', 'kernels.ssd_scan.kernel', "
        "'kernels.ssd_scan.ops'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
