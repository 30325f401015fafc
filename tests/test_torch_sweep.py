"""``Simulation.sweep`` in the port (``repro_torch.fl.fused_sim``, the
decide-plane half of the reference's fused module) against the port's own
stepwise ``reset(seed)`` runs and against ``repro``'s ``Simulation.sweep``
at the same scenario: ``tests/test_fused_sim.py``'s small MLP network, two
seeds, two V values, four rounds.

Tolerances are the reference's (``tests/test_fused_sim.py``): ``selected``
identical, queues at atol 1e-12, ``taus`` at rtol 1e-9. Against the
reference the port runs from the reference's statistics, so both see the
same participation targets.
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core.network import NetworkConfig as RefNetworkConfig  # noqa
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.core import policy_sweep  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl import fused_sim, sim  # noqa: E402

BASE = dict(model="mlp", alpha=0.2, max_dataset=120, rounds=5, k_iters=2,
            eval_every=100)
POLICIES = ["ddsra_jax", "round_robin", "random", "delay_driven"]
V_VALUES, SEEDS, ROUNDS = [0.01, 10.0], [0, 7], 4


@pytest.fixture(scope="module")
def reference():
    r = ref_sim.Simulation(ref_sim.Scenario(
        **BASE, net=RefNetworkConfig(3, 9, 2), policy="ddsra_jax"))
    return dict(
        stats=r.stats,
        single=r.sweep(V_VALUES, seeds=SEEDS, rounds=ROUNDS),
        grid=r.sweep(V_VALUES, seeds=SEEDS, rounds=ROUNDS,
                     policies=POLICIES))


def _scenario(**over):
    return sim.Scenario(**{**BASE, "net": NetworkConfig(3, 9, 2), **over})


def _sim(reference, **over):
    return sim.Simulation(_scenario(**over), reference["stats"],
                          device="cpu")


def _stepwise_rows(reference, **over):
    """(delays, selected, queues) of a stepwise ``reset(seed)`` run."""
    def run(seed, v):
        s = _sim(reference, **over, v=v, rounds=ROUNDS)
        s.reset(seed)
        recs = list(s.rounds())
        return ([r.delay for r in recs],
                np.asarray([r.selected for r in recs]),
                np.asarray([r.queues for r in recs]))
    return run


def _assert_rows(got_taus, got_sel, got_q, want_taus, want_sel, want_q,
                 msg=""):
    np.testing.assert_allclose(got_taus, want_taus, rtol=1e-9, err_msg=msg)
    assert np.array_equal(got_sel, want_sel), msg
    np.testing.assert_allclose(got_q, want_q, atol=1e-12, err_msg=msg)


def test_sweep_matches_stepwise_rows_and_the_reference(reference):
    """Every (seed, v) lane equals the port's stepwise reset(seed) run at
    that V, row for row, and the reference's sweep."""
    s = _sim(reference, policy="ddsra_jax")
    state0 = s.net.rng.bit_generator.state
    res = s.sweep(V_VALUES, seeds=SEEDS, rounds=ROUNDS)
    assert s.net.rng.bit_generator.state == state0   # the live stream kept
    assert isinstance(res, fused_sim.SweepResult) and res.policies is None
    assert res.seeds == SEEDS and res.v_values == V_VALUES
    assert res.taus.shape == (2, 2, ROUNDS)
    assert res.selected.shape == (2, 2, ROUNDS, 3)
    run = _stepwise_rows(reference, policy="ddsra_jax")
    for si, seed in enumerate(SEEDS):
        for vi, v in enumerate(V_VALUES):
            _assert_rows(res.taus[si, vi], res.selected[si, vi],
                         res.queues[si, vi], *run(seed, v),
                         msg=f"seed={seed} v={v}")
    want = reference["single"]
    _assert_rows(res.taus, res.selected, res.queues, want.taus,
                 want.selected, want.queues)


def test_multi_policy_sweep_matches_stepwise_rows_and_the_reference(
        reference):
    """Every (policy, seed, v) lane of the grid equals the stepwise
    ``reset(seed)`` run of that policy at that V (queues bit-identical),
    and the reference's grid; baseline rows repeat across V."""
    s = _sim(reference, policy="ddsra_jax")
    res = s.sweep(V_VALUES, seeds=SEEDS, rounds=ROUNDS, policies=POLICIES)
    assert res.policies == POLICIES
    assert res.taus.shape == (4, 2, 2, ROUNDS)
    for pi, pol in enumerate(POLICIES):
        run = _stepwise_rows(reference, policy=pol)
        for si, seed in enumerate(SEEDS):
            for vi, v in enumerate(V_VALUES):
                taus, sel, queues = run(seed, v)
                _assert_rows(res.taus[pi, si, vi], res.selected[pi, si, vi],
                             res.queues[pi, si, vi], taus, sel, queues,
                             msg=f"{pol} seed={seed} v={v}")
                assert np.array_equal(res.queues[pi, si, vi], queues)
        if pol != "ddsra_jax":
            assert np.array_equal(res.taus[pi, :, 0], res.taus[pi, :, 1])
    want = reference["grid"]
    _assert_rows(res.taus, res.selected, res.queues, want.taus,
                 want.selected, want.queues)


def test_policy_kinds_match_the_reference():
    from repro.core import policy_sweep as ref_policy_sweep
    assert policy_sweep.POLICY_KINDS == ref_policy_sweep.POLICY_KINDS


def test_sweep_requires_traced_decide_policy(reference):
    with pytest.raises(ValueError, match="traced-decide"):
        _sim(reference, policy="loss_driven").sweep([0.01, 1.0])
    with pytest.raises(ValueError, match="traced-decide"):
        _sim(reference, policy="ddsra").sweep([0.01, 1.0])


def test_sweep_refuses_fixed_resource_baselines(reference):
    # round_robin decides on tensors, but a V sweep over it is
    # meaningless: fixed-resource baselines never read V
    with pytest.raises(ValueError, match="V-sweep"):
        _sim(reference, policy="round_robin").sweep([0.01, 1.0])


def test_multi_policy_sweep_refuses_host_policies(reference):
    with pytest.raises(ValueError, match="loss_driven"):
        _sim(reference, policy="ddsra_jax").sweep(
            [0.01], rounds=2, policies=["ddsra_jax", "loss_driven"])


def test_sweep_defaults_to_the_scenario_seed_and_rounds(reference):
    """``seeds=None`` is the scenario seed and ``rounds=None`` its round
    count: the lane is the stepwise ``reset()`` run."""
    s = _sim(reference, policy="ddsra_jax", rounds=3, v=10.0)
    res = s.sweep([10.0])
    assert res.seeds == [0] and res.taus.shape == (1, 1, 3)
    recs = list(s.reset().rounds())
    assert np.array_equal(res.selected[0, 0],
                          np.asarray([r.selected for r in recs]))
    assert np.array_equal(res.queues[0, 0],
                          np.asarray([r.queues for r in recs]))
    assert dataclasses.asdict(res)["policies"] is None
