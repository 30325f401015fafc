"""The port's fused round loop (``Simulation.fused_rounds``, ``run_fused``,
``repro_torch.fl.fused_sim``) against its own stepwise loop and against
``repro``'s fused loop, on ``tests/test_fused_sim.py``'s small MLP network
(3 gateways, 9 devices, 2 channels, 5 rounds, K = 2), cohort engine.

Tolerances are the reference's (``tests/test_fused_sim.py``): ``selected``,
``trained``, ``l_n``, failures, queues and both RNG streams identical,
delays at rtol 1e-9, losses at 1e-5 (the fused loop carries them in f32,
as the reference's scan does), params at 1e-5 of each leaf's largest entry
(f32; bf16 at the reference's bf16 contract, losses 5e-2 and params 3e-2),
and accuracies on eval rounds identical on the CPU. Against the reference
the port starts from the reference's statistics, weights and batch stream.
On the CPU every step runs eagerly: no CUDA graph is captured here.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core.network import NetworkConfig as RefNetworkConfig  # noqa
from repro.fl import fused_sim as ref_fused  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.fl.fused_sim import RoundTelemetry  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

BASE = dict(model="mlp", alpha=0.2, max_dataset=120, rounds=5, k_iters=2,
            eval_every=100)
TOL = {"f32": dict(losses=1e-5, params=1e-5),
       "bf16": dict(losses=5e-2, params=3e-2)}


def _scenario(**over):
    return sim.Scenario(**{**BASE, "net": NetworkConfig(3, 9, 2), **over})


def _ref_scenario(**over):
    return ref_sim.Scenario(**{**BASE, "net": RefNetworkConfig(3, 9, 2),
                               **over})


def _stepwise(sc, n=None):
    s = sim.Simulation(sc, device="cpu")
    gen = s.rounds()
    return s, [next(gen) for _ in range(sc.rounds if n is None else n)]


def _assert_records(recs_a, recs_b, *, losses=1e-5, accuracy=True):
    assert len(recs_a) == len(recs_b)
    for a, b in zip(recs_a, recs_b):
        assert a.t == b.t
        assert np.array_equal(a.selected, b.selected), a.t
        assert list(a.trained) == list(b.trained), a.t
        assert np.array_equal(a.l_n, b.l_n), a.t
        assert b.delay == pytest.approx(a.delay, rel=1e-9), a.t
        assert b.cum_delay == pytest.approx(a.cum_delay, rel=1e-9), a.t
        assert np.array_equal(a.queues, b.queues), a.t
        np.testing.assert_allclose(b.losses, a.losses, atol=losses)
        assert a.failures == b.failures, a.t
        assert a.aggregations == b.aggregations, a.t
        if accuracy:
            assert a.accuracy == b.accuracy, a.t


def _np(params):
    """Leaves of the port's or the reference's params, as f64 numpy."""
    if isinstance(params, list) and params and isinstance(params[0], dict):
        return [np.asarray(p[k], np.float64) for p in params
                for k in sorted(p)]
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(params)]


def _assert_params(got, want, rel):
    for g, w in zip(_np(got), _np(want)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30)


def _assert_end_state(a, b, *, params=1e-5):
    """Queues and both RNG streams identical, t and delay_sum, params."""
    assert np.array_equal(a.queues, b.queues)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert a.net.rng.bit_generator.state == b.net.rng.bit_generator.state
    assert a.t == b.t
    assert b.delay_sum == pytest.approx(a.delay_sum, rel=1e-9)
    _assert_params(b.params, a.params, params)


# ---------------------------------------------------------------------------
# fused against the port's own stepwise loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["ddsra_jax", "round_robin",
                                    "delay_driven"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_matches_stepwise(policy, dtype):
    sc = _scenario(policy=policy, dtype=dtype)
    a, recs_a = _stepwise(sc)
    b = sim.Simulation(sc, device="cpu")
    captures = dict(graphs.CAPTURE_COUNTS)
    recs_b = b.fused_rounds()
    assert graphs.CAPTURE_COUNTS == captures     # eager on the CPU
    assert any(r.trained for r in recs_b)
    _assert_records(recs_a, recs_b, losses=TOL[dtype]["losses"])
    _assert_end_state(a, b, params=TOL[dtype]["params"])
    assert b.padding_stats == a.padding_stats


def test_fused_in_scan_eval_matches_stepwise():
    """The ``eval_every`` rounds, and the last, evaluate inside the block
    with the stepwise loop's hit counts; ``run_fused`` folds the same
    :class:`FLResult` as ``run``."""
    sc = _scenario(policy="ddsra_jax", eval_every=2)
    a, recs_a = _stepwise(sc)
    b = sim.Simulation(sc, device="cpu")
    recs_b = b.fused_rounds()
    assert [r.t for r in recs_b if r.accuracy is not None] == [1, 3, 4]
    _assert_records(recs_a, recs_b)
    res_a, res_b = a.reset().run(), b.reset().run_fused()
    assert res_a.accuracy == res_b.accuracy and res_b.acc_rounds == [2, 4, 5]
    np.testing.assert_allclose(res_b.cum_delay, res_a.cum_delay, rtol=1e-9)
    assert np.array_equal(res_a.participation, res_b.participation)
    np.testing.assert_allclose(res_b.losses, res_a.losses, atol=1e-5)


@pytest.mark.parametrize("policy", ["ddsra_jax", "delay_driven"])
def test_fused_matches_stepwise_traced_data_plane(policy):
    """The traced plane: the fused scan's gathers from the resident stacks
    equal the stepwise loop's host oracle, and neither touches the batch
    RNG."""
    sc = _scenario(policy=policy, data_plane="traced", eval_every=2)
    a, recs_a = _stepwise(sc)
    b = sim.Simulation(sc, device="cpu")
    state = b.rng.bit_generator.state
    recs_b = b.fused_rounds()
    assert b.rng.bit_generator.state == state
    _assert_records(recs_a, recs_b)
    _assert_end_state(a, b)
    assert b.padding_stats == a.padding_stats


def test_fused_and_stepwise_blocks_interleave():
    sc = _scenario(rounds=6)
    a, recs_a = _stepwise(sc)
    b = sim.Simulation(sc, device="cpu")
    recs_b = b.fused_rounds(rounds=3)             # fused block ...
    gen = b.rounds()
    recs_b += [next(gen) for _ in range(2)]       # ... stepwise block ...
    recs_b += b.fused_rounds(rounds=1)            # ... fused again
    assert b.fused_rounds() == []                 # nothing left
    _assert_records(recs_a, recs_b)
    _assert_end_state(a, b)


def test_fused_resume_from_checkpoint(tmp_path):
    """A checkpoint saved after a fused block resumes into the fused path
    (the same state exactly) and into the stepwise one."""
    sc = _scenario(rounds=6, policy="ddsra_jax")
    s = sim.Simulation(sc, device="cpu")
    recs = s.fused_rounds(rounds=3)
    s.save(tmp_path, block=True)
    recs_a = recs + s.fused_rounds()

    f = sim.Simulation.resume(tmp_path, device="cpu")
    _assert_records(recs_a, recs + f.fused_rounds())
    _assert_end_state(s, f, params=0.0)

    w = sim.Simulation.resume(tmp_path, device="cpu")
    gen = w.rounds()
    _assert_records(recs_a, recs + [next(gen) for _ in range(3)])
    _assert_end_state(s, w)


# ---------------------------------------------------------------------------
# against the reference's fused loop, and checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["host", "traced"])
def test_fused_matches_reference(plane):
    over = dict(policy="ddsra_jax", eval_every=2, data_plane=plane)
    r = ref_sim.Simulation(_ref_scenario(**over))
    params0 = jax.tree.map(np.asarray, r.params)
    rng0 = r.rng.bit_generator.state
    recs_r = r.fused_rounds()
    s = sim.Simulation(_scenario(**over), r.stats, device="cpu",
                       init_params=params0)
    s.rng.bit_generator.state = rng0
    recs_s = s.fused_rounds()
    assert [x.t for x in recs_s if x.accuracy is not None] == [1, 3, 4]
    _assert_records(recs_r, recs_s)
    _assert_params(params_to_numpy(s.plan, s.params), r.params, 1e-5)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state
    assert s.net.rng.bit_generator.state == r.net.rng.bit_generator.state
    assert np.array_equal(s.queues, r.queues) and s.t == r.t
    np.testing.assert_allclose(s.losses, r.losses, atol=1e-5)


@pytest.mark.parametrize("plane", ["host", "traced"])
def test_checkpoint_after_fused_block_crosses_packages(tmp_path, plane):
    """Either package resumes the other's checkpoint taken after a fused
    block, and continues it (fused) as the saving package does."""
    over = dict(rounds=6, policy="ddsra_jax", data_plane=plane)
    r = ref_sim.Simulation(_ref_scenario(**over))
    r.fused_rounds(rounds=3)
    r.save(tmp_path / "ref", block=True)
    tail_r = r.fused_rounds()
    s = sim.Simulation.resume(tmp_path / "ref", device="cpu")
    _assert_records(tail_r, s.fused_rounds())
    _assert_params(params_to_numpy(s.plan, s.params), r.params, 1e-5)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state

    p = sim.Simulation(_scenario(**over), device="cpu")
    p.fused_rounds(rounds=3)
    p.save(tmp_path / "port", block=True)
    tail_p = p.fused_rounds()
    q = ref_sim.Simulation.resume(tmp_path / "port")
    _assert_records(tail_p, q.fused_rounds())
    _assert_params(q.params, params_to_numpy(p.plan, p.params), 1e-5)
    assert q.net.rng.bit_generator.state == p.net.rng.bit_generator.state


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_fused_refuses_loss_driven_policy():
    s = sim.Simulation(_scenario(policy="loss_driven"), device="cpu")
    with pytest.raises(ValueError, match="reads_losses"):
        s.fused_rounds()
    # refused before any stream was consumed
    assert s.net.rng.bit_generator.state == s._net_rng_state0


def test_fused_refuses_sequential_engine():
    s = sim.Simulation(_scenario(engine="sequential"), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="'sequential' has no fused scan path"):
        s.fused_rounds()
    assert s.net.rng.bit_generator.state == s._net_rng_state0


def test_traced_plane_refused_off_cohort_engines():
    with pytest.raises(ValueError, match="data_plane"):
        sim.Simulation(_scenario(engine="sequential", data_plane="traced"),
                       device="cpu")
    assert sim.ENGINES["cohort"].supports_traced_data
    assert not sim.ENGINES["sequential"].supports_fused


# ---------------------------------------------------------------------------
# RoundTelemetry
# ---------------------------------------------------------------------------


def _random_telemetry(rng, t, m, n) -> RoundTelemetry:
    trained = rng.random((t, m)) < 0.5
    aggs = trained.any(axis=1).astype(int)
    delay = np.where(aggs > 0, rng.random(t), 0.0)
    return RoundTelemetry(
        t=np.arange(t), selected=rng.random((t, m)) < 0.7, trained=trained,
        l_n=rng.integers(0, 4, (t, n)), delay=delay,
        cum_delay=np.cumsum(delay), queues=rng.random((t, m)),
        losses=rng.random((t, m)), failures=rng.integers(0, 2, t),
        aggregations=aggs,
        staleness_mean=np.where(aggs > 0, rng.random(t), 0.0),
        staleness_max=np.zeros(t, int), stale_discarded=np.zeros(t, int),
        dropped_devices=np.zeros(t, int), lost_devices=np.zeros(t, int),
        straggler_devices=np.zeros(t, int), buffer_fill=np.zeros(t, int),
        inflight=np.zeros(t, int))


def _check_telemetry(tel: RoundTelemetry):
    recs = tel.to_records()
    assert all(isinstance(r.delay, float) and isinstance(r.failures, int)
               and isinstance(r.queues, np.ndarray) for r in recs)
    back = RoundTelemetry.from_records(recs)
    for name, a, b in zip(RoundTelemetry._fields, tel, back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    quiet = np.asarray(tel.aggregations) == 0
    assert (np.asarray(tel.delay)[quiet] == 0.0).all()
    assert (np.asarray(tel.staleness_mean)[quiet] == 0.0).all()


def test_telemetry_roundtrip_fixed_seeds():
    for seed in range(5):
        rng = np.random.default_rng(seed)
        _check_telemetry(_random_telemetry(
            rng, t=int(rng.integers(1, 8)), m=int(rng.integers(1, 5)),
            n=int(rng.integers(1, 9))))


def test_telemetry_roundtrip_property():
    pytest.importorskip("hypothesis")  # container may lack hypothesis
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), t=st.integers(1, 10),
           m=st.integers(1, 6), n=st.integers(1, 12))
    def prop(seed, t, m, n):
        _check_telemetry(_random_telemetry(np.random.default_rng(seed),
                                           t, m, n))

    prop()


def test_telemetry_from_real_records():
    """from_records over a real stepwise stream gives the fused stream's
    mask form and back, as the reference's does."""
    _, recs = _stepwise(_scenario(policy="ddsra_jax"))
    back = RoundTelemetry.from_records(recs).to_records()
    for a, b in zip(recs, back):
        assert a.t == b.t and a.trained == b.trained
        assert np.array_equal(a.queues, b.queues) and a.delay == b.delay
    assert RoundTelemetry._fields == ref_fused.RoundTelemetry._fields
    assert [f.name for f in dataclasses.fields(sim.RoundRecord)] == [
        f.name for f in dataclasses.fields(ref_sim.RoundRecord)]
