"""The batched control plane (``repro_torch.core.ddsra_batched``, the
batched Hungarian, the baselines' scans) against the port's numpy oracle
and against ``repro.core.ddsra_jax`` / ``baseline_jax`` on the same inputs.

Tolerances are the reference's own (``tests/test_ddsra_jax.py``):
assignments, selected sets, finite masks and per-device cuts on assigned
pairs identical; Lambda (finite entries) and tau within atol 1e-6, rtol
1e-9; ``f_gw`` rtol 1e-6; ``p_tx`` 1e-6 relative; queues bit-identical
given identical selections (the same f64 Eq. (14) in the same order).
The batched Hungarian must return the numpy oracle's assignment, not
merely an optimal one.
"""
import dataclasses
import itertools

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import costmodel as ref_cm  # noqa: E402
from repro.core import ddsra as ref_ddsra  # noqa: E402
from repro.core import hungarian as ref_hung  # noqa: E402
from repro.core import network as ref_net  # noqa: E402
from repro.core.baseline_jax import BaselinePlan as RefBaselinePlan  # noqa
from repro.core.ddsra_jax import DDSRAPlan as RefDDSRAPlan  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import ddsra, ddsra_batched, hungarian  # noqa: E402
from repro_torch.core import lyapunov, network, schedulers  # noqa: E402
from repro_torch.core.baseline_batched import BaselinePlan  # noqa: E402
from repro_torch.core.ddsra_batched import DDSRAPlan  # noqa: E402
from repro_torch.core.participation import participation_rates  # noqa
from repro_torch.fl import sim  # noqa: E402
from repro_torch.models.vgg import mlp_layer_costs  # noqa: E402

PSI = 1e18
# the reference's three shapes: the paper default, M == J, and a ragged
# shop floor (26 devices over 8 gateways)
CONFIGS = [
    dict(),
    dict(n_gateways=5, n_channels=5, n_devices=15),
    dict(n_gateways=8, n_channels=4, n_devices=26),
]


def _workloads(n_devices: int, seed: int):
    """The reference test's MLP workload, built by each package."""
    from repro.models.vgg import mlp_layer_costs as ref_mlp_layer_costs
    rng = np.random.default_rng(seed)
    d_tilde = np.maximum(
        (rng.uniform(0, 2000, n_devices) * 0.05).astype(int), 4).astype(float)
    out = []
    for mod, costs, wl in ((cm, mlp_layer_costs, ddsra.Workload),
                           (ref_cm, ref_mlp_layer_costs, ref_ddsra.Workload)):
        layers = costs((3072, 512, 512, 10))
        out.append(wl(mod.flops_vector(layers), mod.mem_vector(layers, 50),
                      mod.model_size_bytes(layers), 5, d_tilde))
    return out


def _setup(ci: int):
    cfg = CONFIGS[ci]
    net = network.Network(network.NetworkConfig(**cfg),
                          np.random.default_rng(100 + ci))
    rnet = ref_net.Network(ref_net.NetworkConfig(**cfg),
                           np.random.default_rng(100 + ci))
    w, rw = _workloads(net.cfg.n_devices, seed=ci)
    gamma = participation_rates(
        np.random.default_rng(ci).uniform(0.5, 2, net.cfg.n_gateways),
        net.cfg.n_channels)
    return net, rnet, w, rw, gamma


def _assert_round_parity(dec, got):
    """The reference's parity contract between one oracle round ``dec``
    and one batched round ``got``."""
    assert np.array_equal(dec.assignment, got.assignment)
    assert np.array_equal(dec.selected, got.selected)
    finite = np.isfinite(dec.lam)
    assert np.array_equal(finite, np.isfinite(got.lam))
    np.testing.assert_allclose(got.lam[finite], dec.lam[finite], atol=1e-6,
                               rtol=1e-9)
    assert abs(dec.delay - got.delay) <= 1e-6
    for key, sol in dec.solutions.items():
        solg = got.solutions.get(key)
        if solg is None:          # the batched dict keeps assigned pairs
            assert dec.assignment[key] == 0
            continue
        assert sol.feasible == solg.feasible
        assert np.array_equal(sol.l_split, solg.l_split)
        np.testing.assert_allclose(solg.f_gw, sol.f_gw, rtol=1e-6)
        assert abs(sol.p_tx - solg.p_tx) <= 1e-6 * max(sol.p_tx, 1)


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_round_parity_with_oracle_and_reference(ci):
    """18 rounds at V in {0.01, 10, 1000} on each network: the batched
    round against the port's numpy ``ddsra_round`` (queues bit-identical)
    and against the reference's ``DDSRAPlan.round`` on the same host
    states."""
    net, rnet, w, rw, gamma = _setup(ci)
    plan = DDSRAPlan.build(w, net, device="cpu")
    ref_plan = RefDDSRAPlan.build(rw, rnet)
    q = qb = qr = np.zeros(net.cfg.n_gateways)
    for t in range(18):
        st = net.draw()
        rnet.draw()
        v = [0.01, 10.0, 1000.0][t % 3]
        dec = ddsra.ddsra_round(w, net, st, q, gamma, v)
        got = plan.round(st, qb, gamma, v)
        want = ref_plan.round(st, qr, gamma, v)
        _assert_round_parity(dec, got)
        _assert_round_parity(want, got)
        assert np.array_equal(got.queues, dec.queues)
        np.testing.assert_allclose(got.queues, want.queues, atol=1e-9)
        q, qb, qr = dec.queues, got.queues, want.queues
    assert plan.captures == 0           # the CPU runs the round eagerly


def test_round_arrays_are_float64_on_the_plan_device():
    """Precision contract: the control plane is f64 whatever the data
    plane's dtype, and the raw arrays carry a lane axis of 1."""
    net, _, w, _, gamma = _setup(0)
    plan = DDSRAPlan.build(w, net, device="cpu")
    out = plan.round_arrays(net.draw(), np.zeros(net.cfg.n_gateways), gamma,
                            10.0)
    m, j = net.cfg.n_gateways, net.cfg.n_channels
    assert out.lam.shape == (1, m, j) and out.lam.dtype == torch.float64
    assert out.queues.dtype == torch.float64
    assert out.l.shape == (1, m, j, plan.n_max) and out.l.dtype == torch.long
    assert plan.statics.cumf.dtype == torch.float64


# ---------------------------------------------------------------------------
# the batched Hungarian
# ---------------------------------------------------------------------------


def _brute_force_min(cost: np.ndarray) -> float:
    r, c = cost.shape
    return min(sum(cost[i, p[i]] for i in range(r))
               for p in itertools.permutations(range(c), r))


_JIT_HUNGARIAN = jax.jit(ref_hung.hungarian_min_jax)


def _check_hungarian(cost: np.ndarray) -> None:
    cols_np, total_np = hungarian.hungarian_min(cost)
    # a batch of two lanes, the second the first's transpose-free copy
    cols_t, total_t = hungarian.hungarian_min_t(
        torch.as_tensor(cost)[None].expand(2, *cost.shape))
    with jax.experimental.enable_x64():
        cols_jx, _ = _JIT_HUNGARIAN(cost)
    for lane in range(2):
        assert np.array_equal(cols_t[lane].numpy(), cols_np)
    assert np.array_equal(cols_np, np.asarray(cols_jx))
    assert float(total_t[0]) == pytest.approx(total_np, abs=1e-9)
    assert total_np == pytest.approx(_brute_force_min(cost), rel=1e-12,
                                     abs=1e-9)


def test_hungarian_t_matches_numpy_jax_and_bruteforce():
    """Random R <= C <= 6 matrices with ties and PSI-masked cells."""
    rng = np.random.default_rng(0)
    for trial in range(30):
        r = int(rng.integers(1, 5))
        c = int(rng.integers(r, 6))
        cost = rng.uniform(0, 10, (r, c))
        if trial % 3 == 1:
            cost = np.round(cost)            # many equal-cost optima
        elif trial % 3 == 2:
            cost[rng.uniform(size=cost.shape) < 0.3] = PSI
        _check_hungarian(cost)


def test_hungarian_t_property():
    """Hypothesis: R <= C up to 6 x 8, small integer costs (ties) and PSI
    entries; the assignment is the numpy oracle's and the reference's,
    and its cost the brute-force minimum."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @st.composite
    def costs(draw):
        r = draw(st.integers(1, 6))
        c = draw(st.integers(r, 8))
        cells = st.one_of(st.integers(0, 4).map(float), st.just(PSI),
                          st.floats(0, 10, allow_nan=False))
        return np.asarray(draw(st.lists(cells, min_size=r * c,
                                        max_size=r * c)),
                          np.float64).reshape(r, c)

    @hyp.settings(max_examples=25, deadline=None, derandomize=True)
    @hyp.given(costs())
    def check(cost):
        _check_hungarian(cost)

    check()


def test_assign_channels_t_parity():
    """The oracle's exact 0/1 incidence matrix, batched over lanes,
    including fully PSI-banned gateways."""
    rng = np.random.default_rng(1)
    for trial in range(20):
        m = int(rng.integers(2, 7))
        j = int(rng.integers(1, m + 1))
        thetas = rng.normal(size=(3, m, j))
        if trial % 2:
            thetas[rng.uniform(size=thetas.shape) < 0.25] = PSI
            thetas[:, rng.integers(m), :] = PSI
        eyes = hungarian.assign_channels_t(torch.as_tensor(thetas)).numpy()
        for theta, eye in zip(thetas, eyes):
            assert np.array_equal(eye, hungarian.assign_channels(theta))
            assert (eye.sum(axis=0) == 1).all() and \
                (eye.sum(axis=1) <= 1).all()


def test_first_wins_matches_the_sequential_pick():
    """Pointer doubling replays the oracle's first-wins / 1e-12 scan,
    objectives within 1e-12 of each other included."""
    rng = np.random.default_rng(2)
    for k in (1, 2, 3, 7, 18, 40):
        ok = rng.uniform(size=(64, k)) < 0.6
        obj = 1.0 + rng.integers(-3, 4, (64, k)) * 0.6e-12
        # the longest chain: every cap ok, each beating the last
        ok[0], obj[0] = True, 1.0 - np.arange(k) * 1e-9
        best, found = ddsra_batched._first_wins(torch.as_tensor(ok),
                                                torch.as_tensor(obj))
        for lane in range(64):
            pick, best_obj = None, None
            for i in range(k):
                if ok[lane, i] and (pick is None
                                    or obj[lane, i] < best_obj - 1e-12):
                    pick, best_obj = i, obj[lane, i]
            assert bool(found[lane]) == (pick is not None)
            if pick is not None:
                assert int(best[lane]) == pick


# ---------------------------------------------------------------------------
# resolution, the queue twin and the tensor channel state
# ---------------------------------------------------------------------------


def test_resolve_decision_arrays_matches_host_resolution():
    """The device resolution equals ``resolve_decision`` on the host,
    lane by lane, on rounds with and without failures."""
    net, _, w, _, gamma = _setup(2)
    plan = DDSRAPlan.build(w, net, device="cpu")
    gateways = [sim.Gateway(m, [sim.Device(int(n), m, 1, 1)
                                for n in net.devices_of(m)])
                for m in range(net.cfg.n_gateways)]
    q = np.zeros(net.cfg.n_gateways)
    for t in range(6):
        st = net.draw()
        out = plan.round_arrays(st, q, gamma, 10.0)
        res = ddsra_batched.resolve_decision_arrays(plan.statics, out,
                                                    net.cfg.n_devices)
        dec = plan.round(st, q, gamma, 10.0)
        trained, l_n, gw_delay, failures = sim.resolve_decision(
            dec, gateways, net.cfg.n_devices)
        assert sorted(np.flatnonzero(res.trained[0]).tolist()) == trained
        assert np.array_equal(res.l_dev[0].numpy(), l_n)
        assert int(res.failures[0]) == failures
        want = np.zeros(net.cfg.n_gateways)
        for m, d in gw_delay.items():
            want[m] = d
        assert np.array_equal(res.gw_delay[0].numpy(), want)
        assert float(res.delay[0]) == (max(gw_delay.values())
                                       if gw_delay else 0.0)
        q = dec.queues


def test_queue_twin_and_state_lifts():
    rng = np.random.default_rng(3)
    q, sel, gamma = rng.uniform(0, 2, 6), rng.uniform(size=6) < 0.5, \
        rng.uniform(0, 1, 6)
    assert np.array_equal(
        lyapunov.update_queues_t(torch.as_tensor(q), torch.as_tensor(sel),
                                 torch.as_tensor(gamma)).numpy(),
        lyapunov.update_queues(q, sel, gamma))
    net = network.Network(network.NetworkConfig(), np.random.default_rng(0))
    states = [net.draw() for _ in range(3)]
    stacked = network.stack_states(states, device="cpu")
    ref = ref_net.stack_states(states)
    for a, b in zip(stacked, ref):
        assert a.dtype == torch.float64 and np.array_equal(a.numpy(), b)
    one = network.ChannelStateT.of(states[1], device="cpu")
    for a, b in zip(one, ref_net.ChannelStateT.of(states[1])):
        assert np.array_equal(a.numpy(), b)


def test_draw_state_law_and_shapes():
    """The device draw: (rounds, ...) leaves in path's dtype, the same
    distributions as ``Network.draw`` (means within 5 %), reproducible
    from a generator seed."""
    cfg = network.NetworkConfig()
    net = network.Network(cfg, np.random.default_rng(0))
    w, _ = _workloads(cfg.n_devices, 0)
    path = DDSRAPlan.build(w, net, device="cpu").statics.path

    def draw(seed):
        return network.draw_state(
            torch.Generator().manual_seed(seed), path, cfg.n_channels,
            cfg.n_devices, e_dev_max=cfg.e_dev_max, e_gw_max=cfg.e_gw_max,
            i_up_var=cfg.interference_up_var,
            i_down_var=cfg.interference_down_var, shape=(4000,))

    st = draw(0)
    assert st.h_up.shape == (4000, cfg.n_gateways, cfg.n_channels)
    assert st.e_dev.shape == (4000, cfg.n_devices)
    assert st.e_gw.dtype == torch.float64
    for a, b in zip(st, draw(0)):
        assert torch.equal(a, b)
    np.testing.assert_allclose((st.h_up / path[:, None]).mean().item(), 1.0,
                               rtol=0.05)
    np.testing.assert_allclose(st.e_dev.mean().item(), cfg.e_dev_max / 2,
                               rtol=0.05)
    np.testing.assert_allclose(
        st.i_up.mean().item(),
        np.sqrt(cfg.interference_up_var) * np.sqrt(2 / np.pi), rtol=0.05)


# ---------------------------------------------------------------------------
# the baselines' scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
@pytest.mark.parametrize("policy", ["round_robin", "random", "delay_driven"])
def test_baseline_decide_scan_matches_stepwise(policy, ci):
    """``BaselinePlan.decide_scan`` (the delay-driven pick computed in each
    round) against the stepwise host policy resolved by
    ``resolve_decision``, and against the reference's ``decide_scan``:
    selections, trained sets, cuts and failures identical, delays at rtol
    1e-9, queues bit-identical."""
    net, rnet, w, rw, gamma = _setup(ci)
    rounds = 6
    states = [net.draw() for _ in range(rounds)]
    pol = schedulers.make_policy(policy, seed=5)
    chosen = pol.traced_chosen(0, rounds, net)
    plan = pol.plan_for(w, net, device="cpu")
    assert isinstance(plan, BaselinePlan) and plan is pol.plan_for(
        w, net, device="cpu")
    q0 = np.zeros(net.cfg.n_gateways)
    got = plan.decide_scan(network.stack_states(states, device="cpu"), q0,
                           gamma, 10.0, chosen=chosen)
    ref = RefBaselinePlan.build(rw, rnet).decide_scan(
        ref_net.stack_states(states), q0, gamma, 10.0, chosen=chosen)

    host = schedulers.make_policy(policy, seed=5)
    gateways = [sim.Gateway(m, [sim.Device(int(n), m, 1, 1)
                                for n in net.devices_of(m)])
                for m in range(net.cfg.n_gateways)]
    q = q0
    for t, st in enumerate(states):
        dec = host.schedule(schedulers.RoundContext(
            t, w, net, st, q, gamma, 10.0))
        trained, l_n, gw_delay, failures = sim.resolve_decision(
            dec, gateways, net.cfg.n_devices)
        assert np.array_equal(got.selected[t].numpy(), dec.selected)
        assert np.flatnonzero(got.trained[t]).tolist() == sorted(trained)
        assert np.array_equal(got.l_dev[t].numpy(), l_n)
        assert int(got.failures[t]) == failures
        np.testing.assert_allclose(float(got.tau[t]), dec.delay, rtol=1e-9)
        np.testing.assert_allclose(
            float(got.delay[t]),
            max(gw_delay.values()) if gw_delay else 0.0, rtol=1e-9)
        assert np.array_equal(got.queues[t].numpy(), dec.queues)
        q = dec.queues
    for name in ("selected", "trained", "l_dev", "failures"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    for name in ("delay", "tau", "gw_delay", "queues"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, err_msg=name)


def test_ddsra_decide_scan_matches_stepwise_rounds():
    """``DDSRAPlan.decide_scan`` threads the queues through the rounds as
    the stepwise ``round`` loop does."""
    net, _, w, _, gamma = _setup(1)
    states = [net.draw() for _ in range(5)]
    plan = DDSRAPlan.build(w, net, device="cpu")
    got = plan.decide_scan(network.stack_states(states, device="cpu"),
                           np.zeros(net.cfg.n_gateways), gamma, 10.0)
    q = np.zeros(net.cfg.n_gateways)
    for t, st in enumerate(states):
        dec = plan.round(st, q, gamma, 10.0)
        assert np.array_equal(got.selected[t].numpy(), dec.selected)
        assert float(got.tau[t]) == dec.delay
        assert np.array_equal(got.queues[t].numpy(), dec.queues)
        q = dec.queues


# ---------------------------------------------------------------------------
# the registry, the stepwise Simulation and Theorem 2's V sweep
# ---------------------------------------------------------------------------


def test_ddsra_jax_policy_defaults_to_cuda_and_takes_the_sim_device():
    pol = schedulers.make_policy("ddsra_jax")
    assert pol.device == "cuda" and pol.traced_decide
    assert schedulers.POLICIES["ddsra_jax"].kwargs == ("device",)
    cpu = schedulers.make_policy("ddsra_jax", seed=3, device="cpu")
    net, _, w, _, _ = _setup(0)
    plan = cpu.plan_for(w, net)
    assert plan is cpu.plan_for(w, net) and plan.device.type == "cpu"


def test_simulation_policy_parity():
    """A Simulation under ``policy="ddsra_jax"`` reproduces the oracle's
    round telemetry: selected, trained and cuts exactly, delay to 1e-6,
    queues bit-identical, losses to 1e-9 (the same trained sets give the
    same data plane)."""
    s = sim.Simulation(sim.Scenario(model="mlp", rounds=4, eval_every=2,
                                    seed=0, max_dataset=400, k_iters=2,
                                    sigma_samples=2), device="cpu")
    oracle = list(s.reset().rounds("ddsra"))
    batched = list(s.reset().rounds("ddsra_jax"))
    assert len(oracle) == len(batched) == 4
    assert any(r.trained for r in oracle)
    for a, b in zip(oracle, batched):
        assert np.array_equal(a.selected, b.selected)
        assert a.trained == b.trained
        assert np.array_equal(a.l_n, b.l_n)
        assert abs(a.delay - b.delay) <= 1e-6
        assert np.array_equal(a.queues, b.queues)
        np.testing.assert_allclose(b.losses, a.losses, atol=1e-9)
        assert a.accuracy == b.accuracy


def _theorem2_plan():
    cfg = network.NetworkConfig()
    net = network.Network(cfg, np.random.default_rng(0))
    w, _ = _workloads(cfg.n_devices, 0)
    gamma = participation_rates(
        np.random.default_rng(2).uniform(0.5, 2, cfg.n_gateways),
        cfg.n_channels)
    return DDSRAPlan.build(w, net, device="cpu"), gamma


def test_simulate_v_sweep_reproducible_and_equal_to_sweep_states():
    """From a generator seed: the same (taus, selected) twice, and the same
    as ``sweep_states`` over the trajectory that seed draws."""
    plan, gamma = _theorem2_plan()
    s, c = plan.statics, plan.statics.cfg
    v_values, rounds = [0.01, 100.0], 12
    taus, sel = plan.simulate_v_sweep(torch.Generator().manual_seed(4),
                                      gamma, v_values, rounds)
    assert taus.shape == (2, rounds)
    assert sel.shape == (2, rounds, plan.n_gateways) and sel.dtype == bool
    taus2, sel2 = plan.simulate_v_sweep(torch.Generator().manual_seed(4),
                                        gamma, v_values, rounds)
    assert np.array_equal(taus, taus2) and np.array_equal(sel, sel2)
    states = network.draw_state(
        torch.Generator().manual_seed(4), s.path, plan.n_channels,
        plan.n_devices, e_dev_max=c.e_dev_max, e_gw_max=c.e_gw_max,
        i_up_var=c.i_up_var, i_down_var=c.i_down_var, shape=(rounds,))
    taus3, sel3, _ = plan.sweep_states(states.map(lambda x: x[None]),
                                       gamma, v_values)
    assert np.array_equal(taus3[0], taus) and np.array_equal(sel3[0], sel)


def test_simulate_v_sweep_theorem2_direction():
    """Small V honours the participation targets (rates >= Gamma - 0.2),
    as the reference's V sweep does."""
    plan, gamma = _theorem2_plan()
    taus, sel = plan.simulate_v_sweep(None, gamma, [0.01, 100.0], rounds=40)
    assert taus.shape == (2, 40) and np.isfinite(taus).all()
    rates = sel[0].mean(axis=0)
    assert (rates >= gamma - 0.2).all(), (rates, gamma)


def test_scenario_json_names_the_registry_policy():
    sc = sim.Scenario(policy="ddsra_jax")
    assert sim.Scenario.from_json(sc.to_json()) == sc
    assert dataclasses.replace(sc, policy="ddsra").policy == "ddsra"
