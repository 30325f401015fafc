"""The paper's four baseline policies (random, round robin, loss-driven,
delay-driven) in the port against ``repro.core.schedulers``.

Both packages are numpy doing the same operations in the same order, so
every decision is compared exactly: on one ``RoundContext`` at a time
(the assignment, the selected gateways, Lambda, tau, the queues and every
``GatewaySolution`` field), and over three rounds of ``Simulation.run``
on the narrow VGG and the FL transformer, where the picks and queues are
exact and the losses, which the two data planes sum in different orders,
agree to the reference's f32 contract (atol = rtol = 1e-5). The
loss-driven policy sorts on those losses; with this seed no near-tie
flips a pick.
"""
import dataclasses
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import costmodel as ref_cm  # noqa: E402
from repro.core import ddsra as ref_ddsra  # noqa: E402
from repro.core import network as ref_net  # noqa: E402
from repro.core import schedulers as ref_sched  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import ddsra, network, participation  # noqa: E402
from repro_torch.core import schedulers  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

eq = np.testing.assert_array_equal
BASELINES = ["random", "round_robin", "loss_driven", "delay_driven"]
TOPOLOGIES = [
    dict(),
    dict(n_gateways=5, n_channels=5, n_devices=15),
    dict(n_gateways=8, n_channels=4, n_devices=26),
]


def _workloads(n_devices, width, seed):
    rng = np.random.default_rng(seed)
    d_tilde = np.maximum(
        (rng.uniform(0, 2000, n_devices) * 0.05).astype(int), 4).astype(float)
    out = []
    for mod, wl in ((cm, ddsra.Workload), (ref_cm, ref_ddsra.Workload)):
        layers = mod.vgg11_layers(width_mult=width)
        out.append(wl(mod.flops_vector(layers), mod.mem_vector(layers, 50),
                      mod.model_size_bytes(layers), 5, d_tilde))
    return out


def _assert_decisions_equal(dec, rdec):
    for name in ("assignment", "selected", "lam", "queues"):
        eq(getattr(dec, name), getattr(rdec, name))
    assert dec.delay == rdec.delay
    assert dec.solutions.keys() == rdec.solutions.keys()
    for key, sol in dec.solutions.items():
        rsol = rdec.solutions[key]
        for f in dataclasses.fields(sol):
            eq(getattr(sol, f.name), getattr(rsol, f.name))


def test_registry_names_the_reference_policies():
    """Every policy the reference registers is registered, with the same
    constructor kwargs (``ddsra_jax`` also takes the device its batched
    control plane runs on); the SCHEDULERS view lists them all, and the
    same policies decide on tensors (``traced_decide``)."""
    names = set(ref_sched.POLICIES)
    assert set(schedulers.POLICIES) == names == set(schedulers.SCHEDULERS)
    for name in names:
        extra = ("device",) if name == "ddsra_jax" else ()
        assert schedulers.POLICIES[name].kwargs == \
            ref_sched.POLICIES[name].kwargs + extra
        assert getattr(schedulers.POLICIES[name].cls, "traced_decide",
                       False) == getattr(ref_sched.POLICIES[name].cls,
                                         "traced_decide", False), name
    assert schedulers.LossDrivenScheduler.reads_losses


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("policy", BASELINES)
def test_baseline_rounds_bit_identical(policy, topo):
    """Four rounds on the same network draws, queues and losses through
    each package's registry: every decision field and every solution."""
    net = network.Network(network.NetworkConfig(**topo),
                          np.random.default_rng(0))
    rnet = ref_net.Network(ref_net.NetworkConfig(**topo),
                           np.random.default_rng(0))
    w, rw = _workloads(net.cfg.n_devices, 0.25, seed=1)
    m = net.cfg.n_gateways
    gamma = participation.participation_rates(
        np.random.default_rng(2).uniform(0.5, 2, m), net.cfg.n_channels)
    pol = schedulers.make_policy(policy, seed=5)
    rpol = ref_sched.make_policy(policy, seed=5)
    q, rq = np.zeros(m), np.zeros(m)
    losses = np.random.default_rng(3).uniform(0.5, 2.5, (4, m))
    for t in range(4):
        dec = pol.schedule(schedulers.RoundContext(
            t, w, net, net.draw(), q, gamma, 0.01, losses=losses[t]))
        rdec = rpol.schedule(ref_sched.RoundContext(
            t, rw, rnet, rnet.draw(), rq, gamma, 0.01, losses=losses[t]))
        _assert_decisions_equal(dec, rdec)
        assert dec.selected.sum() == net.cfg.n_channels
        q, rq = dec.queues, rdec.queues


def test_random_policy_rng_round_trips_through_policy_state():
    """The random policy's generator is its state: saved (JSON) after a
    round and loaded into a differently seeded policy, the next picks
    match, and match the reference's."""
    net = network.Network(network.NetworkConfig(), np.random.default_rng(0))
    w, _ = _workloads(net.cfg.n_devices, 0.25, seed=1)
    gamma = np.full(net.cfg.n_gateways, 0.5)
    ctx = schedulers.RoundContext(0, w, net, net.draw(),
                                  np.zeros(net.cfg.n_gateways), gamma, 0.01)
    pol = schedulers.make_policy("random", seed=7)
    rpol = ref_sched.make_policy("random", seed=7)
    pol.schedule(ctx)
    rpol.rng.choice(net.cfg.n_gateways, size=net.cfg.n_channels,
                    replace=False)
    state = json.loads(json.dumps(schedulers.policy_state(pol)))
    assert state == ref_sched.policy_state(rpol)
    other = schedulers.make_policy("random", seed=99)
    schedulers.set_policy_state(other, state)
    eq(other.schedule(ctx).selected, pol.schedule(ctx).selected)
    assert schedulers.policy_state(other) == schedulers.policy_state(pol)
    assert schedulers.policy_state(schedulers.make_policy("round_robin")) \
        is None


RUN = dict(max_dataset=400, k_iters=2, sigma_samples=2, rounds=3,
           eval_every=3)
MODELS = {"vgg": dict(width_mult=0.0625), "transformer":
          dict(model="transformer")}


@pytest.fixture(scope="module")
def references():
    """One reference Simulation per model, built once; each policy's run
    starts from ``reset()``, its fresh state."""
    return {name: ref_sim.Simulation(ref_sim.Scenario(**RUN, **kw))
            for name, kw in MODELS.items()}


@pytest.mark.parametrize("policy", BASELINES)
@pytest.mark.parametrize("model", list(MODELS))
def test_simulation_run_matches_reference(references, model, policy):
    """Three rounds of ``Simulation.run(policy)`` from the reference's
    weights, statistics and batch stream: identical participation, delays,
    failures and queues; losses and params to 1e-5."""
    r = references[model].reset()
    p0 = jax.tree.map(np.array, r.params)
    rng0 = r.rng.bit_generator.state
    want = r.run(policy)
    s = sim.Simulation(sim.Scenario(**RUN, **MODELS[model]), r.stats,
                       device="cpu", init_params=p0)
    s.rng.bit_generator.state = rng0
    got = s.run(policy)
    eq(got.participation, want.participation)
    assert got.cum_delay == want.cum_delay
    assert got.failures == want.failures
    eq(s.queues, r.queues)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.losses, r.losses, atol=1e-5, rtol=1e-5)
    assert got.participation.any()
    got_p = params_to_numpy(s.plan, s.params)
    assert jax.tree.structure(got_p) == jax.tree.structure(
        jax.tree.map(np.asarray, r.params))
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(r.params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state
