"""The port's control plane (cost model, network, participation rates,
Hungarian, DDSRA, queues) against ``repro.core`` on the same inputs.

Both are numpy doing the same operations in the same order, so every
comparison here is exact: no tolerance.
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

from repro.core import costmodel as ref_cm  # noqa: E402
from repro.core import ddsra as ref_ddsra  # noqa: E402
from repro.core import hungarian as ref_hung  # noqa: E402
from repro.core import lyapunov as ref_lyap  # noqa: E402
from repro.core import network as ref_net  # noqa: E402
from repro.core import participation as ref_part  # noqa: E402
from repro.core import schedulers as ref_sched  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import ddsra, hungarian, lyapunov  # noqa: E402
from repro_torch.core import network, participation, schedulers  # noqa: E402

eq = np.testing.assert_array_equal


@pytest.mark.parametrize("width", [0.0625, 0.25, 1.0])
def test_cost_vectors_and_workload_equal(width):
    ref_layers = ref_cm.vgg11_layers(width)
    layers = cm.vgg11_layers(width)
    assert [dataclasses.astuple(a) for a in layers] == \
        [dataclasses.astuple(b) for b in ref_layers]
    eq(cm.flops_vector(layers), ref_cm.flops_vector(ref_layers))
    eq(cm.mem_vector(layers, 95), ref_cm.mem_vector(ref_layers, 95))
    assert cm.model_size_bytes(layers) == ref_cm.model_size_bytes(ref_layers)
    assert cm.param_count(layers) == ref_cm.param_count(ref_layers)
    for bits in (None, 16, 8):
        assert cm.upload_bytes(layers, bits) == \
            ref_cm.upload_bytes(ref_layers, bits)
    fl = cm.flops_vector(layers)
    args = (fl, 7, 5, 95, 16.0, 1e9, 32.0, 4e9)
    assert cm.train_time_split(*args) == ref_cm.train_time_split(*args)
    args = (fl, 7, 5, 95, 1e-27, 16.0, 1e9)
    assert cm.train_energy_device(*args) == \
        ref_cm.train_energy_device(*args)
    assert cm.train_energy_gateway(*args) == \
        ref_cm.train_energy_gateway(*args)
    d_tilde = np.arange(4, 16, dtype=float)
    w = ddsra.Workload(fl, cm.mem_vector(layers, 95),
                       cm.upload_bytes(layers, None), 5, d_tilde)
    rw = ref_ddsra.Workload(ref_cm.flops_vector(ref_layers),
                            ref_cm.mem_vector(ref_layers, 95),
                            ref_cm.upload_bytes(ref_layers, None), 5,
                            d_tilde)
    for f in dataclasses.fields(w):
        eq(getattr(w, f.name), getattr(rw, f.name))


TOPOLOGIES = [
    dict(),
    dict(n_gateways=5, n_channels=5, n_devices=15),
    dict(n_gateways=8, n_channels=4, n_devices=26),
]


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_network_draws_identical(topo):
    net = network.Network(network.NetworkConfig(**topo),
                          np.random.default_rng(3))
    rnet = ref_net.Network(ref_net.NetworkConfig(**topo),
                           np.random.default_rng(3))
    for name in ("dist", "f_dev", "assign", "a"):
        eq(getattr(net, name), getattr(rnet, name))
    assert net.h0 == rnet.h0 and net.n0 == rnet.n0
    for _ in range(4):
        st, rst = net.draw(), rnet.draw()
        for f in dataclasses.fields(st):
            eq(getattr(st, f.name), getattr(rst, f.name))
    st = net.draw()
    rst = rnet.draw()
    assert net.uplink_time(0, 1, 0.1, 1e6, st) == \
        rnet.uplink_time(0, 1, 0.1, 1e6, rst)
    assert net.downlink_time(1, 0, 1e6, st) == \
        rnet.downlink_time(1, 0, 1e6, rst)


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


@pytest.mark.parametrize("width", [0.25, 1.0])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_ddsra_rounds_bit_identical(topo, width):
    """Several DDSRA rounds through each package's policy registry: every
    decision field, every per-(gateway, channel) solution and the queues."""
    cfg = dict(topo)
    net = network.Network(network.NetworkConfig(**cfg),
                          np.random.default_rng(0))
    rnet = ref_net.Network(ref_net.NetworkConfig(**cfg),
                           np.random.default_rng(0))
    w, rw = _workloads(net.cfg.n_devices, width, seed=1)
    gamma = participation.participation_rates(
        np.random.default_rng(2).uniform(0.5, 2, net.cfg.n_gateways),
        net.cfg.n_channels)
    pol = schedulers.make_policy("ddsra", seed=0)
    rpol = ref_sched.make_policy("ddsra", seed=0)
    q = np.zeros(net.cfg.n_gateways)
    rq = q.copy()
    for t in range(4):
        dec = pol.schedule(schedulers.RoundContext(
            t, w, net, net.draw(), q, gamma, 0.01))
        rdec = rpol.schedule(ref_sched.RoundContext(
            t, rw, rnet, rnet.draw(), rq, gamma, 0.01))
        _assert_decisions_equal(dec, rdec)
        q, rq = dec.queues, rdec.queues


def test_participation_rates_and_bound_equal():
    rng = np.random.default_rng(4)
    n, m = 12, 6
    assign = np.arange(n) % m
    stats = dict(sigma=rng.uniform(1, 20, n), delta=rng.uniform(5, 30, n),
                 lipschitz=rng.uniform(0.1, 120, n),
                 d_tilde=rng.integers(4, 100, n).astype(float))
    for beta, k in ((0.01, 5), (0.05, 2)):
        phi = participation.divergence_bound(
            participation.DataStats(**stats), assign, beta, k)
        rphi = ref_part.divergence_bound(ref_part.DataStats(**stats), assign,
                                         beta, k)
        eq(phi, rphi)
        for j in (1, 3, 6):
            eq(participation.participation_rates(phi, j),
               ref_part.participation_rates(rphi, j))
    g1, g2 = rng.normal(size=50), rng.normal(size=50)
    assert participation.estimate_lipschitz(g1, g2, g2, g1) == \
        ref_part.estimate_lipschitz(g1, g2, g2, g1)
    per = rng.normal(size=(8, 50))
    assert participation.estimate_sigma(per, per.mean(0)) == \
        ref_part.estimate_sigma(per, per.mean(0))


@pytest.mark.parametrize("shape", [(3, 6), (4, 4), (5, 8)])
def test_hungarian_and_queues_equal(shape):
    rng = np.random.default_rng(5)
    for _ in range(5):
        cost = rng.normal(size=shape)
        col, total = hungarian.hungarian_min(cost)
        rcol, rtotal = ref_hung.hungarian_min(cost)
        eq(col, rcol)
        assert total == rtotal
        eq(hungarian.assign_channels(cost.T), ref_hung.assign_channels(cost.T))
    q = rng.uniform(0, 2, shape[0])
    sel = rng.random(shape[0]) < 0.5
    gam = rng.uniform(0, 1, shape[0])
    eq(lyapunov.update_queues(q, sel, gam),
       ref_lyap.update_queues(q, sel, gam))
    eq(lyapunov.update_queues_realized(q, sel, gam),
       ref_lyap.update_queues_realized(q, sel, gam))
    assert lyapunov.drift_plus_penalty(0.1, 2.0, q, sel) == \
        ref_lyap.drift_plus_penalty(0.1, 2.0, q, sel)
    hist = rng.random((7, shape[0])) < 0.5
    eq(lyapunov.queue_stability_gap(hist, gam),
       ref_lyap.queue_stability_gap(hist, gam))
