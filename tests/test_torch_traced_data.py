"""The port's traced data plane against ``repro.fl.data``'s, bit for bit.

``repro_torch.fl.threefry`` reproduces the parts of ``jax.random`` that
``traced_batch_indices`` draws with (threefry2x32, ``PRNGKey``,
``fold_in``, the 32-bit ``uniform``, under JAX 0.9's defaults), so the
port's counter-based draws are the reference's indices exactly, not within
a tolerance: ``traced_batch_indices`` (a hypothesis property over seed,
round, device, pool length and width, widths past the pool included; the
prefix property across widths), ``Simulation.data_key``,
``device_resident_stacks``, ``sample_cohort_batch_traced`` (valid rows
byte-identical, masks and ``slot_of`` identical) and
``CohortEngine._pack_round_meta``, on ``tests/test_fused_sim.py``'s small
MLP network. Also F9 and F11: ``ChannelStateT.of``, ``stack_states`` and
``threefry.prng_key`` default to the card.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.network import NetworkConfig as RefNetworkConfig  # noqa
from repro.fl import data as ref_data  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl import data, sim, threefry  # noqa: E402

BASE = dict(model="mlp", alpha=0.2, max_dataset=120, rounds=5, k_iters=2,
            eval_every=100, data_plane="traced", tiers=2)


@pytest.fixture(scope="module")
def pair():
    """The reference's Simulation and the port's on the same scenario,
    from the reference's statistics."""
    r = ref_sim.Simulation(ref_sim.Scenario(
        **BASE, net=RefNetworkConfig(3, 9, 2)))
    s = sim.Simulation(sim.Scenario(**BASE, net=NetworkConfig(3, 9, 2)),
                       r.stats, device="cpu")
    return r, s


def _ref_indices(seed, t, dev, pool_len, width, l_max):
    return np.asarray(ref_data.traced_batch_indices(
        jax.random.PRNGKey(seed), t, dev, pool_len, width, l_max))


def test_threefry_matches_jax_random():
    """Keys, fold_in, bits and uniform equal jax.random's bit for bit,
    broadcast over a batch of keys at once."""
    seeds = [0, 2, 9, 77, 2 ** 31 + 5]
    datas = [0, 1, 17, 2 ** 32 - 1]
    keys = torch.stack([threefry.prng_key(s, "cpu") for s in seeds])
    for s, k in zip(seeds, keys):
        assert np.array_equal(
            k.numpy(), np.asarray(jax.random.key_data(jax.random.PRNGKey(s))))
    folded = threefry.fold_in(keys[:, None], torch.tensor(datas))   # (5,4,2)
    for i, s in enumerate(seeds):
        for j, d in enumerate(datas):
            want = jax.random.fold_in(jax.random.PRNGKey(s), d)
            assert np.array_equal(folded[i, j].numpy(), np.asarray(want))
            for n in (1, 7, 130):
                assert np.array_equal(
                    threefry.random_bits(folded[i, j], n).numpy(),
                    np.asarray(jax.random.bits(want, (n,))).astype(np.int64))
                u = threefry.uniform(folded[i, j], n)
                assert u.dtype == torch.float32
                assert np.array_equal(
                    u.numpy(), np.asarray(jax.random.uniform(want, (n,))))


@pytest.mark.parametrize("seed", [2, 9])
def test_traced_batch_indices_grid(seed):
    """Rounds 0, 3, 17 x devices 0, 1, 11 x (pool, l_max) in {(40, 50),
    (50, 50), (7, 120)} at widths inside and past the pool, each device
    drawn alone and all three in one vectorized call."""
    devs = [0, 1, 11]
    key = threefry.prng_key(seed, "cpu")
    for t in (0, 3, 17):
        for pool, l_max in ((40, 50), (50, 50), (7, 120)):
            for width in sorted({1, min(pool, 5), pool, l_max}):
                got = data.traced_batch_indices(key, t, devs, pool, width,
                                                l_max)
                assert got.shape == (3, width)
                for i, d in enumerate(devs):
                    want = _ref_indices(seed, t, d, pool, width, l_max)
                    assert np.array_equal(got[i].numpy(), want)
                    assert np.array_equal(
                        data.traced_batch_indices(key, t, d, pool, width,
                                                  l_max).numpy(), want)


def test_traced_batch_indices_property():
    """Bit for bit against the reference over seed, round, device, pool
    length <= l_max and width <= l_max (past the pool included), and a
    narrower draw is a wider one's prefix."""
    pytest.importorskip("hypothesis")  # container may lack hypothesis
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), t=st.integers(0, 500),
           dev=st.integers(0, 64), l_max=st.integers(1, 200),
           more=st.data())
    def prop(seed, t, dev, l_max, more):
        pool = more.draw(st.integers(1, l_max))
        width = more.draw(st.integers(1, l_max))
        key = threefry.prng_key(seed, "cpu")
        got = data.traced_batch_indices(key, t, dev, pool, width,
                                        l_max).numpy()
        assert np.array_equal(got, _ref_indices(seed, t, dev, pool, width,
                                                l_max))
        # without replacement, valid positions first, then the padding in
        # order
        assert len(set(got.tolist())) == width
        assert (got[:min(pool, width)] < pool).all()
        assert np.array_equal(got[pool:], np.arange(pool, width))
        narrow = more.draw(st.integers(1, width))
        assert np.array_equal(
            data.traced_batch_indices(key, t, dev, pool, narrow,
                                      l_max).numpy(), got[:narrow])

    prop()


def test_data_key_matches_reference(pair):
    """``Simulation.data_key`` is the reference's key data, (0, seed + 2),
    and follows ``reset(seed)``."""
    r, s = pair
    assert s.data_key.dtype == torch.int64
    assert np.array_equal(s.data_key.numpy(),
                          np.asarray(jax.random.key_data(r.data_key)))
    assert s.data_key.tolist() == [0, s.scenario.seed + 2]
    s.reset(seed=11)
    try:
        assert s.data_key.tolist() == [0, 13]
    finally:
        s.reset()


def test_device_resident_stacks_match_reference(pair):
    r, s = pair
    x_all, y_all, pool = data.device_resident_stacks(s.ds, device="cpu")
    rx, ry, rpool = ref_data.device_resident_stacks(r.ds)
    assert x_all.device.type == "cpu" and pool.dtype == np.int32
    assert x_all.numpy().tobytes() == rx.tobytes()
    assert y_all.numpy().tobytes() == ry.tobytes()
    assert np.array_equal(pool, rpool)


def test_sample_cohort_batch_traced_matches_reference(pair):
    """Every slot's valid rows byte-identical, masks and ``slot_of``
    identical, at two rounds and three participant sets; no host RNG
    consumed."""
    r, s = pair
    layout = s.engine._layout(s, s.cohort_capacity)
    rlayout = r.engine._layout(r, r.cohort_capacity)
    assert (layout.tier_widths, layout.tier_slots) == \
        (rlayout.tier_widths, rlayout.tier_slots)
    state = s.rng.bit_generator.state
    for t in (0, 3):
        for ids in ([], [4, 1, 7], list(range(s.cohort_capacity))):
            got = data.sample_cohort_batch_traced(
                s.data_key, t, s.ds, ids, s.d_tilde, layout)
            want = ref_data.sample_cohort_batch_traced(
                r.data_key, t, r.ds, ids, r.d_tilde, rlayout)
            assert np.array_equal(got.slot_of, want.slot_of)
            for g, w in zip(got.tiers, want.tiers):
                assert np.array_equal(g.mask, w.mask)
                assert g.x.tobytes() == w.x.tobytes()
                assert g.y.tobytes() == w.y.tobytes()
    assert s.rng.bit_generator.state == state


def test_pack_round_meta_matches_reference(pair):
    r, s = pair
    l_n = np.arange(s.net.cfg.n_devices) % 3
    for trained in ([], [1], [0, 2], [2, 0]):
        got = s.engine._pack_round_meta(s, trained, l_n)
        want = r.engine._pack_round_meta(r, trained, l_n)
        assert got[0] == want[0]
        assert got[1].tier_widths == want[1].tier_widths
        for g, w in zip(got[2:6], want[2:6]):
            assert np.array_equal(g, w)
        assert got[6] == want[6]


def test_channel_state_lifts_default_to_the_card():
    """F9: like every entry point of the port, ``ChannelStateT.of`` and
    ``stack_states`` run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    net = network.Network(network.NetworkConfig(), np.random.default_rng(0))
    st = net.draw()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        network.ChannelStateT.of(st)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        network.stack_states([st])
    assert network.stack_states([st], device="cpu").h_up.device.type == "cpu"


def test_prng_key_defaults_to_the_card():
    """F11: like every entry point of the port, ``threefry.prng_key`` asks
    for the card unless the caller passes ``"cpu"``; ``data_key``, the
    host oracle's key, asks for the CPU explicitly."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        threefry.prng_key(3)
    assert threefry.prng_key(3, "cpu").tolist() == [0, 3]
