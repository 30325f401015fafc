"""The port's partition-point bisection (``repro_torch.core.partition``)
and pipeline cut (``repro_torch.launch.pipeline.choose_cut``) against
``repro``'s on the same numpy inputs.

Both packages run the same numpy arithmetic, so every cut must be the
reference's bit for bit (the same int, or both ``None``): on
hypothesis-drawn costs, memories, tiers and boundary traffic under both
objectives, on the infeasible interval, on ``tests/test_launch.py``'s two
``choose_cut`` cases and on all ten archs' cost-model vectors at seq 4096.
The port's ``choose_cut`` defaults are one H100 a stage; every comparison
passes the reference's TPU values explicitly to both packages.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import partition as ref_part  # noqa: E402
from repro.launch import pipeline as ref_pipe  # noqa: E402
from repro_torch import configs as cfg_lib  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import partition as part  # noqa: E402
from repro_torch.launch import pipeline as pipe  # noqa: E402

hyp = pytest.importorskip("hypothesis")
st = hyp.strategies

# the reference's choose_cut defaults: a TPU v5e pod a stage, over ICI
REF_TPU = dict(ici_bw=50e9, throughput=197e12 * 256)


def _tiers(mod, t_b, t_t, cap_b, cap_t):
    return (mod.Tier(throughput=t_b, mem_capacity=cap_b),
            mod.Tier(throughput=t_t, mem_capacity=cap_t))


@hyp.settings(max_examples=120, deadline=None)
@hyp.given(st.integers(1, 24), st.integers(0, 2**31 - 1),
           st.sampled_from([0.4, 0.6, 1.0, 2.0]), st.booleans(),
           st.sampled_from(["serial", "bottleneck"]))
def test_best_partition_is_the_reference_cut(n_layers, seed, mem_frac,
                                             link, objective):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.1, 10, n_layers)
    if seed % 5 == 0:
        costs = np.ones(n_layers)          # exact ties: the tie-break
    mem = rng.uniform(0.1, 5, n_layers)
    caps = mem.sum() * mem_frac * rng.uniform(0.8, 1.2, 2)
    rates = rng.uniform(0.5, 2, 2)
    bb = rng.uniform(0, 3, n_layers + 1) if link else None
    bw = rng.uniform(0.5, 4) if link else np.inf
    for fn in ("best_partition", "brute_force_partition"):
        want = getattr(ref_part, fn)(costs, mem, *_tiers(ref_part, *rates,
                                                         *caps),
                                     boundary_bytes=bb, link_bw=bw,
                                     objective=objective)
        got = getattr(part, fn)(costs, mem, *_tiers(part, *rates, *caps),
                                boundary_bytes=bb, link_bw=bw,
                                objective=objective)
        assert got == want and type(got) is type(want), (fn, got, want)
    lo_hi = part.feasible_interval(mem, *_tiers(part, *rates, *caps))
    assert lo_hi == ref_part.feasible_interval(mem, *_tiers(ref_part, *rates,
                                                            *caps))
    for l in range(n_layers + 1):
        args = (costs, l, *_tiers(part, *rates, *caps),
                np.zeros(n_layers + 1) if bb is None else bb, bw, objective)
        ref_args = (costs, l, *_tiers(ref_part, *rates, *caps)) + args[4:]
        assert part.split_time(*args) == ref_part.split_time(*ref_args)


@hyp.settings(max_examples=80, deadline=None)
@hyp.given(st.integers(2, 24), st.integers(0, 2**31 - 1), st.booleans())
def test_bisection_matches_brute_force(n_layers, seed, tight_mem):
    """The reference's property on the port: the bisection's cut has the
    exact argmin's objective value (here the same cut)."""
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.1, 10, n_layers)
    mem = rng.uniform(0.1, 5, n_layers)
    cap = mem.sum() * (0.6 if tight_mem else 2.0)
    bottom, top = _tiers(part, rng.uniform(0.5, 2), rng.uniform(0.5, 2),
                         cap, cap)
    got = part.best_partition(costs, mem, bottom, top)
    want = part.brute_force_partition(costs, mem, bottom, top)
    if want is None:
        assert got is None
    else:
        bb = np.zeros(n_layers + 1)
        assert part.split_time(costs, got, bottom, top, bb, np.inf) == \
            pytest.approx(part.split_time(costs, want, bottom, top, bb,
                                          np.inf), rel=1e-6)


def test_infeasible_interval():
    costs, mem = np.ones(4), np.ones(4) * 10
    small = part.Tier(throughput=1.0, mem_capacity=1.0)
    assert part.feasible_interval(mem, small, small) == (1, 0)
    assert part.best_partition(costs, mem, small, small) is None
    assert part.brute_force_partition(costs, mem, small, small) is None
    with pytest.raises(ValueError, match="no feasible"):
        pipe.choose_cut(costs, mem, hbm_per_pod=1.0)


def test_choose_cut_launch_cases():
    """``tests/test_launch.py``'s two cases, port against reference."""
    cut = pipe.choose_cut(np.ones(16), np.ones(16), hbm_per_pod=100.0,
                          **REF_TPU)
    assert cut == pipe.PipelineCut(8, 16) and cut.stage_layers == (8, 8)
    assert cut.cut == ref_pipe.choose_cut(np.ones(16), np.ones(16),
                                          hbm_per_pod=100.0).cut
    costs = np.ones(10)
    mem = np.concatenate([np.full(5, 10.0), np.full(5, 1.0)])
    cut = pipe.choose_cut(costs, mem, hbm_per_pod=30.0, **REF_TPU)
    g = np.concatenate([[0], np.cumsum(mem)])
    assert g[cut.cut] <= 30.0 and g[-1] - g[cut.cut] <= 30.0
    assert cut.cut == ref_pipe.choose_cut(costs, mem, hbm_per_pod=30.0).cut
    # the port's defaults (one H100 a stage) cut uniform layers alike
    assert pipe.choose_cut(np.ones(16), np.ones(16),
                           hbm_per_pod=100.0).cut == 8


@pytest.mark.parametrize("arch", cfg_lib.ARCHS)
def test_arch_cuts_are_the_reference_cuts(arch):
    """Every arch's cost-model vector at seq 4096: the reference's cut, in
    ``test_profiles_and_drivers.py``'s balanced band, with ample memory;
    and with one H100 a stage (the port's defaults) and 80 GB."""
    from repro import configs as ref_configs
    from repro.core import costmodel as ref_cm
    layers = cm.arch_layers(cfg_lib.get_config(arch), seq=4096)
    costs, mem = cm.flops_vector(layers), cm.mem_vector(layers, batch=1)
    ref_layers = ref_cm.arch_layers(ref_configs.get_config(arch), seq=4096)
    np.testing.assert_array_equal(costs, ref_cm.flops_vector(ref_layers))
    np.testing.assert_array_equal(mem, ref_cm.mem_vector(ref_layers, batch=1))
    cut = pipe.choose_cut(costs, mem, hbm_per_pod=1e18, **REF_TPU)
    assert cut.cut == ref_pipe.choose_cut(costs, mem, hbm_per_pod=1e18).cut
    c = np.concatenate([[0], np.cumsum(costs)])
    assert 0.25 <= c[cut.cut] / c[-1] <= 0.75, (arch, cut)
    h100 = dict(ici_bw=pipe.NVLINK_BYTES_PER_S,
                throughput=pipe.H100_BF16_FLOPS)
    try:
        want = ref_pipe.choose_cut(costs, mem, hbm_per_pod=80e9, **h100).cut
    except ValueError:
        with pytest.raises(ValueError):
            pipe.choose_cut(costs, mem, hbm_per_pod=80e9)
    else:
        assert pipe.choose_cut(costs, mem, hbm_per_pod=80e9).cut == want
