"""The port's MoE FFN (``repro_torch.models.moe``) and the FL MoE model
(``Scenario(model="moe")``) against ``repro.models.moe`` and the
reference's token FL path, on the same numpy weights, tokens and seeds.

Tolerances: the FFN's output, f32, at 1e-5 of its largest magnitude; bf16
at one bf16 ulp per element plus 1e-5 of that magnitude (inputs on a
coarse dyadic grid, so the router logits are exact in either summation
order and every routing decision is the reference's); gradients at 1e-5
of each leaf's largest entry; a 2-round simulation's decisions, cuts and
queues identical, its statistics at rtol 1e-4, losses and params at 1e-5
(bf16: the reference's bf16 contract, losses 5e-2 and params 3e-2, as
``tests/test_mixed_precision.py`` holds its own bf16 runs). Routing
(``capacity``, the top-k with its ties, the ranks that decide the drops)
must be exact.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core import costmodel as ref_cm  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro.models import model as ref_model_lib  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl import cohort, sim, split  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)
SEQ = 32
SC = dict(model="moe", max_dataset=400, k_iters=2, sigma_samples=2,
          rounds=2, eval_every=2)
EK = [(4, 1), (4, 2), (8, 4)]
# (capacity_factor, dispatch_groups): no drops (capacity >= every group's
# token count), drops at capacity factors 0.1-0.5, two dispatch groups
ROUTING = {"no-drops": (None, 1), "drops-0.1": (0.1, 1),
           "drops-0.3": (0.3, 1), "drops-0.5": (0.5, 1),
           "groups-2": (1.25, 2), "groups-2-drops": (0.3, 2)}


def _cfgs(e, k, cf, groups):
    cf = e / k if cf is None else cf          # capacity >= tokens: no drop
    return (RefMoEConfig(n_experts=e, top_k=k, capacity_factor=cf,
                         dispatch_groups=groups),
            MoEConfig(n_experts=e, top_k=k, capacity_factor=cf,
                      dispatch_groups=groups))


def _ffn_inputs(e, seed, b=3, s=16, d=32, f=24, grid=None):
    """x (b, s, d) and the FFN's params, numpy f32; ``grid``: every value
    a multiple of 1/grid in [-1, 1], exact in bf16 (so are the router
    logits' products and sums, in any order)."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale):
        a = rng.normal(size=shape) * scale
        if grid is not None:
            a = np.clip(np.round(a * grid), -grid, grid) / grid
        return a.astype(np.float32)
    x = draw((b, s, d), 1.0)
    params = dict(router=draw((d, e), 0.5), w1=draw((e, d, f), 0.2),
                  w3=draw((e, d, f), 0.2), w2=draw((e, f, d), 0.2))
    return x, params


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _jnp(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def test_capacity_matches_reference_over_a_grid():
    for n in (1, 7, 8, 32, 95 * 32, 256 * 32, 100 * 32, 3040, 12345):
        for e, k in EK + [(64, 8)]:
            for cf in (0.1, 0.5, 1.0, 1.25, 2.0):
                rc, c = _cfgs(e, k, cf, 1)
                assert moe.capacity(n, c) == ref_moe.capacity(n, rc)
    # the FL model's two statistics shapes: a device's 95 x 32 tokens, one
    # sample's 32 (capacity 24)
    fl = sm.FL_MOE.moe
    assert moe.capacity(32, fl) == 24
    assert moe.capacity(95 * 32, fl) == ref_moe.capacity(95 * 32,
                                                         ref_sm.FL_MOE.moe)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_router_topk_breaks_exact_ties_as_lax_top_k(dtype):
    """Exact ties pick the lower expert first, as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order): rows of equal logits, pairs and
    triples of ties at every rank, and bf16 logits on a coarse grid, where
    ties are common at E = 4."""
    rows = [[1, 1, 1, 1], [0, 2, 2, 1], [3, 3, 0, 3], [0, 0, 5, 0],
            [-1, 2, -1, 2], [7, 7, 7, 6], [0.5, 0.25, 0.5, 0.25]]
    rng = np.random.default_rng(0)
    rows += (np.round(rng.normal(size=(200, 4)) * 2) / 2).tolist()
    logits = np.asarray(rows, np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    for k in (1, 2, 3, 4):
        want_g, want_i = ref_moe.router_topk(jnp.asarray(logits, jdt), k)
        got_g, got_i = moe.router_topk(torch.from_numpy(logits).to(tdt), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_g.dtype == torch.float32
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("routing", sorted(ROUTING))
@pytest.mark.parametrize("e,k", EK, ids=[f"e{e}k{k}" for e, k in EK])
def test_moe_ffn_matches_reference_f32(e, k, routing):
    cf, groups = ROUTING[routing]
    rc, c = _cfgs(e, k, cf, groups)
    x, p = _ffn_inputs(e, seed=e * 10 + k)
    want = np.asarray(ref_moe.moe_ffn(jnp.asarray(x), _jnp(p), rc))
    got = moe.moe_ffn(_torch(x), _torch(p), c).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # the cases hold what they say: a group's k entries a token outnumber
    # its experts' cells (a drop, by pigeonhole) or fit in one expert's
    tg = x.shape[0] * x.shape[1] // groups
    cap = moe.capacity(tg, c)
    if routing == "no-drops":
        assert cap >= tg
    elif routing.startswith("drops"):
        assert tg * k > e * cap


@pytest.mark.parametrize("routing", ["no-drops", "drops-0.3", "groups-2"])
@pytest.mark.parametrize("e,k", EK, ids=[f"e{e}k{k}" for e, k in EK])
def test_moe_ffn_matches_reference_bf16(e, k, routing):
    """bf16 activations and weights, as the bf16 plane casts them: logits
    bf16 before the f32 top-k, the gate cast to bf16 before the multiply,
    the combine summed in bf16."""
    cf, groups = ROUTING[routing]
    rc, c = _cfgs(e, k, cf, groups)
    x, p = _ffn_inputs(e, seed=e * 10 + k + 1, grid=8)
    want = np.asarray(ref_moe.moe_ffn(jnp.asarray(x, jnp.bfloat16),
                                      _jnp(p, jnp.bfloat16), rc)
                      .astype(jnp.float32))
    got = moe.moe_ffn(_torch(x, torch.bfloat16), _torch(p, torch.bfloat16),
                      c)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    # one bf16 ulp of each element (2^-7 of its binade) plus 1e-5 of scale
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp + 1e-5 * scale).all(), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("routing", ["no-drops", "drops-0.3", "groups-2"])
@pytest.mark.parametrize("e,k", EK, ids=[f"e{e}k{k}" for e, k in EK])
def test_moe_ffn_gradients_match_jax_grad(e, k, routing):
    """Gradients of x, router, w1, w3 and w2 against ``jax.grad`` of the
    same loss, at 1e-5 of each leaf's largest entry."""
    cf, groups = ROUTING[routing]
    rc, c = _cfgs(e, k, cf, groups)
    x, p = _ffn_inputs(e, seed=e * 10 + k + 2)
    probe = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def ref_loss(xx, pp):
        return jnp.sum(ref_moe.moe_ffn(xx, pp, rc) * probe)
    gx, gp = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), _jnp(p))
    xt = _torch(x).requires_grad_()
    pt = {n: v.requires_grad_() for n, v in _torch(p).items()}
    loss = (moe.moe_ffn(xt, pt, c) * torch.from_numpy(probe)).sum()
    names = sorted(pt)
    grads = torch.autograd.grad(loss, [xt] + [pt[n] for n in names])
    for name, got, want in zip(["x"] + names, grads,
                               [gx] + [gp[n] for n in names]):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)


@pytest.mark.parametrize("shared", [False, True], ids=["per-slot",
                                                       "stride-0"])
def test_slot_batched_form_is_a_per_slot_loop(shared):
    """``moe_ffn_slots`` on (S, B, seq, D) with per-slot weights (or one
    weight set as stride-0 views) equals ``moe_ffn`` slot by slot: each
    slot is its own routing group, whatever the others route."""
    c = MoEConfig(n_experts=4, top_k=2, capacity_factor=0.5)
    slots = [_ffn_inputs(4, seed=20 + i) for i in range(3)]
    x = torch.stack([_torch(xs) for xs, _ in slots])
    if shared:
        p = {n: v.expand(3, *v.shape) for n, v in _torch(slots[0][1]).items()}
    else:
        p = {n: torch.stack([_torch(ps[n]) for _, ps in slots])
             for n in slots[0][1]}
    got = moe.moe_ffn_slots(x, p, c)
    for i in range(3):
        want = moe.moe_ffn(x[i], {n: v[i] for n, v in p.items()}, c)
        assert torch.equal(got[i], want)
    # a slot's output does not depend on another slot's tokens
    x2 = x.clone()
    x2[1] = 0.0
    got2 = moe.moe_ffn_slots(x2, p, c)
    assert torch.equal(got2[0], got[0]) and torch.equal(got2[2], got[2])


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (64, 2))
    want = float(ref_moe.aux_load_balance_loss(jnp.asarray(logits),
                                               jnp.asarray(idx), 8))
    got = float(moe.aux_load_balance_loss(torch.from_numpy(logits),
                                          torch.from_numpy(idx), 8))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the FL MoE model
# ---------------------------------------------------------------------------


def _models():
    return ref_sm.SeqSplitModel(ref_sm.FL_MOE, SEQ), \
        sm.SeqSplitModel(sm.FL_MOE, SEQ)


def _np_params(seed):
    ref_model, _ = _models()
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), p)
        for p in ref_model.init(jax.random.PRNGKey(seed))]


def _templates_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _templates_equal(got[k], want[k])
        return
    assert (got.shape, got.axes, got.init) == (want.shape, want.axes,
                                               want.init)


def test_fl_moe_template_structure_and_costs_match_reference():
    """``FL_MOE`` is the reference's config; its template leaf for leaf
    (shapes, logical axes, init kinds: the router ``"small"``), its
    blocks, cuts, parameter count, and ``layer_costs`` (all experts
    resident gateway-side) exactly."""
    ref_model, model = _models()
    assert dataclasses.asdict(sm.FL_MOE) == dataclasses.asdict(ref_sm.FL_MOE)
    _templates_equal(model_lib.build_template(sm.FL_MOE),
                     ref_model_lib.build_template(ref_sm.FL_MOE))
    assert model.block_kinds == ref_model.block_kinds
    assert model.valid_cuts == ref_model.valid_cuts and model.min_cut == 1
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    ref_p = ref_model.init(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in split.leaves(p)] == \
        [tuple(a.shape) for a in jax.tree.leaves(ref_p)]
    assert sum(t.numel() for t in split.leaves(p)) == 140_096
    for seq, sf in ((SEQ, 4), (64, 2)):
        assert [vars(a) for a in cm.arch_layers(sm.FL_MOE, seq, sf=sf)] == \
            [vars(b) for b in ref_cm.arch_layers(ref_sm.FL_MOE, seq, sf=sf)]
    costs = model.layer_costs()
    assert [vars(a) for a in costs] == \
        [vars(b) for b in ref_model.layer_costs()]
    assert sum(c.kind == "moe_ffn" for c in costs) == 2
    # the carry across: the MoE leaves round-trip through convert
    np_p = _np_params(4)
    back = params_to_numpy(model, params_from_numpy(model, np_p, "cpu"))
    for g, w in zip(back, np_p):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert np.array_equal(a, b)


def test_fl_moe_blocks_forward_and_grads_match_reference():
    """Every block on the reference's own input activation, and every
    parameter gradient of the token loss, at 1e-5 (gradients of each
    leaf's largest entry)."""
    ref_model, model = _models()
    np_params = _np_params(1)
    params = params_from_numpy(model, np_params, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 128, (4, SEQ)).astype(np.int32)
    y = rng.integers(0, 128, (4, SEQ)).astype(np.int32)
    jp = [jax.tree.map(jnp.asarray, p) for p in np_params]
    acts = ref_model.activations(jp, jnp.asarray(x))
    for i in range(model.n_blocks):
        got = model.forward_range(params, torch.from_numpy(np.array(acts[i])),
                                  i, i + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(acts[i + 1]),
                                   **TOL)

    def ref_loss(p):
        return ref_model.loss(ref_model.forward(p, jnp.asarray(x)),
                              jnp.asarray(y))
    r_loss, r_grads = jax.value_and_grad(ref_loss)(jp)
    for t in split.leaves(params):
        t.requires_grad_()
    loss = model.loss(model.forward(params, torch.from_numpy(x)),
                      torch.from_numpy(y))
    grads = torch.autograd.grad(loss, split.leaves(params))
    assert float(loss.detach()) == pytest.approx(float(r_loss), rel=1e-5,
                                                 abs=1e-5)
    got = params_to_numpy(model, split._like(list(grads), params))
    for g, w in zip(got, r_grads):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            b = np.asarray(b)
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * max(float(np.abs(b).max()), 1.0))


def test_accuracy_routes_each_chunk_as_one_group():
    """``SplitModel.accuracy`` and the fused loop's ``_eval_hits`` route
    each 256-row chunk as one group, the last one (44 rows) unpadded, as
    the reference's evaluation does: the same hits."""
    ref_model, model = _models()
    np_params = _np_params(6)
    params = params_from_numpy(model, np_params, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.integers(0, 128, (300, SEQ)).astype(np.int32)
    y = rng.integers(0, 128, (300, SEQ)).astype(np.int32)
    want = ref_model.accuracy([jax.tree.map(jnp.asarray, p)
                               for p in np_params], x, y)
    got = model.accuracy(params, x, y)
    assert abs(got - want) <= 1e-3          # a near-tie argmax may flip
    hits = cohort._eval_hits(model, params, torch.from_numpy(x),
                             torch.from_numpy(y))
    assert int(hits) == round(got * y.size)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 2-round MoE simulation per dtype, run once."""
    runs = {}

    def get(dtype):
        if dtype not in runs:
            s = ref_sim.Simulation(ref_sim.Scenario(dtype=dtype, **SC))
            out = dict(sim=s, rng0=s.rng.bit_generator.state, stats=s.stats,
                       params0=[jax.tree.map(np.asarray, p)
                                for p in s.params])
            out["records"] = list(s.rounds())
            out["final"] = [jax.tree.map(np.asarray, p) for p in s.params]
            runs[dtype] = out
        return runs[dtype]
    return get


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_simulation_matches_reference(dtype, reference_runs):
    """Setup draws and statistics (f32: the statistics pass routes per
    device and per sample), then two rounds from the reference's
    statistics: decisions, cuts, queues and delays bit-identical, losses
    and params at 1e-5 (bf16: the bf16 contract)."""
    ref = reference_runs(dtype)
    r = ref["sim"]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else None
    if dtype == "f32":
        s = sim.Simulation(sim.Scenario(**SC), device="cpu",
                           init_params=ref["params0"])
        assert s.rng.bit_generator.state == ref["rng0"]
        for f in ("sigma", "delta", "lipschitz"):
            np.testing.assert_allclose(getattr(s.stats, f),
                                       getattr(ref["stats"], f), rtol=1e-4)
    s = sim.Simulation(sim.Scenario(dtype=dtype, **SC), ref["stats"],
                       device="cpu", init_params=ref["params0"])
    s.rng.bit_generator.state = ref["rng0"]
    records = list(s.rounds())
    assert len(records) == len(ref["records"]) == SC["rounds"]
    for got, want in zip(records, ref["records"]):
        np.testing.assert_array_equal(got.selected, want.selected)
        assert got.trained == want.trained
        np.testing.assert_array_equal(got.l_n, want.l_n)
        assert got.delay == want.delay and got.cum_delay == want.cum_delay
        np.testing.assert_array_equal(got.queues, want.queues)
        if tol:
            np.testing.assert_allclose(got.losses, want.losses, **tol)
        else:
            np.testing.assert_allclose(got.losses, want.losses, atol=5e-2)
        assert (got.accuracy is None) == (want.accuracy is None)
        if want.accuracy is not None:
            assert abs(got.accuracy - want.accuracy) <= (
                1e-3 if tol else 2e-2)
    assert any(rec.trained for rec in records)
    got = params_to_numpy(s.plan, s.params)
    for g, w in zip(got, ref["final"]):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            if tol:
                np.testing.assert_allclose(a, b, **tol)
            else:
                np.testing.assert_allclose(a, b, atol=3e-2)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state


@pytest.fixture
def one_thread():
    """One CPU thread: the token embedding's backward (an accumulating
    index_put) sums in a thread-dependent order on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_rounds_bit_identical_to_stepwise(dtype, one_thread):
    """``fused_rounds`` on ``moe`` leaves the stepwise loop's records and
    params bit for bit on the CPU (each round eager there, the same
    operations in the same order; the fused loop carries losses in f32,
    so they are compared as f32)."""
    sc = sim.Scenario(model="moe", dtype=dtype, alpha=0.05, max_dataset=200,
                      rounds=3, k_iters=1, sigma_samples=2, eval_every=3,
                      policy="round_robin", net=NetworkConfig(3, 6, 2))
    a = sim.Simulation(sc, device="cpu")
    recs_a = list(a.rounds())
    b = sim.Simulation(sc, a.stats, device="cpu")
    b.rng.bit_generator.state = a._rng_state0
    recs_b = b.fused_rounds()
    assert len(recs_b) == 3 and any(r.trained for r in recs_a)
    for ra, rb in zip(recs_a, recs_b):
        assert ra.trained == rb.trained
        assert np.array_equal(ra.l_n, rb.l_n)
        assert np.array_equal(ra.queues, rb.queues)
        assert np.array_equal(ra.losses.astype(np.float32),
                              rb.losses.astype(np.float32))
        assert ra.accuracy == rb.accuracy
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
