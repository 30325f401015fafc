"""The port's token models (FL transformer, FL Mamba-2) against
``repro.models.split_model.SeqSplitModel`` and the reference's token FL
path, on the same numpy weights, tokens and seeds.

On the CPU the reference runs attention through its op's "ref" impl and
the SSD scan through ``ssd_chunked`` (its ``default_impl()`` off the TPU);
the port runs the plain versions of its kernels and its own
``ssd_chunked``. Tolerances: activations, logits, losses, gradients and
params at atol = rtol = 1e-5 (the reference's f32 contract; the two
frameworks sum in different orders); split-vs-unsplit inside the port at
1e-6 (the same operations); the statistics at rtol 1e-4 (norms of
gradient differences over a step of size lr). Control-plane outputs
(costs, datasets, decisions, queues) must be bit-identical.
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

from repro.core import costmodel as ref_cm  # noqa: E402
from repro.fl import data as ref_data  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro.models import split_model as ref_sm  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.fl import data, sim, split  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import split_model as sm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)
MODELS = {"transformer": (ref_sm.FL_TRANSFORMER, sm.FL_TRANSFORMER),
          "ssm": (ref_sm.FL_SSM, sm.FL_SSM)}
N_PARAMS = {"transformer": 98_624, "ssm": 72_216}
SEQ = 32
SC = dict(max_dataset=400, k_iters=2, sigma_samples=2, rounds=2,
          eval_every=2)


def _models(name):
    ref_cfg, cfg = MODELS[name]
    return ref_sm.SeqSplitModel(ref_cfg, SEQ), sm.SeqSplitModel(cfg, SEQ)


def _np_params(name, seed):
    """The reference's init, every leaf perturbed so that norms, biases,
    decay rates and skips are not at their ones/zeros init values."""
    ref_model, _ = _models(name)
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), p)
        for p in ref_model.init(jax.random.PRNGKey(seed))]


def _tokens(b, seed, vocab=128):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, SEQ)).astype(np.int32),
            rng.integers(0, vocab, (b, SEQ)).astype(np.int32))


def _jnp(params):
    return [jax.tree.map(jnp.asarray, p) for p in params]


def _assert_trees_close(got, want, scaled=False, **tol):
    """Leaf by leaf; ``scaled``: atol is relative to the leaf's largest
    magnitude, for gradients whose size the rms norms amplify."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            b = np.asarray(b)
            t = dict(tol)
            if scaled:
                t["atol"] *= max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(np.asarray(a), b, **t)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_structure_params_and_costs_match_reference(name):
    """Configs, blocks, cuts, parameter shapes and pytree leaf order,
    parameter count, and the per-token and per-sequence cost profiles,
    exactly."""
    ref_model, model = _models(name)
    ref_cfg, cfg = MODELS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert model.block_kinds == ref_model.block_kinds
    assert model.valid_cuts == ref_model.valid_cuts and model.min_cut == 1
    assert model.input_kind == "tokens" and model.classes == 128
    ref_p = ref_model.init(jax.random.PRNGKey(0))
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in split.leaves(p)] == \
        [tuple(a.shape) for a in jax.tree.leaves(ref_p)]
    assert sum(t.numel() for t in split.leaves(p)) == N_PARAMS[name]
    for seq, sf in ((SEQ, 4), (64, 2)):
        assert [vars(a) for a in cm.arch_layers(cfg, seq, sf=sf)] == \
            [vars(b) for b in ref_cm.arch_layers(ref_cfg, seq, sf=sf)]
    assert [vars(a) for a in model.layer_costs()] == \
        [vars(b) for b in ref_model.layer_costs()]


def test_token_dataset_byte_identical():
    sizes = np.array([40, 57, 91, 40, 120])
    want = ref_data.make_token_fl_dataset(5, sizes, seq_len=SEQ, chi=0.7,
                                          seed=3)
    got = data.make_token_fl_dataset(5, sizes, seq_len=SEQ, chi=0.7, seed=3)
    for a, b in zip(got.x_dev + got.y_dev + got.classes_of + [got.x_test,
                                                              got.y_test],
                    want.x_dev + want.y_dev + want.classes_of
                    + [want.x_test, want.y_test]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_blocks_forward_loss_and_grads_match_reference(name):
    """Every block on the reference's own input activation, the whole
    forward, the token loss and every parameter gradient (gradients to
    1e-5 of each leaf's largest entry: the rms norms scale the embedding's
    gradient by 1 / rms of its 0.02-scale rows)."""
    ref_model, model = _models(name)
    np_params = _np_params(name, seed=1)
    params = params_from_numpy(model, np_params, device="cpu")
    x, y = _tokens(4, seed=2)
    acts = ref_model.activations(_jnp(np_params), jnp.asarray(x))
    for i in range(model.n_blocks):
        got = model.forward_range(params, torch.from_numpy(np.array(acts[i])),
                                  i, i + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(acts[i + 1]),
                                   **TOL)

    def ref_loss(p):
        return ref_model.loss(ref_model.forward(p, jnp.asarray(x)),
                              jnp.asarray(y))
    r_loss, r_grads = jax.value_and_grad(ref_loss)(_jnp(np_params))
    for t in split.leaves(params):
        t.requires_grad_()
    loss = model.loss(model.forward(params, torch.from_numpy(x)),
                      torch.from_numpy(y))
    grads = torch.autograd.grad(loss, split.leaves(params))
    assert float(loss.detach()) == pytest.approx(float(r_loss), rel=1e-5,
                                                 abs=1e-5)
    _assert_trees_close(params_to_numpy(model, split._like(list(grads),
                                                           params)),
                        r_grads, scaled=True, **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_masked_loss_and_slot_batching(name):
    """masked_loss per slot equals the reference's per model (an empty slot
    gives exactly 0); per-slot and stride-0 shared weights give each slot's
    single-model logits."""
    ref_model, model = _models(name)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, SEQ, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (3, 5, SEQ)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    mask[2] = 0.0
    got = model.masked_loss(*map(torch.from_numpy, (logits, labels, mask)))
    for s in range(2):
        want = ref_model.masked_loss(logits[s], labels[s], mask[s])
        assert float(got[s]) == pytest.approx(float(want), rel=1e-6)
    assert float(got[2]) == 0.0

    slots = [params_from_numpy(model, _np_params(name, seed=s), "cpu")
             for s in range(2)]
    stacked = [{k: torch.stack([p[i][k] for p in slots]) for k in layer}
               for i, layer in enumerate(slots[0])]
    shared = [{k: v.expand(2, *v.shape) for k, v in layer.items()}
              for layer in slots[0]]
    x = torch.from_numpy(np.stack([_tokens(3, seed=s)[0] for s in range(2)]))
    out = model.forward_slots(stacked, x)
    out_shared = model.forward_slots(shared, x)
    for s in range(2):
        torch.testing.assert_close(out[s], model.forward(slots[s], x[s]),
                                   **TOL)
        torch.testing.assert_close(out_shared[s],
                                   model.forward(slots[0], x[s]), **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_step_equals_unsplit_at_every_cut(name):
    _, model = _models(name)
    params = params_from_numpy(model, _np_params(name, seed=5), "cpu")
    x, y = map(torch.from_numpy, _tokens(3, seed=5))
    want, want_loss = split.local_train(model, params, x, y, 0, 1, 0.05)
    for cut in model.valid_cuts:
        got, loss = split.split_sgd_step(model, params, (x, y), cut, 0.05)
        assert float(loss) == pytest.approx(want_loss, rel=1e-6)
        _assert_trees_close(params_to_numpy(model, got),
                            params_to_numpy(model, want),
                            atol=1e-6, rtol=1e-6)


def test_registry_builds_token_models_seeded():
    class Spec:
        seq_len = SEQ
    for name in MODELS:
        model, params, costs = registry.build_fl_model(
            name, torch.Generator().manual_seed(0), Spec, "cpu")
        again = registry.build_fl_model(
            name, torch.Generator().manual_seed(0), Spec, "cpu")[1]
        assert isinstance(model, sm.SeqSplitModel)
        assert len(costs) == model.n_blocks == len(params)
        for a, b in zip(split.leaves(params), split.leaves(again)):
            assert torch.equal(a, b)
    with pytest.raises(KeyError):
        registry.build_fl_model("moe", torch.Generator(), Spec, "cpu")
    if not torch.cuda.is_available():
        # the default device is the card: asking for it without one raises
        with pytest.raises(RuntimeError):
            sm.SeqSplitModel(sm.FL_SSM).init(torch.Generator())


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 2-round token simulation per model, run once."""
    runs = {}

    def get(name):
        if name not in runs:
            s = ref_sim.Simulation(ref_sim.Scenario(model=name, **SC))
            out = dict(sim=s, rng0=s.rng.bit_generator.state, stats=s.stats,
                       params0=[jax.tree.map(np.asarray, p)
                                for p in s.params])
            out["records"] = list(s.rounds())
            out["final"] = [jax.tree.map(np.asarray, p) for p in s.params]
            runs[name] = out
        return runs[name]
    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_simulation_matches_reference(name, reference_runs):
    """Setup draws, dataset, statistics, then two rounds from the
    reference's statistics: decisions, queues and delays bit-identical,
    losses and params to 1e-5."""
    ref = reference_runs(name)
    r = ref["sim"]
    s = sim.Simulation(sim.Scenario(model=name, **SC), device="cpu",
                       init_params=ref["params0"])
    assert s.rng.bit_generator.state == ref["rng0"]
    np.testing.assert_array_equal(s.d_tilde, r.d_tilde)
    np.testing.assert_array_equal(s.ds.x_test, r.ds.x_test)
    for f in dataclasses.fields(s.workload):
        np.testing.assert_array_equal(getattr(s.workload, f.name),
                                      getattr(r.workload, f.name))
    for f in ("sigma", "delta", "lipschitz"):
        np.testing.assert_allclose(getattr(s.stats, f),
                                   getattr(ref["stats"], f), rtol=1e-4)

    s = sim.Simulation(sim.Scenario(model=name, **SC), ref["stats"],
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
        np.testing.assert_allclose(got.losses, want.losses, **TOL)
        assert (got.accuracy is None) == (want.accuracy is None)
        if want.accuracy is not None:
            # per-token accuracy over 256 x 32 test tokens: a near-tie
            # argmax may flip under a few-ulp difference
            assert abs(got.accuracy - want.accuracy) <= 1e-3
    assert any(rec.trained for rec in records)
    _assert_trees_close(params_to_numpy(s.plan, s.params), ref["final"],
                        **TOL)
    assert s.rng.bit_generator.state == r.rng.bit_generator.state
