"""The LM training side of the port (``repro_torch.optim``,
``repro_torch.data.lm``, ``repro_torch.launch.train``) against ``repro``'s.

Optimizers and schedules: three steps on the same gradients, within 1e-6
relative to each leaf's largest magnitude. Token streams: bit-identical.
The training step: three steps of the port's ``make_step`` against the
reference's step, built here from its public pieces as
``src/repro/launch/train.py`` builds it, from the reference's params on
the same batches: losses, gradient norms, both AdamW moments and params
within 1e-5 (each leaf at its largest magnitude). One exception, which
AdamW itself makes: where an element's bias-corrected second-moment root
lies within a few times the 1e-5 contract of zero (below APART_ROOT of
the leaf's largest) at some step, its gradient is of the size of the
contract's rounding, and ``m / (sqrt(v) + eps)`` turns that rounding into
a change of the step's direction there; such an element's param is held
within APART_ATOL from that step on (its largest difference from the
reference, 4.4e-6, is carried by the later steps; a step of the wrong
sign moves it by about 2 x the learning rate, 1.2e-4 at the first step).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import load_pytree as ref_load_pytree  # noqa: E402
from repro.data import LMStream as RefLMStream  # noqa: E402
from repro.models import get_bundle as ref_get_bundle  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.data import LMStream, markov_stream  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import get_bundle  # noqa: E402
from repro_torch.models.convert import tree_from_numpy  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402

OPT_RTOL = 1e-6
STEP_RTOL = 1e-5
# the step test's set-apart elements: second-moment roots below 3 x
# STEP_RTOL of the leaf's largest, params within 1e-5 absolute
APART_ROOT = 3 * STEP_RTOL
APART_ATOL = 1e-5


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _walk(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _close(got, want, rtol, what="", apart=None, apart_atol=0.0):
    """Every leaf of ``got`` (tensors) within ``rtol`` of ``want``'s
    (arrays) largest magnitude; the elements ``apart[path]`` marks within
    ``apart_atol`` instead."""
    got, want = dict(_walk(got)), dict(_walk(want))
    assert set(got) == set(want), what
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(
            g, np.float32)
        assert g.shape == w.shape, (what, path)
        diff = np.abs(g - w)
        mask = (apart or {}).get(path, np.zeros(w.shape, bool))
        err = diff[~mask].max() if (~mask).any() else 0.0
        assert err <= rtol * max(np.abs(w).max(), 1e-30), (what, path, err)
        if mask.any():
            assert diff[mask].max() <= apart_atol, (what, path,
                                                   diff[mask].max())


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "blocks": {"a": (rng.standard_normal(5) * scale).astype(
                np.float32),
                "b": (rng.standard_normal((2, 2, 3)) * scale).astype(
                np.float32)}}


def _run_both(make_port, make_ref, steps=3, grad_scale=1.0):
    """The port's and the reference's optimizer from the same params over
    ``steps`` steps of the same gradients; the updates and params after
    each step must agree."""
    params = _tree(0)
    p_port = tree_from_numpy(params, "cpu")
    p_ref = jax.tree.map(jnp.asarray, params)
    port, ref = make_port(), make_ref()
    s_port, s_ref = port.init(p_port), ref.init(p_ref)
    for i in range(steps):
        g = _tree(10 + i, grad_scale)
        u_port, s_port = port.update(tree_from_numpy(g, "cpu"), s_port,
                                     p_port)
        u_ref, s_ref = ref.update(jax.tree.map(jnp.asarray, g), s_ref, p_ref)
        _close(u_port, jax.tree.map(np.asarray, u_ref), OPT_RTOL,
               f"updates step {i}")
        p_port = opt.apply_updates(p_port, u_port)
        p_ref = ref_opt.apply_updates(p_ref, u_ref)
        _close(p_port, jax.tree.map(np.asarray, p_ref), OPT_RTOL,
               f"params step {i}")
        assert int(s_port["step"]) == int(s_ref["step"]) == i + 1
    return s_port, s_ref



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops run faster on one thread, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("schedule", [False, True], ids=["const", "cosine"])
def test_sgd_matches(momentum, schedule):
    lr_p = opt.cosine_schedule(0.1, 2, 5) if schedule else 0.1
    lr_r = ref_opt.cosine_schedule(0.1, 2, 5) if schedule else 0.1
    s_port, s_ref = _run_both(lambda: opt.sgd(lr_p, momentum),
                              lambda: ref_opt.sgd(lr_r, momentum))
    assert ("mu" in s_port) == ("mu" in s_ref) == bool(momentum)
    if momentum:
        _close(s_port["mu"], jax.tree.map(np.asarray, s_ref["mu"]), OPT_RTOL)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches(moments, weight_decay):
    dt_p = torch.bfloat16 if moments == "bf16" else torch.float32
    dt_r = jnp.bfloat16 if moments == "bf16" else jnp.float32
    lr_p = opt.cosine_schedule(3e-3, 2, 6)
    lr_r = ref_opt.cosine_schedule(3e-3, 2, 6)
    s_port, s_ref = _run_both(
        lambda: opt.adamw(lr_p, weight_decay=weight_decay,
                          moment_dtype=dt_p),
        lambda: ref_opt.adamw(lr_r, weight_decay=weight_decay,
                              moment_dtype=dt_r))
    for key in ("m", "v"):
        assert all(t.dtype == dt_p for _, t in _walk(s_port[key]))
        # bf16 moments: the same f32 value rounded once, so bit-equal
        # unless the f32 values straddle a rounding boundary
        _close(s_port[key], jax.tree.map(
            lambda a: np.asarray(a, np.float32), s_ref[key]),
            OPT_RTOL if moments == "f32" else 2 ** -8, key)


def test_adamw_defaults_match():
    """b2 = 0.95, eps outside the sqrt, constant lr."""
    _run_both(lambda: opt.adamw(1e-3), lambda: ref_opt.adamw(1e-3))


def test_cosine_schedule_matches():
    for warmup, total in ((5, 3), (5, 100), (0, 10), (10, 10)):
        p = opt.cosine_schedule(3e-4, warmup, total)
        r = ref_opt.cosine_schedule(3e-4, warmup, total)
        for step in range(0, total + 3):
            got = float(p(torch.tensor(step, dtype=torch.int32)))
            want = float(r(jnp.int32(step)))
            assert abs(got - want) <= OPT_RTOL * 3e-4, (warmup, total, step)
            assert float(p(step)) == got


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches(scale):
    g = _tree(3, scale)
    got, norm = opt.clip_by_global_norm(tree_from_numpy(g, "cpu"), 1.0)
    want, ref_norm = ref_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    assert abs(float(norm) - float(ref_norm)) <= OPT_RTOL * float(ref_norm)
    assert abs(float(opt.global_norm(tree_from_numpy(g, "cpu")))
               - float(ref_opt.global_norm(g))) <= OPT_RTOL * float(ref_norm)
    _close(got, jax.tree.map(np.asarray, want), OPT_RTOL)


def test_optimizer_records_no_graph():
    params = {"w": torch.ones(3, requires_grad=True)}
    grads = {"w": torch.full((3,), 0.5, requires_grad=True)}
    adam = opt.adamw(1e-2)
    upd, _ = adam.update(grads, adam.init(params), params)
    new = opt.apply_updates(params, upd)
    assert not upd["w"].requires_grad and not new["w"].requires_grad


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 2, 0),
                                                  (49155, 32, 3, 7)])
def test_lm_stream_bit_identical(vocab, seq, batch, seed):
    got, want = LMStream(vocab, seq, batch, seed), RefLMStream(vocab, seq,
                                                              batch, seed)
    assert np.array_equal(got.succ, want.succ)
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert got.entropy_floor() == want.entropy_floor()
    first = next(markov_stream(vocab, seq, batch, seed).batches())
    assert np.array_equal(first["tokens"], RefLMStream(
        vocab, seq, batch, seed).next_batch()["tokens"])


# ---------------------------------------------------------------------------
# the training step and the entry points
# ---------------------------------------------------------------------------


def _ref_step_fn(cfg, ref_opt_):
    """The reference's step, as ``src/repro/launch/train.py`` builds it."""
    @jax.jit
    def step_fn(params, opt_state, tokens, labels):
        batch_d = {"tokens": tokens, "labels": labels}
        if cfg.enc_layers:
            batch_d["enc_frames"] = jnp.zeros(
                (tokens.shape[0], 16, cfg.d_model), params["final_norm"].dtype)
        loss, grads = jax.value_and_grad(
            lambda p: ref_model.loss_fn(p, batch_d, cfg))(params)
        grads, gnorm = ref_opt.clip_by_global_norm(grads, 1.0)
        upd, opt_state = ref_opt_.update(grads, opt_state, params)
        return ref_opt.apply_updates(params, upd), opt_state, loss, gnorm
    return step_fn


@pytest.mark.parametrize("arch", ["qwen3-14b", "seamless-m4t-medium"])
def test_train_step_matches_reference(arch):
    steps, batch, seq = 3, 2, 64
    ref_bundle = ref_get_bundle(arch, smoke=True)
    cfg = ref_bundle.cfg
    ref_params = ref_bundle.init(jax.random.PRNGKey(0))
    ref_o = ref_opt.adamw(ref_opt.cosine_schedule(
        3e-4, warmup=max(steps // 20, 5), total=steps), weight_decay=0.01)
    ref_state = ref_o.init(ref_params)
    ref_step = _ref_step_fn(cfg, ref_o)

    port_cfg = get_bundle(arch, smoke=True).cfg
    port_o = opt.adamw(opt.cosine_schedule(
        3e-4, warmup=max(steps // 20, 5), total=steps), weight_decay=0.01)
    params = tree_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    state = port_o.init(params)
    port_step = train_lib.make_step(port_cfg, port_o)

    stream = markov_stream(cfg.vocab, seq, batch, 0)
    ill = {}
    for i in range(steps):
        b = stream.next_batch()
        ref_params, ref_state, ref_loss, ref_gnorm = ref_step(
            ref_params, ref_state, jnp.asarray(b["tokens"]),
            jnp.asarray(b["labels"]))
        params, state, loss, gnorm = port_step(
            params, state, torch.from_numpy(b["tokens"]),
            torch.from_numpy(b["labels"]))
        assert abs(float(loss) - float(ref_loss)) <= STEP_RTOL * abs(
            float(ref_loss)), i
        assert abs(float(gnorm) - float(ref_gnorm)) <= STEP_RTOL * float(
            ref_gnorm), i
        bc2 = 1 - 0.95 ** (i + 1)
        for path, v in _walk(jax.tree.map(np.asarray, ref_state["v"])):
            root = np.sqrt(v / bc2)
            ill[path] = ill.get(path, False) | (root
                                                < APART_ROOT * root.max())
        for moment in ("m", "v"):
            _close(state[moment], jax.tree.map(np.asarray, ref_state[moment]),
                   STEP_RTOL, f"{moment} after step {i}")
        _close(params, jax.tree.map(np.asarray, ref_params), STEP_RTOL,
               f"params after step {i}", ill, APART_ATOL)


def test_train_on_cpu_checkpoints_in_reference_format(tmp_path):
    """``train(device="cpu")`` runs, learns a little, and its checkpoint
    reads back in both packages; a rerun resumes from it."""
    kw = dict(arch="granite-moe-1b-a400m", smoke=True, batch=2, seq=32,
              lr=3e-3, ckpt_dir=str(tmp_path), device="cpu")
    losses = train_lib.train(steps=6, **kw)
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    like = get_bundle("granite-moe-1b-a400m", smoke=True).build_template()
    fname = tmp_path / "step_00000006.npz"
    got = load_pytree(fname, like)
    want = ref_load_pytree(fname, ref_get_bundle(
        "granite-moe-1b-a400m", smoke=True).build_template())
    _close(got, jax.tree.map(np.asarray, want), 0.0)
    assert train_lib.train(steps=6, **kw) == []     # resumed at its end


def test_entry_points_default_to_the_card(capsys):
    """``train`` and ``main`` ask for CUDA unless told otherwise (here, with
    no card, that raises); ``--device cpu`` runs."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_lib.train("qwen3-14b", True, 1, 1, 16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_lib.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1"])
    train_lib.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "64"])
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("block", [None, 1000])
def test_update_in_place_is_the_tree_update_bit_for_bit(block,
                                                        monkeypatch):
    """``update_in_place`` (the clip's scaling, AdamW and the update's
    application written into the params and moments, a block of a leaf at
    a time; here also blocks of 1000 elements, which split leaves and end
    ragged) gives the whole-tree functions' params and moments bit for bit
    over two steps, and empties the flat gradients."""
    from repro_torch.models.convert import flatten, tree_leaves, tree_map
    if block is not None:
        monkeypatch.setattr(train_lib, "UPDATE_BLOCK", block)
    params = get_bundle("qwen3-14b", smoke=True).init(
        torch.Generator().manual_seed(0))
    o = opt.adamw(opt.cosine_schedule(3e-4, warmup=5, total=3),
                  weight_decay=0.01)
    want_p, want_s = params, o.init(params)
    got_p = tree_map(torch.clone, params)
    got_s = o.init(got_p)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        grads = tree_map(lambda p: 3 * torch.randn(p.shape, generator=g),
                         params)
        clipped, norm = opt.clip_by_global_norm(grads, 1.0)
        upd, want_s = o.update(clipped, want_s, want_p)
        want_p = opt.apply_updates(want_p, upd)
        scale, got_norm = opt.clip_scale(grads, 1.0)
        assert torch.equal(got_norm, norm)
        flat = flatten(grads)
        train_lib.update_in_place(o, flat, got_s, got_p, scale)
        assert flat == {}
    assert torch.equal(got_s["step"], want_s["step"])
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_train_step_with_remat_matches_plain():
    """``make_step(remat=True)`` recomputes each unit's activations in the
    backward: the same loss and gradient norm, and params within 1e-6 of
    scale of the plain step's (the recomputation's sums may run in
    another order), for a dense and an SSM config."""
    for arch in ("stablelm-3b", "mamba2-2.7b"):
        bundle = get_bundle(arch, smoke=True)
        stream = markov_stream(bundle.cfg.vocab, 32, 2, 0)
        b = stream.next_batch()
        tokens, labels = (torch.from_numpy(b[k]) for k in ("tokens",
                                                           "labels"))
        runs = []
        for remat in (False, True):
            o = opt.adamw(1e-3, weight_decay=0.01)
            params = bundle.init(torch.Generator().manual_seed(0))
            step = train_lib.make_step(bundle.cfg, o, remat)
            runs.append(step(params, o.init(params), tokens, labels))
        (p0, _, l0, n0), (p1, _, l1, n1) = runs
        assert float(l0) == float(l1), arch
        assert abs(float(n0) - float(n1)) <= 1e-6 * float(n0), arch
        _close(p1, p0, 1e-6, arch)
