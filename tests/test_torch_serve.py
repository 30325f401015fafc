"""The LM decode side of the port (``models.layers.decode_attention``,
``models.ssm.ssd_step``/``mamba_step``, ``models.model``'s
``cache_template``, ``serve_step``, ``encode_for_decode`` and
``fill_cross_cache``, ``launch.serve``) against ``repro``'s.

Each test carries the reference's weights and caches across with
``tree_from_numpy`` and holds the port at the f32 contract: every tensor
within 1e-5 of the reference's largest magnitude. Decode against the
sequence forward mirrors ``tests/test_decode_parity.py`` at its 2e-3.
The ten smoke configs decode S = 16 tokens at B = 2 from one
module-scoped reference run per arch.
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

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import backend as ref_backend  # noqa: E402
from repro.models import get_bundle as ref_get_bundle  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import bundle_for, get_bundle  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.convert import flatten, tree_from_numpy  # noqa

ARCHS = list(ref_configs.ARCHS)
# tests/test_decode_parity.py's archs
PARITY_ARCHS = ["deepseek-7b", "qwen3-14b", "mamba2-2.7b", "jamba-v0.1-52b",
                "granite-moe-1b-a400m", "seamless-m4t-medium"]
B, S, ENC = 2, 16, 8
RTOL = 1e-5
PARITY_TOL = 2e-3
# examples/serve_decode.py's archs and sizes
SERVE_ARCHS = ["deepseek-7b", "mamba2-2.7b", "jamba-v0.1-52b"]
SERVE = dict(batch=4, prompt_len=16, gen=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops run faster on one thread, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, what=""):
    """``got`` (tensor) within ``rtol`` of ``want``'s (numpy) largest
    magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _walk(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _close_tree(got, want, rtol=RTOL):
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k in w:
        _close(g[k], w[k], rtol, k)


# ---------------------------------------------------------------------------
# layers: decode attention, ring index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [5, S - 1, S + 3],
                         ids=["inside", "end", "past"])
@pytest.mark.parametrize("groups", [1, 2])
def test_decode_attention_matches(groups, pos):
    """One query token against a (B, S, KV, hd) cache, int and 0-d tensor
    positions."""
    rng = np.random.default_rng(groups * 100 + pos)
    kv, hd = 2, 16
    q = rng.standard_normal((B, 1, kv * groups, hd), np.float32)
    k = rng.standard_normal((B, S, kv, hd), np.float32)
    v = rng.standard_normal((B, S, kv, hd), np.float32)
    want = np.asarray(ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = layers.decode_attention(qt, kt, vt, p)
        _close(got, want)


def test_ring_index_matches():
    for pos in (0, 5, 7, 8, 23, 130):
        want = int(ref_layers.ring_index(jnp.int32(pos), 8))
        assert layers.ring_index(pos, 8) == want
        assert int(layers.ring_index(torch.tensor(pos), 8)) == want


# ---------------------------------------------------------------------------
# ssm: the single-token recurrence and the Mamba decode step
# ---------------------------------------------------------------------------


def test_ssd_step_and_mamba_step_match():
    cfg = ref_configs.get_smoke_config("mamba2-2.7b")
    s = cfg.ssm
    n, p, ds = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    conv_ch = s.d_inner(cfg.d_model) + 2 * ds
    params = ref_get_bundle("mamba2-2.7b", smoke=True).init(
        jax.random.PRNGKey(0))
    mp = _np(jax.tree.map(lambda a: a[0], params["blocks"]["s0"]["mamba"]))
    # nonzero dt bias and decay rates, so every term of the step counts
    rng = np.random.default_rng(0)
    mp["a_log"] = rng.standard_normal(n).astype(np.float32)
    mp["dt_bias"] = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    conv = rng.standard_normal((B, s.d_conv - 1, conv_ch), np.float32)
    h = rng.standard_normal((B, n, ds, p), np.float32)
    port_cfg = configs.get_smoke_config("mamba2-2.7b")
    want = jax.jit(ref_ssm.mamba_step, static_argnums=2)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, mp), cfg,
        jnp.asarray(conv), jnp.asarray(h))
    got = ssm.mamba_step(torch.from_numpy(x), tree_from_numpy(mp, "cpu"),
                         port_cfg, torch.from_numpy(conv), torch.from_numpy(h))
    for g, w, what in zip(got, want, ("out", "conv", "h")):
        _close(g, np.asarray(w), what=what)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy()[:, :-1], conv[:, 1:])

    xh = rng.standard_normal((B, n, p), np.float32)
    dt = np.abs(rng.standard_normal((B, n), np.float32))
    b_ssm, c_ssm = (rng.standard_normal((B, ds), np.float32)
                    for _ in range(2))
    want = jax.jit(ref_ssm.ssd_step)(*(jnp.asarray(a) for a in (
        xh, dt, mp["a_log"], b_ssm, c_ssm, h)))
    got = ssm.ssd_step(*(torch.from_numpy(a) for a in (
        xh, dt, mp["a_log"], b_ssm, c_ssm, h)))
    for g, w, what in zip(got, want, ("y", "h")):
        _close(g, np.asarray(w), what=what)


# ---------------------------------------------------------------------------
# cache templates (no allocation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_template_matches_leaf_for_leaf(arch):
    got = _walk(get_bundle(arch).cache_template(4, 128, enc_len=16))
    want = _walk(ref_get_bundle(arch).cache_template(4, 128, enc_len=16))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init), path
        if w.dtype is None:
            assert g.dtype is None, path
        else:
            assert str(g.dtype) == f"torch.{np.dtype(w.dtype)}", path
    leaves = dict(got)
    cfg = configs.get_config(arch)
    assert any(p.endswith(".h") for p in leaves) == (cfg.ssm is not None)
    assert any(p.endswith(".xk") for p in leaves) == bool(cfg.enc_layers)
    assert params_lib.spec_bytes(get_bundle(arch).cache_template(
        4, 128, 16)) == ref_params.spec_bytes(
        ref_get_bundle(arch).cache_template(4, 128, 16))


# ---------------------------------------------------------------------------
# serve_step against the reference's, every smoke config
# ---------------------------------------------------------------------------


def _ref_decode(cfg, params, cache, tokens, **kw):
    """The reference's jitted serve_step over ``tokens`` (B, T) -> (logits
    (B, T, V), final cache), as numpy."""
    step = jax.jit(lambda p, c, t, pos: ref_model.serve_step(
        p, c, t, pos, cfg, **kw))
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1), _np(cache)


def _port_decode(bundle, params, cache, tokens, tensor_pos=False, **kw):
    """The port's serve_step over ``tokens``, the positions 0-d tensors at
    odd steps when ``tensor_pos``."""
    outs = []
    for t in range(tokens.shape[1]):
        pos = torch.tensor(t) if tensor_pos and t % 2 else t
        logits, cache2 = bundle.serve_step(
            params, cache, torch.from_numpy(tokens[:, t:t + 1]), pos, **kw)
        assert cache2 is cache
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1), cache


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's smoke params, tokens, encoder frames, and its
    decode logits and final cache over S tokens, as numpy."""
    arch = request.param
    bundle = ref_get_bundle(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(jax.random.PRNGKey(0))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg.vocab), np.int32)
    cache = ref_params.init_params(jax.random.PRNGKey(3),
                                   bundle.cache_template(B, S, enc_len=ENC))
    enc = None
    if cfg.enc_layers:
        enc = jax.random.normal(jax.random.PRNGKey(2), (B, ENC, cfg.d_model))
        enc_out = ref_model.encode_for_decode(params, enc, cfg)
        cache = ref_model.fill_cross_cache(params, cache, enc_out, cfg)
    logits, final = _ref_decode(cfg, params, cache, tokens)
    return dict(arch=arch, params=_np(params), tokens=tokens,
                enc=None if enc is None else np.array(enc), logits=logits,
                cache=final)


def test_serve_step_matches_reference(reference):
    """S tokens through the port's serve_step (int and tensor positions)
    from the reference's params: logits and final cache at 1e-5 of
    scale."""
    bundle = get_bundle(reference["arch"], smoke=True)
    cfg = bundle.cfg
    params = tree_from_numpy(reference["params"], "cpu")
    cache = params_lib.init_params(torch.Generator().manual_seed(3),
                                   bundle.cache_template(B, S, enc_len=ENC))
    if cfg.enc_layers:
        enc_out = model_lib.encode_for_decode(
            params, torch.from_numpy(reference["enc"]), cfg)
        model_lib.fill_cross_cache(params, cache, enc_out, cfg)
    logits, cache = _port_decode(bundle, params, cache, reference["tokens"],
                                 tensor_pos=True)
    _close(logits, reference["logits"], what="logits")
    assert bool(torch.isfinite(logits).all())
    _close_tree(cache, reference["cache"])


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_decode_matches_own_forward(arch):
    """Feeding tokens one by one reproduces the port's sequence forward
    (tests/test_decode_parity.py on the port, its 2e-3): KV cache, SSM
    state, cross attention; MoE at capacity factor 8, drop-free."""
    cfg = configs.get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    bundle = bundle_for(cfg)
    g = torch.Generator().manual_seed(0)
    params = bundle.init(g)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    cache = params_lib.init_params(g, bundle.cache_template(B, S,
                                                            enc_len=ENC))
    if cfg.enc_layers:
        enc = torch.randn(B, ENC, cfg.d_model, generator=g)
        batch["enc_frames"] = enc
        model_lib.fill_cross_cache(
            params, cache, model_lib.encode_for_decode(params, enc, cfg), cfg)
    with torch.no_grad():
        want = bundle.forward(params, batch)
    got, _ = _port_decode(bundle, params, cache, tokens.numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PARITY_TOL,
                               rtol=PARITY_TOL)


def _deepseek(window=None):
    cfg = ref_configs.get_smoke_config("deepseek-7b")
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
    port_cfg = configs.get_smoke_config("deepseek-7b")
    if window is not None:
        port_cfg = dataclasses.replace(port_cfg, window=window)
    params = ref_get_bundle("deepseek-7b", smoke=True).init(
        jax.random.PRNGKey(0))
    return cfg, port_cfg, params


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "clamp"])
def test_ring_and_clamp_match_reference(ring):
    """deepseek-smoke over 24 tokens against a cache of 8: as ring buffers
    (window 8, tests/test_decode_parity.py's ring case), and without a
    ring, where the reference's dynamic_update_slice clamps every write
    past the end to the last slot and every slot stays valid."""
    cfg, port_cfg, params = _deepseek(window=8 if ring else None)
    total, w = 24, 8
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, total),
                                         0, cfg.vocab), np.int32)
    cache = ref_params.init_params(jax.random.PRNGKey(2),
                                   ref_model.cache_template(cfg, B, w))
    want, want_cache = _ref_decode(cfg, params, cache, tokens, ring=ring)
    bundle = bundle_for(port_cfg)
    cache = params_lib.init_params(torch.Generator(),
                                   bundle.cache_template(B, w))
    got, got_cache = _port_decode(bundle, tree_from_numpy(_np(params), "cpu"),
                                  cache, tokens, tensor_pos=True, ring=ring)
    _close(got, want, what="logits")
    _close_tree(got_cache, want_cache)
    if not ring:
        # the clamp's own effect: steps past the end differ from the ring's
        ring_want, _ = _ref_decode(cfg, params, ref_params.init_params(
            jax.random.PRNGKey(2), ref_model.cache_template(cfg, B, w)),
            tokens, ring=True)
        assert np.abs(want[:, w:] - ring_want[:, w:]).max() > 1e-3


def test_encoder_and_cross_cache_match_reference_pallas():
    """seamless-smoke's ``encode_for_decode`` and ``fill_cross_cache``
    against the reference's under ``use_pallas(interpret=True)`` (its
    flash attention kernel in interpret mode, at enc_len 16)."""
    arch = "seamless-m4t-medium"
    bundle = ref_get_bundle(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(jax.random.PRNGKey(0))
    enc = jax.random.normal(jax.random.PRNGKey(2), (B, 16, cfg.d_model))
    cache = ref_params.init_params(jax.random.PRNGKey(1),
                                   bundle.cache_template(B, S, enc_len=16))
    with ref_backend.use_pallas(interpret=True):
        enc_out = jax.jit(lambda p, e: ref_model.encode_for_decode(
            p, e, cfg))(params, enc)
    want = _np(ref_model.fill_cross_cache(params, cache, enc_out, cfg))

    port = get_bundle(arch, smoke=True)
    pp = tree_from_numpy(_np(params), "cpu")
    got_out = model_lib.encode_for_decode(pp, torch.from_numpy(
        np.array(enc)), port.cfg)
    _close(got_out, np.asarray(enc_out), what="enc_out")
    cache = params_lib.init_params(torch.Generator(),
                                   port.cache_template(B, S, enc_len=16))
    assert model_lib.fill_cross_cache(pp, cache, got_out, port.cfg) is cache
    _close_tree(cache, want)
    short = params_lib.init_params(torch.Generator(),
                                   port.cache_template(B, S, enc_len=8))
    with pytest.raises(ValueError, match="enc_out of shape"):
        model_lib.fill_cross_cache(pp, short, got_out, port.cfg)


# ---------------------------------------------------------------------------
# launch/serve.py: the greedy loop against the reference's serve()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_decode_matches_reference_serve(arch, capsys):
    """examples/serve_decode.py's runs: the reference's ``serve()``
    tokens against the port's greedy loop handed the reference's params
    and prompt. A token may differ only where the reference's top two
    logits lie within the contract of each other (printed)."""
    want = ref_serve.serve(arch, smoke=True, **SERVE)
    bundle = ref_get_bundle(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])).astype(np.int32)
    port = get_bundle(arch, smoke=True)
    cache = params_lib.init_params(torch.Generator(), port.cache_template(
        SERVE["batch"], 128, enc_len=serve_lib.ENC_LEN))
    got = serve_lib.greedy_decode(port.cfg, tree_from_numpy(_np(params),
                                                            "cpu"),
                                  cache, prompt, SERVE["gen"])
    assert got.dtype == np.int32 and got.shape == want.shape
    if np.array_equal(got, want):
        return
    # teacher-force the reference's own tokens for its logits
    cache = ref_params.init_params(jax.random.PRNGKey(1),
                                   bundle.cache_template(SERVE["batch"], 128,
                                                         enc_len=16))
    logits, _ = _ref_decode(cfg, params, cache,
                            np.concatenate([prompt, want], axis=1))
    gen_logits = logits[:, SERVE["prompt_len"] - 1:-1]
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if not diff.size:
            continue
        i = diff[0]
        top = np.sort(gen_logits[row, i])[::-1]
        gap = top[0] - top[1]
        with capsys.disabled():
            print(f"{arch} row {row} step {i}: tokens part at a top-two "
                  f"logit gap of {gap:.3e} (scale "
                  f"{np.abs(gen_logits).max():.3e})")
        assert gap <= 2 * RTOL * np.abs(gen_logits).max(), (row, i, gap)


def test_serve_runs_on_the_cpu_and_refuses_a_missing_card():
    out = serve_lib.serve("seamless-m4t-medium", True, 2, 4, 3, device="cpu")
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert int(out.min()) >= 0
    assert int(out.max()) < configs.get_smoke_config(
        "seamless-m4t-medium").vocab
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_lib.serve("mamba2-2.7b", True, 2, 4, 3)
