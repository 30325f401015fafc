"""The LM stack of the port (``repro_torch.configs``, ``models.model``'s
templates, ``forward`` and ``loss_fn``, ``models.registry``'s bundles)
against ``repro``'s, for all ten published architectures.

Configs and templates are compared for the full (published) configs,
without allocating a parameter. Forward, loss and gradients run the ten
smoke configs at B = 2, S = 64 (``tests/test_models_smoke.py``'s shape)
from the reference's ``bundle.init(PRNGKey(0))`` params and its
``demo_batch``, carried across by ``tree_from_numpy``, at the f32
contract: logits and loss within 1e-5 of the reference's largest
magnitude, each gradient leaf within 1e-5 of its largest entry. One
module-scoped reference run per arch serves every test of that arch.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import backend as ref_backend  # noqa: E402
from repro.models import demo_batch as ref_demo_batch  # noqa: E402
from repro.models import bundle_for as ref_bundle_for  # noqa: E402
from repro.models import get_bundle as ref_get_bundle  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import bundle_for, demo_batch, get_bundle  # noqa
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.convert import (flatten, tree_from_numpy,  # noqa
                                        tree_to_numpy, unflatten)

ARCHS = list(ref_configs.ARCHS)
B, S = 2, 64
RTOL = 1e-5


def _walk(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _walk(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops run faster on one thread, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_arch_registry_matches():
    assert configs.ARCHS == ref_configs.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    got, want = getattr(configs, get)(arch), getattr(ref_configs, get)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.n_params == want.n_params
    assert got.n_active_params == want.n_active_params
    assert got.hd == want.hd
    assert [got.kind(i) for i in range(got.n_layers)] == \
        [want.kind(i) for i in range(want.n_layers)]


def test_granite_full_width_count():
    cfg = configs.get_config("granite-moe-1b-a400m")
    assert cfg.n_params == 1_384_962_048
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (1024, 24, 16, 8, 64, 512, 49155)


def test_shapes_match():
    assert set(configs.SHAPES) == set(ref_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(ref_configs.get_shape(name))
        assert configs.get_shape(name) is shape


# ---------------------------------------------------------------------------
# templates (no allocation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_leaf_for_leaf(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    got = _walk(model_lib.build_template(getattr(configs, get)(arch)))
    want = _walk(ref_model.build_template(getattr(ref_configs, get)(arch)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init), path
        assert g.dtype is None and w.dtype is None, path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_bytes(arch):
    """Meta tensors of the reference's ShapeDtypeStruct shapes, and the
    same byte count in bf16 and f32, at full width."""
    got = get_bundle(arch).abstract_params()
    want = ref_get_bundle(arch).abstract_params()
    got_l, want_l = _walk(got), _walk(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
    t_got = model_lib.build_template(configs.get_config(arch))
    t_want = ref_model.build_template(ref_configs.get_config(arch))
    assert params_lib.spec_bytes(t_got) == ref_params.spec_bytes(t_want)
    assert params_lib.spec_bytes(t_got, torch.float32) == \
        ref_params.spec_bytes(t_want, np.float32)


def test_init_params_structure_and_kinds():
    """``bundle.init`` draws every leaf of the template, zeros and ones
    where the template says so, on the generator's device."""
    bundle = get_bundle("qwen2.5-32b", smoke=True)
    params = bundle.init(torch.Generator().manual_seed(0))
    specs = dict(_walk(bundle.build_template()))
    leaves = dict(_walk(params))
    assert set(leaves) == set(specs)
    for path, t in leaves.items():
        spec = specs[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        if spec.init == "zeros":
            assert not t.any(), path
        elif spec.init == "ones":
            assert bool((t == 1).all()), path
        else:
            assert float(t.std()) > 0, path


# ---------------------------------------------------------------------------
# forward, loss and gradients against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's smoke params, batch, logits, loss and gradients
    (one jitted ``value_and_grad``), as numpy."""
    arch = request.param
    bundle = ref_get_bundle(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(jax.random.PRNGKey(0))
    batch = ref_demo_batch(cfg, B, S)

    def f(p, b):
        logits = ref_model.forward(p, b, cfg)
        return ref_model.loss_fn(p, b, cfg), logits
    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, batch)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(arch=arch, params=as_np(params), batch=as_np(batch),
                loss=float(loss), logits=np.asarray(logits),
                grads=as_np(grads))


def _port_run(ref, **kw):
    bundle = get_bundle(ref["arch"], smoke=True)
    params = tree_from_numpy(ref["params"], "cpu")
    batch = tree_from_numpy(ref["batch"], "cpu")
    leaves = {k: v.requires_grad_() for k, v in flatten(params).items()}
    logits = bundle.forward(params, batch, **kw)
    loss = bundle.loss_fn(params, batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits.detach(), float(loss.detach()), dict(zip(leaves, grads))


@pytest.fixture(scope="module")
def port(reference):
    return _port_run(reference)


def test_forward_logits_match(reference, port):
    logits, _, _ = port
    want = reference["logits"]
    assert logits.shape == want.shape == (B, S, reference["params"][
        "embed"].shape[0])
    err = np.abs(logits.numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), err


def test_loss_matches(reference, port):
    _, loss, _ = port
    assert np.isfinite(loss)
    assert abs(loss - reference["loss"]) <= RTOL * abs(reference["loss"])


def test_grads_match(reference, port):
    _, _, grads = port
    want = dict(_walk(reference["grads"]))
    assert set(grads) == set(want)
    for path, g in grads.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        err = np.abs(g.numpy() - w).max()
        assert err <= RTOL * max(np.abs(w).max(), 1e-30), (path, err)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-medium"])
def test_remat_matches_plain(arch):
    """``remat=True`` (a checkpointed unit) recomputes the same loss and
    gradients: hybrid (Mamba + attention + MoE) and encoder-decoder."""
    bundle = get_bundle(arch, smoke=True)
    params = bundle.init(torch.Generator().manual_seed(1))
    batch = demo_batch(bundle.cfg, B, S, device="cpu")
    runs = []
    for remat in (False, True):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten(params).items()}
        loss = bundle.loss_fn(unflatten(leaves), batch, remat=remat)
        runs.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(a.abs().max()))


def test_forward_matches_reference_pallas_interpret():
    """deepseek-7b-smoke's logits against the reference's under
    ``use_pallas(interpret=True)`` (its flash attention kernel in
    interpret mode)."""
    bundle = ref_get_bundle("deepseek-7b", smoke=True)
    params = bundle.init(jax.random.PRNGKey(0))
    batch = ref_demo_batch(bundle.cfg, B, S)
    with ref_backend.use_pallas(interpret=True):
        want = np.asarray(jax.jit(bundle.forward)(params, batch))
    got = get_bundle("deepseek-7b", smoke=True).forward(
        tree_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        tree_from_numpy(jax.tree.map(np.asarray, batch), "cpu"))
    err = np.abs(got.numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), err


def test_random_init_loss_near_uniform():
    """From the port's own init, every smoke config's loss is finite and
    within 1 of ln(vocab): the logits of a random model have unit
    variance, which adds about 0.5."""
    for arch in ARCHS:
        bundle = get_bundle(arch, smoke=True)
        params = bundle.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            loss = float(bundle.loss_fn(params, demo_batch(
                bundle.cfg, B, S, device="cpu")))
        assert abs(loss - np.log(bundle.cfg.vocab)) < 1.0, (arch, loss)


def test_full_configs_have_cuda_plans():
    """Every published config's attention and SSD shapes have CUDA plans,
    at SHAPES["train_4k"]'s 4096 steps of one row: the head dims (stablelm-
    3b's 80 among them, ROADMAP K7) in ``HEAD_DIMS``, on the tiled kernels
    with 16-byte copies of the (B, S, H, hd) activations; the SSD forward
    at each chunk of 256 (mamba2-2.7b's and jamba's, K15) on an inner chunk
    whose block fits the card, and the backward's chunk-parallel
    tensor-core form. No
    fallback: head dim 256, which no config has, is refused with
    ``NotImplementedError``, and a chunk with no inner chunk that fits
    with ``ValueError``, by the kernels' own checks (run on the card, the
    LM raises there), not routed to the plain versions."""
    seq = 4096
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        kinds = {cfg.kind(i) for i in range(cfg.n_layers)}
        if "A" in kinds:
            h, hd = cfg.n_heads, cfg.hd
            assert hd in fa_kernel.HEAD_DIMS, arch
            plan = fa_kernel.attention_plan(
                1, h, seq, hd, strides=(seq * h * hd, hd, h * hd) * 5,
                aligned=True)
            assert (plan.form, plan.vec) == ("tiled", 16), arch
        if "M" in kinds:
            s = cfg.ssm
            n, p, ds = s.n_heads(cfg.d_model), s.head_dim, s.d_state
            plan = ssd_kernel.ssd_plan(1, seq, n, p, ds, s.chunk_size,
                                       sms=132)
            assert plan.chunk == s.chunk_size and seq % plan.inner == 0
            assert ssd_kernel.smem_floats(plan.inner, p, ds, plan.heads,
                                          plan.chunks > 1) <= \
                ssd_kernel.SMEM_MAX, arch
            # one row of 80 or 128 heads cannot fill the card: the
            # chunk-parallel tensor-core form
            assert ssd_kernel.ssd_bwd_plan(1, seq, n, p, ds,
                                           sms=132).form == "tc"
    assert configs.get_config("stablelm-3b").hd == 80
    q = torch.empty(1, 2, 64, 256)
    with pytest.raises(NotImplementedError, match="head dim 256"):
        fa_kernel._operands("qkv", q, q, q)
    assert ssd_kernel.smem_floats(256, 64, 128, 1, True) == 222_980
    with pytest.raises(ValueError, match="no inner chunk"):
        ssd_kernel.ssd_plan(1, seq, 2, 256, 256, 256, sms=132)
    # every smoke config fits: head dim 64, SSD chunk 32
    for arch in ARCHS:
        cfg = configs.get_smoke_config(arch)
        assert cfg.n_heads == 0 or cfg.hd in fa_kernel.HEAD_DIMS
        if cfg.ssm is not None:
            s = cfg.ssm
            ssd_kernel.ssd_plan(B, S, s.n_heads(cfg.d_model), s.head_dim,
                                s.d_state, min(s.chunk_size, S), sms=132)


# The shapes the smoke configs do not reach, on the CPU path: a smoke
# config narrowed to head dim 80 (stablelm-3b's, at d_model 320 over its 4
# heads) at B = 2, S = 64, and mamba2-smoke at its published chunk of 256
# over two chunks (B = 1, S = 512). name -> (arch, config change, B, S,
# the gradients' reference route and tolerance). The logits and the loss
# are the reference's CPU form's, at RTOL. At chunk 256 that form's
# gradients are NaN (its chunked dual form under autodiff: exp overflows
# above the diagonal before its mask zeroes it; the port masks the
# exponent, tests/test_torch_ssd_scan.py), so mamba2's gradients are held
# against the route the reference's model takes there on the TPU, its
# Pallas forward in interpret mode and ``jax.vjp`` through the sequential
# oracle, at the SSD's own tolerance (SSD_RTOL, 1e-4 of each leaf's
# largest entry): the port's chunked adjoint and that sequential one sum
# in different orders (2.6e-5 of scale at most, a_log's).
SSD_RTOL = 1e-4
WIDE = {
    "stablelm-hd80": ("stablelm-3b", lambda c: dataclasses.replace(
        c, d_model=320), 2, 64, False, RTOL),
    "mamba2-chunk256": ("mamba2-2.7b", lambda c: dataclasses.replace(
        c, ssm=dataclasses.replace(c.ssm, chunk_size=256)), 1, 512, True,
        SSD_RTOL),
}


@pytest.fixture(scope="module", params=list(WIDE))
def wide_reference(request):
    """One WIDE config's reference run (one jitted ``value_and_grad``, on
    the kernel route where WIDE says so, then the CPU form's forward) and
    the port's from the same params and batch: (config, the gradients'
    tolerance, the reference's numpy, the port's tensors)."""
    arch, change, b, s, kernel_route, grad_rtol = WIDE[request.param]
    ref_cfg = change(ref_configs.get_smoke_config(arch))
    cfg = change(configs.get_smoke_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    bundle = ref_bundle_for(ref_cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    batch = ref_demo_batch(ref_cfg, b, s)

    def f(p, bt):
        logits = ref_model.forward(p, bt, ref_cfg)
        return ref_model.loss_fn(p, bt, ref_cfg), logits
    with (ref_backend.use_pallas(interpret=True) if kernel_route
          else contextlib.nullcontext()):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(params, batch)
    if kernel_route:
        loss, logits = jax.jit(f)(params, batch)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = dict(loss=float(loss), logits=np.asarray(logits),
                grads=dict(_walk(as_np(grads))))
    port = bundle_for(cfg)
    tparams = tree_from_numpy(as_np(params), "cpu")
    tbatch = tree_from_numpy(as_np(batch), "cpu")
    leaves = {k: v.requires_grad_() for k, v in flatten(tparams).items()}
    got_logits = port.forward(tparams, tbatch)
    got_loss = port.loss_fn(tparams, tbatch)
    got_grads = torch.autograd.grad(got_loss, list(leaves.values()))
    return cfg, grad_rtol, want, dict(logits=got_logits.detach(),
                                      loss=float(got_loss.detach()),
                                      grads=dict(zip(leaves, got_grads)))


def test_wide_config_shapes(wide_reference):
    cfg, _, _, _ = wide_reference
    assert cfg.hd == 80 if cfg.n_heads else cfg.ssm.chunk_size == 256


def test_wide_forward_logits_match(wide_reference):
    _, _, want, got = wide_reference
    assert got["logits"].shape == want["logits"].shape
    err = np.abs(got["logits"].numpy() - want["logits"]).max()
    assert err <= RTOL * np.abs(want["logits"]).max(), err


def test_wide_loss_matches(wide_reference):
    _, _, want, got = wide_reference
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])


def test_wide_grads_match(wide_reference):
    _, rtol, want, got = wide_reference
    assert set(got["grads"]) == set(want["grads"])
    for path, g in got["grads"].items():
        w = want["grads"][path]
        assert tuple(g.shape) == w.shape, path
        err = np.abs(g.numpy() - w).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-30), (path, err)


# ---------------------------------------------------------------------------
# bundle, batch and conversion
# ---------------------------------------------------------------------------


def test_demo_batch():
    cfg = configs.get_smoke_config("seamless-m4t-medium")
    a = demo_batch(cfg, B, S, torch.Generator().manual_seed(3), enc_len=16,
                   device="cpu")
    b = demo_batch(cfg, B, S, torch.Generator().manual_seed(3), enc_len=16,
                   device="cpu")
    assert set(a) == {"tokens", "labels", "enc_frames"}
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (B, S)
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert a["enc_frames"].shape == (B, 16, cfg.d_model)
    assert "enc_frames" not in demo_batch(
        configs.get_smoke_config("qwen3-14b"), B, S, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            demo_batch(cfg, B, S)


def test_tree_numpy_round_trip():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}}
    got = tree_from_numpy(tree, "cpu")
    assert got["b"]["c"].dtype == torch.int32
    back = tree_to_numpy(got)
    got["a"].add_(1.0)                        # the host copies stay apart
    assert np.array_equal(back["a"], tree["a"])
    assert np.array_equal(back["b"]["c"], tree["b"]["c"])
