"""The port's dry-run side (``repro_torch.launch.specs``, ``mesh``,
``roofline``, ``dryrun`` and the LM sharding rules of
``repro_torch.models.params``) against ``repro``'s.

* ``input_specs``: shapes and dtypes of every input, all 40 (arch, shape)
  pairs, against the reference's ``ShapeDtypeStruct``s.
* ``rules_for`` and ``partition_specs``: equal to the reference's for
  every arch's params template and decode-cache template on both
  production mesh shapes (the reference is handed a stand-in with
  ``shape`` and ``axis_names``: no 512 host devices), each spec tuple
  entry for entry.
* ``build_case`` on fake tensors for the ten smoke configs in all three
  modes (at sequence 64, batch 2): the outputs' shapes and dtypes, FLOPs
  counted.
* one full-size ``run_case`` (granite-moe-1b-a400m x train_4k, about 35 s
  of tracing): per-device bytes, the JSON, and ``useful_flops_frac`` in a
  band derived in :func:`test_full_size_run_case`.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs as cfg_lib  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, batch_axes,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, Roofline  # noqa
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402

DTYPES = {jax.numpy.dtype("int32"): torch.int32,
          jax.numpy.dtype("bfloat16"): torch.bfloat16}
MESHES = {"16x16": False, "2x16x16": True}
# the smoke configs' shapes: every mode at this sequence and global batch
SMOKE_SHAPE = dict(seq_len=64, global_batch=2)


def _ref_mesh(mesh: MeshShape):
    """A stand-in of a jax mesh for the reference's rules: shape and axis
    names only."""
    return types.SimpleNamespace(shape=mesh.shape, axis_names=mesh.axis_names)


@pytest.mark.parametrize("arch", cfg_lib.ARCHS)
def test_input_specs_match_the_reference(arch):
    for shape in cfg_lib.SHAPES:
        want = ref_specs.input_specs(arch, shape)
        got = specs.input_specs(arch, shape)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (arch, shape, k)
            assert got[k].dtype == DTYPES[w.dtype], (arch, shape, k)
            assert isinstance(got[k], FakeTensor)


def _same_specs(got, want, template, where) -> int:
    """Walk the reference's spec tree and the port's together; returns the
    leaves compared."""
    if isinstance(template, dict):
        assert set(got) == set(want) == set(template), where
        return sum(_same_specs(got[k], want[k], template[k], f"{where}.{k}")
                   for k in template)
    assert isinstance(got, tuple) and len(got) == len(template.shape), where
    assert got == tuple(want), (where, got, want)
    return 1


@pytest.mark.parametrize("arch", cfg_lib.ARCHS)
def test_rules_and_partition_specs_match_the_reference(arch):
    cfg, ref_cfg = cfg_lib.get_config(arch), ref_configs.get_config(arch)
    template = model_lib.build_template(cfg)
    ref_template = ref_model.build_template(ref_cfg)
    n = 0
    for label, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        ref_mesh = _ref_mesh(mesh)
        assert sharding.rules_for_mesh(mesh) == \
            ref_params.rules_for_mesh(ref_mesh)
        n += _same_specs(sharding.partition_specs(template, mesh),
                         ref_params.partition_specs(ref_template, ref_mesh),
                         template, f"{arch} {label} default")
        for name in cfg_lib.SHAPES:
            shape = cfg_lib.get_shape(name)
            ref_shape = ref_configs.get_shape(name)
            for profile in ("baseline", "optimized"):
                rules = specs.rules_for(cfg, shape, mesh, profile)
                assert rules == ref_specs.rules_for(ref_cfg, ref_shape,
                                                    ref_mesh, profile)
            where = f"{arch} {label} {name}"
            n += _same_specs(
                params_lib.partition_specs(template, mesh, rules),
                ref_params.partition_specs(ref_template, ref_mesh, rules),
                template, where)
            if shape.mode != "decode":
                continue
            clen = specs.cache_len_for(cfg, shape)
            assert clen == ref_specs.cache_len_for(ref_cfg, ref_shape)
            enc = specs.ENC_LEN if cfg.enc_layers else 0
            cache_t = model_lib.cache_template(cfg, shape.global_batch, clen,
                                               enc_len=enc)
            ref_cache_t = ref_model.cache_template(
                ref_cfg, shape.global_batch, clen, enc_len=enc)
            n += _same_specs(
                params_lib.partition_specs(cache_t, mesh, rules),
                ref_params.partition_specs(ref_cache_t, ref_mesh, rules),
                cache_t, f"{where} cache")
    assert n > 0


def test_mesh_shapes():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert (one.shape, one.size) == ({"data": 16, "model": 16}, 256)
    assert (two.shape, two.size) == ({"pod": 2, "data": 16, "model": 16},
                                     512)
    assert batch_axes(one) == ("data",) and batch_axes(two) == ("pod", "data")
    host = make_host_mesh()
    assert host.axis_names == ("data",) and host.size >= 1
    with pytest.raises(ValueError):
        MeshShape(("data",), (2, 2))


def test_roofline_terms():
    r = Roofline(flops=2 * PEAK_FLOPS, hbm_bytes=HBM_BW, chips=2)
    d = r.as_dict()
    assert d["t_compute_s"] == 1.0 and d["t_memory_s"] == 0.5
    assert d["bottleneck"] == "compute"
    assert d["t_collective_s"] is None and d["collective_bytes"] is None
    assert Roofline(1.0, 1e15, 1).bottleneck == "memory"


@pytest.mark.parametrize("arch", cfg_lib.ARCHS)
def test_build_case_traces_smoke_configs(arch, monkeypatch):
    """Every mode's step of the smoke config traced on fake tensors at
    SMOKE_SHAPE's sequence and batch (the smoke SSM configs' short chunks
    would make a 32k-token plain scan thousands of chunk steps): the
    outputs' shapes and dtypes, and a positive FLOP count."""
    monkeypatch.setattr(specs.cfg_lib, "get_config",
                        cfg_lib.get_smoke_config)
    monkeypatch.setattr(specs.cfg_lib, "get_shape", lambda name: dataclasses
                        .replace(cfg_lib.SHAPES[name], **SMOKE_SHAPE))
    cfg = cfg_lib.get_smoke_config(arch)
    mesh = make_production_mesh()
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = specs.cfg_lib.get_shape(name)
        case = specs.build_case(arch, name, mesh, microbatch=1)
        counter = dryrun.StepCounter(held=case.args)
        with case.fake_mode, counter:
            out = case.fn(*case.args)
        assert counter.flops > 0 and counter.bytes > 0, (arch, name)
        b = shape.global_batch
        if shape.mode == "train":
            params, opt_state, loss = out
            assert loss.shape == () and loss.dtype == torch.float32
            for new, old in zip(jax.tree.leaves(params),
                                jax.tree.leaves(case.args[0])):
                assert new.shape == old.shape and new.dtype == old.dtype
            assert set(opt_state) == {"step", "m", "v"}
        elif shape.mode == "prefill":
            assert tuple(out.shape) == (b, shape.seq_len, cfg.vocab)
        else:
            logits, cache = out
            assert tuple(logits.shape) == (b, 1, cfg.vocab)
            # the cache is written in place: the argument's tensors
            assert all(x is y for x, y in zip(jax.tree.leaves(cache),
                                              jax.tree.leaves(case.args[1])))


def test_dryrun_main_reports_and_goes_on(monkeypatch, capsys):
    """A case that raises is reported as failed and the run goes on."""
    seen = []

    def fake_run(arch, shape, mp, **kw):
        seen.append(arch)
        if arch == "stablelm-3b":
            raise RuntimeError("trace failed")
        return {}
    monkeypatch.setattr(dryrun, "run_case", fake_run)
    assert dryrun.main(["--arch", "all", "--shape", "decode_32k"]) == 1
    assert seen == list(cfg_lib.ARCHS)
    assert "FAIL stablelm-3b x decode_32k" in capsys.readouterr().out


def test_full_size_run_case(tmp_path):
    """granite-moe-1b-a400m x train_4k traced at full published size
    (global batch 256 x 4096 in 4 microbatches, bf16 params, remat).

    useful_flops_frac = 6 N T / traced FLOPs, N = 478,992,384 active
    params, so 6N = 2.87 GFLOP a token. The traced step is four passes
    over the units (forward, remat's recompute, the backward's two
    products a matmul), so with nothing else it would be 8N a token,
    0.75. The plain attention computes the full S x S products at S = 4096
    (causality masks, it skips nothing): 4 S d_attn = 16.8 MFLOP a token a
    layer, 0.40 GFLOP over 24 layers, in each of the four passes; the
    embedding's 50 M params are a gather with no FLOPs, and the unembed is
    not recomputed. So the four passes hold at most 4 (2N - 0.10 + 0.40)
    - 0.10 = 5.0 GFLOP a token: a fraction of at most 0.58, which the band
    rounds up to 0.60. The MoE's capacity padding (factor 1.25 on the
    experts' products) and the router and dispatch only lower it: the
    band's floor, 0.40 (7.2 GFLOP a token), allows them up to 2.2 GFLOP a
    token."""
    r = dryrun.run_case("granite-moe-1b-a400m", "train_4k", False,
                        out_dir=tmp_path, verbose=False)
    assert 0.40 <= r["useful_flops_frac"] <= 0.60, r["useful_flops_frac"]
    tokens = 256 * 4096
    assert r["model_flops"] == 6 * 478_992_384 * tokens
    m = r["memory"]
    # train: args = params + opt state + batch; outputs = params + opt
    # state + the f32 loss; tokens and labels int32, batch over 'data'
    assert m["argument_bytes"] - m["output_bytes"] == \
        2 * tokens * 4 // 16 - 4
    whole = params_lib.spec_bytes(model_lib.build_template(
        cfg_lib.get_config("granite-moe-1b-a400m")), torch.bfloat16)
    assert whole // 256 < m["argument_bytes"] < 5 * whole
    assert m["temp_bytes"] > 0 and "estimate" in m["temp_bytes_is"]
    # no device peak is claimed: the trace measures none
    assert "peak_bytes" not in m
    roof = r["roofline"]
    assert roof["chips"] == 256 and roof["t_collective_s"] is None
    assert roof["t_compute_s"] == pytest.approx(
        roof["hlo_flops"] / (256 * PEAK_FLOPS))
    saved = json.loads((tmp_path / "granite-moe-1b-a400m_train_4k_16-16.json")
                       .read_text())
    assert saved["useful_flops_frac"] == r["useful_flops_frac"]
    assert saved["mesh"] == "16x16" and saved["ok"]
