"""The port's hill-climbing driver (``repro_torch.launch.hillclimb``) and
the ``build_case`` keywords it needs (``extra_rules``, ``moe_groups``)
against ``repro``'s.

* The variants' names, hypotheses and keywords equal the reference's, read
  from ``src/repro/launch/hillclimb.py`` with ``ast`` (importing it sets
  ``XLA_FLAGS`` for the process), its ``jnp`` dtypes mapped to torch's.
* A hill climb over a few variants of a smoke config (patched in as
  ``tests/test_torch_dryrun.py`` does) writes one JSON entry a variant, a
  raising variant recorded with its error, the collective term None with
  its reason; ``no_fsdp`` raises the per-device argument bytes over the
  baseline's and ``adam_bf16_moments`` lowers them.
* ``extra_rules`` gives the reference's ``rules_for`` plus ``update``
  partition specs; ``moe_groups`` sets the MoE dispatch groups, and the
  optimized profile's own group choice applies only without it.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import ast  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import types  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch import configs as cfg_lib  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import NO_COLLECTIVES  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the smoke configs' shapes: tests/test_torch_dryrun.py's sequence, a batch
# that four microbatches split and eight do not
SMOKE_SHAPE = dict(seq_len=64, global_batch=4)
TABLES = ("TRAIN_VARIANTS", "DECODE_VARIANTS", "PREFILL_VARIANTS")
# the reference's jnp dtypes as the port names them
JNP = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _value(node):
    """A keyword's value in the reference's source: a literal, or a
    ``jnp.<dtype>`` attribute mapped to the torch dtype."""
    if isinstance(node, ast.Attribute):
        assert isinstance(node.value, ast.Name) and node.value.id == "jnp"
        return JNP[node.attr]
    return ast.literal_eval(node)


def _reference_variants() -> dict:
    """table -> name -> (hypothesis, keywords) of the reference's module,
    parsed, not imported."""
    tree = ast.parse((ROOT / "src/repro/launch/hillclimb.py").read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in TABLES):
            table = {}
            for key, val in zip(node.value.keys, node.value.values):
                hyp, kw = val.elts
                if isinstance(kw, ast.Call):
                    assert kw.func.id == "dict" and not kw.args
                    kw = {k.arg: _value(k.value) for k in kw.keywords}
                else:
                    kw = ast.literal_eval(kw)
                table[ast.literal_eval(key)] = (ast.literal_eval(hyp), kw)
            out[node.targets[0].id] = table
    return out


def test_variants_equal_the_reference():
    ref = _reference_variants()
    assert set(ref) == set(TABLES)
    for name in TABLES:
        got, want = getattr(hillclimb, name), ref[name]
        assert list(got) == list(want), name
        for variant, (hyp, kw) in want.items():
            assert got[variant][0] == hyp, (name, variant)
            assert got[variant][1] == kw, (name, variant)
    assert hillclimb.variants_for("train") is hillclimb.TRAIN_VARIANTS
    assert hillclimb.variants_for("decode") is hillclimb.DECODE_VARIANTS
    assert hillclimb.variants_for("prefill") is hillclimb.PREFILL_VARIANTS


@pytest.fixture()
def smoke(monkeypatch):
    """The smoke configs at SMOKE_SHAPE in place of the published ones."""
    monkeypatch.setattr(specs.cfg_lib, "get_config",
                        cfg_lib.get_smoke_config)
    monkeypatch.setattr(specs.cfg_lib, "get_shape", lambda name: dataclasses
                        .replace(cfg_lib.SHAPES[name], **SMOKE_SHAPE))


def test_hillclimb_writes_every_variant(smoke, tmp_path, capsys):
    """Four train variants of deepseek-7b's smoke config: one JSON entry a
    variant in order, ``micro8`` (8 microbatches of a batch of 4) recorded
    with its error, the others with their terms, the collective term None
    with its reason; no_fsdp holds more argument bytes a device than the
    baseline, bf16 moments fewer."""
    only = ["baseline", "micro8", "no_fsdp", "adam_bf16_moments"]
    log = hillclimb.hillclimb("deepseek-7b", "train_4k", out_dir=tmp_path,
                              only=only)
    saved = json.loads((tmp_path / "deepseek-7b_train_4k.json").read_text())
    assert saved == json.loads(json.dumps(log))
    assert (saved["arch"], saved["shape"], saved["mesh"]) == (
        "deepseek-7b", "train_4k", "16x16")
    rows = {r["variant"]: r for r in saved["iterations"]}
    assert [r["variant"] for r in saved["iterations"]] == only
    for name, row in rows.items():
        assert row["hypothesis"] == hillclimb.TRAIN_VARIANTS[name][0]
    assert rows["micro8"]["error"].startswith("ValueError: batch 4")
    for name in ("baseline", "no_fsdp", "adam_bf16_moments"):
        row = rows[name]
        assert "error" not in row
        assert row["t_collective_s"] is None
        assert row["t_collective_reason"] == NO_COLLECTIVES
        assert row["temp_gib_is"] == dryrun.TEMP_ESTIMATE
        assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0
        assert row["trace_s"] >= 0 and row["temp_gib"] > 0
    base = rows["baseline"]["args_gib"]
    assert rows["no_fsdp"]["args_gib"] > base
    assert rows["adam_bf16_moments"]["args_gib"] < base
    out = capsys.readouterr().out
    assert "collectives not counted" in out and "ERROR ValueError" in out


def _ref_mesh(mesh):
    return types.SimpleNamespace(shape=mesh.shape, axis_names=mesh.axis_names)


@pytest.mark.parametrize("arch,shape,extra", [
    ("deepseek-7b", "train_4k", {"embed": None}),
    ("granite-moe-1b-a400m", "train_4k", {"moe_d": None, "moe_f": "data"}),
    ("deepseek-7b", "prefill_32k", {"mlp": "data"}),
    ("deepseek-7b", "decode_32k", {"hd": None, "seq": "model"}),
])
def test_extra_rules_update_the_reference_rules(arch, shape, extra):
    """``extra_rules`` update the rules after ``rules_for``: the case's
    param specs (and a decode case's cache specs) equal the reference's
    partition specs under its ``rules_for`` plus ``update``, and differ
    from the case's without them."""
    mesh = make_production_mesh()
    ref_mesh = _ref_mesh(mesh)
    cfg, ref_cfg = cfg_lib.get_config(arch), ref_configs.get_config(arch)
    rules = ref_specs.rules_for(ref_cfg, ref_configs.get_shape(shape),
                                ref_mesh)
    rules.update(extra)
    got = specs.build_case(arch, shape, mesh, extra_rules=extra)
    plain = specs.build_case(arch, shape, mesh)
    want = ref_params.partition_specs(
        ref_model.build_template(ref_cfg), ref_mesh, rules)
    flat = []

    def walk(g, w, where):
        if isinstance(w, dict):
            assert set(g) == set(w), where
            for k in w:
                walk(g[k], w[k], f"{where}.{k}")
        else:
            assert g == tuple(w), (where, g, w)
            flat.append(g)
    walk(got.in_specs[0], want, arch)
    assert flat and got.in_specs != plain.in_specs
    if cfg_lib.get_shape(shape).mode == "decode":
        s = cfg_lib.get_shape(shape)
        cache_t = ref_model.cache_template(
            ref_cfg, s.global_batch, specs.cache_len_for(cfg, s))
        walk(got.in_specs[1], ref_params.partition_specs(cache_t, ref_mesh,
                                                         rules), "cache")


@pytest.mark.parametrize("moe_groups,profile,shape,want", [
    (None, "baseline", "train_4k", 1),
    (16, "baseline", "train_4k", 16),
    (None, "optimized", "train_4k", 16),
    (4, "optimized", "train_4k", 4),
    (8, "baseline", "decode_32k", 8),
])
def test_moe_groups_set_the_dispatch_groups(monkeypatch, moe_groups,
                                            profile, shape, want):
    """``moe_groups`` sets the MoE config's dispatch groups; the optimized
    profile's choice (the batch axis's size, 16) applies only where it is
    None, as in the reference's ``build_case``; a dense config keeps no
    MoE."""
    seen = []
    real = model_lib.build_template
    monkeypatch.setattr(specs.model_lib, "build_template",
                        lambda cfg: seen.append(cfg) or real(cfg))
    mesh = make_production_mesh()
    specs.build_case("granite-moe-1b-a400m", shape, mesh,
                     moe_groups=moe_groups, profile=profile)
    assert seen[-1].moe.dispatch_groups == want
    specs.build_case("deepseek-7b", shape, mesh, moe_groups=16,
                     profile=profile)
    assert seen[-1].moe is None


def test_model_pattern_is_pattern_of():
    for arch in cfg_lib.ARCHS:
        cfg = cfg_lib.get_config(arch)
        assert dryrun.model_pattern(cfg) == model_lib.pattern_of(cfg) == \
            ref_model.pattern_of(ref_configs.get_config(arch))
