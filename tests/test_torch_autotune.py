"""The port's kernel-selection tables (``repro_torch.kernels.autotune``)
over the CUDA kernels' pure-Python launch plans: lookup semantics, the
LRU, fallbacks on a missing or corrupt table, strict validation, the
admission of an entry's fields by each plan function, and the committed
tables under ``artifacts/autotune_torch``.

The reference's CPU cases (``tests/test_autotune.py``) carry over with the
port's entries (plan fields where the reference has block tuples). The
sweeps time CUDA kernels and run only on the card (``tools/
autotune_tables.py``, ``chip_smoke.py``); here every table lives in a
temporary directory, and the plans are called with an explicit backend,
as the CUDA path calls them.
"""
import ast
import json
import pathlib

import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.fused_linear import kernel as fl_kernel
from repro_torch.kernels.fused_linear import ops as fl_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = "cuda-sm90-132"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# one shape an op at which each plan has a choice: the pipeline's stage
# layer, the transformer round's attention, mamba2-2.7b's SSD
FL_SHAPE = (1, 128, 4096, 4096)
# dw/db's Hopper form (bf16, M <= 96) runs at the round's fc1
DW_SHAPE = (6, 95, 512, 4096)
FA_SHAPE = (570, 2, 32, 32)
SSD_SHAPE = (1, 4096, 80, 64, 128, 256)
# the backward's chunked form with a choice of heads: few rows, 8 heads
SSD_BWD_SHAPE = (1, 4096, 8, 32, 16, 256)


@pytest.fixture()
def tmp_table_dir(tmp_path, monkeypatch):
    """Point the selection tables at a scratch dir with clean caches."""
    monkeypatch.setattr(autotune, "table_dir", lambda: tmp_path)
    autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()


def _fwd(shape=FL_SHAPE, itemsize=4, backend=H100):
    nb, m, k, n = shape
    return fl_kernel.fwd_plan(nb, m, k, n, sxb=m * k, sxm=k, swb=k * n,
                              swk=n, sbb=n, x_align=16, w_align=16, sms=132,
                              itemsize=itemsize, backend=backend)


def _dx(shape=FL_SHAPE, itemsize=4, backend=H100):
    nb, m, k, n = shape
    return fl_kernel.dx_plan(nb, m, k, n, strides=(m * n, n, m * n, n),
                             swb=k * n, swk=n, dz_align=16, w_align=16,
                             sms=132, itemsize=itemsize, backend=backend)


def _dw(shape=DW_SHAPE, itemsize=2, backend=H100):
    nb, m, k, n = shape
    return fl_kernel.dwdb_plan(nb, m, k, n,
                               strides=(m * k, k, m * n, n, m * n, n),
                               x_align=16, dz_align=16, itemsize=itemsize,
                               sms=132, backend=backend)


def _attn(shape=FA_SHAPE, itemsize=4, backend=H100):
    return fa_kernel.attention_plan(*shape, aligned=True, itemsize=itemsize,
                                    backend=backend)


def _ssd(shape=SSD_SHAPE, itemsize=4, backend=H100):
    return ssd_kernel.ssd_plan(*shape, sms=132, x_aligned=True,
                               bc_aligned=True, itemsize=itemsize,
                               backend=backend)


def _ssd_bwd(shape=SSD_BWD_SHAPE, itemsize=4, backend=H100):
    bsz, s, n, p, ds, chunk = shape
    return ssd_kernel.ssd_bwd_plan(bsz, s, n, p, ds, sms=132, x_aligned=True,
                                   bc_aligned=True, itemsize=itemsize,
                                   chunk=chunk, backend=backend)


PLANS = {"fwd": _fwd, "dx": _dx, "dw": _dw, "attention": _attn, "ssd": _ssd,
         "ssd_bwd": _ssd_bwd}


# ---------------------------------------------------------------------------
# lookup semantics
# ---------------------------------------------------------------------------


def test_cold_key_falls_back_to_heuristic(tmp_table_dir):
    """A cold key gives the rules' plan: no sweep, no disk write, no
    error."""
    for name, plan in PLANS.items():
        assert plan() == plan(backend=None), name
    for op, n in (("fused_linear", 4), ("flash_attention", 4),
                  ("ssd_scan", 6)):
        assert autotune.blocks_for(op, (64,) * n, "float32", H100) == {}
    assert list(tmp_table_dir.iterdir()) == []      # lookups never write


def test_cache_hit_returns_identical_plan(tmp_table_dir):
    """A recorded entry is returned on every later lookup: the table hit,
    then the LRU's same object; another dtype, backend or shape is another
    key (the heuristic)."""
    autotune.record("fused_linear", FL_SHAPE, "float32", H100,
                    {"fwd_splits": 8}, us=10.0, baseline_us=20.0, card=CARD)
    first = autotune.blocks_for("fused_linear", FL_SHAPE, "float32", H100)
    second = autotune.blocks_for("fused_linear", FL_SHAPE, "float32", H100)
    assert first is second and dict(first) == {"fwd_splits": 8}
    for dtype, backend, shape in (("bfloat16", H100, FL_SHAPE),
                                  ("float32", "cuda-sm90-114", FL_SHAPE),
                                  ("float32", H100, (2, 128, 4096, 4096))):
        assert autotune.blocks_for("fused_linear", shape, dtype,
                                   backend) == {}
    autotune.clear_cache()       # persisted: a cold cache reloads it
    assert dict(autotune.blocks_for("fused_linear", FL_SHAPE, "float32",
                                    H100)) == {"fwd_splits": 8}
    with pytest.raises(TypeError):
        first["fwd_splits"] = 1           # read-only: callers share it


def test_corrupt_or_missing_table_falls_back(tmp_table_dir):
    """Corrupt JSON, a wrong schema, or a bad plan inside an entry all
    give the heuristic without raising."""
    path = tmp_table_dir / "fused_linear.json"
    key = autotune.make_key("fused_linear", FL_SHAPE, "float32", H100)
    want = _fwd(backend=None)
    for text in ("{ not json !",
                 json.dumps({"version": 1, "op": "fused_linear"}),
                 json.dumps({"version": 1, "op": "fused_linear",
                             "entries": []}),
                 json.dumps({"version": 1, "op": "fused_linear", "entries": {
                     key: {"plan": {"fwd_splits": "x"}}}}),
                 json.dumps({"version": 1, "op": "fused_linear", "entries": {
                     key: {"plan": {"block_m": 64}}}})):
        path.write_text(text)
        autotune.clear_cache()
        assert _fwd() == want, text


def _entry(op, shape, dtype, plan, us=5.0, baseline_us=10.0):
    return autotune.record(op, shape, dtype, H100, plan, us=us,
                           baseline_us=baseline_us, card=CARD)


def test_validate_table_round_trip_and_rejects_drift(tmp_table_dir):
    """validate_table: entries re-key deterministically; a renamed key, a
    bad field or a non-positive time fails loudly (unlike the runtime
    path)."""
    _entry("fused_linear", FL_SHAPE, "float32", {"fwd_splits": 4})
    assert autotune.validate_table("fused_linear") == 1
    assert autotune.validate_table("flash_attention") == 0   # missing file

    path = tmp_table_dir / "fused_linear.json"
    payload = json.loads(path.read_text())
    (key, entry), = payload["entries"].items()
    for entries, match in (({key + "-renamed": entry}, "round-trip"),
                           ({key: dict(entry, plan={"block_m": 64})},
                            "bad plan"),
                           ({key: dict(entry, plan={"fwd_splits": 0})},
                            "bad plan"),
                           ({key: dict(entry, us=0.0)}, "non-positive"),
                           ({key: dict(entry, card="")}, "names no card")):
        path.write_text(json.dumps(dict(payload, entries=entries)))
        with pytest.raises(ValueError, match=match):
            autotune.validate_table("fused_linear")


# ---------------------------------------------------------------------------
# the plans take the table's fields where they admit them
# ---------------------------------------------------------------------------


def test_planted_entry_changes_the_plans(tmp_table_dir):
    """A planted cuda-sm90-132 entry changes what ssd_plan, fwd_plan,
    dx_plan, dwdb_plan, attention_plan and ssd_bwd_plan return when called
    with that backend, and nothing without one."""
    _entry("fused_linear", FL_SHAPE, "float32",
           {"fwd_splits": 1, "dx_splits": 8})
    _entry("fused_linear", DW_SHAPE, "bfloat16", {"dw_ctas": 66})
    _entry("flash_attention", FA_SHAPE, "float32", {"heads_per_block": 4})
    _entry("ssd_scan", SSD_SHAPE, "float32",
           {"inner": 32, "chunk_parallel": False})
    _entry("ssd_scan", SSD_BWD_SHAPE, "float32", {"bwd_heads": 4})
    base = {name: plan(backend=None) for name, plan in PLANS.items()}
    assert (base["fwd"].splits, _fwd().splits) == (3, 1)
    assert (base["dx"].splits, _dx().splits) == (3, 8)
    assert _dx().n_chunk == 512
    assert (base["dw"].ctas, _dw().ctas) == (132, 66)
    assert _dw(shape=(12, 95, 512, 4096)).ctas == 132   # a miss
    assert _dw(itemsize=4).form == "mma_sync"           # no CTA count
    assert (base["attention"].heads_per_block,
            _attn().heads_per_block) == (1, 4)
    assert (base["ssd"].inner, base["ssd"].chunk_parallel) == (64, True)
    got = _ssd()
    assert (got.inner, got.chunk_parallel, got.chunks) == (32, False, 128)
    assert (base["ssd_bwd"].heads, _ssd_bwd().heads) == (1, 4)
    assert _ssd_bwd().warps == 4
    # the entry keys the forward's chunk: another chunk misses
    assert _ssd_bwd(shape=(1, 4096, 8, 32, 16, 128)).heads == 1


@pytest.mark.parametrize("op,shape,dtype,plan,name", [
    ("ssd_scan", SSD_SHAPE, "float32", {"inner": 48}, "ssd"),
    ("ssd_scan", SSD_SHAPE, "float32", {"heads": 3}, "ssd"),
    ("ssd_scan", SSD_SHAPE, "float32", {"inner": 256}, "ssd"),  # smem
    ("ssd_scan", SSD_BWD_SHAPE, "float32", {"bwd_heads": 3}, "ssd_bwd"),
    ("fused_linear", FL_SHAPE, "float32", {"fwd_splits": 33}, "fwd"),
    ("fused_linear", FL_SHAPE, "float32", {"dx_splits": 64}, "dx"),
    ("fused_linear", DW_SHAPE, "bfloat16", {"dw_ctas": 6145}, "dw"),
    ("fused_linear", DW_SHAPE, "float32", {"dw_ctas": 66}, "dw"),
    ("flash_attention", FA_SHAPE, "float32", {"heads_per_block": 9},
     "attention"),
    ("flash_attention", FA_SHAPE, "bfloat16", {"heads_per_block": 8},
     "attention"),
])
def test_inadmissible_entry_gives_heuristic_and_fails_validation(
        tmp_table_dir, op, shape, dtype, plan, name):
    """An entry the plan function does not admit (an inner chunk of 48, 3
    heads of 80, more splits than the reduction takes, more CTAs than
    tiles, a CTA count for dw/db's mma.sync form, more heads a block than
    the form holds) gives the heuristic
    plan at runtime, and validate_table rejects it."""
    _entry(op, shape, dtype, plan)
    kw = dict(shape=shape, itemsize=2 if dtype == "bfloat16" else 4)
    assert PLANS[name](**kw) == PLANS[name](backend=None, **kw)
    with pytest.raises(ValueError, match="not admitted"):
        autotune.validate_table(op)


def test_tiled_attention_and_tensor_core_ssd_have_no_choice():
    """The tiled attention forms and the SSD's tensor-core forms have no
    free field: no candidates, and an entry is refused."""
    assert autotune.candidates("flash_attention", (1, 16, 4096, 64)) == {}
    assert fa_kernel.entry_error((1, 16, 4096, 64), 4, 132,
                                 {"heads_per_block": 1}) is not None
    assert autotune.candidates("ssd_scan", (570, 32, 4, 32, 16, 32),
                               "bfloat16") == {}
    assert ssd_kernel.entry_error((570, 32, 4, 32, 16, 32), 2, 132,
                                  {"heads": 1}) is not None


@pytest.mark.parametrize("op,shape,dtype", [
    ("fused_linear", FL_SHAPE, "float32"),
    ("fused_linear", (6, 95, 512, 4096), "bfloat16"),
    ("fused_linear", (6, 95, 4096, 10), "float32"),
    ("flash_attention", FA_SHAPE, "float32"),
    ("flash_attention", FA_SHAPE, "bfloat16"),
    ("ssd_scan", SSD_SHAPE, "float32"),
    ("ssd_scan", (570, 32, 4, 32, 16, 32), "float32"),
])
def test_candidates_are_admitted_and_start_at_the_rule(op, shape, dtype):
    """Every candidate is admitted at its shape, each part starts with the
    rules' own fields (a sweep's baseline), and the forward's and dx's
    splits never exceed what the reduction takes."""
    itemsize = {"float32": 4, "bfloat16": 2}[dtype]
    kernel = {"fused_linear": fl_kernel, "flash_attention": fa_kernel,
              "ssd_scan": ssd_kernel}[op]
    parts = autotune.candidates(op, shape, dtype)
    for variants in parts.values():
        assert len({json.dumps(v, sort_keys=True) for v in variants}) == len(
            variants)
        for v in variants:
            assert kernel.entry_error(shape, itemsize, 132, v) is None, v
    assert parts and all(len(v) > 1 for v in parts.values())
    if op == "fused_linear":
        assert parts["fwd"][0]["fwd_splits"] == _fwd(shape, itemsize,
                                                     None).splits
        if "dx" in parts:
            assert parts["dx"][0]["dx_splits"] == _dx(shape, itemsize,
                                                      None).splits
    if op == "ssd_scan":
        base = _ssd(shape, itemsize, None)
        assert parts["fwd"][0] == dict(inner=base.inner, heads=base.heads,
                                       chunk_parallel=base.chunk_parallel,
                                       tc=base.form == "tc")


def test_shared_weight_candidates_start_at_the_folded_rule():
    """With one weight for every slot (the per-sample pass's stride-0
    views) the forward and dx fold the slots, so their rules split
    differently: a shared sweep's baseline is the folded rule's, not the
    unshared one's."""
    nb, m, k, n = shape = (8, 1, 4096, 4096)
    fwd = fl_kernel.fwd_plan(nb, m, k, n, sxb=k, sxm=k, swb=0, swk=n, sbb=0,
                             x_align=16, w_align=16, sms=132)
    dx = fl_kernel.dx_plan(nb, m, k, n, strides=(n, n, n, n), swb=0, swk=n,
                           dz_align=16, w_align=16, sms=132)
    shared = autotune.candidates("fused_linear", shape, shared=True)
    unshared = autotune.candidates("fused_linear", shape)
    assert fwd.fold and dx.fold
    assert shared["fwd"][0] == {"fwd_splits": fwd.splits}
    assert shared["dx"][0] == {"dx_splits": dx.splits}
    assert unshared["fwd"][0] == {"fwd_splits": _fwd(shape, 4, None).splits}
    assert shared["fwd"][0] != unshared["fwd"][0]


# ---------------------------------------------------------------------------
# CPU tensors never read the table; the committed tables; the imports
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_read_the_table(monkeypatch):
    """The wrappers and ops take their plain versions on CPU tensors
    without a lookup."""
    def refuse(*args, **kwargs):
        raise AssertionError("the table was read for a CPU call")
    monkeypatch.setattr(autotune, "blocks_for", refuse)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, generator=g, requires_grad=True)
    w = torch.randn(2, 8, 5, generator=g)
    b = torch.randn(2, 5, generator=g)
    fl_ops.linear(x, w, b, activation="relu").sum().backward()
    q, k, v = (torch.randn(1, 2, 8, 32, generator=g) for _ in range(3))
    fa_kernel.flash_attention(q, k, v)
    xh = torch.randn(1, 8, 2, 4, generator=g, requires_grad=True)
    dt = torch.rand(1, 8, 2, generator=g)
    bc = torch.randn(1, 8, 4, generator=g)
    ssd_ops.ssd(xh, dt, torch.zeros(2), bc, bc, chunk=4).sum().backward()
    assert x.grad is not None and xh.grad is not None


def test_committed_tables_validate():
    """The tables under artifacts/autotune_torch pass the strict check
    (``python -m repro_torch.kernels.autotune --check``): every entry
    re-keys, is admitted at its shape, was timed on a card it names."""
    autotune.clear_cache()
    assert autotune.table_dir() == ROOT / "artifacts" / "autotune_torch"
    for op in autotune.OPS:
        assert autotune.validate_table(op) > 0, op
        entries = json.loads((autotune.table_dir() / f"{op}.json")
                             .read_text())["entries"]
        assert all(e["backend"] == H100 and "H100" in e["card"]
                   for e in entries.values())
    # mamba2-2.7b's SSD entry, re-swept with the chunk-parallel
    # tensor-core forms: it keeps them, forward and backward, as the rules
    # take them
    got = _ssd(SSD_SHAPE)
    assert (got.inner, got.heads, got.chunk_parallel, got.form) == (
        64, 1, True, "tc")
    assert got == _ssd(SSD_SHAPE, backend=None)
    assert _ssd_bwd(SSD_SHAPE).form == "tc"


@pytest.mark.parametrize("path", [
    "src/repro_torch/kernels/autotune.py",
    "src/repro_torch/launch/hillclimb.py",
    "src/repro_torch/launch/dryrun.py",
    "src/repro_torch/launch/specs.py",
    "src/repro_torch/kernels/fused_linear/kernel.py",
    "src/repro_torch/kernels/flash_attention/kernel.py",
    "src/repro_torch/kernels/ssd_scan/kernel.py",
])
def test_modules_import_neither_jax_nor_repro(path):
    """The new modules and the plan functions' modules import nothing of
    jax or of the reference package, at any depth of the file."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
