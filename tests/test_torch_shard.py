"""The port's sharded cohort engine (``repro_torch.fl.shard``, the cohort
mesh of ``repro_torch.sharding``) against ``repro``'s ``engine="sharded"``
on the same numpy inputs, at a narrow VGG width and two tiers (so the
tiers pad to mesh multiples).

The reference runs once, in this process, on its one-device CPU mesh. The
port runs as a mesh of 1 rank twice in this process (no process group,
then a one-rank gloo group) and of 2 and 3 ranks under gloo, each world
spawned once for the module (``torch.multiprocessing``, a ``file://``
init), every rank running the whole of :func:`_port_outputs` and writing
its results for the checks here. Each spawn is joined under its own time
limit and killed at expiry, so a hung collective fails its tests instead
of stalling the suite.

Tolerances: decisions and queues bit-identical (the control plane is
numpy on both sides, the statistics injected or held); f32 losses and
params at atol = rtol = 1e-5 (the reference's f32 contract: the ranks'
sums add in another order); the statistics at rtol 1e-4 (norms of
differences of whole-model gradients, as ``tests/test_torch_sim.py``
holds them); bf16 at the reference's bf16 contract
(``tests/test_mixed_precision.py``: losses 5e-2, params 3e-2).

The ranks import this module too and need only the port: the reference's
modules are imported on first use (:func:`_ref`), with the enable_x64
shim the other files apply at import.
"""
import dataclasses
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.fl as port_fl
from repro_torch.core.participation import DataStats
from repro_torch.fl import sim
from repro_torch.fl.data import CohortLayout, sample_cohort_batch
from repro_torch.fl.shard import ShardedCohortEngine
from repro_torch.models.convert import params_to_numpy
from repro_torch.sharding import COHORT_AXIS, cohort_mesh

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_LOSS_TOL = dict(atol=5e-2, rtol=5e-2)
BF16_PARAM_TOL = dict(atol=3e-2, rtol=3e-2)
SC = dict(width_mult=0.0625, max_dataset=400, k_iters=2, sigma_samples=2,
          rounds=2, eval_every=2, tiers=2, engine="sharded")
SHOP_SEED = 17
# one spawned world's limit, start-up included (about 10 s each here)
SPAWN_LIMIT_S = 120
WORLDS = ["1-nogroup", "1-gloo", "2-gloo", "3-gloo"]


def _ref():
    """The reference's modules, imported on first use (see the module
    docstring)."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        # the reference imports this alias, which JAX 0.9 dropped; patched
        # for this process only
        jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    from repro.fl import data as ref_data
    from repro.fl import sim as ref_sim   # repro.fl registers "sharded"
    return jax, ref_sim, ref_data


def _np_params(params):
    return [{k: np.array(v) for k, v in p.items()} for p in params]


def _records(records):
    """What the checks read of a RoundRecord stream, as numpy."""
    return [dict(selected=r.selected, trained=list(r.trained), l_n=r.l_n,
                 delay=r.delay, queues=r.queues, losses=r.losses,
                 accuracy=r.accuracy, boundary_rms=r.boundary_rms)
            for r in records]


def _mid_cut(s):
    device_ids = [dev.idx for gw in s.gateways for dev in gw.devices]
    return device_ids, np.full(s.net.cfg.n_devices, s.plan.n_blocks // 2,
                               dtype=int)


def _inputs(r) -> dict:
    """What a rank needs of the reference, its starting point (weights,
    statistics, the batch stream after the statistics pass), as numpy and
    plain Python: a rank unpickles it without the reference."""
    return dict(params0=_np_params(r.params), rng0=r.rng.bit_generator.state,
                stats={f.name: np.asarray(getattr(r.stats, f.name))
                       for f in dataclasses.fields(r.stats)})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded engine (one-device mesh): its statistics,
    two rounds with boundary telemetry on each data plane and in bf16,
    the shop-floor round, all as numpy. Worlds 2 and 3 start as soon as
    the starting point (``"inputs"``) exists and run while the rest of
    the reference does (``"spawned"``: their process contexts, joined by
    :func:`worlds`); any rank still alive at the module's end is
    killed."""
    jax, ref_sim, _ = _ref()
    r = ref_sim.Simulation(ref_sim.Scenario(**SC))
    out = dict(inputs=_inputs(r), stats=r.stats, d_tilde=np.asarray(r.d_tilde),
               capacity=r.cohort_capacity, spawned={})
    out.update(params0=out["inputs"]["params0"], rng0=out["inputs"]["rng0"])
    for n in (2, 3):
        tmp = tmp_path_factory.mktemp(f"world{n}")
        ctx = mp.start_processes(
            _rank_main, args=(n, f"file://{tmp}/init", str(tmp),
                              out["inputs"]),
            nprocs=n, join=False, start_method="spawn")
        out["spawned"][f"{n}-gloo"] = (ctx, str(tmp), time.monotonic())
    try:
        out["host"] = _records(r.rounds(boundary=True))
        out["host_final"] = _np_params(r.params)
        device_ids, l_n = _mid_cut(r)
        _, gw_models, gw_loss, _ = r.engine.shop_floor_round(
            r, device_ids, l_n, params=jax.tree.map(jax.numpy.asarray,
                                                    out["params0"]),
            rng=np.random.default_rng(SHOP_SEED))
        out["shop"] = ([[jax.tree.map(lambda a: np.asarray(a[m]), p)
                         for p in gw_models]
                        for m in range(r.net.cfg.n_gateways)],
                       np.asarray(gw_loss))
        for label, kw in (("traced", dict(data_plane="traced")),
                          ("bf16", dict(dtype="bf16"))):
            t = ref_sim.Simulation(ref_sim.Scenario(**SC, **kw), r.stats)
            t.rng.bit_generator.state = out["rng0"]
            out[label] = _records(t.rounds())
            out[f"{label}_final"] = _np_params(t.params)
        yield out
    finally:
        for ctx, _, _ in out["spawned"].values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()


def _port_outputs(inputs, ckpt_dir) -> dict:
    """Everything the checks read, from one rank of the port's sharded
    engine: the mesh, the statistics pass and two rounds with boundary
    telemetry (a save after the first round by the mesh's first rank, a
    resume on every rank, its second round), the shop-floor round,
    ``run_fused`` on the host plane, both loops on the traced plane, and
    two bf16 rounds."""
    params0, rng0 = inputs["params0"], inputs["rng0"]
    stats = DataStats(**inputs["stats"])
    mesh = cohort_mesh()
    out = dict(mesh=(mesh.size, mesh.rank, mesh.shape))
    if mesh.group is not None and mesh.size > 1:
        try:
            small = cohort_mesh((mesh.size - 1,))
            out["small_mesh"] = (small.size, small.rank)
        except ValueError as e:
            out["small_mesh"] = str(e)

    # the reference's statistics drive the rounds (a decision hangs on
    # them); the port's own pass runs from the same point of the stream
    s = sim.Simulation(sim.Scenario(**SC), stats, device="cpu",
                       init_params=params0)
    est = s.estimate_stats()
    out["stats"] = {f: getattr(est, f) for f in
                    ("sigma", "delta", "lipschitz", "d_tilde")}
    out["rng_after_stats"] = s.rng.bit_generator.state
    out["layout"] = s.engine._layout(s, s.cohort_capacity)
    it = s.rounds(boundary=True)
    first = next(it)
    s.save(ckpt_dir)
    s.flush()
    resumed = sim.Simulation.resume(ckpt_dir, device="cpu")
    second = next(it)
    out["host_rng"] = s.rng.bit_generator.state
    out["host"] = _records([first, second])
    out["host_final"] = params_to_numpy(s.plan, s.params)
    again = next(resumed.rounds(boundary=True))
    out["resumed"] = _records([again])
    out["resumed_final"] = params_to_numpy(resumed.plan, resumed.params)
    out["ckpt_files"] = sorted(os.listdir(ckpt_dir))

    device_ids, l_n = _mid_cut(s)
    s.reset()
    for label, eng in (("shop", s.engine),
                       ("shop_cohort", sim.make_engine("cohort"))):
        _, gw_models, gw_loss, _ = eng.shop_floor_round(
            s, device_ids, l_n, rng=np.random.default_rng(SHOP_SEED))
        out[label] = ([params_to_numpy(s.plan, [{k: v[m] for k, v in
                                                 p.items()}
                                                for p in gw_models])
                       for m in range(s.net.cfg.n_gateways)], gw_loss)

    for label, kw in (("host_fused", dict()),
                      ("traced", dict(data_plane="traced")),
                      ("traced_fused", dict(data_plane="traced")),
                      ("bf16", dict(dtype="bf16"))):
        t = sim.Simulation(sim.Scenario(**SC, **kw), stats, device="cpu",
                           init_params=params0)
        t.rng.bit_generator.state = rng0
        records = t.fused_rounds() if label.endswith("fused") \
            else list(t.rounds())
        out[label] = _records(records)
        out[f"{label}_final"] = params_to_numpy(t.plan, t.params)
        out[f"{label}_rng"] = t.rng.bit_generator.state
    return out


def _rank_main(rank, world, init, out_dir, inputs):
    """One spawned rank: join the gloo group, run :func:`_port_outputs`,
    write its results."""
    torch.set_num_threads(1)      # the ranks share the suite's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = _port_outputs(inputs, os.path.join(out_dir, "ckpt"))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _joined(world: str, ctx, tmp: str, started: float) -> list:
    """Every rank's outputs from a spawned gloo world, joined within
    SPAWN_LIMIT_S of its start; a rank still running then is killed and
    the test fails."""
    deadline = started + SPAWN_LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world}: the ranks did not end "
                                   f"within {SPAWN_LIMIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(ctx.processes))]


@pytest.fixture(scope="module")
def worlds(reference):
    """world label -> every rank's outputs, each world run once: the
    spawned ones joined, the one-rank ones run here."""
    cache = {}

    def get(label):
        if label in cache:
            return cache[label]
        if label in reference["spawned"]:
            cache[label] = _joined(label, *reference["spawned"][label])
            return cache[label]
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ckpt")
            if label == "1-nogroup":
                cache[label] = [_port_outputs(reference["inputs"], ckpt)]
            else:
                dist.init_process_group(
                    "gloo", init_method=f"file://{tmp}/init", rank=0,
                    world_size=1)
                try:
                    cache[label] = [_port_outputs(reference["inputs"], ckpt)]
                finally:
                    dist.destroy_process_group()
        return cache[label]
    return get


def _trees_close(got, want, **tol):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **tol)


def _records_match(got, want, loss_tol, boundary: bool = False,
                   accuracy: bool = True):
    assert len(got) == len(want) == SC["rounds"]
    assert any(w["trained"] for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["selected"], w["selected"])
        assert g["trained"] == w["trained"]
        np.testing.assert_array_equal(g["l_n"], w["l_n"])
        assert g["delay"] == w["delay"]
        np.testing.assert_array_equal(g["queues"], w["queues"])
        np.testing.assert_allclose(g["losses"], w["losses"], **loss_tol)
        assert (g["accuracy"] is None) == (w["accuracy"] is None)
        if accuracy and w["accuracy"] is not None:
            # one test image in a thousand (two such ratios can differ by
            # 1e-3 and an ulp)
            assert abs(g["accuracy"] - w["accuracy"]) <= 1e-3 + 1e-12
        if boundary:
            np.testing.assert_allclose(g["boundary_rms"], w["boundary_rms"],
                                       **TOL)


# ---------------------------------------------------------------------------
# the mesh, the registry and the layouts
# ---------------------------------------------------------------------------


def test_cohort_mesh_clamps_without_a_group():
    """No process group: a one-rank mesh whose reduction is the identity,
    whatever size is asked for (the reference's one-device mesh)."""
    assert not dist.is_initialized()
    for shape in (None, (8,), (2, 4), (1,)):
        mesh = cohort_mesh(shape)
        assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
        assert mesh.shape == {COHORT_AXIS: 1}
    t = torch.arange(3.0)
    assert cohort_mesh().all_reduce(t) is t and t.tolist() == [0, 1, 2]


def test_make_engine_sharded_and_the_package_exports_it():
    _, ref_sim, _ = _ref()
    eng = sim.make_engine("sharded")
    assert isinstance(eng, ShardedCohortEngine)
    assert isinstance(eng, sim.CohortEngine)
    assert port_fl.ShardedCohortEngine is ShardedCohortEngine
    assert sim.ENGINES["sharded"] is ShardedCohortEngine
    assert set(sim.ENGINES) == set(ref_sim.ENGINES)


@pytest.mark.parametrize("shards", [2, 3])
def test_layouts_match_reference_at_shard_count(reference, shards):
    """``CohortLayout.build(..., shard_count=n)`` against the reference's:
    tier widths and slot counts (each a multiple of n) and padded
    samples, at the simulation's capacity and every tier count."""
    _, _, ref_data = _ref()
    d_tilde = reference["d_tilde"]
    for tiers in (1, 2, 3, "auto"):
        for cap in (reference["capacity"], len(d_tilde)):
            got = CohortLayout.build(d_tilde, cap, tiers, shards)
            want = ref_data.CohortLayout.build(d_tilde, cap, tiers, shards)
            assert got.tier_slots == want.tier_slots
            assert got.tier_widths == want.tier_widths
            assert got.padded_samples == want.padded_samples
            assert all(s % shards == 0 for s in got.tier_slots)


# ---------------------------------------------------------------------------
# worlds 1, 2 and 3 against the reference's sharded engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_layout_of_each_rank(worlds, reference, world):
    """Each rank's mesh (the world's size, its own rank), the engine's
    layout carrying the mesh size as its shard count (the reference's
    layout at that count), and a smaller mesh: a group of the first ranks,
    where the last rank raises."""
    _, _, ref_data = _ref()
    outs = worlds(world)
    n = len(outs)
    for rank, out in enumerate(outs):
        assert out["mesh"] == (n, rank, {COHORT_AXIS: n})
        want = ref_data.CohortLayout.build(
            reference["d_tilde"], reference["capacity"], SC["tiers"], n)
        assert out["layout"].tier_slots == want.tier_slots
        assert out["layout"].padded_samples == want.padded_samples
        if n > 1:
            if rank < n - 1:
                assert out["small_mesh"] == (n - 1, rank)
            else:
                assert "outside the cohort mesh" in out["small_mesh"]


@pytest.mark.parametrize("world", WORLDS)
def test_statistics_match_reference(worlds, reference, world):
    """The sharded statistics pass on every rank: sigma, delta and L at
    rtol 1e-4, having drawn the reference's batch stream."""
    for out in worlds(world):
        assert out["rng_after_stats"] == reference["rng0"]
        np.testing.assert_array_equal(out["stats"]["d_tilde"],
                                      reference["stats"].d_tilde)
        for f in ("sigma", "delta", "lipschitz"):
            np.testing.assert_allclose(out["stats"][f],
                                       getattr(reference["stats"], f),
                                       rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_rounds_with_boundary_match_reference(worlds, reference, world):
    """Two stepwise rounds with ``boundary=True`` on every rank:
    decisions and queues bit-identical, losses, boundary RMS and the final
    params at 1e-5."""
    for out in worlds(world):
        _records_match(out["host"], reference["host"], TOL, boundary=True)
        _trees_close(out["host_final"], reference["host_final"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_save_on_first_rank_resume_on_every_rank(worlds, world):
    """A save after the first round writes from the mesh's first rank only
    (one step's files); every rank resumes the directory and its second
    round is bit-identical to the uninterrupted one."""
    for out in worlds(world):
        assert out["ckpt_files"] == ["sim_00000001.json",
                                     "step_00000001.json",
                                     "step_00000001.npz"]
        g, w = out["resumed"][0], out["host"][1]
        for k in ("selected", "l_n", "queues", "losses", "boundary_rms"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["trained"] == w["trained"] and g["delay"] == w["delay"]
        for a, b in zip(out["resumed_final"], out["host_final"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("world", WORLDS)
def test_shop_floor_gateway_models_match_reference(worlds, reference,
                                                   world):
    """``shop_floor_round`` (the all-devices layout, padded to the mesh) on
    every rank: the gateway losses against the reference's at 1e-5, and
    each gateway's model at 1e-5 against the port's single-device
    shop-floor round on the same inputs. Against the reference the
    narrow VGG's models part at 2 of gateway 3's 108 conv1 weights,
    1.75e-5 apart where the rest lie a median 1.3e-8 apart: a max-pool
    tie, not a fault. At the first local step of device 3, row 7, the 2 x 2
    window (15, 8) of conv1's channel 0 holds two values 6.4e-8 apart in
    f64 (2.1182634e-1 and 2.1182640e-1); the reference's f32 conv rounds
    the first above the second and the port's the second above the first,
    so the pool's gradient reaches a different input patch and only that
    channel's conv1 weights differ. The same at one rank and at three, and
    in the cohort engine, so the port's shop-floor round is held against
    the reference's at 1e-5 on the MLP (``tests/test_torch_telemetry.py``)
    and here against itself across meshes."""
    want_models, want_loss = reference["shop"]
    for out in worlds(world):
        got_models, got_loss = out["shop"]
        np.testing.assert_allclose(got_loss, want_loss, **TOL)
        np.testing.assert_allclose(got_loss, out["shop_cohort"][1], **TOL)
        for got, want in zip(got_models, out["shop_cohort"][0]):
            _trees_close(got, want, **TOL)
        assert len(got_models) == len(want_models)


def test_shop_floor_gateway3_parts_at_a_max_pool_tie(reference):
    """Why gateway 3's models part from the reference's (the test above):
    conv1 of both packages, slot-batched on the shop-floor round's first
    batch, agrees within 1e-6 of its largest output, yet the 2 x 2 pool
    window (15, 8) of channel 0 of device 3's row 7 holds two outputs
    6.4e-8 apart in f64 that the packages' f32 convs order either way, so
    the pool's gradient takes another input patch there. Nowhere else on
    that batch does the first pool choose another element."""
    jax, _, _ = _ref()
    from repro.models import split_model as ref_sm
    s = sim.Simulation(sim.Scenario(**SC),
                       DataStats(**reference["inputs"]["stats"]),
                       device="cpu", init_params=reference["params0"])
    device_ids, _ = _mid_cut(s)
    batch = sample_cohort_batch(np.random.default_rng(SHOP_SEED), s.ds,
                                device_ids, s.d_tilde, int(s.d_tilde.max()))
    slots = batch.x.shape[0]
    ref_model = ref_sm.VGGSplitModel(width_mult=SC["width_mult"],
                                     classes=s.plan.classes)
    w0, b0 = (reference["params0"][0][k] for k in ("w", "b"))
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: ref_model.apply_block(0, {"w": w0, "b": b0}, x)))(
            batch.x))
    with torch.no_grad():
        got = s.plan.apply_block(
            0, {k: v.detach().expand(slots, *v.shape)
                for k, v in s.params[0].items()},
            torch.from_numpy(batch.x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(
        want).max())

    def windows(a):
        n, rows, h, w, c = a.shape
        return a.reshape(n, rows, h // 2, 2, w // 2, 2, c).transpose(
            0, 1, 2, 4, 6, 3, 5).reshape(n, rows, h // 2, w // 2, c, 4)
    wa, wb = windows(want), windows(got)
    live = (wa.max(-1) > 0) & batch.mask.astype(bool)[:, :, None, None, None]
    differ = np.argwhere((wa.argmax(-1) != wb.argmax(-1)) & live)
    assert [tuple(int(i) for i in d) for d in differ] == [(3, 7, 15, 8, 0)]
    # the batch's rows are devices (row n = device n): device 3 trains
    # under gateway 3
    assert [m for m, gw in enumerate(s.gateways) for d in gw.devices
            if d.idx == 3] == [3]
    # the two outputs in f64, at conv1 positions (30, 16) and (30, 17)
    x = np.pad(batch.x[3, 7].astype(np.float64), ((1, 1), (1, 1), (0, 0)))
    f64 = [float((x[30:33, c:c + 3] * w0[..., 0]).sum() + b0[0])
           for c in (16, 17)]
    assert 0 < f64[1] - f64[0] < 1e-7
    assert want[3, 7, 30, 16, 0] > want[3, 7, 30, 17, 0]
    assert got[3, 7, 30, 17, 0] > got[3, 7, 30, 16, 0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", ["host_fused", "traced", "traced_fused"])
def test_both_planes_stepwise_and_fused_match_reference(worlds, reference,
                                                        world, label):
    """``fused_rounds`` on the host plane, and both loops on the traced
    plane, from the reference's weights, statistics and batch stream:
    records and params as the stepwise host rounds hold them; the fused
    loop leaves the stepwise loop's batch stream."""
    want = reference["traced" if label.startswith("traced") else "host"]
    final = reference["traced_final" if label.startswith("traced")
                      else "host_final"]
    outs = worlds(world)
    for out in outs:
        _records_match(out[label], want, TOL)
        _trees_close(out[f"{label}_final"], final, **TOL)
    if label.endswith("fused"):
        stepwise = "traced_rng" if label == "traced_fused" else "host_rng"
        assert all(o[f"{label}_rng"] == o[stepwise] for o in outs)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_rounds_match_reference(worlds, reference, world):
    """Two bf16 rounds over f32 masters: decisions and queues
    bit-identical, losses and params at the reference's bf16 contract
    (which, as ``tests/test_torch_bf16.py``'s, holds no accuracy: the
    ranks' test accuracy read 1 and 2 images in 1,000 off)."""
    for out in worlds(world):
        _records_match(out["bf16"], reference["bf16"], BF16_LOSS_TOL,
                       accuracy=False)
        _trees_close(out["bf16_final"], reference["bf16_final"],
                     **BF16_PARAM_TOL)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_every_rank_ends_bit_identical(worlds, world):
    """Every rank of a group ends every path with the same bits: the
    reduced sums are the same on every rank, and each rank divides them
    alike."""
    outs = worlds(world)
    for label in ("host", "host_fused", "traced", "traced_fused", "bf16"):
        for other in outs[1:]:
            for a, b in zip(other[f"{label}_final"],
                            outs[0][f"{label}_final"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            for a, b in zip(other[label], outs[0][label]):
                np.testing.assert_array_equal(a["losses"], b["losses"])
