"""The port's two-stage GPipe forward (``repro_torch.launch.pipeline``)
against ``repro.launch.pipeline`` on the reference's own weights.

The reference runs once, in a subprocess with two forced host devices
(its ``shard_map`` needs a 2-device ``"pod"`` mesh; the enable_x64 alias
that JAX 0.9 dropped is patched in the subprocess's code): ``build_demo``
and ``reference_forward`` at (4 layers, width 64, batch 8, 2 microbatches)
and (8, 256, 16, 4), written as ``.npz``. The port runs as one spawned
2-rank gloo world on the CPU (``torch.multiprocessing``, a ``file://``
init, joined under a time limit and killed at expiry), started before the
reference so that its start-up overlaps it; the ranks wait for a marker
written once the reference's outputs are in place. Each
rank carries the weights across (``convert.pipeline_params_from_numpy``)
with the other stage's slice set to NaN, so a rank that read more than its
own slice would spoil its output, and runs ``gpipe_forward`` through the
fused linear op (its plain version on CPU tensors), counting its layer
calls.

Tolerance: 1e-5 of the output's largest magnitude (the reference's f32
contract: XLA's and PyTorch's CPU matmuls sum in different orders).
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import pipeline as pipe
from repro_torch.models.convert import pipeline_params_from_numpy
from repro_torch.sharding import CohortMesh, pod_mesh

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
# tag -> (n_layers, width, batch, n_micro)
SIZES = {"small": (4, 64, 8, 2), "demo": (8, 256, 16, 4)}
RTOL = 1e-5
RANK_LIMIT_S = 120
READY = "reference.ready"

REFERENCE = """
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
import numpy as np
from repro.launch.pipeline import build_demo, reference_forward
mesh = jax.make_mesh((2,), ("pod",))
for tag, (n_layers, width, batch, n_micro) in {sizes!r}.items():
    params, x, y = build_demo(mesh, n_layers=n_layers, width=width,
                              batch=batch, n_micro=n_micro)
    np.savez(f"{out}/{{tag}}.npz", w=np.asarray(params["w"]),
             b=np.asarray(params["b"]), x=np.asarray(x), y=np.asarray(y),
             ref=np.asarray(reference_forward(params, x)))
print("REFERENCE_OK")
"""


def _rank_main(rank: int, init: str, out_dir: str) -> None:
    """One stage: every size's ``gpipe_forward`` on the reference's
    weights, the other stage's slice NaN; writes its outputs and its
    layer-call counts."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    try:
        deadline = time.monotonic() + RANK_LIMIT_S
        while not os.path.exists(os.path.join(out_dir, READY)):
            assert time.monotonic() < deadline, "no reference outputs"
            time.sleep(0.1)
        mesh = pod_mesh(2)
        out = {"axis": mesh.shape, "rank": mesh.rank}
        for tag, (n_layers, _, _, n_micro) in SIZES.items():
            data = np.load(os.path.join(out_dir, f"{tag}.npz"))
            params = pipeline_params_from_numpy(
                {"w": data["w"], "b": data["b"]}, device="cpu")
            for t in params.values():
                t[1 - rank] = float("nan")
            calls = []

            def layer(lp, x):
                calls.append(1)
                return pipe.mlp_layer_fn(lp, x)

            with torch.no_grad():
                y = pipe.gpipe_forward(layer, params,
                                       torch.from_numpy(data["x"]), mesh,
                                       n_micro, n_layers // 2)
            out[tag] = (y, len(calls))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs (``.npz`` per size), and the port's two
    ranks' outputs on them."""
    tmp = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    code = textwrap.dedent(REFERENCE).format(sizes=SIZES, out=str(tmp))
    ctx = mp.start_processes(_rank_main, args=(f"file://{tmp}/init",
                                               str(tmp)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_LIMIT_S
    try:
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert "REFERENCE_OK" in res.stdout, res.stderr[-2000:]
        (tmp / READY).touch()
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "the ranks ran too long"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ref = {tag: dict(np.load(tmp / f"{tag}.npz")) for tag in SIZES}
    port = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return ref, port


def _close(got, want) -> None:
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("tag", list(SIZES))
def test_gpipe_matches_the_reference_gpipe(runs, tag):
    ref, port = runs
    for out in port:
        y, _ = out[tag]
        assert torch.isfinite(y).all()
        _close(y.numpy(), ref[tag]["y"])
    # the finished microbatches come back identical on both ranks
    assert torch.equal(port[0][tag][0], port[1][tag][0])


@pytest.mark.parametrize("tag", list(SIZES))
def test_gpipe_matches_reference_forward(runs, tag):
    """Against the unpipelined oracle: the reference's, and the port's own
    on the carried weights."""
    ref, port = runs
    _close(port[0][tag][0].numpy(), ref[tag]["ref"])
    params = pipeline_params_from_numpy({"w": ref[tag]["w"],
                                         "b": ref[tag]["b"]}, device="cpu")
    mine = pipe.reference_forward(params, torch.from_numpy(ref[tag]["x"]))
    _close(mine.numpy(), ref[tag]["ref"])
    _close(port[0][tag][0].numpy(), mine.numpy())


@pytest.mark.parametrize("tag", list(SIZES))
def test_each_stage_runs_its_microbatches_once(runs, tag):
    """The fill and drain ticks are skipped: each rank calls its layer
    n_micro x layers_per_stage times, and the mesh is the "pod" axis."""
    _, port = runs
    n_layers, _, _, n_micro = SIZES[tag]
    for r, out in enumerate(port):
        assert out[tag][1] == n_micro * n_layers // 2
        assert out["axis"] == {"pod": 2} and out["rank"] == r


def test_mesh_of_other_size_raises():
    params, x = pipe.demo_inputs(4, 8, 4)
    one = pod_mesh()          # no process group: one rank
    assert one.size == 1 and one.shape == {"pod": 1}
    for mesh in (one, CohortMesh(3, 0, axis="pod")):
        with pytest.raises(ValueError, match="two stages"):
            pipe.gpipe_forward(pipe.mlp_layer_fn, params, x, mesh, 2, 2)


def test_pipeline_params_from_numpy_checks_the_layout():
    w = np.zeros((2, 2, 4, 4), np.float32)
    b = np.zeros((2, 2, 4), np.float32)
    got = pipeline_params_from_numpy({"w": w, "b": b}, device="cpu")
    assert got["w"].shape == (2, 2, 4, 4) and got["b"].dtype == torch.float32
    for bad in ({"w": w[:1], "b": b[:1]}, {"w": w, "b": b[..., :3]},
                {"w": w, "b": b, "x": b}):
        with pytest.raises(ValueError, match="2-stage demo"):
            pipeline_params_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="split in two"):
        pipe.demo_inputs(3, 8, 4)
