"""Two-stage pipeline split: the paper's DNN partition mapped to GPUs (port
of ``repro.launch.pipeline``).

The paper's device/gateway tier split becomes a two-stage GPipe pipeline
over a ``"pod"`` mesh of two ranks: rank 0 (the device tier) owns the
bottom layers, rank 1 (the gateway tier) the top ones, and boundary
activations flow from stage 0 to stage 1 as the split-learning exchange of
Sec. II-B3 does. :func:`choose_cut` picks the cut with the paper's
bisection (``repro_torch.core.partition.best_partition``) from per-layer
costs on the card's rates instead of WiFi's.

The reference maps one program over the pod axis (``shard_map``, a
``ppermute`` for the handoff). Here each stage is one process of a
``torch.distributed`` group (:func:`repro_torch.sharding.pod_mesh`), and
the only collective is ``all_reduce``, as the sharded FL engine's: gloo
takes CUDA tensors for it, so NCCL, gloo on the CPU and gloo ranks sharing
one card run the same code.

    PYTHONPATH=src python -m repro_torch.launch.pipeline --device cpu
    PYTHONPATH=src python -m repro_torch.launch.pipeline   # on the card

The command prints the cut of jamba-v0.1-52b's cost-model layers, then
spawns two gloo ranks that run the demo's pipelined forward and hold it
against the unpipelined one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.partition import Tier, best_partition
from repro_torch.kernels.fused_linear import ops as fused_linear_ops
from repro_torch.models.convert import tree_map

# One NVIDIA H100 SXM a stage (NVIDIA's data sheet): dense bf16 tensor-core
# rate, HBM capacity, and NVLink 4's 900 GB/s as 450e9 B/s a direction
# between the two stages.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES = 80e9
NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class PipelineCut:
    """Chosen partition for a layered model on a 2-stage mesh."""
    cut: int              # layers [0, cut) on stage 0, [cut, L) on stage 1
    n_layers: int

    @property
    def stage_layers(self) -> Tuple[int, int]:
        return self.cut, self.n_layers - self.cut


def choose_cut(costs: np.ndarray, mem: np.ndarray, hbm_per_pod: float,
               boundary_bytes: Optional[np.ndarray] = None,
               ici_bw: float = NVLINK_BYTES_PER_S,
               throughput: float = H100_BF16_FLOPS) -> PipelineCut:
    """Run the paper's bisection over per-layer costs (sub-problem 21)
    under the pipeline's bottleneck objective. The keywords keep the
    reference's names: ``hbm_per_pod`` is a stage's memory, ``ici_bw`` the
    link between the stages, ``throughput`` a stage's rate; the defaults
    are one H100 a stage joined by NVLink."""
    tier = Tier(throughput=throughput, mem_capacity=hbm_per_pod)
    cut = best_partition(costs, mem, tier, tier,
                         boundary_bytes=boundary_bytes, link_bw=ici_bw,
                         objective="bottleneck")
    if cut is None:
        raise ValueError("no feasible pipeline partition")
    return PipelineCut(cut, len(costs))


def _stage_apply(layer_fn: Callable, stage_params, x, n_layers: int):
    """Run ``n_layers`` stacked layers in turn on this stage."""
    for i in range(n_layers):
        x = layer_fn(tree_map(lambda t: t[i], stage_params), x)
    return x


def gpipe_forward(layer_fn: Callable, params_stacked, x: torch.Tensor,
                  mesh, n_micro: int, layers_per_stage: int) -> torch.Tensor:
    """Two-stage GPipe forward over the ``"pod"`` mesh, on every rank.

    params_stacked: nested dict with leading dims (2, layers_per_stage,
    ...); this rank reads only its slice ``[mesh.rank]``, moved to ``x``'s
    device. x: (B, ...) on every rank, B = n_micro * mb. Returns y: (B,
    ...), stage 1's outputs, the same on both ranks.

    Schedule, the reference's: n_micro + 1 ticks; at tick i stage 0 runs
    microbatch i and hands its output to stage 1, which runs the one handed
    over at tick i - 1. The reference's fill and drain work is skipped,
    since nothing keeps it: stage 1 on zeros at tick 0 and stage 0 on the
    last microbatch again at tick n_micro. So each stage runs n_micro
    microbatches of ``layers_per_stage`` layers. Each tick is one
    ``all_reduce`` (sum) of a (2, mb, ...) buffer: row 0 is the handoff
    (the reference's ``ppermute(out, [(0, 1)])``: stage 0's output, zeros
    from stage 1), row 1 the finished microbatch (its ``y_done`` psum:
    stage 1's output, zeros from stage 0). Adding zeros is exact, so the
    outputs are the stages' own, bit for bit.
    """
    if mesh.size != 2:
        raise ValueError(f"gpipe_forward runs two stages, not a mesh of "
                         f"{mesh.size} ranks")
    stage = mesh.rank
    stage_params = tree_map(lambda t: t[stage].to(x.device), params_stacked)
    mb = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    done = []
    pending = None
    for i in range(n_micro + 1):
        buf = torch.zeros((2,) + mb.shape[1:], dtype=x.dtype,
                          device=x.device)
        if stage == 0 and i < n_micro:
            buf[0] = _stage_apply(layer_fn, stage_params, mb[i],
                                  layers_per_stage)
        elif stage == 1 and i > 0:
            buf[1] = _stage_apply(layer_fn, stage_params, pending,
                                  layers_per_stage)
        mesh.all_reduce(buf)
        pending = buf[0]
        if i > 0:
            done.append(buf[1])
    return torch.stack(done).reshape(x.shape)


# ---------------------------------------------------------------------------
# demo layer: the fused-linear unit the split-FL experiment uses
# ---------------------------------------------------------------------------


def mlp_layer_fn(lp, x: torch.Tensor) -> torch.Tensor:
    """relu(x @ w + b) through the fused linear kernel on a CUDA tensor
    (its plain version on a CPU one)."""
    return fused_linear_ops.linear(x, lp["w"], lp["b"], activation="relu")


def demo_inputs(n_layers: int = 8, width: int = 512, batch: int = 32,
                generator: Optional[torch.Generator] = None):
    """The demo's stacked weights {"w": (2, L/2, W, W), "b": (2, L/2, W)}
    and input x (batch, W), drawn from ``generator`` on its device."""
    if n_layers % 2:
        raise ValueError(f"n_layers {n_layers} does not split in two")
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    w = torch.randn((2, n_layers // 2, width, width), generator=g,
                    device=g.device) * (width ** -0.5)
    b = torch.zeros((2, n_layers // 2, width), device=g.device)
    x = torch.randn((batch, width), generator=g, device=g.device)
    return {"w": w, "b": b}, x


def build_demo(mesh, n_layers: int = 8, width: int = 512, batch: int = 32,
               n_micro: int = 4, generator: Optional[torch.Generator] = None):
    """A runnable 2-stage pipeline demo (also used by tests):
    :func:`demo_inputs` (every rank draws the same), then
    :func:`gpipe_forward`. Returns (params, x, y)."""
    params, x = demo_inputs(n_layers, width, batch, generator)
    with torch.no_grad():
        y = gpipe_forward(mlp_layer_fn, params, x, mesh, n_micro,
                          n_layers // 2)
    return params, x, y


@torch.no_grad()
def reference_forward(params, x: torch.Tensor) -> torch.Tensor:
    """Unpipelined oracle for the demo, through the same layer."""
    w = params["w"].reshape(-1, *params["w"].shape[2:])
    b = params["b"].reshape(-1, *params["b"].shape[2:])
    for i in range(w.shape[0]):
        x = mlp_layer_fn({"w": w[i], "b": b[i]}, x)
    return x


# ---------------------------------------------------------------------------
# command line: the counterpart of examples/pipeline_partition.py
# ---------------------------------------------------------------------------


# the command's demo: examples/pipeline_partition.py's sizes
DEMO = dict(n_layers=8, width=256, batch=16, n_micro=4)
# jamba-v0.1-52b's training state (374 GB at seq 4096, batch 1, by the
# cost model) does not fit two single-H100 stages: one 8-card node a stage
JAMBA_CARDS_PER_STAGE = 8


def _demo_rank(rank: int, init: str, device: str, out_dir: str) -> None:
    """One stage of the demo: joins the gloo group of two, runs
    :func:`build_demo` on ``device`` and writes its output."""
    import torch.distributed as dist

    from repro_torch.sharding import pod_mesh
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    try:
        g = torch.Generator(device=device).manual_seed(0)
        _, _, y = build_demo(pod_mesh(2), generator=g, **DEMO)
        torch.save(y.cpu(), os.path.join(out_dir, f"y{rank}.pt"))
    finally:
        dist.destroy_process_group()


def jamba_cut(hbm_per_stage: float, throughput: float) -> PipelineCut:
    """:func:`choose_cut` over jamba-v0.1-52b's cost-model layers at seq
    4096, batch 1."""
    from repro_torch import configs as cfg_lib
    from repro_torch.core import costmodel as cm
    layers = cm.arch_layers(cfg_lib.get_config("jamba-v0.1-52b"), seq=4096)
    return choose_cut(cm.flops_vector(layers), cm.mem_vector(layers, 1),
                      hbm_per_pod=hbm_per_stage, throughput=throughput)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch.multiprocessing as mp

    from repro_torch.device import resolve_device, use_f32_numerics
    from repro_torch.kernels.fused_linear import kernel
    resolve_device(args.device)
    n = JAMBA_CARDS_PER_STAGE
    cut = jamba_cut(n * H100_HBM_BYTES, n * H100_BF16_FLOPS)
    print(f"jamba-v0.1-52b: {cut.n_layers} cost-model layers, {n} H100 a "
          f"stage: cut at {cut.cut} -> stages of {cut.stage_layers} layers")
    if args.device == "cuda":
        use_f32_numerics()
        kernel.library()                # built once, loaded by the ranks
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_demo_rank, args=(f"file://{tmp}/init",
                                             args.device, tmp),
                           nprocs=2, join=True, start_method="spawn")
        ys = [torch.load(os.path.join(tmp, f"y{r}.pt")) for r in range(2)]
    params, x = demo_inputs(
        DEMO["n_layers"], DEMO["width"], DEMO["batch"],
        torch.Generator(device=args.device).manual_seed(0))
    want = reference_forward(params, x).cpu()
    err = max(float((y - want).abs().max()) for y in ys)
    print(f"GPipe over 2 {args.device} ranks matches the unpipelined "
          f"forward: max err {err:.2e}, ranks identical "
          f"{torch.equal(ys[0], ys[1])}")
    return 0 if err <= 1e-5 * float(want.abs().max()) else 1


if __name__ == "__main__":
    sys.exit(main())
