"""Dry run: trace every (arch x input shape x mesh) step at full published
size on fake tensors, and read its roofline terms (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch granite-moe-1b-a400m --shape train_4k [--multi-pod] \
        [--out artifacts/dryrun_torch]

The step of :func:`repro_torch.launch.specs.build_case` runs once on fake
CPU tensors (``FakeTensorMode``: shapes and dtypes, no storage, so nothing
is allocated at model size and no card is needed) under a dispatch mode
that sees every aten op: FLOPs by ``torch.utils.flop_counter``'s formulas
(``FlopCounterMode``'s own registry), the bytes each op reads and writes,
and the live bytes of the tensors the trace makes. The port's units and
microbatches run in Python loops, so the full depth is traced and counted
as it runs: the reference's two shallow compiles with linear extrapolation
(XLA's cost analysis counts a scanned body once) are not needed. On fake
CPU tensors the kernel wrappers take their plain versions, so the counts
are those of the plain ops, not of the CUDA kernels.

The JSON keeps the reference's keys where their meaning holds:

* ``memory``: ``argument_bytes`` and ``output_bytes`` are exact per
  device, each leaf's bytes divided by the mesh axes its partition spec
  shards it over; ``temp_bytes`` is an estimate, the peak of live bytes
  over the whole step traced unsharded on one fake device, not divided
  over the mesh, the new storages of the step's outputs among them
  (``temp_bytes_is`` says so). The reference's ``peak_bytes``, a device's
  peak, is left out: no trace here measures one, and the sum of the
  per-device and the whole-step figures would not be one;
* ``roofline``: :class:`repro_torch.launch.roofline.Roofline` on H100
  data-sheet peaks, ``hlo_flops`` and ``hlo_bytes`` the traced ops' global
  FLOPs and bytes (the keys keep the reference's names; the bytes are
  those of the plain ops unfused, so the memory term is far above what
  fused kernels would move), no collective term;
* ``model_flops`` (6 N T for training, 2 N T otherwise, N the active
  params) and ``useful_flops_frac`` = model FLOPs / traced FLOPs.

No number here is a device measurement: the times are bounds against
data-sheet peaks, and ``trace_s`` is the host's tracing time.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as cfg_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline
from repro_torch.models.model import pattern_of
from repro_torch.models.params import _axis_size

# how the temp_bytes figure was made
TEMP_ESTIMATE = ("estimate: peak live bytes of the whole step's plain ops "
                 "(the attention's full S x S scores and the outputs' new "
                 "storages among them), traced unsharded on one fake "
                 "device, not divided over the mesh: not a device's peak")
# what the hlo_bytes figure counts
BYTES_ARE = ("each traced plain op's tensor inputs read once and outputs "
             "written once, unfused, over the whole step")
# new storages between two sweeps for freed ones
_SWEEP_EVERY = 32


class StepCounter(TorchDispatchMode):
    """Counts every aten op dispatched under it: ``flops`` (the ops that
    ``flop_registry`` knows), ``bytes`` (each non-view op's tensor inputs
    read once and outputs written once) and ``peak_live_bytes`` (the most
    bytes held at once by the storages the traced ops made, not counting
    those of ``held``, the step's arguments, which in-place ops write;
    freed ones are swept every few new storages, so the peak may read a
    little high)."""

    def __init__(self, held=()):
        super().__init__()
        self._held = {t.untyped_storage()._cdata for t in _tensors(held)}
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live = {}            # storage id -> (weak ref, bytes)
        self._new = 0

    def _sweep(self) -> None:
        for key, (ref, n) in list(self._live.items()):
            if torch.UntypedStorage._expired(ref):
                del self._live[key]
                self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._held:
            return
        n = st.nbytes()
        self._live[key] = (st._weak_ref(), n)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        self._new += 1
        if self._new % _SWEEP_EVERY == 0:
            self._sweep()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            # metadata queries (``prim.device``, asked of every fake tensor
            # the autograd engine touches): they read no bytes
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            outs = list(_tensors(out))
            self.bytes += sum(t.numel() * t.element_size() for t in
                              (*_tensors(args), *_tensors(kwargs), *outs))
            for t in outs:
                self._track(t)
        return out


def _tensors(x):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _pairs(tree, specs):
    """(tensor, spec) for every tensor of ``tree``, walking ``specs``
    alongside: a tensor's spec is a tuple of one entry a dimension."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        for t, s in zip(tree, specs, strict=True):
            yield from _pairs(t, s)


def sharded_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree``: each tensor's bytes divided by the
    sizes of the mesh axes its spec names."""
    return sum(t.numel() * t.element_size()
               // math.prod(_axis_size(mesh, ax) for ax in spec)
               for t, spec in _pairs(tree, specs))


def model_pattern(cfg) -> str:
    """The config's repeating unit of layer kinds (``pattern_of``)."""
    return pattern_of(cfg)


def trace_case(case: specs_lib.Case, mesh) -> tuple:
    """Run ``case``'s step once on its fake tensors under a
    :class:`StepCounter`: (counter, host seconds of the trace, per-device
    argument bytes, per-device output bytes, :class:`Roofline`)."""
    counter = StepCounter(held=case.args)
    t0 = time.perf_counter()
    with case.fake_mode, counter:
        out = case.fn(*case.args)
    t_trace = time.perf_counter() - t0
    return (counter, t_trace, sharded_bytes(case.args, case.in_specs, mesh),
            sharded_bytes(out, case.out_specs, mesh),
            Roofline(float(counter.flops), float(counter.bytes), mesh.size))


def run_case(arch: str, shape: str, multi_pod: bool, out_dir=None,
             remat: bool = True, verbose: bool = True,
             profile: str = "baseline") -> dict:
    """Trace the full-depth step of ``arch`` x ``shape`` on the production
    mesh's shape and count it; writes ``<arch>_<shape>_<mesh>.json`` under
    ``out_dir`` when given. Returns the result dict."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    case = specs_lib.build_case(arch, shape, mesh, remat=remat,
                                profile=profile)
    counter, t_trace, args_b, out_b, roof = trace_case(case, mesh)
    cfg = cfg_lib.get_config(arch)
    shape_cfg = cfg_lib.get_shape(shape)
    tokens = shape_cfg.global_batch * (shape_cfg.seq_len
                                       if shape_cfg.mode != "decode" else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape_cfg.mode]
    model_flops = mult * cfg.n_active_params * tokens

    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": shape_cfg.mode,
        "ok": True,
        "trace_s": round(t_trace, 1),
        "traced_ops": counter.ops,
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": counter.peak_live_bytes,
            "temp_bytes_is": TEMP_ESTIMATE,
        },
        "roofline": {**roof.as_dict(), "hlo_bytes_is": BYTES_ARE},
        "model_flops": model_flops,
        "useful_flops_frac": model_flops / max(roof.flops, 1.0),
    }
    if verbose:
        m, r = result["memory"], result["roofline"]
        print(f"[{result['mesh']}] {arch} x {shape}: traced in "
              f"{t_trace:.1f}s ({counter.ops} ops)")
        print(f"  memory/device: args {m['argument_bytes'] / 2**30:.2f} GiB, "
              f"outputs {m['output_bytes'] / 2**30:.2f} GiB; whole-step "
              f"temp estimate {m['temp_bytes'] / 2**30:.2f} GiB")
        print(f"  roofline on H100 data-sheet peaks: compute "
              f"{r['t_compute_s']:.3e}s  memory {r['t_memory_s']:.3e}s "
              f"-> {r['bottleneck']}-bound (collectives not counted)")
        print(f"  traced flops {r['hlo_flops']:.3e}  model flops "
              f"{model_flops:.3e} (useful frac "
              f"{result['useful_flops_frac']:.2f})")
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}_{shape}_{result['mesh'].replace('x', '-')}"
        (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=list(cfg_lib.ARCHS) + ["all"])
    ap.add_argument("--shape", required=True,
                    choices=list(cfg_lib.SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"],
                    help="'optimized' applies the reference's tuned "
                         "shardings")
    args = ap.parse_args(argv)

    archs = list(cfg_lib.ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(cfg_lib.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_case(arch, shape, mp, out_dir=args.out,
                             remat=not args.no_remat, profile=args.profile)
                except Exception as e:  # noqa: BLE001: reported, run goes on
                    print(f"FAIL {arch} x {shape} mesh="
                          f"{'2pod' if mp else '1pod'}: "
                          f"{type(e).__name__}: {e}")
                    failures.append((arch, shape, mp))
    if failures:
        print(f"{len(failures)} failures: {failures}")
        return 1
    print("all dry-run cases traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
