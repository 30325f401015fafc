"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It imports
the port (``src/repro_torch``), never jax and nothing of ``repro``, and:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from the sources in the checkout (``nvcc``, timed);
2. kernel phase: holds each fused linear kernel against its plain PyTorch
   version on the card at the main path's shapes (the round's fc layers at
   6 slots x 95 rows, the statistics pass's stride-0 shared weights at
   M = 95 and M = 1, the evaluation's M = 232, fc_last's N = 10), and times
   kernel, plain version and one library call (``torch.baddbmm``/``bmm``);
3. agreement phase: a narrow simulation on the card against the same on
   the CPU, whose plain path the CPU tests hold against the JAX reference;
4. path phase: the paper's default experiment (VGG-11, DDSRA, cohort
   engine) at full width, ``Scenario(width_mult=1.0, rounds=3,
   eval_every=3, net=FULL_WIDTH_NET)`` on ``device="cuda"``: statistics
   pass plus three trained rounds, with every kernel's launch count read
   from this run alone.

Any failure raises, which exits non-zero before the result line. The line
before last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl.sim import Scenario, Simulation  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_linear import kernel, ref  # noqa: E402

# H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth. The
# kernels are plain f32 FMA (TF32 would break the 1e-5 contract).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SOURCE = "src/repro_torch/kernels/fused_linear/csrc/fused_linear.cu"
REPLACES = {
    "fused_linear": "src/repro/kernels/fused_linear/kernel.py:81",
    "fused_linear_bwd_dx": "src/repro/kernels/fused_linear/kernel.py:123",
    "fused_linear_bwd_dw_db": "src/repro/kernels/fused_linear/kernel.py:179",
}
NAMES = tuple(REPLACES)
# kernel vs plain version on the same card: both f32 with f32
# accumulation, summed in different orders over K up to 4096
KERNEL_RTOL = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (label, slots B, rows M, K, N, activation, weights shared by all slots)
CASES = [
    ("round fc1", 6, 95, 512, 4096, "relu", False),
    ("round fc2", 6, 95, 4096, 4096, "relu", False),
    ("round fc3", 6, 95, 4096, 10, "none", False),
    ("stats fc2 shared", 12, 95, 4096, 4096, "relu", True),
    ("stats fc3 shared", 12, 95, 4096, 10, "none", True),
    ("sigma fc2 M=1", 8, 1, 4096, 4096, "relu", True),
    ("eval fc1 M=232", 1, 232, 512, 4096, "relu", True),
]
ROUND = ("round fc1", "round fc2", "round fc3")


def _bound_ms(name, b, m, k, n, relu, shared) -> tuple:
    """Least time for the function on these inputs: each input read once,
    each output written once, against the f32 FMA peak."""
    wb = 1 if shared else b                     # distinct weight matrices
    mn, mk, kn = b * m * n, b * m * k, k * n
    if name == "fused_linear":
        ops = 2 * b * m * k * n + 2 * mn
        nbytes = 4 * (mk + wb * kn + wb * n + mn)
    elif name == "fused_linear_bwd_dx":
        ops = 2 * b * m * k * n + mn
        nbytes = 4 * (mn * (2 if relu else 1) + wb * kn + mk)
    else:
        ops = 2 * b * m * k * n + 2 * mn
        nbytes = 4 * (mk + mn * (2 if relu else 1) + b * kn + b * n)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _case_fns(x, w, b, dy, act):
    """(kernel, plain, library) callables per kernel for one case. The
    library call is the GEMM alone: no fused epilogue, mask or db."""
    y = kernel.fused_linear(x, w, b, act)
    ys = y if act == "relu" else None
    return {
        "fused_linear": (
            lambda: kernel.fused_linear(x, w, b, act),
            lambda: ref.fused_linear_ref(x, w, b, act),
            lambda: torch.baddbmm(b.unsqueeze(1), x, w)),
        "fused_linear_bwd_dx": (
            lambda: kernel.fused_linear_bwd_dx(dy, w, ys, act),
            lambda: ref.fused_linear_bwd_dx_ref(dy, w, ys, act),
            lambda: torch.bmm(dy, w.transpose(1, 2))),
        "fused_linear_bwd_dw_db": (
            lambda: kernel.fused_linear_bwd_dw_db(x, dy, ys, act),
            lambda: ref.fused_linear_bwd_dw_db_ref(x, dy, ys, act),
            lambda: torch.bmm(x.transpose(1, 2), dy)),
    }


def kernel_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                         library_ms=0.0, bound_ms=0.0, ops_ms=0.0)
              for name in NAMES}
    for label, nb, m, k, n, act, shared in CASES:
        x = torch.randn(nb, m, k, device="cuda", generator=g)
        if shared:
            w = torch.randn(k, n, device="cuda", generator=g).expand(nb, k, n)
            b = torch.randn(n, device="cuda", generator=g).expand(nb, n)
        else:
            w = torch.randn(nb, k, n, device="cuda", generator=g)
            b = torch.randn(nb, n, device="cuda", generator=g)
        w = w * (2.0 / k) ** 0.5
        dy = torch.randn(nb, m, n, device="cuda", generator=g)
        for name, (fn, plain, lib) in _case_fns(x, w, b, dy, act).items():
            got, want = fn(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err, scale = 0.0, 0.0
            for a, r in zip(got, want):
                check(bool(torch.isfinite(a).all()), f"{name} {label}: "
                      "non-finite output")
                err = max(err, float((a - r).abs().max()))
                scale = max(scale, float(r.abs().max()))
            # each kernel's error is held against its own output scale
            check(err <= KERNEL_RTOL * max(scale, 1.0),
                  f"{name} {label}: max |kernel - plain| = {err:.3e} "
                  f"> {KERNEL_RTOL} x {scale:.3e}")
            ms, plain_ms, lib_ms = time_ms(fn), time_ms(plain), time_ms(lib)
            bound, by = _bound_ms(name, nb, m, k, n, act == "relu", shared)
            print(f"case {name:24s} {label:18s} B={nb} M={m} K={k} N={n} "
                  f"{act:4s} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.4f} ({by})", flush=True)
            tot = totals[name]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if label in ROUND:
                # one local epoch of the round: fc1 + fc2 + fc3
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["library_ms"] += lib_ms
                tot["bound_ms"] += bound
                tot["ops_ms"] += bound if by == "operations" else 0.0
    return totals


# ---------------------------------------------------------------------------
# agreement phase: the card against the CPU on a narrow simulation
# ---------------------------------------------------------------------------

# cuDNN's and the CPU's f32 convolutions and reductions sum in different
# orders: params and losses to the reference's 1e-5 f32 contract; the
# statistics, which divide gradient differences by a step of size lr, to
# rtol 1e-4 as in the CPU parity tests
AGREE_TOL = dict(params=1e-5, stats=1e-4)


def agreement_phase() -> None:
    sc = Scenario(width_mult=0.0625, max_dataset=400, k_iters=2,
                  sigma_samples=2, rounds=2, eval_every=2)
    cpu = Simulation(sc, device="cpu")
    rng0 = cpu.rng.bit_generator.state
    gpu = Simulation(sc, device="cuda")
    for f in ("sigma", "delta", "lipschitz"):
        a, r = getattr(gpu.stats, f), getattr(cpu.stats, f)
        rel = float(np.max(np.abs(a - r) / np.abs(r)))
        print(f"agree stats {f}: max rel diff {rel:.3e}")
        check(rel <= AGREE_TOL["stats"], f"stats {f} disagree: {rel:.3e}")
    gpu = Simulation(sc, cpu.stats, device="cuda")
    gpu.rng.bit_generator.state = rng0
    recs_c, recs_g = list(cpu.rounds()), list(gpu.rounds())
    for c, g in zip(recs_c, recs_g):
        check(np.array_equal(c.selected, g.selected)
              and np.array_equal(c.queues, g.queues)
              and c.delay == g.delay and c.trained == g.trained,
              f"round {c.t}: decisions differ between cpu and cuda")
        diff = float(np.max(np.abs(c.losses - g.losses)))
        print(f"agree round {c.t}: losses max diff {diff:.3e}")
        check(diff <= AGREE_TOL["params"], f"losses disagree: {diff:.3e}")
    worst = 0.0
    for pc, pg in zip(cpu.params, gpu.params):
        for key in pc:
            worst = max(worst, float((pc[key] - pg[key].cpu()).abs().max()))
    print(f"agree params after {sc.rounds} rounds: max abs diff {worst:.3e}")
    check(worst <= AGREE_TOL["params"], f"params disagree: {worst:.3e}")


# ---------------------------------------------------------------------------
# path phase: the default experiment at full width
# ---------------------------------------------------------------------------


# At full width one round of VGG-11 does not fit the default per-round
# energy arrivals (5 J per device, 30 J per gateway: the 112 MB model upload
# alone costs ~25 J at p_max), so DDSRA schedules no gateway at all, in the
# port and in the reference alike. Ten times the arrivals lets the
# full-width trainer take its steps; every other setting is the default.
FULL_WIDTH_NET = NetworkConfig(e_dev_max=50.0, e_gw_max=300.0)


def _print_breakdown(prof, wall: float) -> None:
    """Device time of the profiled round by kernel, and its busy share of
    the round's wall time (the profiler's own overhead inflates the wall
    time, so the idle share is an upper bound)."""
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"profile round: wall_s={wall:.3f} device_busy_s={busy_s:.3f} "
          f"busy_share={busy_s / wall:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"profile   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def path_phase() -> dict:
    for counts in (kernel.LAUNCHES, ref.CALLS):
        for key in counts:
            counts[key] = 0
    t0 = time.perf_counter()
    sim = Simulation(Scenario(width_mult=1.0, rounds=3, eval_every=3,
                              net=FULL_WIDTH_NET), device="cuda")
    torch.cuda.synchronize()
    print(f"path setup_s={time.perf_counter() - t0:.3f} "
          f"stats_s={sim.stats_seconds:.3f} "
          f"slots={sim.cohort_capacity} d_tilde_max={int(sim.d_tilde.max())}")
    records, rounds = [], sim.rounds()
    for i in range(sim.scenario.rounds):
        # the last round runs under the profiler, for where its time goes
        last = i == sim.scenario.rounds - 1
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if last \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            rec = next(rounds)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records.append(rec)
        print(f"path round {rec.t}: s={wall:.3f}{' (profiled)' * last} "
              f"trained={rec.trained} delay={rec.delay:.6f} "
              f"losses={np.round(rec.losses, 6).tolist()} "
              f"accuracy={rec.accuracy}", flush=True)
    _print_breakdown(prof, wall)
    launches, plain_calls = dict(kernel.LAUNCHES), dict(ref.CALLS)
    print(f"path launches={launches} plain_calls={plain_calls}")

    check(all(launches[k] > 0 for k in NAMES),
          f"a kernel of the path never launched: {launches}")
    check(not any(plain_calls.values()),
          f"the plain versions ran on the card: {plain_calls}")
    stats = sim.stats
    check(all(np.all(np.isfinite(getattr(stats, f)) & (getattr(stats, f) > 0))
              for f in ("sigma", "delta", "lipschitz")),
          "statistics are not finite and positive")
    shapes = [tuple(p["w"].shape) for p in sim.params if p]
    check(shapes[0] == (64, 3, 3, 3) and shapes[-3:] == [
        (512, 4096), (4096, 4096), (4096, 10)], f"param shapes {shapes}")
    check(all(bool(torch.isfinite(v).all()) for p in sim.params
              for v in p.values()), "non-finite params")
    check(any(r.trained for r in records), "no gateway trained")
    check(all(np.all(np.isfinite(r.losses)) for r in records),
          "non-finite losses")
    acc = records[-1].accuracy
    check(acc is not None and 0.0 <= acc <= 1.0, f"accuracy {acc}")
    return launches


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA device: this smoke test needs "
          "one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all([ROOT / SOURCE])
    kernel.library()
    print(f"build_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = kernel_phase()
    agreement_phase()
    launches = path_phase()

    out = [dict(name=name, route="cuda", source=SOURCE,
                replaces=REPLACES[name], launches=launches[name],
                max_abs_err=totals[name]["max_abs_err"],
                ms=totals[name]["ms"], plain_ms=totals[name]["plain_ms"],
                bound_ms=totals[name]["bound_ms"],
                bound_by=("operations" if totals[name]["ops_ms"]
                          >= totals[name]["bound_ms"] / 2 else "bytes"),
                library_ms=totals[name]["library_ms"])
           for name in NAMES]
    print(f"card: {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
