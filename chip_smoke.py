"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It imports
the port (``src/repro_torch``), never jax and nothing of ``repro``, and:

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA source in the checkout (one ``nvcc`` per source, all at once,
   timed);
2. kernel phases: holds each kernel against its plain PyTorch version on
   the card and times kernel, plain version, bound and one library call
   where PyTorch has one:
   - fused linear at the VGG path's shapes (the round's fc layers at 6
     slots x 95 rows, the statistics pass's stride-0 shared weights at
     M = 95 and M = 1, the evaluation's M = 232, fc_last's N = 10);
   - flash attention forward, dq and dk/dv at the transformer path's
     shapes (S = 32, D = 32, causal; the round's 6 slots x 95 rows x 2
     heads, the statistics pass's 12 x 95 x 2, the per-sample pass's
     8 x 2) and at multi-tile shapes the path never reaches ((2, 8, 1024,
     128) causal, the same with a 256 window, (2, 4, 256, 64) non-causal),
     against ``scaled_dot_product_attention`` as the library yardstick;
   - the SSD scan at the SSM path's shapes (S = 32, chunk 32, n = 4,
     p = 32, ds = 16, a_log per slot or stride-0 shared) and a multi-chunk
     shape ((2, 512, 8, 64), ds = 64, chunk 64);
3. agreement phases: narrow simulations on the card against the same on
   the CPU, whose plain path the CPU tests hold against the JAX reference:
   VGG, the FL transformer and the FL Mamba-2;
4. path phases, each with every kernel's launch count set to 0 just before
   and read just after: the paper's default experiment (VGG-11, DDSRA,
   cohort engine) at full width, ``Scenario(width_mult=1.0, rounds=3,
   eval_every=3, net=FULL_WIDTH_NET)``, then ``Scenario(model="transformer",
   rounds=3, eval_every=3)`` and ``Scenario(model="ssm", rounds=3,
   eval_every=3)`` on the default network, all on ``device="cuda"``:
   statistics pass plus three rounds, the last one profiled.

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

import torch.nn.functional as F  # noqa: E402

from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl.sim import Scenario, Simulation  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fused_linear import kernel, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

# H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth. The
# kernels are plain f32 FMA (TF32 would break the 1e-5 contract).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SOURCE = "src/repro_torch/kernels/fused_linear/csrc/fused_linear.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
REPLACES = {
    "fused_linear": "src/repro/kernels/fused_linear/kernel.py:81",
    "fused_linear_bwd_dx": "src/repro/kernels/fused_linear/kernel.py:123",
    "fused_linear_bwd_dw_db": "src/repro/kernels/fused_linear/kernel.py:179",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:227",
    "flash_attention_bwd_dkdv":
        "src/repro/kernels/flash_attention/kernel.py:227",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:77",
}
SOURCES = {name: (SOURCE if name.startswith("fused") else FA_SOURCE
                  if name.startswith("flash") else SSD_SOURCE)
           for name in REPLACES}
NAMES = tuple(REPLACES)[:3]            # the fused linear kernels
FA_NAMES = tuple(REPLACES)[3:6]
# every launch counter and every plain-version call counter of the port
LAUNCH_COUNTS = (kernel.LAUNCHES, fa_kernel.LAUNCHES, ssd_kernel.LAUNCHES)
CALL_COUNTS = (ref.CALLS, fa_ref.CALLS, ssd_ref.CALLS)
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


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time per call over ``reps`` calls: the CUDA kernels' own
    times, summed from torch.profiler. Where the host launches more slowly
    than the card runs (small kernels, plain versions of many small ops),
    the event-timed :func:`time_ms` measures the host instead. A profile
    that caught no device time at all (the tracer drops a window now and
    then) is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError("three profiles in a row caught no device time")


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
    return _bound(ops, nbytes)


def _bound(ops: float, nbytes: float) -> tuple:
    """(least ms, what bounds it) for ``ops`` f32 operations on ``nbytes``
    bytes read and written once."""
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
    totals: dict = {}
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
            # the record sums one local epoch of the round: fc1 + fc2 + fc3
            _hold(totals, name, label, fn, plain, lib, KERNEL_RTOL,
                  _bound_ms(name, nb, m, k, n, act == "relu", shared),
                  label in ROUND, f"B={nb} M={m} K={k} N={n} {act}")
    return totals


def _max_err(name: str, label: str, got, want) -> tuple:
    """(max |kernel - plain|, max |plain|) over a kernel's outputs."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for a in got:
        check(bool(torch.isfinite(a).all()),
              f"{name} {label}: non-finite output")
    return (max(float((a - r).abs().max()) for a, r in zip(got, want)),
            max(float(r.abs().max()) for r in want))


def _fmt(ms) -> str:
    return "-" if ms is None else f"{ms:.4f}"


def _hold(totals: dict, name: str, label: str, fn, plain, lib, rtol: float,
          bound: tuple, record: bool, shape: str) -> None:
    """Check one kernel against its plain version at ``rtol`` x its output
    scale; time kernel, plain version and library call on the device (and
    print their event-timed wall times); keep the largest error, and add
    the case to the record when ``record``."""
    err, scale = _max_err(name, label, fn(), plain())
    check(err <= rtol * max(scale, 1.0),
          f"{name} {label}: max |kernel - plain| = {err:.3e} > {rtol} x "
          f"{scale:.3e}")
    fns = dict(ms=fn, plain_ms=plain, library_ms=lib)
    dev = {k: None if f is None else device_ms(f) for k, f in fns.items()}
    wall = {k: None if f is None else time_ms(f) for k, f in fns.items()}
    print(f"case {name:24s} {label:18s} {shape} max_abs_err={err:.3e} "
          + " ".join(f"{k}={_fmt(dev[k])} (wall {_fmt(wall[k])})"
                     for k in fns)
          + f" bound_ms={bound[0]:.4f} ({bound[1]})", flush=True)
    tot = totals.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                       library_ms=None if lib is None
                                       else 0.0, bound_ms=0.0, ops_ms=0.0))
    tot["max_abs_err"] = max(tot["max_abs_err"], err)
    if record:
        for k in fns:
            if dev[k] is not None:
                tot[k] += dev[k]
        tot["bound_ms"] += bound[0]
        tot["ops_ms"] += bound[0] if bound[1] == "operations" else 0.0


# attention against its plain versions: the reference's f32 attention
# tolerance (TOL[f32] in tests/test_kernels.py) times the output scale; the
# online softmax sums over k-tiles in another order than the one-shot one
FA_RTOL = 2e-5
# (label, B, H, S, D, causal, window): the transformer path's B x H heads
# (rows x 2 heads, S = 32, hd = 32, causal) and multi-tile shapes
FA_CASES = [
    ("round", 570, 2, 32, 32, True, None),
    ("stats", 1140, 2, 32, 32, True, None),
    ("sigma M=1", 8, 2, 32, 32, True, None),
    ("causal 1024", 2, 8, 1024, 128, True, None),
    ("window 256", 2, 8, 1024, 128, True, 256),
    ("full 256", 2, 4, 256, 64, False, None),
]
# operations per visible (query, key) pair per head dim, (B, H, S, D)
# tensors and (B, H, S) rows read or written once
FA_WORK = {"flash_attention": (4, 4, 1),           # q k v o, lse
           "flash_attention_bwd_dq": (6, 5, 2),    # q k v do dq, lse delta
           "flash_attention_bwd_dkdv": (8, 6, 2)}  # q k v do dk dv, ...


def _visible(s: int, causal: bool, window) -> torch.Tensor:
    q = torch.arange(s, device="cuda")[:, None]
    k = torch.arange(s, device="cuda")[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= k > q - window
    return mask


def attention_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    totals: dict = {}
    for label, b, h, s, d, causal, window in FA_CASES:
        # (B, S, H, D) activations read as (B, H, S, D) views, as the model
        # hands them to the kernels
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g)
                       .transpose(1, 2) for _ in range(4))
        o, lse = fa_kernel.flash_attention(q, k, v, causal, window)
        delta = (do * o).sum(-1)
        mask = _visible(s, causal, window)
        pairs = int(mask.sum())
        # library yardstick: scaled_dot_product_attention, forward and its
        # whole backward (dq, dk and dv in one call)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_mask = None if window is None else mask

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=lib_mask,
                is_causal=causal and lib_mask is None)
        o_lib = sdpa()

        def lib_fwd():
            with torch.no_grad():
                return sdpa()
        args = (q, k, v, do, lse, delta)
        fns = {
            "flash_attention": (
                lambda: fa_kernel.flash_attention(q, k, v, causal, window),
                lambda: fa_ref.attention_ref_lse(q, k, v, causal=causal,
                                                 window=window), lib_fwd),
            "flash_attention_bwd_dq": (
                lambda: fa_kernel.flash_attention_bwd_dq(*args, causal,
                                                         window),
                lambda: fa_ref.attention_ref_bwd_dq(*args, causal=causal,
                                                    window=window),
                lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                            retain_graph=True)),
            "flash_attention_bwd_dkdv": (
                lambda: fa_kernel.flash_attention_bwd_dkdv(*args, causal,
                                                           window),
                lambda: fa_ref.attention_ref_bwd_dkdv(*args, causal=causal,
                                                      window=window),
                lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                            retain_graph=True)),
        }
        for name, (fn, plain, lib) in fns.items():
            per_pair, tensors, rows = FA_WORK[name]
            bound = _bound(per_pair * d * pairs * b * h,
                           4 * b * h * s * (tensors * d + rows))
            _hold(totals, name, label, fn, plain, lib, FA_RTOL, bound,
                  label == "round",
                  f"B={b} H={h} S={s} D={d} causal={int(causal)} "
                  f"window={window}")
    return totals


# the SSD scan against its plain version: the reference's own SSD
# tolerance (tests/test_kernels.py) times the output scale; the chunked
# kernel and the sequential recurrence take different exponentials of
# cumulative decays
SSD_RTOL = 1e-4
# (label, rows, S, n, p, ds, chunk, slots): rows = slots x batch rows, each
# slot with its own a_log; slots = 0: one a_log for every row, read through
# a stride-0 view of 12 slots (the statistics pass)
SSD_CASES = [
    ("round", 570, 32, 4, 32, 16, 32, 6),
    ("stats", 1140, 32, 4, 32, 16, 32, 0),
    ("multi-chunk", 2, 512, 8, 64, 64, 64, 1),
]


def ssd_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(2)
    totals: dict = {}
    for label, rows, s, n, p, ds, chunk, slots in SSD_CASES:
        # x, b and c as the model hands them over: split views of one conv
        # output, read through their row and step strides
        conv = torch.randn(rows, s, n * p + 2 * ds, device="cuda",
                           generator=g)
        x = conv[..., :n * p].reshape(rows, s, n, p)
        bm, cm = conv[..., n * p:n * p + ds], conv[..., n * p + ds:]
        dt = F.softplus(torch.randn(rows, s, n, device="cuda", generator=g))
        a_log = 0.5 * (torch.randn(n, device="cuda", generator=g)
                       .expand(12, n) if slots == 0 else
                       torch.randn(slots, n, device="cuda", generator=g))
        pairs = chunk * (chunk + 1) // 2
        ops = rows * (s // chunk) * (2 * pairs * ds + n * (
            2 * pairs * p + 4 * chunk * ds * p))
        nbytes = 4 * (2 * rows * s * n * p + rows * s * n
                      + 2 * rows * s * ds + max(slots, 1) * n)
        _hold(totals, "ssd_scan", label,
              lambda: ssd_kernel.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk),
              lambda: ssd_ref.ssd_ref(x, dt, a_log, bm, cm), None, SSD_RTOL,
              _bound(ops, nbytes), label == "round",
              f"rows={rows} S={s} n={n} p={p} ds={ds} chunk={chunk} "
              f"slots={slots}")
    return totals


# ---------------------------------------------------------------------------
# agreement phases: the card against the CPU on narrow simulations
# ---------------------------------------------------------------------------

# cuDNN's and the CPU's f32 convolutions and reductions sum in different
# orders: params and losses to the reference's 1e-5 f32 contract; the
# statistics, which divide gradient differences by a step of size lr, to
# rtol 1e-4 as in the CPU parity tests. The SSM's params and losses to the
# reference's SSD tolerance of 1e-4: the card runs the chunked kernel
# forward and the sequential recurrence backward, the CPU the chunked dual
# form both ways, which sum in different orders.
AGREE = {
    "vgg": (dict(width_mult=0.0625), dict(params=1e-5, stats=1e-4)),
    "transformer": (dict(model="transformer"), dict(params=1e-5, stats=1e-4)),
    "ssm": (dict(model="ssm"), dict(params=1e-4, stats=1e-4)),
}


def agreement_phase(label: str) -> None:
    kw, tol = AGREE[label]
    sc = Scenario(max_dataset=400, k_iters=2, sigma_samples=2, rounds=2,
                  eval_every=2, **kw)
    cpu = Simulation(sc, device="cpu")
    rng0 = cpu.rng.bit_generator.state
    gpu = Simulation(sc, device="cuda")
    for f in ("sigma", "delta", "lipschitz"):
        a, r = getattr(gpu.stats, f), getattr(cpu.stats, f)
        rel = float(np.max(np.abs(a - r) / np.abs(r)))
        print(f"agree {label} stats {f}: max rel diff {rel:.3e}")
        check(rel <= tol["stats"], f"{label} stats {f} disagree: {rel:.3e}")
    gpu = Simulation(sc, cpu.stats, device="cuda")
    gpu.rng.bit_generator.state = rng0
    recs_c, recs_g = list(cpu.rounds()), list(gpu.rounds())
    for c, g in zip(recs_c, recs_g):
        check(np.array_equal(c.selected, g.selected)
              and np.array_equal(c.queues, g.queues)
              and c.delay == g.delay and c.trained == g.trained,
              f"{label} round {c.t}: decisions differ between cpu and cuda")
        diff = float(np.max(np.abs(c.losses - g.losses)))
        print(f"agree {label} round {c.t}: losses max diff {diff:.3e}")
        check(diff <= tol["params"], f"{label} losses disagree: {diff:.3e}")
    worst = 0.0
    for pc, pg in zip(cpu.params, gpu.params):
        for key in pc:
            worst = max(worst, float((pc[key] - pg[key].cpu()).abs().max()))
    print(f"agree {label} params after {sc.rounds} rounds: max abs diff "
          f"{worst:.3e}")
    check(worst <= tol["params"], f"{label} params disagree: {worst:.3e}")


# ---------------------------------------------------------------------------
# path phases: the default experiment at full width, and the token models
# ---------------------------------------------------------------------------


# At full width one round of VGG-11 does not fit the default per-round
# energy arrivals (5 J per device, 30 J per gateway: the 112 MB model upload
# alone costs ~25 J at p_max), so DDSRA schedules no gateway at all, in the
# port and in the reference alike. Ten times the arrivals lets the
# full-width trainer take its steps; every other setting is the default.
FULL_WIDTH_NET = NetworkConfig(e_dev_max=50.0, e_gw_max=300.0)

# (scenario, the kernels the path must launch, parameter count or None)
PATHS = {
    "vgg": (Scenario(width_mult=1.0, rounds=3, eval_every=3,
                     net=FULL_WIDTH_NET), NAMES, None),
    "transformer": (Scenario(model="transformer", rounds=3, eval_every=3),
                    FA_NAMES, 98_624),
    "ssm": (Scenario(model="ssm", rounds=3, eval_every=3), ("ssd_scan",),
            72_216),
}


def _print_breakdown(label: str, prof, wall: float) -> None:
    """Device time of the profiled round by kernel, and its busy share of
    the round's wall time (the profiler's own overhead inflates the wall
    time, so the idle share is an upper bound)."""
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"{label} profile round: wall_s={wall:.3f} device_busy_s="
          f"{busy_s:.3f} busy_share={busy_s / wall:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"{label} profile {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def path_phase(label: str) -> dict:
    """Statistics pass plus the scenario's rounds on the card, with every
    launch and plain-call count read from this run alone."""
    scenario, names, n_params = PATHS[label]
    for counts in LAUNCH_COUNTS + CALL_COUNTS:
        for key in counts:
            counts[key] = 0
    t0 = time.perf_counter()
    sim = Simulation(scenario, device="cuda")
    torch.cuda.synchronize()
    print(f"{label} path setup_s={time.perf_counter() - t0:.3f} "
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
        print(f"{label} path round {rec.t}: s={wall:.3f}"
              f"{' (profiled)' * last} trained={rec.trained} "
              f"delay={rec.delay:.6f} "
              f"losses={np.round(rec.losses, 6).tolist()} "
              f"accuracy={rec.accuracy}", flush=True)
    _print_breakdown(label, prof, wall)
    launches, plain_calls = {}, {}
    for counts in LAUNCH_COUNTS:
        launches.update(counts)
    for counts in CALL_COUNTS:
        plain_calls.update(counts)
    print(f"{label} path launches={launches} plain_calls={plain_calls}")

    check(all(launches[k] > 0 for k in names),
          f"a kernel of the {label} path never launched: {launches}")
    check(not any(plain_calls.values()),
          f"the plain versions ran on the card: {plain_calls}")
    stats = sim.stats
    check(all(np.all(np.isfinite(getattr(stats, f)) & (getattr(stats, f) > 0))
              for f in ("sigma", "delta", "lipschitz")),
          "statistics are not finite and positive")
    if n_params is None:
        shapes = [tuple(p["w"].shape) for p in sim.params if p]
        check(shapes[0] == (64, 3, 3, 3) and shapes[-3:] == [
            (512, 4096), (4096, 4096), (4096, 10)], f"param shapes {shapes}")
    else:
        count = sum(v.numel() for p in sim.params for v in p.values())
        check(count == n_params, f"{label}: {count} params")
    check(all(bool(torch.isfinite(v).all()) for p in sim.params
              for v in p.values()), "non-finite params")
    check(any(r.trained for r in records), "no gateway trained")
    check(all(np.all(np.isfinite(r.losses)) for r in records),
          "non-finite losses")
    acc = records[-1].accuracy
    check(acc is not None and 0.0 <= acc <= 1.0, f"accuracy {acc}")
    return {k: launches[k] for k in names}


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
    build.build_all([ROOT / src for src in (SOURCE, FA_SOURCE, SSD_SOURCE)])
    for mod in (kernel, fa_kernel, ssd_kernel):
        mod.library()
    print(f"build_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = kernel_phase()
    totals.update(attention_phase())
    totals.update(ssd_phase())
    for label in AGREE:
        agreement_phase(label)
    launches = {}
    for label in PATHS:
        launches.update(path_phase(label))

    out = [dict(name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=launches[name],
                bound_by=("operations" if totals[name].pop("ops_ms")
                          >= totals[name]["bound_ms"] / 2 else "bytes"),
                **totals[name])
           for name in REPLACES]
    print(f"card: {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
