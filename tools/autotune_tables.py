"""Sweep the kernel-selection tables (``repro_torch.kernels.autotune``) on
the card at the shapes the port's paths run, and write them.

    python3 tools/autotune_tables.py [--out artifacts/autotune_torch]
                                     [--only OP]

Every shape of chip_smoke.py's ``CASES``, ``FA_CASES`` and ``SSD_CASES``
that a path runs, in each dtype a path runs it in (the VGG round's fc
layers in f32 and bf16, the statistics, per-sample and evaluation passes
and the pipeline's stage layer in f32; the transformer round's attention in
f32 and bf16, its statistics and per-sample passes and the LM steps' and
the serve encoder's in f32; the SSM round's SSD in f32 and bf16, its
statistics pass and mamba2-2.7b's step in f32), goes through the op's
sweep: each admissible variant of the rules' plan called through the
normal wrapper, captured in a CUDA graph after a warm-up and timed by CUDA
events over 20 replays (10 for the SSD) in each of 7 rounds that take the
variants in turn, its time the median; the winner kept where it beats the
rules' own by more than ``autotune.MARGIN``, and recorded with both times
and the card's name and power limit. A shape
whose plans have no choice (the tiled attention, the SSD's tensor-core
forms) gets no entry. The tables are written to ``--out`` (a run on a
machine whose copy of the repository is discarded writes under
``chiprun_out/``) and checked there with ``validate_table``.
``--only OP`` sweeps and writes one op's table (``ssd_scan``,
``flash_attention`` or ``fused_linear``) and leaves the others as they
are.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import autotune, build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.fused_linear import kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402

F32, BF16 = ("float32",), ("float32", "bfloat16")
# chip_smoke.py's case label -> the dtypes its paths run it in
FL_PATHS = {"round fc1": BF16, "round fc2": BF16, "round fc3": BF16,
            "stats fc2 shared": F32, "stats fc3 shared": F32,
            "sigma fc2 M=1": F32, "eval fc1 M=232": F32,
            "pipeline layer": F32}
FA_PATHS = {"round": BF16, "stats": F32, "sigma M=1": F32, "lm 4096": F32,
            "serve encoder": F32, "lm stablelm 4096": F32}
SSD_PATHS = {"round": BF16, "stats": F32, "mamba2 4096": F32}


def _line(op: str, label: str, dtype: str, entry, seconds: float,
          card: str) -> None:
    if entry is None:
        print(f"sweep {op} {label!r} {dtype}: no choice ({seconds:.1f} s)",
              flush=True)
        return
    print(f"sweep {op} {label!r} {dtype}: plan {entry['plan']} "
          f"us={entry['us']:.2f} baseline_us={entry['baseline_us']:.2f} "
          f"speedup={entry['speedup_vs_default']:.3f} ({seconds:.1f} s; "
          f"card {card})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "artifacts"
                                         / "autotune_torch"))
    ap.add_argument("--only", choices=sorted(autotune.OPS), default=None)
    args = ap.parse_args(argv)
    ops = [args.only] if args.only else list(autotune.OPS)
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, autotune.backend_id(), flush=True)
    build.build_all([ROOT / src for src in (chip_smoke.SOURCE,
                                            chip_smoke.FA_SOURCE,
                                            chip_smoke.SSD_SOURCE)])
    for mod in (kernel, fa_kernel, ssd_kernel):
        mod.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    # start from no entries: the sweeps' baselines are the rules' plans
    for op in ops:
        autotune._entries(op).clear()
    cases = {c[0]: c[1:] for c in chip_smoke.CASES}
    for label, dtypes in FL_PATHS.items() if "fused_linear" in ops else ():
        nb, m, k, n, act, shared = cases[label]
        for dtype in dtypes:
            t0 = time.perf_counter()
            entry = autotune.sweep_fused_linear(
                nb, m, k, n, dtype, shared=shared, activation=act,
                card=card, save=False)
            _line("fused_linear", label, dtype, entry,
                  time.perf_counter() - t0, card)
    cases = {c[0]: c[1:] for c in chip_smoke.FA_CASES}
    for label, dtypes in (FA_PATHS.items() if "flash_attention" in ops
                          else ()):
        b, h, s, d, causal, window = cases[label]
        chip_smoke.check(window is None, f"{label}: a window")
        for dtype in dtypes:
            t0 = time.perf_counter()
            entry = autotune.sweep_flash_attention(b, h, s, d, dtype,
                                                   causal=causal, card=card,
                                                   save=False)
            _line("flash_attention", label, dtype, entry,
                  time.perf_counter() - t0, card)
    cases = {c[0]: c[1:] for c in chip_smoke.SSD_CASES}
    for label, dtypes in SSD_PATHS.items() if "ssd_scan" in ops else ():
        rows, s, n, p, ds, chunk, _ = cases[label]
        for dtype in dtypes:
            t0 = time.perf_counter()
            entry = autotune.sweep_ssd_scan(rows, s, n, p, ds, chunk, dtype,
                                            card=card, save=False)
            _line("ssd_scan", label, dtype, entry, time.perf_counter() - t0,
                  card)
    for op in ops:
        path = autotune.save_table(op, args.out)
        print(f"{op}: {autotune.validate_table(op, args.out)} entries "
              f"written to {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
