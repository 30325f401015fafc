"""Launch-plan variants of the flash-attention backward pair, side by side
on one card.

    python3 tools/flash_attention_variants.py

Run from the root of a checkout on a machine with a CUDA card. The source
is built as it is (no substitutions); each variant changes one choice of
the backward's launch plan (``kernel.attention_bwd_plan``): heads per block
of the short form, its staging copy width, or the 64-row tiled form forced
where the short form would run. Each is driven through the wrappers at
chip_smoke.py's round and statistics shapes, held against the plain
versions (chip_smoke.py's FA_RTOL x the output scale) and timed on the
device (chip_smoke.py's ``device_ms``); SDPA's whole backward is timed
beside them. ``plan`` (the wrapper's own) runs first and again last, which
shows the run's spread. Prints the registers and spills of every kernel of
the source (``ptxas -v``), then one line per case, variant and kernel, in
milliseconds.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402

# name -> change to the wrapper's plan (None: the plan as it is)
PLANS = {
    "plan": None,
    **{f"heads_per_block={n}":
       (lambda p, n=n: dataclasses.replace(p, heads_per_block=n))
       for n in (1, 2, 4, 8)},
    "copies_4_bytes": lambda p: dataclasses.replace(p, vec=4),
    "tiled_form": lambda p: kernel.AttentionPlan("tiled", 1, 4),
}
CASES = ("round", "stats")


def print_registers() -> None:
    """Compile the source with ``-Xptxas -v`` and print each kernel's
    registers and spill bytes."""
    out_dir = build.BUILD_DIR / "fa_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / "ptxas.so"), str(kernel.SOURCE)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        # a mangled name: ...<length><name>ILi<template argument>E...
        found = re.search(r"Compiling entry function '.*?\d+([a-z_]+kernel)"
                          r"(?:ILi(\d+)E)?", line)
        if not found:
            continue
        info = " ".join(lines[i + 1:i + 5])
        regs = re.search(r"Used (\d+) registers", info).group(1)
        spill = re.search(r"(\d+) bytes spill stores", info).group(1)
        name = f"{found.group(1)}<{found.group(2)}>"
        print(f"ptxas {name:22s} registers={regs} spill_bytes={spill}")


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print_registers()
    kernel.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    plan_of = kernel.attention_bwd_plan
    runs = list(PLANS.items()) + [("plan", None)]
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {c[0]: c[1:] for c in chip_smoke.FA_CASES}
    for label in CASES:
        b, h, s, d, causal, window = cases[label]
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g)
                       .transpose(1, 2) for _ in range(4))
        o, lse = kernel.flash_attention(q, k, v, causal, window)
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta)
        want = {"dq": (ref.attention_ref_bwd_dq(*args, causal=causal,
                                                window=window),),
                "dkdv": ref.attention_ref_bwd_dkdv(*args, causal=causal,
                                                   window=window)}
        fns = {"dq": lambda: (kernel.flash_attention_bwd_dq(
                   *args, causal, window),),
               "dkdv": lambda: kernel.flash_attention_bwd_dkdv(
                   *args, causal, window)}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        sdpa_ms = chip_smoke.device_ms(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True))
        print(f"variant {label:6s} sdpa_backward ms={sdpa_ms:.4f}")
        for name, change in runs:
            kernel.attention_bwd_plan = (
                plan_of if change is None else
                lambda *t, c=change: c(plan_of(*t)))
            plan = kernel.attention_bwd_plan(q, k, v, do)
            for which, fn in fns.items():
                got = fn()
                scale = max(1.0, max(float(w.abs().max())
                                     for w in want[which]))
                err = max(float((a - w).abs().max())
                          for a, w in zip(got, want[which])) / scale
                note = " OVER FA_RTOL" if err > chip_smoke.FA_RTOL else ""
                print(f"variant {label:6s} {name:18s} {which:4s} "
                      f"ms={chip_smoke.device_ms(fn):.4f} "
                      f"err/scale={err:.1e}{note} plan: form={plan.form} "
                      f"heads_per_block={plan.heads_per_block} "
                      f"vec={plan.vec}", flush=True)
        kernel.attention_bwd_plan = plan_of
    return 0


if __name__ == "__main__":
    sys.exit(main())
