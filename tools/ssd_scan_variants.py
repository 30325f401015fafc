"""Design variants of the SSD scan CUDA kernel, side by side on one card.

    python3 tools/ssd_scan_variants.py [--bf16]

Run from the root of a checkout on a machine with a CUDA card. Source
variants are ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` with one
piece of a chunk's work removed (a text substitution, listed in VARIANTS:
what the piece costs; their outputs are wrong and not checked) or, with
``--bf16``, one choice of the tensor-core form undone (BF16_VARIANTS; their
outputs are checked); plan variants run the source as it is with one choice
of the launch plan undone (PLANS, BF16_PLANS). All are compiled in parallel
with the port's nvcc flags into ``build/ssd_variants/``, loaded with
ctypes, and driven through the wrapper at chip_smoke.py's SSD shapes, on
f32 operands or (``--bf16``) bf16 ones, timed on the device (chip_smoke.py's
``device_ms``). Checked variants are held against the plain version
(chip_smoke.py's SSD_RTOL x the output scale; bf16: one bf16 ulp plus
that). ``base`` runs first and again last, which shows the run's spread.
Prints each source variant's registers and spills, then one line per case
and variant, in milliseconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel, ref  # noqa: E402

# name -> [(text in the source, its replacement)]: one piece removed
VARIANTS = {
    "base": [],
    # no staging copies (cp.async of x, b, c, dt)
    "no_staging": [
        ('  asm volatile("cp.async.ca.shared.global', '  if (0) asm volatile('
         '"cp.async.ca.shared.global'),
        ('  asm volatile("cp.async.cg.shared.global', '  if (0) asm volatile('
         '"cp.async.cg.shared.global')],
    # no c b^T scores
    "no_scores": [("    if (outputs)   // scores,",
                   "    if (false)   // scores,")],
    # no decayed-weight build
    "no_weights": [("      for (int hh = 0; hh < H; ++hh) {\n"
                    "        const float* cum2",
                    "      for (int hh = 0; hh < 0; ++hh) {\n"
                    "        const float* cum2")],
    # no intra-chunk product (the FMA from registers)
    "no_intra": [
        ("        for (int kb = 0; kb < qb; ++kb)\n"
         "          intra_block<false>",
         "        if (p < 0) for (int kb = 0; kb < qb; ++kb)\n"
         "          intra_block<false>"),
        ("        intra_block<true>(acc, ws", "        if (p < 0) "
         "intra_block<true>(acc, ws")],
    # no output stores
    "no_store": [("        if (p < P) {\n          T* out = y",
                  "        if (p < -1) {\n          T* out = y")],
}
# the bf16 tensor-core form with one choice undone (outputs checked)
BF16_VARIANTS = {
    "base": [],
    # W, the inter term's state and the state update's b wk in their big
    # bf16 parts only: one mma.sync per product instead of two
    "big_part_only": [
        ("          mma_bf16(acc[np], ws[kk], fx[kk][np]);\n", ""),
        ("          mma_bf16(acc[np], fc[mi], fhs[np]);\n", ""),
        ("          mma_bf16(hreg[np], small, fx[kk][np]);\n", "")],
    # no ring: a row's loads wait for the row before it
    "ring_1": [("constexpr int kMmaRing = 2;", "constexpr int kMmaRing = 1;")],
}
# plan variants of the base source for bf16 operands
BF16_PLANS = {
    # the FMA form (ssd_kernel<bf16>: bf16 loads widened into f32 tiles,
    # every product by FMA)
    "fma_form": lambda p: dataclasses.replace(p, form="fma"),
}
# plan variants of the base source: name -> change to the plan
PLANS = {
    # 4-byte staging copies everywhere
    "copies_4_bytes": lambda p: dataclasses.replace(p, vec_x=4, vec_bc=4),
    # a block per (row, head): the scores are not shared by heads
    "one_head_per_block": lambda p: dataclasses.replace(
        p, heads=1, warps=max(1, p.warps // p.heads)),
    # a row's chunks walked in order by one block, whatever the grid
    "sequential_chunks": lambda p: dataclasses.replace(p,
                                                       chunk_parallel=False),
}


def build_variants(variants: dict) -> dict:
    """Compile every variant in parallel; print registers and spills."""
    out_dir = build.BUILD_DIR / "ssd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = kernel.SOURCE.read_text()
    jobs = {}
    for name, subs in variants.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   "exactly once")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(out_dir / f"{name}.so"), str(src)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            found = re.search(r"\d(ssd_\w*?kernel)", line)
            if "Compiling entry" in line and found:
                info = " ".join(lines[i + 1:i + 5])
                regs = re.search(r"Used (\d+) registers", info).group(1)
                spill = re.search(r"(\d+) bytes spill stores", info).group(1)
                print(f"ptxas {name:12s} {found.group(1):22s} "
                      f"registers={regs} spill_bytes={spill}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, types in kernel._ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    bf16 = "--bf16" in sys.argv[1:]
    libs = build_variants(BF16_VARIANTS if bf16 else VARIANTS)
    runs = [(name, None) for name in libs] + list(
        (BF16_PLANS if bf16 else PLANS).items()) + [("base", None)]
    plan_of = kernel.ssd_scan_plan
    g = torch.Generator(device="cuda").manual_seed(2)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for label, rows, s, n, p, ds, chunk, slots in chip_smoke.SSD_CASES:
        x, dt, a_log, bm, cm = chip_smoke.ssd_operands(
            g, dtype, rows, s, n, p, ds, max(slots, 1))
        want = ref.ssd_ref(x, dt, a_log, bm, cm)
        scale = max(1.0, float(want.float().abs().max()))

        def fn():
            return kernel.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk)
        for name, change in runs:
            lib = libs["base" if change else name]
            kernel.library = lambda lib=lib: lib
            kernel.ssd_scan_plan = (plan_of if change is None else
                                    lambda *a, c=change: c(plan_of(*a)))
            err = (chip_smoke._bf16_excess(fn(), want) if bf16 else
                   float((fn() - want).abs().max()) / scale)
            checked = bf16 or change is not None or name == "base"
            note = ("" if not checked else " OVER SSD_RTOL"
                    if err > chip_smoke.SSD_RTOL else "")
            print(f"variant {label:12s} {name:20s} "
                  f"form={kernel.ssd_scan_plan(x, bm, cm, chunk).form} "
                  f"ms={chip_smoke.device_ms(fn):.4f} "
                  f"{'ulp_excess' if bf16 else 'err/scale'}={err:.1e}{note}",
                  flush=True)
        kernel.ssd_scan_plan = plan_of
    return 0


if __name__ == "__main__":
    sys.exit(main())
