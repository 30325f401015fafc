"""Design variants of the SSD scan CUDA kernel, side by side on one card.

    python3 tools/ssd_scan_variants.py [--bwd] [--bf16]
    python3 tools/ssd_scan_variants.py --tc [--case LABEL]
    python3 tools/ssd_scan_variants.py --parent DIR

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
that). With ``--bwd`` the same for the backward: its chunked form with one
piece removed (BWD_VARIANTS), its tensor-core forms with one choice undone
(BWD_TF32_VARIANTS, BWD_BF16_VARIANTS), and plan variants (BWD_PLANS,
BWD_BF16_PLANS), every gradient held at its own scale. ``base`` runs
first and again last, which shows the run's spread. With ``--tc`` the
chunk-parallel tensor-core forms at the multi-chunk SSD shapes (TC_CASES),
f32 and bf16, forward and backward: the forms (TC_VARIANTS: the state
pass's loads one chunk at a time, fewer warps in the adjoint's and the
chunk states' blocks, coarser score tasks, fewer warps in the outputs')
against the FMA forms the plans took before them (TC_PLANS, as table
fields), each output checked, with each call's device ms by CUDA kernel;
``--case LABEL`` takes one of TC_CASES. At "ragged chunks" the forward's
steps are not whole chunks of 64, so its tensor-core form is refused and
the forward runs the FMA forms: there TC_PLANS time the FMA
chunk-parallel form against the FMA walk.
With ``--parent DIR`` it times the forward and the backward against those
of another checkout (DIR, this, this, DIR), both checked: DIR's at its own
selection table's plans, this one's at its rules'. Prints each source
variant's registers and spills, then one line per case and variant, in
milliseconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
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
# the backward's chunked form with one piece of a chunk's work removed
# (``--bwd``; outputs wrong, not checked): what each piece costs
BWD_VARIANTS = {
    "base": [],
    # no c b^T scores
    "no_scores": [("    for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) "
                   "{\n      const int q = e >> 5, k = e & 31;",
                   "    for (int e = threadIdx.x; e < 0; e += blockDim.x) "
                   "{\n      const int q = e >> 5, k = e & 31;")],
    # no dW = dY X^T (lane k's column)
    "no_dw": [("      for (int q = 0; q < Q; ++q) acc[q] = 0.f;\n"
               "      for (int p4 = 0; p4 < P; p4 += 4) {",
               "      for (int q = 0; q < Q; ++q) acc[q] = 0.f;\n"
               "      for (int p4 = 0; p4 < 0; p4 += 4) {")],
    # no pass down the column (W, M's suffix sums, dS, ddt's first term)
    "no_column": [("      for (int q = Q - 1; q >= 0; --q) {\n"
                   "        const float l = q >= k",
                   "      for (int q = Q - 1; q >= Q; --q) {\n"
                   "        const float l = q >= k")],
    # no dX = W^T dY
    "no_dx": [("      // row k of dX = W^T dY + u_k B G, over x's row k "
               "(read only by lane k)\n"
               "      for (int p4 = 0; p4 < P; p4 += 4) {",
               "      for (int p4 = 0; p4 < 0; p4 += 4) {")],
    # no dB, dC products
    "no_dbdc": [("task < 2 * Q * nsc;", "task < 0;")],
    # no dX stores
    "no_dx_store": [("      store_rows(a.dx +",
                     "      if (P < 0) store_rows(a.dx +")],
}
# the backward's f32 tensor-core form with one choice undone (outputs
# checked)
BWD_TF32_VARIANTS = {
    "base": [],
    # a ring of two rows (twice the shared memory: two blocks an SM)
    "ring_2": [("constexpr int kTfRing = 1;", "constexpr int kTfRing = 2;")],
}
# the backward's bf16 tensor-core form with one choice undone (outputs
# checked)
BWD_BF16_VARIANTS = {
    "base": [],
    # no ring: a row's loads wait for the row before it
    "ring_1": [("constexpr int kBwdRing = 2;", "constexpr int kBwdRing = 1;")],
    # W^T and the head-summed dS in their big bf16 parts only: one mma.sync
    # per product instead of two
    "big_part_only": [
        ("          mma_bf16(acc[np], wsm[mi][kk], fdyt[kk][np]);\n", ""),
        ("          mma_bf16(acc[np], small, fo[np]);\n", "")],
}
# plan variants of the backward (f32: the chunked FMA form against the
# 3xTF32 tensor-core form where both run)
BWD_PLANS = {
    "chunk_form": lambda p: dataclasses.replace(p, form="chunk",
                                                warps=max(p.heads, 4)),
    # a block per (row, head): heads split across blocks, dB and dC summed
    # over heads by the second launch
    "one_head_per_block": lambda p: dataclasses.replace(
        p, form="chunk", heads=1, warps=4),
}
# the bf16 backward forced into the chunked form (bf16 loads widened, f32
# FMA)
BWD_BF16_PLANS = {
    "chunk_form": lambda p: dataclasses.replace(p, form="chunk",
                                                warps=max(p.heads, 4)),
}
# plan variants of the base source for bf16 operands
BF16_PLANS = {
    # the FMA form (ssd_kernel<bf16>: bf16 loads widened into f32 tiles,
    # every product by FMA)
    "fma_form": lambda p: dataclasses.replace(p, form="fma"),
}
# the chunk-parallel tensor-core forms' source variants (``--tc``;
# outputs checked)
TC_VARIANTS = {
    "base": [],
    # the state pass's loads issued one chunk at a time, each after the
    # last chunk's store (the old chunk scan's chain, on 16-byte loads)
    "pass_depth_1": [("constexpr int kTcDepth = 8;",
                      "constexpr int kTcDepth = 1;")],
    # the adjoint's block of 8 warps (one block an SM either way), so its
    # score tasks up to 32 columns wide (six: a warp each, one more for the
    # cumsum)
    "bwd_warps_8": [("constexpr int kTcBwdThreads = 512;",
                     "constexpr int kTcBwdThreads = 256;"),
                    ("constexpr bool kTcFineUpper = true;",
                     "constexpr bool kTcFineUpper = false;")],
    # the chunk states' block of 4 warps
    "state_warps_4": [("constexpr int kTcStateThreads = 256;",
                       "constexpr int kTcStateThreads = 128;")],
    # the adjoint's score tasks up to 32 columns wide: six tasks, not ten
    "bwd_coarse_scores": [("constexpr bool kTcFineUpper = true;",
                           "constexpr bool kTcFineUpper = false;")],
    # the outputs' block of 8 warps, its tasks 32 columns wide
    "out_warps_8": [("constexpr int kTcThreads = 512;",
                     "constexpr int kTcThreads = 256;"),
                    ("constexpr int kTcOutCols = 16;",
                     "constexpr int kTcOutCols = 32;")],
}
# the multi-chunk SSD cases the tensor-core forms take (the forward's at
# "ragged chunks" refuses: 480 steps)
TC_CASES = ("multi-chunk", "ragged chunks", "mamba2 4096")
# the forms the plans took before the tensor-core ones, as selection-table
# fields (``--tc``): the FMA forward walked in order (the table's pick at
# "mamba2 4096") and chunk-parallel, and the chunked backward, a block per
# head
TC_PLANS = {
    "fma_sequential": {"tc": False, "heads": 1, "chunk_parallel": False},
    "fma_chunk_parallel": {"tc": False, "heads": 1, "chunk_parallel": True},
    "bwd_chunk": {"bwd_tc": False, "bwd_heads": 1},
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
    # the kernel's chunk cut to 32 steps (the same function; at mamba2's
    # ds = 128 a block of 83 KB, two an SM, where inner 64 takes 149 KB)
    "inner_32": lambda p: dataclasses.replace(
        p, inner=32, chunks=p.chunks * p.inner // 32),
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


def _bwd_error(got, want, bf16: bool) -> float:
    """The largest gradient error: each gradient against its own scale
    (bf16: one ulp plus that, ddt by its scale alone)."""
    if bf16:
        return max(chip_smoke._bf16_excess(g, w) if g.dtype == torch.bfloat16
                   else float((g - w).abs().max())
                   / max(float(w.abs().max()), 1.0)
                   for g, w in zip(got, want))
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1.0)
               for g, w in zip(got, want))


def bwd_main(bf16: bool) -> int:
    """The backward's variants at chip_smoke.py's SSD shapes. f32: the
    plan's form (3xTF32 at the FL shape), its ring of one, the chunked FMA
    form, a block per head, and the chunked form with each piece removed
    (unchecked); bf16: the tensor-core form's variants and the chunked
    form."""
    if bf16:
        libs = build_variants(BWD_BF16_VARIANTS)
        runs = [(name, name, None) for name in libs] + [
            (name, "base", change) for name, change in BWD_BF16_PLANS.items()]
    else:
        libs = build_variants({**BWD_VARIANTS, **{
            f"tf32_{k}": v for k, v in BWD_TF32_VARIANTS.items()
            if k != "base"}})
        chunk = BWD_PLANS["chunk_form"]
        runs = ([("base", "base", None)]
                + [(name, name, None) for name in libs
                   if name.startswith("tf32_")]
                + [(name, "base", change)
                   for name, change in BWD_PLANS.items()]
                + [(f"chunk_{name}", name, chunk) for name in BWD_VARIANTS
                   if name != "base"])
    runs.append(("base", "base", None))
    plan_of = kernel.ssd_bwd_scan_plan
    g = torch.Generator(device="cuda").manual_seed(6)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for label, rows, s, n, p, ds, _, slots in chip_smoke.SSD_CASES:
        if bf16 and label in chip_smoke.SSD_F32_ONLY:
            continue
        args = chip_smoke.ssd_operands(g, dtype, rows, s, n, p, ds, slots)
        dy = torch.randn(rows, s, n, p, device="cuda", generator=g).to(dtype)
        want = ref.ssd_bwd_ref(*args, dy)

        def fn():
            return kernel.ssd_scan_bwd(*args, dy)
        base_form = plan_of(args[0], args[3], args[4], dy).form
        for name, lib_name, change in runs:
            if base_form == "tc" and (change is not None or (
                    lib_name != "base" and lib_name in BWD_VARIANTS)):
                continue   # the tensor-core chunk-parallel form: --tc
            lib = libs[lib_name]
            kernel.library = lambda lib=lib: lib
            kernel.ssd_bwd_scan_plan = (plan_of if change is None else
                                        lambda *a, c=change: c(plan_of(*a)))
            err = _bwd_error(fn(), want, bf16)
            checked = lib_name == "base" or lib_name not in BWD_VARIANTS
            note = ("" if not checked else " OVER SSD_RTOL"
                    if err > chip_smoke.SSD_RTOL else "")
            plan = kernel.ssd_bwd_scan_plan(args[0], args[3], args[4], dy)
            print(f"bwd variant {label:12s} {name:20s} form={plan.form} "
                  f"heads={plan.heads} ms={chip_smoke.device_ms(fn):.4f} "
                  f"err={err:.1e}{note}", flush=True)
        kernel.ssd_bwd_scan_plan = plan_of
    return 0


def _by_kernel(fn, reps: int = 3) -> str:
    """Device ms a call of ``fn`` by CUDA kernel (torch.profiler over
    ``reps`` calls), largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    def name(key):
        found = re.search(r"\w*kernel\w*", key)
        return found.group(0) if found else key[:40]
    rows = sorted(((e.self_device_time_total / reps / 1e3, name(e.key))
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    return " ".join(f"{k}={ms:.4f}" for ms, k in rows[:6])


def tc_main(cases=TC_CASES) -> int:
    """The chunk-parallel tensor-core forms at ``cases`` (of TC_CASES), f32
    and bf16: each TC_VARIANTS source (forward and backward forced into the
    form by table fields where it takes the shape) and each TC_PLANS form
    of the base source (the FMA forward at the rules' inner chunk),
    checked against the plain versions, with device ms and each call's
    kernels."""
    libs = build_variants(TC_VARIANTS)
    tuned = kernel._tuned
    g = torch.Generator(device="cuda").manual_seed(6)
    tc = {"tc": True, "inner": kernel.TC_CHUNK, "heads": 1,
          "chunk_parallel": True, "bwd_tc": True}
    # the FMA forward's TC_PLANS at the rules' inner chunk
    fma = {k: v for k, v in tc.items() if k != "inner"}
    for label, rows, s, n, p, ds, chunk, slots in chip_smoke.SSD_CASES:
        if label not in cases:
            continue
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            args = chip_smoke.ssd_operands(g, dtype, rows, s, n, p, ds,
                                           slots)
            dy = torch.randn(rows, s, n, p, device="cuda",
                             generator=g).to(dtype)
            want = ref.ssd_ref(*args)
            want_b = ref.ssd_bwd_ref(*args, dy)
            runs = ([(name, name, tc) for name in libs]
                    + [(name, "base", {**(tc if fields.get("tc", True)
                                          else fma), **fields})
                       for name, fields in TC_PLANS.items()]
                    + [("base", "base", tc)])
            for name, lib_name, fields in runs:
                lib = libs[lib_name]
                kernel.library = lambda lib=lib: lib
                kernel._tuned = lambda *a, f=fields: dict(f)

                def fwd():
                    return kernel.ssd_scan(*args, chunk=chunk)

                def bwd():
                    return kernel.ssd_scan_bwd(*args, dy, chunk=chunk)
                err = (chip_smoke._bf16_excess(fwd(), want) if bf16 else
                       float((fwd() - want).abs().max())
                       / max(1.0, float(want.abs().max())))
                err_b = _bwd_error(bwd(), want_b, bf16)
                note = (" OVER SSD_RTOL"
                        if max(err, err_b) > chip_smoke.SSD_RTOL else "")
                x, _, _, bm, cm = args
                plan = kernel.ssd_scan_plan(x, bm, cm, chunk)
                bplan = kernel.ssd_bwd_scan_plan(x, bm, cm, dy, chunk)
                fwd_form = plan.form + "-cp" * (plan.form == "fma"
                                                and plan.chunk_parallel)
                print(f"tc variant {label:12s} bf16={int(bf16)} {name:20s} "
                      f"forms={fwd_form}/{bplan.form} fwd ms="
                      f"{chip_smoke.device_ms(fwd):.4f} bwd ms="
                      f"{chip_smoke.device_ms(bwd):.4f} err={err:.1e} "
                      f"bwd err={err_b:.1e}{note}", flush=True)
                print(f"  fwd kernels: {_by_kernel(fwd)}", flush=True)
                print(f"  bwd kernels: {_by_kernel(bwd)}", flush=True)
    kernel._tuned = tuned
    return 0


def _parent_tuned(parent: pathlib.Path):
    """A ``_tuned`` that reads DIR's own selection table (its plans at
    DIR's entries, as DIR's CUDA path takes them)."""
    import json
    from repro_torch.kernels import autotune
    path = parent / "artifacts" / "autotune_torch" / "ssd_scan.json"
    entries = json.loads(path.read_text())["entries"]

    def tuned(bsz, s, n, p, ds, chunk, itemsize, backend):
        if backend is None:
            return {}
        key = autotune.make_key("ssd_scan", (bsz, s, n, p, ds, chunk),
                                autotune.DTYPES[itemsize], backend)
        return dict(entries.get(key, {}).get("plan", {}))
    return tuned


def bwd_ab(parent: pathlib.Path) -> int:
    """The forward and the backward against another checkout's (``--parent
    DIR``, e.g. a ``git archive`` of the parent commit unpacked into an
    ignored directory): its wrapper and source loaded from DIR, built beside
    this one's, DIR's plans at DIR's selection table, this one's at its
    rules', both held against the plain versions and timed in turns (DIR,
    this, this, DIR) at every SSD case, f32 and bf16."""
    spec = importlib.util.spec_from_file_location(
        "_parent_ssd_kernel",
        parent / "src" / "repro_torch" / "kernels" / "ssd_scan" / "kernel.py")
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other   # its dataclasses look their module up
    spec.loader.exec_module(other)
    other._tuned = _parent_tuned(parent)
    kernel._tuned = lambda *a: {}
    build.build_all([other.SOURCE, kernel.SOURCE])
    g = torch.Generator(device="cuda").manual_seed(6)
    for bf16 in (False, True):
        dtype = torch.bfloat16 if bf16 else torch.float32
        for label, rows, s, n, p, ds, chunk, slots in chip_smoke.SSD_CASES:
            if bf16 and label in chip_smoke.SSD_F32_ONLY:
                continue
            args = chip_smoke.ssd_operands(g, dtype, rows, s, n, p, ds, slots)
            dy = torch.randn(rows, s, n, p, device="cuda",
                             generator=g).to(dtype)
            want = ref.ssd_ref(*args)
            want_b = ref.ssd_bwd_ref(*args, dy)
            x, _, _, bm, cm = args
            for op in ("fwd", "bwd"):
                if op == "fwd":
                    fns = {"parent": lambda: other.ssd_scan(*args,
                                                            chunk=chunk),
                           "this": lambda: kernel.ssd_scan(*args,
                                                           chunk=chunk)}
                    forms = (other.ssd_scan_plan(x, bm, cm, chunk).form,
                             kernel.ssd_scan_plan(x, bm, cm, chunk).form)
                    errs = {k: (chip_smoke._bf16_excess(f(), want) if bf16
                                else float((f() - want).abs().max())
                                / max(1.0, float(want.abs().max())))
                            for k, f in fns.items()}
                else:
                    fns = {"parent": lambda: other.ssd_scan_bwd(
                               *args, dy, chunk=chunk),
                           "this": lambda: kernel.ssd_scan_bwd(
                               *args, dy, chunk=chunk)}
                    forms = (other.ssd_bwd_scan_plan(x, bm, cm, dy,
                                                     chunk).form,
                             kernel.ssd_bwd_scan_plan(x, bm, cm, dy,
                                                      chunk).form)
                    errs = {k: _bwd_error(f(), want_b, bf16)
                            for k, f in fns.items()}
                ms = [chip_smoke.device_ms(fns[k])
                      for k in ("parent", "this", "this", "parent")]
                print(f"{op} ab {label:12s} bf16={int(bf16)} forms="
                      f"{forms[0]}/{forms[1]} parent/this/this/parent ms="
                      + " ".join(f"{m:.4f}" for m in ms)
                      + f" err parent={errs['parent']:.1e} "
                      f"this={errs['this']:.1e}", flush=True)
                chip_smoke.check(max(errs.values()) <= chip_smoke.SSD_RTOL,
                                 f"{label} {op}: a kernel disagrees with "
                                 f"the plain version: {errs}")
    return 0


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    bf16 = "--bf16" in sys.argv[1:]
    if "--parent" in sys.argv[1:]:
        return bwd_ab(pathlib.Path(sys.argv[sys.argv.index("--parent") + 1]))
    if "--tc" in sys.argv[1:]:
        if "--case" in sys.argv[1:]:
            label = sys.argv[sys.argv.index("--case") + 1]
            chip_smoke.check(label in TC_CASES, f"--case: one of {TC_CASES}")
            return tc_main((label,))
        return tc_main()
    if "--bwd" in sys.argv[1:]:
        return bwd_main(bf16)
    libs = build_variants(BF16_VARIANTS if bf16 else VARIANTS)
    runs = [(name, None) for name in libs] + list(
        (BF16_PLANS if bf16 else PLANS).items()) + [("base", None)]
    plan_of = kernel.ssd_scan_plan
    g = torch.Generator(device="cuda").manual_seed(2)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for label, rows, s, n, p, ds, chunk, slots in chip_smoke.SSD_CASES:
        if bf16 and label in chip_smoke.SSD_F32_ONLY:
            continue
        x, dt, a_log, bm, cm = chip_smoke.ssd_operands(
            g, dtype, rows, s, n, p, ds, max(slots, 1))
        want = ref.ssd_ref(x, dt, a_log, bm, cm)
        scale = max(1.0, float(want.float().abs().max()))

        def fn():
            return kernel.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk)
        base_form = plan_of(x, bm, cm, chunk).form
        for name, change in runs:
            if base_form == "tc" and (change is not None or name != "base"):
                continue   # the tensor-core chunk-parallel form: --tc
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
