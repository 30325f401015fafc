"""Design and launch-plan variants of the flash-attention kernels, side by
side on one card.

    python3 tools/flash_attention_variants.py [--bwd | --fwd | --tiled-bwd]
    python3 tools/flash_attention_variants.py --parent DIR [--fwd | --tiled-bwd]

Run from the root of a checkout on a machine with a CUDA card. It prints
the registers and spills of every kernel of the source as it is (``ptxas
-v``), then times, each held against the plain versions (chip_smoke.py's
FA_RTOL x the output scale) and timed on the device (chip_smoke.py's
``device_ms``):

1. forward source variants (VARIANTS): the source with one design choice
   of the forward undone (a text substitution), all compiled in parallel
   with the port's nvcc flags into ``build/variants/``, loaded with ctypes
   and driven through the wrapper with its own plan: the short form at
   chip_smoke.py's round, statistics and sigma shapes, the tensor-core
   tiled form at its multi-tile shapes (stablelm-3b's D = 80 among
   them);
2. forward plan variants (FWD_PLANS, FWD_TILED_PLANS): heads per block
   1-8, 4-byte copies and the tiled form forced where the short form runs;
   4-byte copies where the tiled form runs; SDPA's forward beside them;
3. backward plan variants (PLANS): heads per block of the short form, its
   staging copy width, or the 64-row tiled form forced, at the round's and
   statistics shapes; SDPA's whole backward beside them.

With ``--bwd`` only the fused bf16 backward (``bwd_short_mma_kernel``):
its source variants (BWD_VARIANTS: the persistent grid and its ring of
two undone, one warp a head, the causal skip undone, expf) and plan
variants (BWD_MMA_PLANS: heads per block 1, 2, 4) at
chip_smoke.py's bf16 cases whose plan is ``"mma"``, each held to one bf16
ulp plus FA_RTOL, beside the pair of FMA short forms (dq, then dk/dv) and
bf16 SDPA's whole backward. With ``--fwd`` the same for the bf16
tensor-core forward (``fwd_short_mma_kernel``; FWD_MMA_VARIANTS: the
persistent grid undone, a ring of two, one warp a head, the causal skip
undone, copies through L1, staging and stores alone, expf, exp2f, P V
from P's big part alone, whose excess the line prints; FWD_MMA_PLANS:
heads per block 1-8), beside the FMA short form and bf16 SDPA's
forward. With ``--parent DIR`` the bf16 backward
(with ``--fwd``: the bf16 forward) against another checkout's (a ``git
archive`` of the parent unpacked into an ignored ``tmp_*/`` directory):
its wrappers and source loaded from DIR, both held and timed in turns
(DIR, this, this, DIR) at the same cases, bf16 SDPA beside them.

With ``--tiled-bwd`` the f32 tiled backward (``dq_tc_kernel``,
``dkdv_tc_kernel``): the registers and spills of the base source and of
its unsplit variant, then its source variants (TB_VARIANTS: a ring of
one, the shortest blocks first, expf, one TF32 product, no split of the
streamed tiles at D = 128) at chip_smoke.py's tiled f32 cases
(TB_CASES), each held to FA_RTOL (the 1xTF32 variant prints its error,
over it), beside f32 SDPA's whole backward; with ``--parent DIR`` as
well, the pair against another checkout's dq and dk/dv wrappers, timed in
turns (DIR, this, this, DIR) at the same cases, f32 SDPA beside them.

``base`` / ``plan`` (the source and the wrapper's plan as they are) runs
first and again last, which shows the run's spread. One line per case,
variant and kernel, in milliseconds.
"""
from __future__ import annotations

import dataclasses
import importlib.util
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

_SHORT_PASSES = (
    "  float m = kNegInf;\n"
    "#pragma unroll 4\n"
    "  for (int j = 0; j < seq; ++j) {\n"
    "    const float s = dot(qr, ks + j * kShortPitch) * pr.scale;\n"
    "    qs[j * 32 + lane] = s;\n"
    "    if (visible(pr, lane, j)) m = fmaxf(m, s);\n"
    "  }\n"
    "  float l = 0.f;\n"
    "#pragma unroll\n"
    "  for (int d = 0; d < kShortD; ++d) acc[d] = 0.f;\n"
    "#pragma unroll 4\n"
    "  for (int j = 0; j < seq; ++j) {\n"
    "    const float p = visible(pr, lane, j) ? expf(qs[j * 32 + lane] - m)"
    " : 0.f;\n")
_KEYS = "constexpr int kTcKeys = 64;"
_STAGES = "constexpr int kTcStages = 2;"
_PV = "constexpr int kTcPvN = 8;"
_WARPS = "constexpr int kTcWarps = 4;"
_MMA3 = (
    "#pragma unroll\n"
    "  for (int j = 0; j < N; ++j) mma_tf32(c[j], as, bb[j]);\n"
    "#pragma unroll\n"
    "  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bs[j]);\n"
    "#pragma unroll\n"
    "  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);\n")
# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # the short forward in one pass, the online softmax rescaling the
    # accumulator only when some lane's running max changes (the design the
    # two passes replace)
    "short_rescale_on_new_max": [(_SHORT_PASSES, (
        "  float m = kNegInf, l = 0.f;\n"
        "#pragma unroll\n"
        "  for (int d = 0; d < kShortD; ++d) acc[d] = 0.f;\n"
        "  for (int j = 0; j < seq; ++j) {\n"
        "    const float s = dot(qr, ks + j * kShortPitch) * pr.scale;\n"
        "    const bool vis = visible(pr, lane, j);\n"
        "    const float m_new = vis ? fmaxf(m, s) : m;\n"
        "    if (m_new > m) {\n"
        "      const float alpha = expf(m - m_new);\n"
        "      l *= alpha;\n"
        "#pragma unroll\n"
        "      for (int d = 0; d < kShortD; ++d) acc[d] *= alpha;\n"
        "      m = m_new;\n"
        "    }\n"
        "    const float p = vis ? expf(s - m) : 0.f;\n"))],
    # both passes of the short forward without their unroll by 4
    "short_no_unroll": [(_SHORT_PASSES, _SHORT_PASSES.replace(
        "#pragma unroll 4\n", ""))],
    # the tiled forward's split without rounding the small part (the MMA
    # reads its top 19 bits): two integer operations fewer per operand
    "tc_small_truncated": [(
        "  small = rna_tf32(a - __uint_as_float(big));",
        "  small = __float_as_uint(a - __uint_as_float(big));")],
    # the tiled forward with 32-key tiles (four n8 tiles of scores): half
    # the shared memory, so two blocks share an SM at D = 128
    "tc_keys_32": [(_KEYS, "constexpr int kTcKeys = 32;")],
    # P V in chunks of 32 columns of d (four chains of MMAs, not eight)
    "tc_pv_32": [(_PV, "constexpr int kTcPvN = 4;")],
    # both: the first design of the tensor-core tiles
    "tc_keys_32_pv_32": [(_KEYS, "constexpr int kTcKeys = 32;"),
                         (_PV, "constexpr int kTcPvN = 4;")],
    # the softmax in base e (expf), not base 2
    "tc_expf": [
        ("constexpr float kTcLog2e = 1.4426950408889634f;",
         "constexpr float kTcLog2e = 1.f;"),
        ("constexpr float kTcLn2 = 0.6931471805599453f;",
         "constexpr float kTcLn2 = 1.f;"),
        ("float tc_exp(float x) { return exp2f(x); }",
         "float tc_exp(float x) { return expf(x); }")],
    # 32 or 16 query rows per block (two warps or one), not 64
    "tc_warps_2": [(_WARPS, "constexpr int kTcWarps = 2;")],
    "tc_warps_1": [(_WARPS, "constexpr int kTcWarps = 1;")],
    # a ring of one key/value tile (three do not fit in shared memory at
    # D = 128)
    "tc_stages_1": [(_STAGES, "constexpr int kTcStages = 1;")],
    # the two small products of a k-step into their own accumulator, added
    # in f32 after the k-step (a chain of one MMA per k-step, not three)
    "tc_small_terms_apart": [(_MMA3, (
        "  float c2[N][4] = {};\n"
        "#pragma unroll\n"
        "  for (int j = 0; j < N; ++j) mma_tf32(c2[j], as, bb[j]);\n"
        "#pragma unroll\n"
        "  for (int j = 0; j < N; ++j) mma_tf32(c2[j], ab, bs[j]);\n"
        "#pragma unroll\n"
        "  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);\n"
        "#pragma unroll\n"
        "  for (int j = 0; j < N; ++j)\n"
        "#pragma unroll\n"
        "    for (int e = 0; e < 4; ++e) c[j][e] += c2[j][e];\n"))],
}
# the fused bf16 backward with one choice undone (outputs checked)
_RING = "constexpr int kBwdRing = 2;"
_PERSISTENT = "constexpr bool kBwdPersistent = true;"
BWD_VARIANTS = {
    "base": [],
    # a block per heads_per_block heads, each warp one head, no ring
    "not_persistent": [
        (_RING, "constexpr int kBwdRing = 1;"),
        (_PERSISTENT, "constexpr bool kBwdPersistent = false;")],
    # the persistent grid without the ring (a head staged only when the
    # warp reaches it)
    "persistent_ring_1": [(_RING, "constexpr int kBwdRing = 1;")],
    # the causal mask's hidden tiles multiplied too
    "no_causal_skip": [("constexpr bool kBwdCausalSkip = true;",
                        "constexpr bool kBwdCausalSkip = false;")],
    # a warp per head, not two
    "one_warp_per_head": [("constexpr int kBwdWarpsPerHead = 2;",
                           "constexpr int kBwdWarpsPerHead = 1;")],
    # P by expf, not exp2f of log2(e)-scaled exponents
    "expf": [("constexpr bool kBwdExp2 = true;",
              "constexpr bool kBwdExp2 = false;")],
}
# the fused backward's plan variants: name -> change to the wrapper's plan
# (two warps a head: at most four heads a block)
BWD_MMA_PLANS = {
    **{f"heads_per_block={n}":
       (lambda p, n=n: dataclasses.replace(p, heads_per_block=n))
       for n in (1, 2, 4)},
}
# the bf16 tensor-core forward with one choice undone (outputs checked)
FWD_MMA_VARIANTS = {
    "base": [],
    # a block per heads_per_block heads
    "not_persistent": [("constexpr bool kFwdPersistent = true;",
                        "constexpr bool kFwdPersistent = false;")],
    # a ring of two heads: the next head's copies in flight while the warps
    # work on this one
    "ring_2": [("constexpr int kFwdRing = 1;", "constexpr int kFwdRing = 2;")],
    # the causal mask's hidden tiles multiplied too
    "no_causal_skip": [("constexpr bool kFwdCausalSkip = true;",
                        "constexpr bool kFwdCausalSkip = false;")],
    # one warp a head (both m-tiles), not two
    "one_warp_per_head": [("constexpr int kFwdWarpsPerHead = 2;",
                           "constexpr int kFwdWarpsPerHead = 1;")],
    # the 16-byte copies through L1 (.ca), as the f32 short forms take them
    "copies_ca": [("cp.async.cg.shared.global [%0], [%1], 16, %2;",
                   "cp.async.ca.shared.global [%0], [%1], 16, %2;")],
    # no arithmetic: the staged q rows stored as o, lse left unwritten (its
    # outputs are wrong: the floor that staging and stores set)
    "staging_and_stores_only": [(
        "  const float scale_b = kFwdExp2 ? pr.scale * kBwdLog2e : pr.scale;\n"
        "  uint32_t pb[MT][2][4]",
        "  if (P) return;\n"
        "  const float scale_b = kFwdExp2 ? pr.scale * kBwdLog2e : pr.scale;\n"
        "  uint32_t pb[MT][2][4]")],
    # P by expf, not exp2 of log2(e)-scaled scores
    "expf": [("constexpr bool kFwdExp2 = true;",
              "constexpr bool kFwdExp2 = false;")],
    # exp2f, which keeps results below 2^-126, not ex2.approx.ftz
    "exp2f": [('    asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "    y = exp2f(x);")],
    # P V from P's bf16 rounding alone (its excess printed, over FA_RTOL)
    "one_part": [("constexpr int kFwdParts = 2;",
                  "constexpr int kFwdParts = 1;")],
}
# the bf16 forward's plan variants: heads per block (csrc kMaxHeadsPerBlock
# bounds them)
FWD_MMA_PLANS = {
    f"heads_per_block={n}":
    (lambda p, n=n: dataclasses.replace(p, heads_per_block=n))
    for n in (1, 2, 4, 8)}
# the f32 tiled backward with one choice undone (outputs checked; the
# substitutions of the ring, the exponent and the products reach the
# forward too, which this mode does not time)
TB_VARIANTS = {
    "base": [],
    # a ring of one streamed tile: no copies in flight while the warps work
    "ring_1": [(_STAGES, "constexpr int kTcStages = 1;")],
    # the blocks in grid order: a causal mask's longest tiles start last
    "shortest_first": [
        ("  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcQRows;\n"
         "  q += b * sq.b + h * sq.h;\n"
         "  k += b * sk.b + h * sk.h;\n"
         "  v += b * sv.b + h * sv.h;\n"
         "  dout +=",
         "  const int q0 = blockIdx.y * kTcQRows;\n"
         "  q += b * sq.b + h * sq.h;\n"
         "  k += b * sk.b + h * sk.h;\n"
         "  v += b * sv.b + h * sv.h;\n"
         "  dout +="),
        ("  const int k0 = blockIdx.y * kTcKeys;",
         "  const int k0 = (gridDim.y - 1 - blockIdx.y) * kTcKeys;")],
    # P by expf of base-e exponents, not exp2f of log2(e)-scaled ones
    "expf": [("constexpr float kTcLog2e = 1.4426950408889634f;",
              "constexpr float kTcLog2e = 1.f;"),
             ("  return exp2f(fmaf(s, scale2, -lse2));",
              "  return expf(fmaf(s, scale2, -lse2));")],
    # one TF32 product a k-step, not three (its error printed, over
    # FA_RTOL)
    "1xtf32": [(_MMA3, (
        "#pragma unroll\n"
        "  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);\n"))],
    # 4 warps a block at D = 128 too, each with the whole streamed tile
    "no_split": [("constexpr int kTbSplitMinD = 128;",
                  "constexpr int kTbSplitMinD = 256;")],
}
# chip_smoke.py's cases that take the tiled backward
TB_CASES = ("causal 1024", "window 256", "full 256", "tiled S=100 D=32",
            "lm 4096", "lm stablelm 4096")
SHORT_CASES = ("round", "stats", "sigma M=1")
TILED_CASES = ("causal 1024", "window 256", "full 256",
               "lm stablelm 4096")


# forward plan variants where the short form runs: name -> change to the
# wrapper's plan, given the plan and (b, h, s) (None: the plan as it is)
FWD_PLANS = {
    "plan": None,
    **{f"heads_per_block={n}":
       (lambda p, b, h, s, n=n: dataclasses.replace(p, heads_per_block=n))
       for n in (1, 2, 4, 8)},
    "copies_4_bytes": lambda p, b, h, s: dataclasses.replace(p, vec=4),
    "tiled_form": lambda p, b, h, s: kernel.AttentionPlan("tiled", 1, p.vec),
}
# forward plan variants where the tiled form runs
FWD_TILED_PLANS = {
    "plan": None,
    "copies_4_bytes": lambda p, b, h, s: dataclasses.replace(p, vec=4),
}
# backward plan variants: name -> change to the wrapper's plan
PLANS = {
    "plan": None,
    **{f"heads_per_block={n}":
       (lambda p, n=n: dataclasses.replace(p, heads_per_block=n))
       for n in (1, 2, 4, 8)},
    "copies_4_bytes": lambda p: dataclasses.replace(p, vec=4),
    "tiled_form": lambda p: kernel.AttentionPlan("tiled", 1, 4),
}
CASES = ("round", "stats")


def print_registers(source: pathlib.Path = kernel.SOURCE, only: str = "",
                    tag: str = "") -> None:
    """Compile ``source`` with ``-Xptxas -v`` and print the registers and
    spill bytes of each kernel whose name holds ``only``."""
    out_dir = build.BUILD_DIR / "fa_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / f"ptxas{tag}.so"), str(source)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        # a mangled name: ...<length><name>I<element type>Li<width>E...,
        # the type f (float) or 13__nv_bfloat16; the fused backward's one
        # parameter is its mask: ...<length><name>ILb<causal>EE...
        found = re.search(r"Compiling entry function '.*?\d+([a-z_]+kernel)"
                          r"I(f|13__nv_bfloat16)Li(\d+)E", line)
        plain = re.search(r"Compiling entry function '.*?\d+([a-z_]+kernel)"
                          r"ILb([01])EE", line)
        if not (found or plain) or only not in line:
            continue
        info = " ".join(lines[i + 1:i + 5])
        regs = re.search(r"Used (\d+) registers", info).group(1)
        spill = re.search(r"(\d+) bytes spill stores", info).group(1)
        if found:
            dtype = "float" if found.group(2) == "f" else "bf16"
            name = f"{found.group(1)}<{dtype}, {found.group(3)}>"
        else:
            name = f"{plain.group(1)}<causal={plain.group(2)}>"
        print(f"ptxas{tag} {name:30s} registers={regs} "
              f"spill_bytes={spill}")


def build_variants(variants: dict = VARIANTS, tag: str = "") -> dict:
    """name -> loaded library of every source of ``variants`` (VARIANTS),
    built in parallel."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = kernel.SOURCE.read_text()
    paths = {}
    for name, subs in variants.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: substitution does not "
                                   f"match the source once: {old[:60]!r}")
            text = text.replace(old, new)
        path = out_dir / f"flash_attention{tag}_{name}.cu"
        path.write_text(text)
        paths[name] = path
    build.build_all(list(paths.values()))
    return {name: build.load(path, kernel._ARGTYPES)
            for name, path in paths.items()}


def _inputs(label: str, g: torch.Generator, dtype=torch.float32):
    case = {c[0]: c[1:] for c in chip_smoke.FA_CASES}[label]
    return case, chip_smoke.fa_operands(label, g, dtype)


def _err(got, want) -> float:
    """max |got - want| over the outputs, over the largest output scale
    (at least 1)."""
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return max(float((a - w).abs().max()) for a, w in zip(got, want)) / scale


def _line(label, name, which, fn, want, plan=None) -> None:
    err = _err(fn(), want)
    note = " OVER FA_RTOL" if err > chip_smoke.FA_RTOL else ""
    plan_txt = "" if plan is None else (
        f" plan: form={plan.form} heads_per_block={plan.heads_per_block} "
        f"vec={plan.vec}")
    print(f"variant {label:11s} {name:24s} {which:4s} "
          f"ms={chip_smoke.device_ms(fn):.4f} err/scale={err:.1e}{note}"
          f"{plan_txt}", flush=True)


def forward_variants(g: torch.Generator) -> None:
    libs = build_variants()
    library = kernel.library
    fwd_plan = kernel.attention_fwd_plan
    for label in SHORT_CASES + TILED_CASES:
        (b, h, s, d, causal, window), (q, k, v, _) = _inputs(label, g)
        want = ref.attention_ref_lse(q, k, v, causal=causal, window=window)

        def fn():
            return kernel.flash_attention(q, k, v, causal, window)
        short = fwd_plan(q, k, v, q).form == "short"
        for name in list(VARIANTS) + ["base"]:
            if name.startswith("tc_" if short else "short_"):
                continue
            kernel.library = lambda lib=libs[name]: lib
            _line(label, name, "fwd", fn, want)
        kernel.library = library
        plans = FWD_PLANS if short else FWD_TILED_PLANS
        for name, change in list(plans.items()) + [("plan", None)]:
            kernel.attention_fwd_plan = (
                fwd_plan if change is None else
                lambda *t, c=change: c(fwd_plan(*t), b, h, s))
            _line(label, name, "fwd", fn, want,
                  kernel.attention_fwd_plan(q, k, v, q))
        kernel.attention_fwd_plan = fwd_plan
        lib_mask = (None if window is None
                    else chip_smoke._visible(s, causal, window))
        sdpa_ms = chip_smoke.device_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask,
                is_causal=causal and lib_mask is None))
        print(f"variant {label:11s} {'sdpa_forward':24s} fwd  "
              f"ms={sdpa_ms:.4f}", flush=True)


def backward_variants(g: torch.Generator) -> None:
    plan_of = kernel.attention_bwd_plan
    runs = list(PLANS.items()) + [("plan", None)]
    for label in CASES:
        (b, h, s, d, causal, window), (q, k, v, do) = _inputs(label, g)
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
        print(f"variant {label:11s} sdpa_backward ms={sdpa_ms:.4f}")
        for name, change in runs:
            kernel.attention_bwd_plan = (
                plan_of if change is None else
                lambda *t, c=change: c(plan_of(*t)))
            plan = kernel.attention_bwd_plan(q, k, v, do)
            for which, fn in fns.items():
                _line(label, name, which, fn, want[which], plan)
        kernel.attention_bwd_plan = plan_of


def _mma_cases(g: torch.Generator, forward: bool = False):
    """chip_smoke.py's attention cases whose bf16 backward plan (with
    ``forward``: forward plan) is "mma": (label, causal, window, the
    wrapper's tensor arguments, the plain version's outputs)."""
    for label, *_ in chip_smoke.FA_CASES:
        (b, h, s, d, causal, window), (q, k, v, do) = _inputs(
            label, g, torch.bfloat16)
        if forward:
            if kernel.attention_fwd_plan(q, k, v, q).form == "mma":
                yield label, causal, window, (q, k, v), ref.attention_ref_lse(
                    q, k, v, causal=causal, window=window)
            continue
        if kernel.attention_bwd_plan(q, k, v, do).form != "mma":
            continue
        o, lse = kernel.flash_attention(q, k, v, causal, window)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
        yield label, causal, window, args, ref.attention_ref_bwd(
            *args, causal=causal, window=window)


def _mma_line(label, name, which, fn, want) -> None:
    excess = chip_smoke._bf16_excess(fn(), want)
    note = " OVER FA_RTOL" if excess > chip_smoke.FA_RTOL else ""
    print(f"variant {label:14s} {name:22s} {which:4s} "
          f"ms={chip_smoke.device_ms(fn):.4f} ulp_excess={excess:.1e}{note}",
          flush=True)


def _sdpa_ms(args, causal, window, forward: bool) -> float:
    """bf16 SDPA's forward, or its whole backward, on the same operands."""
    q, k, v = args[:3]
    lib_mask = (None if window is None else chip_smoke._visible(
        q.shape[2], causal, window))

    def sdpa(*t):
        return F.scaled_dot_product_attention(
            *t, attn_mask=lib_mask, is_causal=causal and lib_mask is None)
    if forward:
        with torch.no_grad():
            return chip_smoke.device_ms(lambda: sdpa(q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = sdpa(qg, kg, vg)
    return chip_smoke.device_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), args[3], retain_graph=True))


def mma_variants(g: torch.Generator, forward: bool) -> None:
    """The bf16 tensor-core forward's (``forward``) or fused backward's
    source and plan variants, the FMA form (the short forward; the dq and
    dk/dv pair) and bf16 SDPA beside them."""
    which = "fwd" if forward else "bwd"
    variants = FWD_MMA_VARIANTS if forward else BWD_VARIANTS
    libs = build_variants(variants, f"_{which}")
    plan_name = "attention_fwd_plan" if forward else "attention_bwd_plan"
    library, plan_of = kernel.library, getattr(kernel, plan_name)
    runs = ([(name, None) for name in variants]
            + list((FWD_MMA_PLANS if forward else BWD_MMA_PLANS).items())
            + [("base", None)])
    wrapper = kernel.flash_attention if forward else \
        kernel.flash_attention_bwd
    for label, causal, window, args, want in _mma_cases(g, forward):
        def fn():
            return wrapper(*args, causal, window)
        for name, change in runs:
            kernel.library = lambda lib=libs["base" if change else name]: lib
            setattr(kernel, plan_name, plan_of if change is None else
                    lambda *t, c=change: c(plan_of(*t)))
            _mma_line(label, name, which, fn, want)
        kernel.library = library
        if forward:
            kernel.attention_fwd_plan = lambda *t: kernel.AttentionPlan(
                "short", kernel.HEADS_PER_BLOCK, plan_of(*t).vec)
            _mma_line(label, "fma_short", which, fn, want)
        else:
            _mma_line(label, "fma_pair", which, lambda: (
                kernel.flash_attention_bwd_dq(*args, causal, window),
                *kernel.flash_attention_bwd_dkdv(*args, causal, window)),
                want)
        setattr(kernel, plan_name, plan_of)
        print(f"variant {label:14s} {'sdpa':22s} {which:4s} "
              f"ms={_sdpa_ms(args, causal, window, forward):.4f}",
              flush=True)


def _load_parent(parent: pathlib.Path):
    """Another checkout's attention wrapper module (its SOURCE its own)."""
    spec = importlib.util.spec_from_file_location(
        "_parent_fa_kernel", parent / "src" / "repro_torch" / "kernels"
        / "flash_attention" / "kernel.py")
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other   # its dataclasses look their module up
    spec.loader.exec_module(other)
    return other


def parent_ab(parent: pathlib.Path, forward: bool = False) -> None:
    """The bf16 backward (``forward``: the bf16 forward) against another
    checkout's (``--parent DIR``): its wrapper module and source loaded
    from DIR, built beside this one's, both held to one bf16 ulp plus
    FA_RTOL and timed in turns (DIR, this, this, DIR), bf16 SDPA beside
    them. A parent without ``flash_attention_bwd`` runs its dq and dk/dv
    wrappers in turn."""
    other = _load_parent(parent)
    build.build_all([other.SOURCE, kernel.SOURCE])
    g = torch.Generator(device="cuda").manual_seed(5)
    which = "fwd" if forward else "bwd"
    for label, causal, window, args, want in _mma_cases(g, forward):
        if forward:
            fns = {"parent": lambda: other.flash_attention(*args, causal,
                                                           window),
                   "this": lambda: kernel.flash_attention(*args, causal,
                                                          window)}
        else:
            fns = {"parent": (
                       lambda: other.flash_attention_bwd(*args, causal,
                                                         window))
                   if hasattr(other, "flash_attention_bwd") else (
                       lambda: (other.flash_attention_bwd_dq(*args, causal,
                                                             window),
                                *other.flash_attention_bwd_dkdv(
                                    *args, causal, window))),
                   "this": lambda: kernel.flash_attention_bwd(
                       *args, causal, window)}
        errs = {k: chip_smoke._bf16_excess(f(), want) for k, f in fns.items()}
        ms = [chip_smoke.device_ms(fns[k])
              for k in ("parent", "this", "this", "parent")]
        print(f"{which} ab {label:14s} parent/this/this/parent ms="
              + " ".join(f"{m:.4f}" for m in ms)
              + f" sdpa={_sdpa_ms(args, causal, window, forward):.4f}"
              + f" ulp_excess parent={errs['parent']:.1e} "
              f"this={errs['this']:.1e}", flush=True)
        chip_smoke.check(max(errs.values()) <= chip_smoke.FA_RTOL,
                         f"{label}: a {which} disagrees with the plain "
                         f"version: {errs}")


def _tb_case(label: str, g: torch.Generator):
    """One TB_CASES case in f32: (causal, window, the pair's arguments, the
    plain versions' dq, dk and dv, f32 SDPA's whole backward in ms)."""
    (b, h, s, d, causal, window), (q, k, v, do) = _inputs(label, g)
    o, lse = kernel.flash_attention(q, k, v, causal, window)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    want = (ref.attention_ref_bwd_dq(*args, causal=causal, window=window),
            *ref.attention_ref_bwd_dkdv(*args, causal=causal, window=window))
    return causal, window, args, want, _sdpa_ms(args, causal, window, False)


def tiled_bwd_variants(g: torch.Generator) -> None:
    """The f32 tiled backward's source variants (TB_VARIANTS) at TB_CASES:
    dq and dk/dv each held to FA_RTOL and timed, f32 SDPA's whole backward
    beside them."""
    libs = build_variants(TB_VARIANTS, "_tb")
    print_registers(build.BUILD_DIR / "variants"
                    / "flash_attention_tb_no_split.cu", "tc_kernel",
                    "[no_split]")
    library = kernel.library
    for label in TB_CASES:
        causal, window, args, want, sdpa = _tb_case(label, g)
        fns = {"dq": lambda: (kernel.flash_attention_bwd_dq(
                   *args, causal, window),),
               "dkdv": lambda: kernel.flash_attention_bwd_dkdv(
                   *args, causal, window)}
        wants = {"dq": want[:1], "dkdv": want[1:]}
        for name in list(TB_VARIANTS) + ["base"]:
            kernel.library = lambda lib=libs[name]: lib
            for which, fn in fns.items():
                _line(label, name, which, fn, wants[which])
        kernel.library = library
        print(f"variant {label:11s} {'sdpa_backward':24s} bwd  "
              f"ms={sdpa:.4f}", flush=True)


def tiled_parent_ab(parent: pathlib.Path) -> None:
    """The f32 tiled backward against another checkout's (``--parent DIR
    --tiled-bwd``): its dq and dk/dv wrappers and source loaded from DIR,
    built beside this one's, all held to FA_RTOL and timed in turns (DIR,
    this, this, DIR) at TB_CASES, f32 SDPA's whole backward beside them."""
    other = _load_parent(parent)
    build.build_all([other.SOURCE, kernel.SOURCE])
    g = torch.Generator(device="cuda").manual_seed(6)
    for label in TB_CASES:
        causal, window, args, want, sdpa = _tb_case(label, g)
        for which, wants in (("dq", want[:1]), ("dkdv", want[1:])):
            fns = {name: (lambda m=mod: getattr(
                       m, f"flash_attention_bwd_{which}")(*args, causal,
                                                          window))
                   for name, mod in (("parent", other), ("this", kernel))}
            errs = {}
            for name, fn in fns.items():
                got = fn()
                errs[name] = _err(got if isinstance(got, tuple) else (got,),
                                  wants)
            ms = [chip_smoke.device_ms(fns[k])
                  for k in ("parent", "this", "this", "parent")]
            print(f"tiled {which:4s} ab {label:16s} parent/this/this/parent "
                  "ms=" + " ".join(f"{m:.4f}" for m in ms)
                  + f" sdpa_backward={sdpa:.4f} err/scale parent="
                  f"{errs['parent']:.1e} this={errs['this']:.1e}",
                  flush=True)
            chip_smoke.check(max(errs.values()) <= chip_smoke.FA_RTOL,
                             f"{label}: a tiled {which} disagrees with the "
                             f"plain version: {errs}")


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    forward = "--fwd" in sys.argv[1:]
    tiled = "--tiled-bwd" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--parent" in sys.argv[1:]:
        parent = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1])
        if tiled:
            tiled_parent_ab(parent)
        else:
            parent_ab(parent, forward)
        return 0
    print_registers(only="tc_kernel" if tiled else "")
    kernel.library()
    g = torch.Generator(device="cuda").manual_seed(1)
    if tiled:
        tiled_bwd_variants(g)
        return 0
    if forward or "--bwd" in sys.argv[1:]:
        mma_variants(g, forward)
        return 0
    forward_variants(g)
    backward_variants(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
