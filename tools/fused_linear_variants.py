"""Design variants of the fused linear CUDA kernels, side by side on one card.

    python3 tools/fused_linear_variants.py          # the f32 kernels
    python3 tools/fused_linear_variants.py --bf16   # their bf16 forms

Run from the root of a checkout on a machine with a CUDA card. Each variant
is the source ``src/repro_torch/kernels/fused_linear/csrc/fused_linear.cu``
with one design choice undone (a text substitution, listed in VARIANTS);
all are compiled in parallel with the port's nvcc flags into
``build/variants/``, loaded with ctypes, and driven through the C entry
points with the wrappers' own launch plans. At the VGG round's fc shapes
(6 slots x 95 rows) and the per-sample pass's M = 1, every variant's
forward, dx and dw/db is held against the plain PyTorch version (1e-5 x
the output scale, as chip_smoke.py) and timed on the device (chip_smoke.py's
``device_ms``); dw/db and dx also without the relu mask, to show what the
mask costs. Two dx variants change the launch plan instead of the source
(DX_PLANS: no split of N, no slot fold), and one computes dz = dy *
1[y > 0] in a separate pass before an unmasked dx. ``base`` (the source as
it is) runs first and again last, which shows the run's spread. Prints each
kernel's registers and spills, then one line per case and variant, in
milliseconds. With ``--bf16`` it does the same for the bf16 forms
(BF16_VARIANTS: the mma.sync forms' and the Hopper forms' design choices)
at chip_smoke.py's bf16 shapes, through the wrappers (``kernel.library``
pointed at each variant), each held to chip_smoke.py's ``BF16_RTOL`` (one
bf16 ulp per element plus that fraction of the scale; each line prints
the excess over one ulp), then the base source under plan variants
(BF16_PLANS: dx with cluster multicast, the mma.sync forms where the
plans pick the Hopper ones, dw/db with one tile per CTA, dx's split for
half the card), with bf16 cuBLAS (and, for dw/db's write floor, a fill
of a tensor of dw's size) beside each case and the round's fc1-fc3
summed per variant; the base source runs first and again last. Last for
each case, the base source and bf16 cuBLAS again with the L2 flushed
before each call (``cold_l2``), as the path reads its operands from HBM.
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
from repro_torch.kernels.fused_linear import kernel, ref  # noqa: E402

DW_LOOP = ("  if (a.M < BR) {\n    if (nr) stage(0, std::true_type{});\n"
           "  } else {\n    for (int rt = 0; rt < nr; ++rt) "
           "stage(rt, std::false_type{});\n  }")
# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # the TF32 split on the conversion unit (cvt.rna.tf32.f32)
    "cvt_rounding": [(
        "  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;",
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) "
        ": \"f\"(a));\n  return r;")],
    # every stage's MMAs chained straight into acc (no per-stage f32 add)
    "no_flush": [
        ("                                             BK, step);\n"
         "    flush(acc, step);",
         "                                             BK, acc);"),
        ("        s, sd, sy, wm, wn, a.M - rt * BR, step);\n"
         "    flush(acc, step);",
         "        s, sd, sy, wm, wn, a.M - rt * BR, acc);"),
        ("                     nend - nbeg, step);\n      flush(acc, step);",
         "                     nend - nbeg, acc);")],
    # dw/db: full stages in a loop, then M's partial last stage apart
    "dw_two_copies": [(DW_LOOP, (
        "  const int full = a.M / BR;\n"
        "  for (int rt = 0; rt < full; ++rt) stage(rt, std::false_type{});\n"
        "  if (full < nr) stage(full, std::true_type{});"))],
    # dw/db: every stage in full, M < 32 too
    "dw_no_tail": [(DW_LOOP, (
        "  for (int rt = 0; rt < nr; ++rt) stage(rt, std::false_type{});"))],
    # dw/db: 128 x 128 tiles, one CTA per SM
    "dw_tiles_128x128": [
        ("constexpr int kDwBN = 64; ", "constexpr int kDwBN = 128;"),
        ("constexpr int kDwMinBlocks = 2;",
         "constexpr int kDwMinBlocks = 1;")],
    # dw/db: 16 rows of M per stage, 4 stages
    "dw_16_row_stages": [
        ("constexpr int kDwBR = 32;", "constexpr int kDwBR = 16;"),
        ("constexpr int kDwStages = 3;", "constexpr int kDwStages = 4;")],
    # dw/db without its dw stores (what the stores cost; output not checked)
    "dw_no_store": [("      if (k >= a.K) continue;",
                     "      if (k >= a.K || a.N >= 0) continue;")],
    # dx: 16-deep stages, 4 of them (two CTAs per SM)
    "dx_16_deep_4_stages": [
        ("constexpr int kDxBK = 32; ", "constexpr int kDxBK = 16; "),
        ("constexpr int kDxStages = 2;", "constexpr int kDxStages = 4;")],
    # dx: 3 stages (the y tile then leaves room for one CTA per SM)
    "dx_3_stages": [
        ("constexpr int kDxStages = 2;", "constexpr int kDxStages = 3;")],
    # dx: a short reduction (N <= 16) copies all 32 columns of its stage
    "dx_full_short_copy": [
        ("const bool short_n = nend - nbeg <= 16;",
         "const bool short_n = false;")],
    # dx: every stage in full, a short reduction (N < 32) too
    "dx_no_tail": [
        ("const bool short_n = nend - nbeg <= 16;",
         "const bool short_n = false;"),
        ("  if (nend - nbeg < BK) {\n"
         "    if (nn) stage(0, std::true_type{});", "  if (false) {")],
}
# The bf16 forms' fragment stores (4 bytes, two bf16, a store) in place of
# the tile staged through shared memory and written 16 bytes at a time;
# the staging code after the early return is left dead.
BF16_FRAGMENT_STORES = """\
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = r0 + wm + i * 16 + g + 8 * h;
        const int c = c0 + wn + j * 8 + 2 * t;
        if (r >= M) continue;
        const uint16_t v0 = from_f32<uint16_t>(f(acc[i][j][2 * h], c));
        const uint16_t v1 = from_f32<uint16_t>(f(acc[i][j][2 * h + 1], c + 1));
        uint16_t* p = out + r * ld;
        if ((ld & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0 &&
            c + 1 < N) {
          *reinterpret_cast<uint32_t*>(p + c) = v0 | (uint32_t(v1) << 16);
        } else {
          if (c < N) p[c] = v0;
          if (c + 1 < N) p[c + 1] = v1;
        }
      }
  return;
"""
BF16_STAGING = ("  cp_async_wait<0>();\n"
                "  __syncthreads();              // every warp is done with "
                "the stages\n")
# dwdb_tma_kernel's stores: the TMA stores of a tile, and the whole
# epilogue from the staging buffer's wait to the stores
TW_STORE = """\
      for (int q = 0; q < kTwNT / 64; ++q)
        tma_store_3d(&tdw, out + q * L::OUT_REGION + wg * 64 * 128,
                     nt * kTwNT + 64 * q, kt * kTwKT + 64 * wg, slot);
      bulk_commit();"""
TW_EPILOGUE = """\
    if (elected) bulk_wait_read<kTwOutBufs - 1>();
    named_sync(2 + wg, 128);
    uint8_t* out = smem + L::OUT + (i % kTwOutBufs) * L::OUT_BUF;
#pragma unroll
    for (int j = 0; j < kTwNT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;   // row % 8 == g
        *reinterpret_cast<uint32_t*>(out + (j / 8) * L::OUT_REGION +
                                     row * 128 + (((j % 8) ^ g) << 4) +
                                     t4 * 4) =
            bf16x2_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (elected) {
""" + TW_STORE + """
    }"""
TW_FRAGMENT_STORES = """\
    uint16_t* dwp = a.dw + slot * a.swb;
#pragma unroll
    for (int j = 0; j < kTwNT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kt * kTwKT + r + 8 * h, n = nt * kTwNT + 8 * j + 2 * t4;
        if (k < a.K && n < a.N)
          *reinterpret_cast<uint32_t*>(dwp + k * a.swk + n) =
              bf16x2_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }"""
# dw/db's staging buffer copied out by its warpgroup's threads, 16 bytes
# a store (a warp two rows of 256 bytes), in place of TMA stores
TW_LSU_EPILOGUE = """\
    named_sync(2 + wg, 128);
    uint8_t* out = smem + L::OUT;
#pragma unroll
    for (int j = 0; j < kTwNT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;   // row % 8 == g
        *reinterpret_cast<uint32_t*>(out + (j / 8) * L::OUT_REGION +
                                     row * 128 + (((j % 8) ^ g) << 4) +
                                     t4 * 4) =
            bf16x2_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    named_sync(2 + wg, 128);
    for (int e = tid & 127; e < 64 * (kTwNT / 8); e += 128) {
      const int row = e / (kTwNT / 8), c = e % (kTwNT / 8);
      const int k = kt * kTwKT + 64 * wg + row, n = nt * kTwNT + 8 * c;
      const uint4 v = *reinterpret_cast<const uint4*>(
          out + (c / 8) * L::OUT_REGION + (64 * wg + row) * 128 +
          (((c % 8) ^ (row % 8)) << 4));
      uint16_t* dst = a.dw + slot * a.swb + static_cast<long long>(k) * a.swk;
      if (k < a.K && n + 8 <= a.N)
        *reinterpret_cast<uint4*>(dst + n) = v;
      else if (k < a.K)
        for (int q = 0; q < 8 && n + q < a.N; ++q)
          dst[n + q] = reinterpret_cast<const uint16_t*>(&v)[q];
    }"""
# dw/db's epilogue with the software bf16 rounding (from_f32) and both
# warpgroups in step, one thread storing the whole tile
TW_JOINT_EPILOGUE = """\
    if (tid == 0) bulk_wait_read<kTwOutBufs - 1>();
    named_sync(1, kTwConsumers);
    uint8_t* out = smem + L::OUT + (i % kTwOutBufs) * L::OUT_BUF;
#pragma unroll
    for (int j = 0; j < kTwNT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;   // row % 8 == g
        *reinterpret_cast<uint32_t*>(out + (j / 8) * L::OUT_REGION +
                                     row * 128 + (((j % 8) ^ g) << 4) +
                                     t4 * 4) =
            from_f32<uint16_t>(acc[4 * j + 2 * h]) |
            (uint32_t(from_f32<uint16_t>(acc[4 * j + 2 * h + 1])) << 16);
      }
    fence_proxy_async();
    named_sync(1, kTwConsumers);
    if (tid == 0) {
      for (int q = 0; q < kTwNT / 64; ++q)
        for (int half = 0; half < 2; ++half)
          tma_store_3d(&tdw, out + q * L::OUT_REGION + half * 64 * 128,
                       nt * kTwNT + 64 * q, kt * kTwKT + 64 * half, slot);
      bulk_commit();
    }"""
# fwd_tma_kernel's epilogue from its f32 staging tile on, and the same
# with y stored by TMA instead: each warpgroup's 64 columns rounded to bf16
# into a 96-row box of 128-byte swizzled rows (the ring, free by then), one
# TMA store a warpgroup, clipped at y's edges; a split's partials as before
TF_TILE = """\
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kTfBM / 8; ++j)"""
TF_TMA_STORE = """\
  if (direct) {
    uint8_t* out = smem + wg * (kTfBM * 128);
    const int nl = r - wg * 64;
#pragma unroll
    for (int j = 0; j < kTfBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * j + 2 * t + (e & 1), n = nl + 8 * (e >> 1);
        *reinterpret_cast<uint16_t*>(out + m * 128 +
                                     (((n >> 3) ^ (m & 7)) << 4) +
                                     (n & 7) * 2) =
            from_f32<uint16_t>(acc[4 * j + e]);
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if ((tid & 127) == 0) {
      tma_store_3d(ty, out, n0 + 64 * wg, m0, slot);
      bulk_commit();
      bulk_wait<0>();
    }
    return;
  }
""" + TF_TILE
# ... and y's tensor map, encoded on the host and passed to the consumers
TF_Y_MAP = [
    ("""    uint8_t* smem, uint64_t* full, uint64_t* empty,
    const FwdArgsT<uint16_t>& a,""",
     """    uint8_t* smem, uint64_t* full, uint64_t* empty, const CUtensorMap* ty,
    const FwdArgsT<uint16_t>& a,"""),
    ("""               const __grid_constant__ CUtensorMap tw,
               const FwdArgsT<uint16_t> a, const int wb) {""",
     """               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap ty,
               const FwdArgsT<uint16_t> a, const int wb) {"""),
    ("fwd_tma_consumer(smem, full, empty, a,",
     "fwd_tma_consumer(smem, full, empty, &ty, a,"),
    ("""  CUtensorMap tx, tw;
  CUresult r = hopper::encode_bf16_3d(&tx,""",
     """  CUtensorMap tx, tw, ty;
  CUresult r = hopper::encode_bf16_3d(&ty, a.y, a.N, a.M, a.batch, a.sym,
                                      a.syb, 64, kTfBM, kSw);
  if (r == CUDA_SUCCESS)
    r = hopper::encode_bf16_3d(&tx,"""),
    ("      tx, tw, a, a.swb != 0);", "      tx, tw, ty, a, a.swb != 0);"),
]
# bf16 forms: name -> [(text in the source, its replacement)]
BF16_VARIANTS = {
    "bf16_base": [],
    # two CTAs per SM, as the f32 forms: 4 forward and 3 dx stages
    "bf16_two_ctas": [
        ("constexpr int kBfMinBlocks = 3;", "constexpr int kBfMinBlocks = 2;"),
        ("constexpr int kBfFwdStages = 3;", "constexpr int kBfFwdStages = 4;"),
        ("constexpr int kBfDxStages = 2;", "constexpr int kBfDxStages = 3;")],
    # results stored straight from the fragments
    "bf16_fragment_stores": [(BF16_STAGING,
                              BF16_FRAGMENT_STORES + BF16_STAGING)],
    # the Hopper backward forms: dx's ring of 2 or 3 stages, not 4
    "tx_ring_2": [("constexpr int kTxStages = 4;",
                   "constexpr int kTxStages = 2;")],
    "tx_ring_3": [("constexpr int kTxStages = 4;",
                   "constexpr int kTxStages = 3;")],
    # dx CTAs of 128 or 64 columns of K (dz and y fetched 1.5x, 3x as often)
    "tx_k128": [("constexpr int kTxGroups = 3;",
                 "constexpr int kTxGroups = 2;")],
    "tx_k64": [("constexpr int kTxGroups = 3;",
                "constexpr int kTxGroups = 1;")],
    # dx: one wgmma chain over all of N, no per-stage f32 add
    "tx_one_chain": [("constexpr bool kTxStageAdd = true;",
                      "constexpr bool kTxStageAdd = false;")],
    # dw/db: tiles of 128 x 256 (wgmma n256), x read half as often
    "tw_n256": [("constexpr int kTwNT = 128;", "constexpr int kTwNT = 256;")],
    # dw/db: two staging buffers, so two tiles' stores drain at once
    "tw_two_out": [("constexpr int kTwOutBufs = 1;",
                    "constexpr int kTwOutBufs = 2;")],
    # dw/db without its dw stores (what the stores cost; output not checked)
    "tw_no_store": [(TW_STORE, "      bulk_commit();")],
    # dw/db storing dw straight from the accumulators (4 bytes a thread, a
    # warp 8 rows x 16 bytes), no staging or TMA store
    "tw_fragment_stores": [(TW_EPILOGUE, TW_FRAGMENT_STORES)],
    # dw/db: dw copied out of the staging buffer by LSU stores, no TMA
    "tw_lsu_stores": [(TW_EPILOGUE, TW_LSU_EPILOGUE)],
    # dw/db: the two warpgroups' epilogues in step (one thread stores the
    # tile) with the software bf16 rounding
    "tw_joint_epilogue": [(TW_EPILOGUE, TW_JOINT_EPILOGUE),
                          ("  if (elected) bulk_wait<0>();",
                           "  if (tid == 0) bulk_wait<0>();")],
    # dw/db: x staged once a tile, no ring ahead of the multiply
    "tw_x_ring_1": [("constexpr int kTwStages = 2;",
                     "constexpr int kTwStages = 1;")],
    # the Hopper forward: a ring of 3 stages, not 4
    "tf_ring_3": [("constexpr int kTfStages = 4;",
                   "constexpr int kTfStages = 3;")],
    # forward CTAs of 128 columns of N (x fetched 1.5x as often; the
    # round's fc2 192 CTAs, two waves)
    "tf_n128": [("constexpr int kTfGroups = 3;",
                 "constexpr int kTfGroups = 2;")],
    # the forward: one wgmma chain over all of K, no per-stage f32 add
    "tf_one_chain": [("constexpr bool kTfStageAdd = true;",
                      "constexpr bool kTfStageAdd = false;")],
    # the forward's y stored by TMA from a swizzled bf16 tile, per
    # warpgroup, not by the threads in 16-byte stores (the box, 24 KB a
    # warpgroup, fits in the ring)
    "tf_tma_store": [(TF_TILE, TF_TMA_STORE)] + TF_Y_MAP,
}


def _mma_sync_fwd(plan, nb, m, k, n):
    """The forward's mma.sync form with the split that form's plan gives
    it."""
    ctas = plan.batch * kernel._cdiv(plan.rows, kernel.FWD_BM) * \
        kernel._cdiv(n, kernel.FWD_BN)
    splits, chunk = kernel._split(ctas, k, kernel.BF16_BK,
                                  kernel._sm_count(0))
    return dataclasses.replace(plan, form="mma_sync", splits=splits,
                               k_chunk=chunk)


def _mma_sync_dx(plan, nb, m, k, n):
    """dx's mma.sync form with the split that form's plan gives it."""
    ctas = plan.batch * kernel._cdiv(plan.rows, kernel.DX_BM) * \
        kernel._cdiv(k, kernel.DX_BN)
    splits, chunk = kernel._split(ctas, n, kernel.BF16_BK,
                                  kernel._sm_count(0))
    return dataclasses.replace(plan, form="mma_sync", splits=splits,
                               n_chunk=chunk)


def _half_card_dx(plan, nb, m, k, n):
    """dx's Hopper form split for half the card's SMs (fewer f32
    partials to write and sum)."""
    if plan.form != "tma":
        return plan
    ctas = plan.batch * kernel._cdiv(plan.rows, kernel.TX_BM) * \
        kernel._cdiv(k, kernel.TX_BK)
    splits, chunk = kernel._split(ctas, n, kernel.TX_BN,
                                  kernel._sm_count(0) // 2, per_sm=1)
    return dataclasses.replace(plan, splits=splits, n_chunk=chunk)


# plan variants of the base source: name -> (forward plan change, dx plan
# change, dw plan change)
BF16_PLANS = {
    # dx's CTAs in pairs along K where the K blocks pair up, each fetching
    # half of every dz and y stage and multicasting it to both
    "tx_multicast": (None, lambda plan, nb, m, k, n: dataclasses.replace(
        plan, cluster=2) if plan.form == "tma" and kernel._cdiv(
            k, kernel.TX_BK) % 2 == 0 else plan, None),
    "mma_sync_forms": (_mma_sync_fwd, _mma_sync_dx,
                       lambda plan: dataclasses.replace(plan,
                                                        form="mma_sync")),
    "tw_one_tile_per_cta": (None, None, lambda plan: dataclasses.replace(
        plan, ctas=plan.tiles) if plan.form == "tma" else plan),
    "tx_split_half_card": (None, _half_card_dx, None),
}
BF16_CASES = ("round fc1", "round fc2", "round fc3", "stats fc2 shared",
              "sigma fc2 M=1")
# dx launch-plan variants of the base source: name -> change to the plan
DX_PLANS = {
    # one CTA per output tile walks all of N, however few CTAs that makes
    "dx_no_split": lambda nb, m, k, n, plan: dataclasses.replace(
        plan, splits=1, n_chunk=max(n, 1)),
    # slots sharing w kept apart (each slot reads the shared w again), the
    # plan's split chosen for that grid
    "dx_no_fold": lambda nb, m, k, n, plan: kernel.dx_plan(
        nb, m, k, n, strides=(m * n, n, m * n, n), swb=k * n, swk=n,
        dz_align=16, w_align=16, sms=kernel._sm_count(0)),
}
CASES = ("round fc1", "round fc2", "round fc3", "sigma fc2 M=1")
DX_SOURCE_VARIANTS = ("base", "cvt_rounding", "no_flush",
                      "dx_16_deep_4_stages", "dx_3_stages",
                      "dx_full_short_copy", "dx_no_tail")


def build_variants(variants: dict) -> dict:
    """Compile every variant in parallel; print registers and spills."""
    out_dir = build.BUILD_DIR / "variants"
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
        # -I: the source's headers (csrc/*.cuh), which it includes by
        # relative path
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(kernel.SOURCE.parent), "-o", str(out_dir / f"{name}.so"),
               str(src)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            found = re.search(
                r"\d((?:fwd|dwdb|dx)(?:_bf16|_tma)?_kernel\w*?)"
                r"(?:vNS_|ENS_|Ev14CU|E14CU)", line)
            if "Compiling entry" in line and found:
                fn = found.group(1)
                info = " ".join(lines[i + 1:i + 5])
                regs = re.search(r"Used (\d+) registers", info).group(1)
                spill = re.search(r"(\d+) bytes spill stores", info).group(1)
                print(f"ptxas {name:18s} {fn:40s} registers={regs} "
                      f"spill_bytes={spill}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, types in kernel._ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fwd_call(lib, x, w, b, act):
    """The forward through ``lib`` with the wrapper's plan: (run, y)."""
    p = kernel.fused_linear_plan(x, w, b)
    nb, m, k = x.shape
    n = w.shape[2]
    y = torch.empty(nb, m, n, device="cuda")
    part = (torch.empty(p.splits * p.batch * p.rows * n, device="cuda")
            if p.splits > 1 else None)
    syb, sym = (0, n) if p.fold else (y.stride(0), y.stride(1))
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), p.batch, p.rows, k, n,
            p.sxb, p.sxm, w.stride(0), w.stride(1), b.stride(0), syb, sym,
            kernel.ACT_CODES[act], p.splits, p.k_chunk, p.vec_x, p.vec_w)

    def run():
        if lib.fused_linear_fwd(*args, _stream()):
            raise RuntimeError("fused_linear_fwd launch failed")
    return run, y


def dwdb_call(lib, x, dy, y, relu: bool):
    """dw/db through ``lib`` with the wrapper's plan: (run, (dw, db))."""
    nb, m, k = x.shape
    n = dy.shape[2]
    y = y if relu else dy
    p = kernel.fused_linear_bwd_dw_db_plan(x, dy, y)
    dw = torch.empty(nb, k, n, device="cuda")
    db = torch.empty(nb, n, device="cuda")
    args = (x.data_ptr(), dy.data_ptr(), y.data_ptr(), dw.data_ptr(),
            db.data_ptr(), nb, m, k, n, *kernel._dw_strides(x, dy, y),
            dw.stride(0), dw.stride(1), db.stride(0), int(relu), p.vec_x,
            p.vec_dz)

    def run():
        if lib.fused_linear_bwd_dw_db(*args, _stream()):
            raise RuntimeError("fused_linear_bwd_dw_db launch failed")
    return run, (dw, db)


def dx_call(lib, dy, w, y, relu: bool, change=None):
    """dx through ``lib`` with the wrapper's plan, or that plan changed by
    ``change`` (a DX_PLANS entry): (run, dx)."""
    nb, m, n = dy.shape
    k = w.shape[1]
    y = y if relu else dy
    p = kernel.fused_linear_bwd_dx_plan(dy, w, y)
    if change is not None:
        p = change(nb, m, k, n, p)
    dx = torch.empty(nb, m, k, device="cuda")
    part = (torch.empty(p.splits * p.batch * p.rows * k, device="cuda")
            if p.splits > 1 else None)
    sxb, sxm = (0, k) if p.fold else (dx.stride(0), dx.stride(1))
    args = (dy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
            None if part is None else part.data_ptr(), p.batch, p.rows, k, n,
            p.sdb, p.sdm, p.syb, p.sym, w.stride(0), w.stride(1), sxb, sxm,
            int(relu), p.splits, p.n_chunk, p.vec_dz, p.vec_w)

    def run():
        if lib.fused_linear_bwd_dx(*args, _stream()):
            raise RuntimeError("fused_linear_bwd_dx launch failed")
    return run, dx


def _dx_line(label, name, lib, dy, w, want_y, want_dx, relu, change=None):
    run, dx = dx_call(lib, dy, w, want_y, relu, change)
    run()
    err = _rel_err((dx,), (want_dx,))
    ms = chip_smoke.device_ms(run)
    nomask = ""
    if relu:
        run, _ = dx_call(lib, dy, w, want_y, False, change)
        nomask = f" dx_nomask_ms={chip_smoke.device_ms(run):.4f}"
    print(f"variant {label:14s} {name:18s} dx_ms={ms:.4f}{nomask} "
          f"err/scale dx={err:.1e}{'' if err <= 1e-5 else ' OVER 1e-5'}",
          flush=True)


def _rel_err(got, want) -> float:
    return max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
               for a, r in zip(got, want))


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--bf16" in sys.argv[1:]:
        return bf16_main()
    libs = build_variants(VARIANTS)
    order = list(libs) + ["base"]
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, nb, m, k, n, act, shared in chip_smoke.CASES:
        if label not in CASES:
            continue
        x = torch.randn(nb, m, k, device="cuda", generator=g)
        if shared:
            w = (torch.randn(k, n, device="cuda", generator=g)
                 * (2.0 / k) ** 0.5).expand(nb, k, n)
            b = torch.randn(n, device="cuda", generator=g).expand(nb, n)
        else:
            w = torch.randn(nb, k, n, device="cuda", generator=g) \
                * (2.0 / k) ** 0.5
            b = torch.randn(nb, n, device="cuda", generator=g)
        dy = torch.randn(nb, m, n, device="cuda", generator=g)
        want_y = ref.fused_linear_ref(x, w, b, act)
        relu = act == "relu"
        want_dw = ref.fused_linear_bwd_dw_db_ref(
            x, dy, want_y if relu else None, act)
        want_dx = ref.fused_linear_bwd_dx_ref(dy, w, want_y if relu else None,
                                              act)
        for name in order:
            lib = libs[name]
            run, y = fwd_call(lib, x, w, b, act)
            run()
            fwd_err = _rel_err((y,), (want_y,))
            fwd_ms = chip_smoke.device_ms(run)
            run, out = dwdb_call(lib, x, dy, want_y, relu)
            run()
            dw_err = _rel_err(out, want_dw)
            dw_ms = chip_smoke.device_ms(run)
            nomask = ""
            if relu:
                run, _ = dwdb_call(lib, x, dy, want_y, False)
                nomask = f" dwdb_nomask_ms={chip_smoke.device_ms(run):.4f}"
            ok = name == "dw_no_store" or max(fwd_err, dw_err) <= 1e-5
            print(f"variant {label:14s} {name:18s} fwd_ms={fwd_ms:.4f} "
                  f"dwdb_ms={dw_ms:.4f}{nomask} err/scale fwd={fwd_err:.1e} "
                  f"dwdb={dw_err:.1e}{'' if ok else ' OVER 1e-5'}",
                  flush=True)
            if name in DX_SOURCE_VARIANTS:
                _dx_line(label, name, lib, dy, w, want_y, want_dx, relu)
        for name, change in DX_PLANS.items():
            _dx_line(label, name, libs["base"], dy, w, want_y, want_dx, relu,
                     change)
        if relu:
            # the mask as its own elementwise pass (PyTorch's), dz written
            # to device memory, then dx without the mask
            dz = torch.empty_like(dy)
            run, _ = dx_call(libs["base"], dz, w, None, False)

            def dz_pass():
                torch.mul(dy, want_y > 0, out=dz)
                run()
            print(f"variant {label:14s} {'dx_dz_pass':18s} "
                  f"dx_ms={chip_smoke.device_ms(dz_pass):.4f}", flush=True)
        lib_fwd = chip_smoke.device_ms(
            lambda: torch.baddbmm(b.unsqueeze(1), x, w))
        lib_dw = chip_smoke.device_ms(lambda: torch.bmm(x.transpose(1, 2),
                                                        dy))
        lib_dx = chip_smoke.device_ms(lambda: torch.bmm(dy, w.transpose(1, 2)))
        print(f"variant {label:14s} {'library':18s} fwd_ms={lib_fwd:.4f} "
              f"dwdb_ms={lib_dw:.4f} dx_ms={lib_dx:.4f} (baddbmm; bmm: no "
              f"mask, no db)", flush=True)
    return 0


def bf16_main() -> int:
    """The bf16 forms' variants at BF16_CASES, through the wrappers: the
    source variants, then the base source under each plan variant."""
    libs = build_variants(BF16_VARIANTS)
    runs = [(name, name, None) for name in libs]
    runs += [(name, "bf16_base", change) for name, change in BF16_PLANS.items()]
    runs += [("bf16_base_again", "bf16_base", None)]   # the run's spread
    plans = (kernel.fused_linear_plan, kernel.fused_linear_bwd_dx_plan,
             kernel.fused_linear_bwd_dw_db_plan)
    g = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(64 * 2 ** 20, device="cuda", dtype=torch.float32)
    rounds: dict = {}
    for label, nb, m, k, n, act, shared in chip_smoke.BF16_CASES:
        if label not in BF16_CASES:
            continue
        x, w, b, dy = chip_smoke.case_operands(g, torch.bfloat16, nb, m, k,
                                               n, shared)
        fns = chip_smoke._bf16_case_fns(x, w, b, dy, act)
        lib_line = []
        for fn_name, (_, _, lib) in fns.items():
            ms = chip_smoke.device_ms(lib)
            _add(rounds, label, "bf16_cublas", fn_name, ms)
            lib_line.append(f"{fn_name}={ms:.4f}")
        # dw/db's write floor: one fill of a tensor of dw's size
        dw = torch.empty(nb, k, n, device="cuda", dtype=torch.bfloat16)
        lib_line.append(f"dw_fill={chip_smoke.device_ms(dw.zero_):.4f}")
        print(f"variant {label:16s} {'bf16_cublas':20s} " + " ".join(lib_line),
              flush=True)
        for name, lib_name, change in runs:
            kernel.library = lambda lib=libs[lib_name]: lib
            fwd_change, dx_change, dw_change = change or (None,) * 3
            kernel.fused_linear_plan = (
                plans[0] if fwd_change is None else
                lambda *a, f=fwd_change: f(plans[0](*a), nb, m, k, n))
            kernel.fused_linear_bwd_dx_plan = (
                plans[1] if dx_change is None else
                lambda *a, f=dx_change: f(plans[1](*a), nb, m, k, n))
            kernel.fused_linear_bwd_dw_db_plan = (
                plans[2] if dw_change is None else
                lambda *a, f=dw_change: f(plans[2](*a)))
            line = []
            for fn_name, (fn, plain, _) in fns.items():
                excess = chip_smoke._bf16_excess(fn(), plain())
                ms = chip_smoke.device_ms(fn)
                _add(rounds, label, name, fn_name, ms)
                over = " OVER" if excess > chip_smoke.BF16_RTOL else ""
                line.append(f"{fn_name}={ms:.4f} (excess {excess:.1e}{over})")
            print(f"variant {label:16s} {name:20s} " + " ".join(line),
                  flush=True)
        (kernel.fused_linear_plan, kernel.fused_linear_bwd_dx_plan,
         kernel.fused_linear_bwd_dw_db_plan) = plans
        # the base source and bf16 cuBLAS with the L2 flushed before each
        # call: the operands come from HBM, as on the path, where other
        # layers' work runs between launches
        kernel.library = lambda lib=libs["bf16_base"]: lib
        line = []
        for fn_name, (fn, _, lib) in fns.items():
            for who, f in (("base", fn), ("cublas", lib)):
                ms = cold_l2_ms(f, flush)
                if ms is not None:
                    _add(rounds, label, f"cold_l2_{who}", fn_name, ms)
                line.append(f"{fn_name}_{who}="
                            + ("not measured" if ms is None else f"{ms:.4f}"))
        print(f"variant {label:16s} {'cold_l2':20s} " + " ".join(line),
              flush=True)
    for (name, fn_name), ms in rounds.items():
        print(f"variant round fc1-fc3 {name:20s} {fn_name}={ms:.4f}",
              flush=True)
    return 0


def cold_l2_ms(fn, flush: torch.Tensor, reps: int = 10) -> float | None:
    """Device ms per call of ``fn`` with the L2 flushed before each call
    (``flush.zero_()``: 256 MB, five times the H100's 50 MB L2), from
    torch.profiler's kernel times without the flush's fill kernels: the
    median of three profiles that caught every launch (ten at most; None
    where none did)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(10):
        with chip_smoke.profile(activities=[
                chip_smoke.ProfilerActivity.CPU,
                chip_smoke.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == chip_smoke.DeviceType.CUDA]
        fills = sum(e.count for e in kernels if "FillFunctor" in e.key)
        rest = [e for e in kernels if "FillFunctor" not in e.key]
        count = sum(e.count for e in rest)
        if fills == reps and count and count % reps == 0:
            runs.append(sum(e.self_device_time_total for e in rest))
        if len(runs) == 3:
            break
    return sorted(runs)[len(runs) // 2] / 1e3 / reps if runs else None


def _add(rounds: dict, label: str, name: str, fn_name: str, ms: float):
    """Sum the round's fc1-fc3 per variant and kernel."""
    if label.startswith("round"):
        rounds[name, fn_name] = rounds.get((name, fn_name), 0.0) + ms


if __name__ == "__main__":
    sys.exit(main())
