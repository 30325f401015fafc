// Fused linear layer, forward and backward, CUDA for Hopper (sm_90a), in
// f32 (3xTF32 tensor-core products) and in bf16 (the *_bf16 entries).
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/fused_linear/kernel.py:
//   fused_linear            (kernel.py:81)  y  = act(x @ w + b),
//                           act in {none, relu, silu, gelu (tanh form)}
//   fused_linear_bwd_dx     (kernel.py:123) dx = (dy * 1[y > 0]) @ w^T
//   fused_linear_bwd_dw_db  (kernel.py:179) dw = x^T @ dz, db = sum_m dz
//
// What bounds them on an H100: at the split-FL round's shapes (VGG-11 fc
// layers, M = 95 rows per slot, K and N up to 4096) a kernel does 2*M*K*N
// operations on about 4*K*N weight (or dw) bytes, ~M/2 = 47 FLOP per byte.
// On the f32 FMA units (67 TFLOP/s) that is far above the ridge; with the
// tensor cores in 3xTF32 (three TF32 products per f32 product, 495/3 = 165
// TFLOP/s) the ridge is 165 / 3.35 = 49 FLOP per byte, so at fc2 the
// forward and dw/db sit on it and HBM bytes bound them about as much as
// operations do (fc2 forward: 0.126 ms of bytes against 0.116 ms of
// operations). So the kernels must both use the tensor cores and stream
// the weights (or dw) at close to HBM rate.
//
// Why 3xTF32 keeps the f32 contract. Each operand a splits into big =
// rna_tf32(a) and small = rna_tf32(a - big); the product is small*big +
// big*small + big*big with f32 accumulation, dropping only small*small
// (~2^-22 relative). Emulated on the CPU in k-steps of 8 at M = 95,
// K = 4096, N = 256 with He-scaled weights, the largest error against the
// f64 product is 1.7e-6 x the output scale, against 6.4e-7 for plain f32
// FMA and 2.9e-4 for one TF32 product; the kernels are held to 1e-5 x scale
// (tests/test_torch_fused_linear.py repeats that emulation). The tensor
// cores truncate the f32 sum they accumulate, though: chained over all of
// K = 4096 that drifted to 2.7e-5 x scale on the card, so each stage's
// products go to a zeroed accumulator that is added to the running sum
// with a round-to-nearest f32 add (flush), which holds 2.2e-6.
//
// What the design does (forward fwd_kernel, dx dx_kernel, dw/db
// dwdb_kernel):
// - Tensor cores: mma.sync.m16n8k8 tf32 with the 3xTF32 split done on the
//   fragments as they leave shared memory, on the integer units (rna_tf32).
//   wgmma would need K-major tiles for both operands, and neither w (K, N)
//   nor x^T and dz are (dx's are: dz (M, N) and w (K, N) both have the
//   reduction N contiguous).
// - A cp.async pipeline: 4 stages of the x/w tiles (3 of the x/dz tiles,
//   2 of dx's dz/w tiles) in flight in dynamic shared memory while the
//   MMAs run on the stage that has landed.
//   Copies are 16 bytes where an operand's row strides and pointer allow it,
//   else 4 bytes (fc3's 10-wide rows): the wrapper picks each operand's
//   width, a template choice of the same kernel. Tiles are padded so that
//   fragment loads are free of bank conflicts (pitches of 4 and 8 mod 32
//   words).
// - Forward tiles of 96 x 64: one CTA covers all 95 rows of a slot, so
//   each weight byte is read from HBM once. M tiles are fastest in the
//   launch, so CTAs sharing a weight strip run together. Where w and b are
//   shared (stride 0) and x's slots are row-contiguous, the wrapper folds
//   slots into rows, so the statistics pass reads the 64 MB weight once.
// - Split-K where the grid cannot fill the card (fc3's N = 10, M = 1):
//   partials go to a scratch buffer and splitk_reduce_kernel sums them in a
//   fixed order, then adds bias and activation: deterministic.
// - dx: the forward's shape with both operands staged reduction-major
//   (dz as sA[row][n], w as sB[k][n]: B fragment pairs are float2 loads
//   too) in two 32-deep stages, so that dz's y tile fits beside them with
//   two CTAs per SM (four 16-deep stages and three 32-deep ones, one CTA
//   per SM, measured slower: tools/fused_linear_variants.py); the relu mask
//   is applied on dz's fragment loads. The same 96-row tiles (w read once
//   per slot), slot fold under shared w (the statistics pass and the
//   per-sample pass read the 64 MB w once), and a split of the reduction N
//   where the grid is small (the round's fc1 has 48 CTAs unsplit, the
//   evaluation's M = 232 has 24), summed by the same fixed-order second
//   launch without the epilogue. A reduction of at most 16 (fc3's N = 10)
//   copies and multiplies only the k-steps it has.
// - dw/db: 128 x 64 dw tiles, the M reduction in stages of 32 rows (M = 95
//   is three); the relu mask dz = dy * 1[y > 0] is applied on the fragment
//   loads from the staged dy and y, so dz never reaches device memory. Two
//   CTAs share an SM, so one CTA's dw stores overlap the other's loads and
//   MMAs (a persistent loop over tiles was tried and measured slower: its
//   per-stage tile arithmetic cost more than the overlap it added). Stores
//   are float2 per fragment pair (full 32-byte sectors). The CTAs of the
//   first K tile also sum the staged dz columns into db in a fixed order:
//   no atomics.
//
// The bf16 forms (fwd_bf16_kernel, dx_bf16_kernel, dwdb_bf16_kernel), the
// reference's bf16 data plane (Scenario(dtype="bf16")): the Pallas kernels
// take bf16 operands, accumulate in f32 and write the operand dtype. Here
// one mma.sync.m16n8k16 bf16 x bf16 -> f32 per 16-deep step (the products
// are exact in f32: no split), the same per-stage f32 add as the f32
// forms, bias and activation in f32, and one rounding to bf16 (to nearest
// even) at the store; split-K partials stay f32. What bounds them: the
// same ~M/2 = 47 FLOP per weight byte is now ~95 FLOP per byte (2-byte
// elements) against a bf16 ridge of 989 / 3.35 = 295, so at the round's
// shapes they are bound by HBM bytes alone, half those of f32. Their
// design is the f32 CTA tiles (96 x 64 forward and dx, 128 x 64 dw) with
// three CTAs per SM, not two (one wave of the round's fc2 grid), so 3, 2
// and 3 cp.async stages (64, 64 and 32 deep); fragments loaded with
// ldmatrix: x4 per 16 x 16 of A or two 8-column blocks of B, transposed in
// the load (.trans) where k runs down the staged rows (the forward's w,
// dw's x^T and dz), which the f32 forms' 32-bit elements could not use;
// results leave through shared memory in 16-byte stores. Pitches of 16
// bytes mod 128 keep every ldmatrix free of bank conflicts.
// The copy width (16, 4 or, for an odd row width of bf16 that cp.async
// cannot move, 2 bytes by plain loads) is an argument, not a template
// choice: one kernel per form (and relu mask) keeps the build short.
//
// All three bf16 forms have Hopper forms besides (fwd_tma_kernel,
// dx_tma_kernel, dwdb_tma_kernel, built on hopper.cuh: TMA rings, wgmma,
// dw stored by TMA from persistent CTAs), which take every operand TMA can
// describe; the mma.sync forms above keep the rest. Their design is set
// out where they are defined.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores, cp.async pipeline
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy VEC bytes (16 or 4) from global to shared memory, reading only
// `bytes` of them and zero-filling the rest.
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major operand
// (row stride ld, unit column stride) into shared memory with row pitch P;
// rows at or past rlim and columns at or past clim read as zero. T is the
// element (float, or uint16_t for bf16 bits); VEC the copy width in bytes.
template <int R, int C, int P, int VEC, int THREADS, typename T = float>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ld,
                                          int r0, int c0, int rlim,
                                          int clim) {
  constexpr int kPer = VEC / static_cast<int>(sizeof(T));
  constexpr int kRowChunks = C / kPer;
  static_assert((R * kRowChunks) % THREADS == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < R * kRowChunks / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kRowChunks, c = (e % kRowChunks) * kPer;
    const int gr = r0 + r, gc = c0 + c;
    int bytes = 0;
    const T* src = g;
    if (gr < rlim && gc < clim) {
      bytes = min(VEC, (clim - gc) * static_cast<int>(sizeof(T)));
      src = g + gr * ld + gc;
    }
    cp_async<VEC>(s + r * P + c, src, bytes);
  }
}

// cvt.rna.tf32.f32 on the integer units: round the magnitude to 10
// mantissa bits, ties away from zero (the same result for finite values;
// the conversion unit itself runs at a quarter of the integer rate, and
// three warps' worth of splits per MMA would make it the bottleneck).
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = big + small, each a TF32 value rounded to nearest (ties away).
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(a);
  small = rna_tf32(a - __uint_as_float(big));
}

// c (16 x 8, f32) += a (16 x 8, tf32) * b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's MT*16 x NT*8 output tile at (row0, col0) of the CTA tile
// accumulates A * B over one staged slab of depth DEPTH, in 3xTF32.
// A is staged as sA[row][k] (pitch PA = 8 mod 32 words), or as sA[k][row]
// when A_KMAJOR (dw's x^T; pitch 4 mod 32). B is staged as sB[k][col]
// (pitch PB = 4 mod 32); MASK zeroes B where the staged forward output sY
// (same layout) is not positive (the relu mask). With B_KMAJOR, B is staged
// as sB[col][k] (dx's w; pitch 8 mod 32) and its fragment pairs are float2
// loads like A's; MASK_A applies the relu mask to A instead (dx's dz, with
// sY in sA's layout). Fragment layouts are
// mma.m16n8k8's: lane = 4 g + t; A (row g [+8], k-slot t [+4]), B (k-slot
// t [+4], col g), C (g [+8], 2t [+1]). K-slots t and t + 4 read physical
// k = 2t and 2t + 1 of the k-step, in A and B alike (any order of the
// reduction is the same sum), so an sA[row][k] pair is one float2 load;
// with those pitches no fragment load has a bank conflict.
// With TAIL only the k-steps below `depth` run (the rest of a reduction's
// last slab is zero fill); the check stays out of every other slab, where
// it would keep the compiler from scheduling across k-steps.
template <int MT, int NT, int DEPTH, int PA, int PB, bool A_KMAJOR, bool MASK,
          bool TAIL = false, bool B_KMAJOR = false, bool MASK_A = false>
__device__ __forceinline__ void warp_mma(const float* sA, const float* sB,
                                         const float* sY, int row0, int col0,
                                         int depth, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 8) {
    if constexpr (TAIL)
      if (kk >= depth) break;
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (B_KMAJOR) {
        const float2 v = *reinterpret_cast<const float2*>(
            sB + (col0 + j * 8 + g) * PB + kk + 2 * t);
        split_tf32(v.x, bb[j][0], bs[j][0]);
        split_tf32(v.y, bb[j][1], bs[j][1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (kk + 2 * t + h) * PB + col0 + j * 8 + g;
          float v = sB[off];
          if constexpr (MASK) v = sY[off] > 0.f ? v : 0.f;
          split_tf32(v, bb[j][h], bs[j][h]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = row0 + i * 16 + g;
      float av[4];
      if constexpr (A_KMAJOR) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          av[q] = sA[(kk + 2 * t + (q >> 1)) * PA + r + 8 * (q & 1)];
      } else {
        const float2 lo = *reinterpret_cast<const float2*>(
            sA + r * PA + kk + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(
            sA + (r + 8) * PA + kk + 2 * t);
        av[0] = lo.x, av[1] = hi.x, av[2] = lo.y, av[3] = hi.y;
        if constexpr (MASK_A) {
          const float2 ylo = *reinterpret_cast<const float2*>(
              sY + r * PA + kk + 2 * t);
          const float2 yhi = *reinterpret_cast<const float2*>(
              sY + (r + 8) * PA + kk + 2 * t);
          av[0] = ylo.x > 0.f ? av[0] : 0.f;
          av[1] = yhi.x > 0.f ? av[1] : 0.f;
          av[2] = ylo.y > 0.f ? av[2] : 0.f;
          av[3] = yhi.y > 0.f ? av[3] : 0.f;
        }
      }
      uint32_t ab[4], as[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(av[q], ab[q], as[q]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], as, bb[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab, bb[j]);
    }
  }
}

// acc += step in f32, then step = 0, after every stage. The tensor cores
// truncate the sum they accumulate, which over K / 8 chained k-steps drifts
// (2.7e-5 x scale at K = 4096 when all of K chains into acc); a chain of one
// stage's k-steps, added to acc with one round-to-nearest add, does not.
template <int MT, int NT>
__device__ __forceinline__ void flush(float (&acc)[MT][NT][4],
                                      float (&step)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] += step[i][j][q];
        step[i][j][q] = 0.f;
      }
}

// Store a fragment pair (v0 at column n, v1 at n + 1) of row pointer p,
// as one float2 when `pair` (both in range, 8-byte aligned).
__device__ __forceinline__ void store_pair(float* p, int n, int N, float v0,
                                           float v1, bool pair) {
  if (pair && n + 1 < N) {
    *reinterpret_cast<float2*>(p + n) = make_float2(v0, v1);
  } else {
    if (n < N) p[n] = v0;
    if (n + 1 < N) p[n + 1] = v1;
  }
}

// 0 none, 1 relu, 2 silu, 3 gelu (tanh form, as jax.nn.gelu's default)
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case 1:
      return fmaxf(z, 0.f);
    case 2:
      return z / (1.f + expf(-z));
    case 3: {
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.f + tanhf(u));
    }
    default:
      return z;
  }
}

// float for the f32 kernels, uint16_t (bf16 bits) for the bf16 forms;
// partial sums are f32 in both
template <typename T>
struct FwdArgsT {
  const T* x;
  const T* w;
  const T* bias;
  T* y;
  float* part;   // (splits, batch, M, N) partial sums when splits > 1
  int batch, M, K, N, act, splits, kchunk;
  long long sxb, sxm, swb, swk, sbb, syb, sym;
};
using FwdArgs = FwdArgsT<float>;

// bf16 (held as its bits) to and from f32; the identity on f32. The
// rounding is to nearest even, as PyTorch's and JAX's casts round.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;   // NaN
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// two floats rounded to bf16 (to nearest even, as from_f32) in one
// instruction: lo in the low half, hi in the high half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

constexpr int kFwdBM = 96;   // all 95 rows of a slot in one CTA
constexpr int kFwdBN = 64;   // output columns per CTA
constexpr int kFwdBK = 32;   // reduction depth per pipeline stage
constexpr int kFwdStages = 4;
constexpr int kFwdThreads = 2 * kFwdBN;
constexpr int kFwdSmemFloats =
    kFwdStages * (kFwdBM * (kFwdBK + 8) + kFwdBK * (kFwdBN + 4));

// One CTA: rows [m0, m0 + 96) x columns [n0, n0 + 64) of one slot, over the
// reduction range of its split. Warps 2 (rows, 48 each) x 2 (columns, 32
// each); two CTAs share an SM.
template <int VX, int VW>
__global__ void __launch_bounds__(kFwdThreads, 2)
fwd_kernel(const FwdArgs a) {
  constexpr int BM = kFwdBM, BN = kFwdBN, BK = kFwdBK;
  constexpr int STAGES = kFwdStages, THREADS = kFwdThreads;
  constexpr int PA = BK + 8, PB = BN + 4;
  constexpr int A_SZ = BM * PA, STAGE = A_SZ + BK * PB;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int kbeg = split * a.kchunk, kend = min(a.K, kbeg + a.kchunk);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const float* x = a.x + slot * a.sxb;
  const float* w = a.w + slot * a.swb;
  auto load = [&](int kt) {
    float* s = smem + (kt % STAGES) * STAGE;
    const int k0 = kbeg + kt * BK;
    load_tile<BM, BK, PA, VX, THREADS>(s, x, a.sxm, m0, k0, a.M, kend);
    load_tile<BK, BN, PB, VW, THREADS>(s + A_SZ, w, a.swk, k0, n0, kend,
                                        a.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 48, wn = (warp >> 1) * 32;
  float acc[3][4][4] = {}, step[3][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const float* s = smem + (kt % STAGES) * STAGE;
    warp_mma<3, 4, BK, PA, PB, false, false>(s, s + A_SZ, nullptr, wm, wn,
                                             BK, step);
    flush(acc, step);
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool direct = a.splits == 1;
  float* out = direct ? a.y + slot * a.syb
                      : a.part + (static_cast<long long>(split) * a.batch +
                                  slot) * a.M * a.N;
  const long long ld = direct ? a.sym : a.N;
  const bool pair =
      (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const float* bias = a.bias + slot * a.sbb;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (direct) {
          if (n < a.N) v0 = activate(v0 + bias[n], a.act);
          if (n + 1 < a.N) v1 = activate(v1 + bias[n + 1], a.act);
        }
        store_pair(out + m * ld, n, a.N, v0, v1, pair);
      }
    }
}

// y = act(sum over splits, in order, of the partials + bias); without
// EPILOGUE (dx) the sum alone. The sum, bias and activation are f32; y is
// rounded to T (bf16 for the bf16 forms) at the store.
template <bool EPILOGUE, typename T>
__global__ void splitk_reduce_kernel(const FwdArgsT<T> a) {
  const long long total = static_cast<long long>(a.batch) * a.M * a.N;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(e % a.N);
    const long long bm = e / a.N;
    const int m = static_cast<int>(bm % a.M), b = static_cast<int>(bm / a.M);
    float v = 0.f;
    for (int s = 0; s < a.splits; ++s) v += a.part[s * total + e];
    a.y[b * a.syb + m * a.sym + n] = from_f32<T>(
        EPILOGUE ? activate(v + to_f32(a.bias[b * a.sbb + n]), a.act) : v);
  }
}

template <typename T>
struct DwArgsT {
  const T* x;
  const T* dy;
  const T* y;
  T* dw;
  T* db;
  int M, K, N;
  long long sxb, sxm, sdb, sdm, syb, sym, swb, swk, sbb;
};
using DwArgs = DwArgsT<float>;

constexpr int kDwBK = 128;   // dw rows (the K axis) per CTA
constexpr int kDwBN = 64;    // dw columns per CTA
constexpr int kDwBR = 32;    // reduction (M) rows per pipeline stage
constexpr int kDwStages = 3;
constexpr int kDwThreads = 2 * kDwBN;
constexpr int kDwMinBlocks = 2;

template <bool RELU>
constexpr int dw_smem_floats() {
  return kDwStages * kDwBR * ((kDwBK + 4) + (kDwBN + 4) * (RELU ? 2 : 1));
}

// One CTA: dw rows [k0, k0 + 128) x columns [n0, n0 + 64) of one slot, over
// all M. Warps 2 (rows, 64 each) x 2 (columns, 32 each).
template <int VX, int VD, bool RELU>
__global__ void __launch_bounds__(kDwThreads, kDwMinBlocks)
dwdb_kernel(const DwArgs a) {
  constexpr int PX = kDwBK + 4, PD = kDwBN + 4, BR = kDwBR;
  constexpr int X_SZ = BR * PX, D_SZ = BR * PD;
  constexpr int STAGE = X_SZ + D_SZ * (RELU ? 2 : 1);
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * kDwBN, k0 = blockIdx.y * kDwBK;
  const int slot = blockIdx.z;
  const float* x = a.x + slot * a.sxb;
  const float* dy = a.dy + slot * a.sdb;
  const float* yv = a.y + slot * a.syb;
  const int nr = (a.M + BR - 1) / BR;
  auto load = [&](int rt) {
    float* s = smem + (rt % kDwStages) * STAGE;
    const int r0 = rt * BR;
    load_tile<BR, kDwBK, PX, VX, kDwThreads>(s, x, a.sxm, r0, k0, a.M, a.K);
    load_tile<BR, kDwBN, PD, VD, kDwThreads>(s + X_SZ, dy, a.sdm, r0, n0,
                                             a.M, a.N);
    if constexpr (RELU)
      load_tile<BR, kDwBN, PD, VD, kDwThreads>(s + X_SZ + D_SZ, yv, a.sym,
                                               r0, n0, a.M, a.N);
  };
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < nr) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const bool with_db = blockIdx.y == 0 && threadIdx.x < kDwBN;
  float acc[4][4][4] = {}, step[4][4][4] = {};
  float dbacc = 0.f;
  // stage rt of the pipeline. With tail, only the k-steps below M run: the
  // whole reduction is one short stage (M < 32: the per-sample pass's
  // M = 1). Any other M runs every stage in full, zero fill included: a
  // second copy of warp_mma after the loop, for M's last partial stage,
  // measured slower at fc2 (tools/fused_linear_variants.py, two_copies).
  auto stage = [&](int rt, auto tail) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (rt + kDwStages - 1 < nr) load(rt + kDwStages - 1);
    cp_async_commit();
    const float* s = smem + (rt % kDwStages) * STAGE;
    const float* sd = s + X_SZ;
    const float* sy = RELU ? sd + D_SZ : nullptr;
    warp_mma<4, 4, BR, PX, PD, true, RELU, decltype(tail)::value>(
        s, sd, sy, wm, wn, a.M - rt * BR, step);
    flush(acc, step);
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < BR; ++r) {
        const float v = sd[r * PD + threadIdx.x];
        dbacc += (!RELU || sy[r * PD + threadIdx.x] > 0.f) ? v : 0.f;
      }
    }
  };
  if (a.M < BR) {
    if (nr) stage(0, std::true_type{});
  } else {
    for (int rt = 0; rt < nr; ++rt) stage(rt, std::false_type{});
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* dw = a.dw + slot * a.swb;
  const bool pair =
      (a.swk & 1) == 0 && (reinterpret_cast<uintptr_t>(dw) & 7) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wm + i * 16 + g + 8 * h;
      if (k >= a.K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_pair(dw + k * a.swk, n0 + wn + j * 8 + 2 * t, a.N,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1], pair);
    }
  if (with_db && n0 + threadIdx.x < a.N)
    a.db[slot * a.sbb + n0 + threadIdx.x] = dbacc;
}

template <typename T>
struct DxArgsT {
  const T* dy;
  const T* y;
  const T* w;
  T* dx;
  float* part;   // (splits, batch, M, K) partial sums when splits > 1
  int batch, M, K, N, splits, nchunk;
  long long sdb, sdm, syb, sym, swb, swk, sxb, sxm;
};
using DxArgs = DxArgsT<float>;

constexpr int kDxBM = 96;    // all 95 rows of a slot in one CTA
constexpr int kDxBN = 64;    // dx columns (the K axis) per CTA
constexpr int kDxBK = 32;    // reduction (N) depth per pipeline stage
constexpr int kDxStages = 2;
constexpr int kDxThreads = 2 * kDxBN;
constexpr int kDxPitch = kDxBK + 8;   // 8 mod 32: float2 fragment loads

template <bool RELU>
constexpr int dx_smem_floats() {
  return kDxStages * kDxPitch * (kDxBM * (RELU ? 2 : 1) + kDxBN);
}

// One CTA: dx rows [m0, m0 + 96) x columns [k0, k0 + 64) of one slot, over
// the N range of its split. dz = dy (* 1[y > 0]) is staged as sA[row][n]
// (with y beside it when RELU) and w as sB[k][n]: both operands have the
// reduction contiguous, the layout mma.sync's row.col product takes, so
// every fragment pair is one float2 load and the mask is applied as dz's
// fragments leave shared memory. Warps 2 (rows, 48 each) x 2 (columns, 32
// each); a warp whose rows all lie past M (the per-sample pass's few rows,
// an evaluation's last tile) loads but skips its MMAs. Two CTAs share an SM.
template <int VD, int VW, bool RELU>
__global__ void __launch_bounds__(kDxThreads, 2)
dx_kernel(const DxArgs a) {
  constexpr int BM = kDxBM, BN = kDxBN, BK = kDxBK, P = kDxPitch;
  constexpr int STAGES = kDxStages, THREADS = kDxThreads;
  constexpr int A_SZ = BM * P, B_OFF = A_SZ * (RELU ? 2 : 1);
  constexpr int STAGE = B_OFF + BN * P;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int nbeg = split * a.nchunk, nend = min(a.N, nbeg + a.nchunk);
  const int nn = (nend - nbeg + BK - 1) / BK;
  const float* dy = a.dy + slot * a.sdb;
  const float* yv = a.y + slot * a.syb;
  const float* w = a.w + slot * a.swb;
  // Copy C columns of each operand. A reduction of at most 16 (fc3's
  // N = 10) runs only its k-steps (below) and copies 16 columns, not BK.
  auto copy = [&](float* s, int n0, auto cols) {
    constexpr int C = decltype(cols)::value;
    load_tile<BM, C, P, VD, THREADS>(s, dy, a.sdm, m0, n0, a.M, nend);
    if constexpr (RELU)
      load_tile<BM, C, P, VD, THREADS>(s + A_SZ, yv, a.sym, m0, n0, a.M,
                                       nend);
    load_tile<BN, C, P, VW, THREADS>(s + B_OFF, w, a.swk, k0, n0, a.K, nend);
  };
  const bool short_n = nend - nbeg <= 16;
  auto load = [&](int st) {
    float* s = smem + (st % STAGES) * STAGE;
    const int n0 = nbeg + st * BK;
    if (short_n)
      copy(s, n0, std::integral_constant<int, 16>{});
    else
      copy(s, n0, std::integral_constant<int, BK>{});
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nn) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 48, wn = (warp >> 1) * 32;
  const bool live = m0 + wm < a.M;
  float acc[3][4][4] = {}, step[3][4][4] = {};
  // stage st of the pipeline. With tail, only the k-steps below the split's
  // depth run: the whole reduction is one short stage (fc3's N = 10).
  auto stage = [&](int st, auto tail) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage st landed; stage st - 1 is free to refill
    if (st + STAGES - 1 < nn) load(st + STAGES - 1);
    cp_async_commit();
    if (live) {
      const float* s = smem + (st % STAGES) * STAGE;
      warp_mma<3, 4, BK, P, P, false, false, decltype(tail)::value, true,
               RELU>(s, s + B_OFF, RELU ? s + A_SZ : nullptr, wm, wn,
                     nend - nbeg, step);
      flush(acc, step);
    }
  };
  if (nend - nbeg < BK) {
    if (nn) stage(0, std::true_type{});
  } else {
    for (int st = 0; st < nn; ++st) stage(st, std::false_type{});
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool direct = a.splits == 1;
  float* out = direct ? a.dx + slot * a.sxb
                      : a.part + (static_cast<long long>(split) * a.batch +
                                  slot) * a.M * a.K;
  const long long ld = direct ? a.sxm : a.K;
  const bool pair =
      (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_pair(out + m * ld, k0 + wn + j * 8 + 2 * t, a.K,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1], pair);
    }
}

// ---------------------------------------------------------------------------
// bf16 forms: mma.sync m16n8k16 bf16 x bf16 -> f32, ldmatrix fragments
// ---------------------------------------------------------------------------

// Load four 8 x 8 b16 matrices from shared memory (lane l gives row l % 8
// of matrix l / 8); with TRANS each is transposed in the load, so that a
// register holds two k-consecutive elements of an operand whose k runs
// down the rows of its tile (fwd's w, dw's x^T and dz).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16): the products
// of two bf16 are exact in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// dz = dy * 1[y > 0] on a register of two bf16, y's register in the same
// fragment layout (y > 0 in bf16: NaN and -0 are not)
__device__ __forceinline__ uint32_t relu_mask_bf16x2(uint32_t v, uint32_t y) {
  uint32_t keep = 0;
  if (__uint_as_float(y << 16) > 0.f) keep |= 0xffffu;
  if (__uint_as_float(y & 0xffff0000u) > 0.f) keep |= 0xffff0000u;
  return v & keep;
}

// One warp's MT*16 x NT*8 output tile at (row0, col0) of the CTA tile
// accumulates A * B over one staged slab of depth DEPTH (a multiple of 16)
// of bf16 operands. A is staged as sA[row][k] (pitch PA), or as sA[k][row]
// when A_TRANS (dw's x^T); B as sB[col][k] (pitch PB; dx's w), or as
// sB[k][col] when B_TRANS (fwd's w, dw's dz). Both pitches are 16 bytes
// mod 128, so the eight 16-byte rows an ldmatrix reads fall in distinct
// banks. MASK 1 applies the relu mask to A (dx's dz), 2 to B (dw's dz),
// from y staged in that operand's layout at sY. Fragment layouts are
// mma.m16n8k16's: lane = 4 g + t; A (row g [+8], k 2t, 2t + 1 [+8]),
// B (k 2t, 2t + 1 [+8], col g), C (g [+8], 2t [+1]). With TAIL only the
// k-steps below `depth` run (a reduction shorter than the slab).
template <int MT, int NT, int DEPTH, int PA, int PB, bool A_TRANS,
          bool B_TRANS, int MASK, bool TAIL = false>
__device__ __forceinline__ void warp_mma_bf16(const uint16_t* sA,
                                              const uint16_t* sB,
                                              const uint16_t* sY, int row0,
                                              int col0, int depth,
                                              float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "B fragments load in pairs of 8 columns");
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 16) {
    if constexpr (TAIL)
      if (kk >= depth) break;
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // matrices: (k 0-7, cols j), (k 8-15, cols j), then cols j + 1
      const int col = col0 + (j + (q >> 1)) * 8, k = kk + (q & 1) * 8;
      const int off = B_TRANS ? (k + r) * PB + col : (col + r) * PB + k;
      uint32_t v[4];
      ldmatrix_x4<B_TRANS>(v, sB + off);
      if constexpr (MASK == 2) {
        uint32_t yv[4];
        ldmatrix_x4<B_TRANS>(yv, sY + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = relu_mask_bf16x2(v[e], yv[e]);
      }
      b[j][0] = v[0], b[j][1] = v[1], b[j + 1][0] = v[2], b[j + 1][1] = v[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), then k 8-15
      const int row = row0 + i * 16 + (q & 1) * 8, k = kk + (q >> 1) * 8;
      const int off = A_TRANS ? (k + r) * PA + row : (row + r) * PA + k;
      uint32_t a[4];
      ldmatrix_x4<A_TRANS>(a, sA + off);
      if constexpr (MASK == 1) {
        uint32_t yv[4];
        ldmatrix_x4<A_TRANS>(yv, sY + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = relu_mask_bf16x2(a[e], yv[e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j]);
    }
  }
}

// Stage a tile as load_tile does, with the copy width chosen at run time:
// one kernel per form, not one per pair of widths, keeps the build short.
// 16-byte copies take load_tile's unrolled loop; the narrow widths (4-byte
// copies of two bf16, or one bf16 by a plain load for an odd row width)
// take a rolled loop: unrolled, their per-copy offsets, hoisted out of the
// stage loop, would hold well over a hundred registers. The branch is
// uniform and taken once per tile.
template <int R, int C, int P, int THREADS>
__device__ __forceinline__ void load_tile_bf16(int vec, uint16_t* s,
                                               const uint16_t* g,
                                               long long ld, int r0, int c0,
                                               int rlim, int clim) {
  if (vec == 16) {
    load_tile<R, C, P, 16, THREADS>(s, g, ld, r0, c0, rlim, clim);
    return;
  }
  const int per = vec / 2, chunks = C / per;   // bf16 per copy: 2 or 1
#pragma unroll 1
  for (int e = threadIdx.x; e < R * chunks; e += THREADS) {
    const int r = e / chunks, c = (e % chunks) * per;
    const int gr = r0 + r, gc = c0 + c;
    const bool in = gr < rlim && gc < clim;
    if (per == 2) {
      cp_async<4>(s + r * P + c, in ? g + gr * ld + gc : g,
                  in ? min(4, (clim - gc) * 2) : 0);
    } else {
      s[r * P + c] = in ? g[gr * ld + gc] : uint16_t(0);
    }
  }
}

// Store one warp's f32 partial sums (rows row0 + [0, MT*16), columns
// col0 + [0, NT*8)) into a split-K scratch buffer (row stride ld) within
// M x N, as fragment pairs.
template <int MT, int NT>
__device__ __forceinline__ void store_partials(float* out, long long ld,
                                               int row0, int col0, int M,
                                               int N,
                                               const float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool pair =
      (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store_pair(out + m * ld, col0 + j * 8 + 2 * t, N, acc[i][j][2 * h],
                   acc[i][j][2 * h + 1], pair);
    }
}

// Store the CTA's ROWS x COLS tile of bf16 results (each warp's MT*16 x
// NT*8 accumulators at (wm, wn), each value through f(value, column)) at
// rows r0.. and columns c0.. of out (row stride ld), within M x N. The
// tile goes through shared memory at s (the pipeline's buffers, free once
// every stage is consumed) and leaves in 16-byte stores, eight bf16 a
// thread, a warp writing whole 128-byte rows: stored from the fragments,
// a warp's 4-byte stores would fill each 32-byte sector of a row half.
// Where out's rows or pointer are not 16-byte aligned, or at a ragged
// right edge, the row is stored element by element.
template <int ROWS, int COLS, int THREADS, int MT, int NT, typename F>
__device__ __forceinline__ void store_tile_bf16(
    uint16_t* s, uint16_t* out, long long ld, int r0, int c0, int M, int N,
    int wm, int wn, const float (&acc)[MT][NT][4], F f) {
  constexpr int P = COLS + 8;   // 16 bytes mod 128: conflict-free
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  cp_async_wait<0>();
  __syncthreads();              // every warp is done with the stages
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm + i * 16 + g + 8 * h, c = wn + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(s + r * P + c) =
            from_f32<uint16_t>(f(acc[i][j][2 * h], c0 + c)) |
            (static_cast<uint32_t>(
                 from_f32<uint16_t>(f(acc[i][j][2 * h + 1], c0 + c + 1)))
             << 16);
      }
  __syncthreads();
  const bool vec =
      (ld & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  constexpr int CHUNKS = COLS / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= M || gc >= N) continue;
    uint16_t* dst = out + gr * ld + gc;
    const uint16_t* src = s + r * P + c;
    if (vec && gc + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < 8 && gc + q < N; ++q) dst[q] = src[q];
    }
  }
}

constexpr int kBfBK = 64;         // reduction depth per stage, fwd and dx
constexpr int kBfPitch = kBfBK + 8;   // 144 bytes: 16 mod 128
// Three CTAs share an SM in every bf16 form (the round's fc2 forward and
// dx fill the card in one wave of 384 CTAs), which caps registers at 168;
// the forward and dx keep fewer stages to fit three in shared memory
constexpr int kBfMinBlocks = 3;
constexpr int kBfFwdStages = 3;
constexpr int kBfFwdSmem =
    2 * kBfFwdStages * (kFwdBM * kBfPitch + kBfBK * (kFwdBN + 8));
constexpr int kBfDxStages = 2;
template <bool RELU>
constexpr int bf_dx_smem() {
  return 2 * kBfDxStages * kBfPitch * (kDxBM * (RELU ? 2 : 1) + kDxBN);
}
constexpr int kBfDwStages = 3;
template <bool RELU>
constexpr int bf_dw_smem() {
  return 2 * kBfDwStages * kDwBR *
         ((kDwBK + 8) + (kDwBN + 8) * (RELU ? 2 : 1));
}

struct Vec2 {
  int a, b;   // copy widths in bytes of the two staged operands
};

// The bf16 forward: fwd_kernel's CTA (96 x 64 of y, warps 2 x 2 of 48 x 32,
// split-K partials), three 64-deep stages; x staged sx[row][k], w
// sw[k][col] and read with ldmatrix.trans.
__global__ void __launch_bounds__(kFwdThreads, kBfMinBlocks)
fwd_bf16_kernel(const FwdArgsT<uint16_t> a, const Vec2 vec) {
  constexpr int BM = kFwdBM, BN = kFwdBN, BK = kBfBK;
  constexpr int STAGES = kBfFwdStages, THREADS = kFwdThreads;
  constexpr int PA = kBfPitch, PB = BN + 8;
  constexpr int A_SZ = BM * PA, STAGE = A_SZ + BK * PB;
  static_assert(BM * (BN + 8) <= STAGES * STAGE, "y tile fits the stages");
  extern __shared__ __align__(16) uint16_t hsmem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int kbeg = split * a.kchunk, kend = min(a.K, kbeg + a.kchunk);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const uint16_t* x = a.x + slot * a.sxb;
  const uint16_t* w = a.w + slot * a.swb;
  auto load = [&](int kt) {
    uint16_t* s = hsmem + (kt % STAGES) * STAGE;
    const int k0 = kbeg + kt * BK;
    load_tile_bf16<BM, BK, PA, THREADS>(vec.a, s, x, a.sxm, m0, k0, a.M,
                                        kend);
    load_tile_bf16<BK, BN, PB, THREADS>(vec.b, s + A_SZ, w, a.swk, k0, n0,
                                        kend, a.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 48, wn = (warp >> 1) * 32;
  float acc[3][4][4] = {}, step[3][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const uint16_t* s = hsmem + (kt % STAGES) * STAGE;
    warp_mma_bf16<3, 4, BK, PA, PB, false, true, 0>(s, s + A_SZ, nullptr, wm,
                                                   wn, BK, step);
    flush(acc, step);
  }
  if (a.splits == 1) {
    const uint16_t* bias = a.bias + slot * a.sbb;
    store_tile_bf16<BM, BN, THREADS>(
        hsmem, a.y + slot * a.syb, a.sym, m0, n0, a.M, a.N, wm, wn, acc,
        [&](float v, int n) {
          return n < a.N ? activate(v + to_f32(bias[n]), a.act) : v;
        });
  } else {
    float* part = a.part + (static_cast<long long>(split) * a.batch + slot) *
                               a.M * a.N;
    store_partials(part, a.N, m0 + wm, n0 + wn, a.M, a.N, acc);
  }
}

// The bf16 dx: dx_kernel's CTA (96 x 64 of dx, warps 2 x 2), two 64-deep
// stages of dz (sA[row][n], y beside it when RELU) and w (sB[k][n]): both
// have the reduction N contiguous, so neither fragment load transposes.
template <bool RELU>
__global__ void __launch_bounds__(kDxThreads, kBfMinBlocks)
dx_bf16_kernel(const DxArgsT<uint16_t> a, const Vec2 vec) {
  constexpr int BM = kDxBM, BN = kDxBN, BK = kBfBK, P = kBfPitch;
  constexpr int STAGES = kBfDxStages, THREADS = kDxThreads;
  constexpr int A_SZ = BM * P, B_OFF = A_SZ * (RELU ? 2 : 1);
  constexpr int STAGE = B_OFF + BN * P;
  static_assert(BM * (BN + 8) <= STAGES * STAGE, "dx tile fits the stages");
  extern __shared__ __align__(16) uint16_t hsmem[];
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int nbeg = split * a.nchunk, nend = min(a.N, nbeg + a.nchunk);
  const int nn = (nend - nbeg + BK - 1) / BK;
  const uint16_t* dy = a.dy + slot * a.sdb;
  const uint16_t* yv = a.y + slot * a.syb;
  const uint16_t* w = a.w + slot * a.swb;
  auto load = [&](int st) {
    uint16_t* s = hsmem + (st % STAGES) * STAGE;
    const int n0 = nbeg + st * BK;
    load_tile_bf16<BM, BK, P, THREADS>(vec.a, s, dy, a.sdm, m0, n0, a.M,
                                       nend);
    if constexpr (RELU)
      load_tile_bf16<BM, BK, P, THREADS>(vec.a, s + A_SZ, yv, a.sym, m0, n0,
                                         a.M, nend);
    load_tile_bf16<BN, BK, P, THREADS>(vec.b, s + B_OFF, w, a.swk, k0, n0,
                                       a.K, nend);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nn) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 48, wn = (warp >> 1) * 32;
  const bool live = m0 + wm < a.M;   // warps wholly past M skip their MMAs
  float acc[3][4][4] = {}, step[3][4][4] = {};
  for (int st = 0; st < nn; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nn) load(st + STAGES - 1);
    cp_async_commit();
    if (live) {
      const uint16_t* s = hsmem + (st % STAGES) * STAGE;
      warp_mma_bf16<3, 4, BK, P, P, false, false, RELU ? 1 : 0>(
          s, s + B_OFF, RELU ? s + A_SZ : nullptr, wm, wn, BK, step);
      flush(acc, step);
    }
  }
  if (a.splits == 1) {
    store_tile_bf16<BM, BN, THREADS>(hsmem, a.dx + slot * a.sxb, a.sxm, m0,
                                     k0, a.M, a.K, wm, wn, acc,
                                     [](float v, int) { return v; });
  } else {
    float* part = a.part + (static_cast<long long>(split) * a.batch + slot) *
                               a.M * a.K;
    store_partials(part, a.K, m0 + wm, k0 + wn, a.M, a.K, acc);
  }
}

// The bf16 dw/db: dwdb_kernel's CTA (128 x 64 of dw, warps 2 x 2 of 64 x
// 32), three stages of 32 rows of M; x staged sx[m][k] and dz sd[m][n],
// both read with ldmatrix.trans (M is the reduction); the relu mask on dz's
// fragments; db summed in f32 from the staged dz by the first K tile's
// CTAs, in a fixed order.
template <bool RELU>
__global__ void __launch_bounds__(kDwThreads, kBfMinBlocks)
dwdb_bf16_kernel(const DwArgsT<uint16_t> a, const Vec2 vec) {
  constexpr int PX = kDwBK + 8, PD = kDwBN + 8, BR = kDwBR;
  constexpr int X_SZ = BR * PX, D_SZ = BR * PD;
  constexpr int STAGE = X_SZ + D_SZ * (RELU ? 2 : 1);
  constexpr int STAGES = kBfDwStages;
  static_assert(kDwBK * (kDwBN + 8) <= STAGES * STAGE,
                "dw tile fits the stages");
  extern __shared__ __align__(16) uint16_t hsmem[];
  const int n0 = blockIdx.x * kDwBN, k0 = blockIdx.y * kDwBK;
  const int slot = blockIdx.z;
  const uint16_t* x = a.x + slot * a.sxb;
  const uint16_t* dy = a.dy + slot * a.sdb;
  const uint16_t* yv = a.y + slot * a.syb;
  const int nr = (a.M + BR - 1) / BR;
  auto load = [&](int rt) {
    uint16_t* s = hsmem + (rt % STAGES) * STAGE;
    const int r0 = rt * BR;
    load_tile_bf16<BR, kDwBK, PX, kDwThreads>(vec.a, s, x, a.sxm, r0, k0,
                                              a.M, a.K);
    load_tile_bf16<BR, kDwBN, PD, kDwThreads>(vec.b, s + X_SZ, dy, a.sdm, r0,
                                              n0, a.M, a.N);
    if constexpr (RELU)
      load_tile_bf16<BR, kDwBN, PD, kDwThreads>(vec.b, s + X_SZ + D_SZ, yv,
                                                a.sym, r0, n0, a.M, a.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nr) load(s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const bool with_db = blockIdx.y == 0 && threadIdx.x < kDwBN;
  float acc[4][4][4] = {}, step[4][4][4] = {};
  float dbacc = 0.f;
  // with tail, only the k-steps below M run (M < 32: the per-sample pass)
  auto stage = [&](int rt, auto tail) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (rt + STAGES - 1 < nr) load(rt + STAGES - 1);
    cp_async_commit();
    const uint16_t* s = hsmem + (rt % STAGES) * STAGE;
    const uint16_t* sd = s + X_SZ;
    const uint16_t* sy = RELU ? sd + D_SZ : nullptr;
    warp_mma_bf16<4, 4, BR, PX, PD, true, true, RELU ? 2 : 0,
                  decltype(tail)::value>(s, sd, sy, wm, wn, a.M - rt * BR,
                                         step);
    flush(acc, step);
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < BR; ++r) {
        const float v = to_f32(sd[r * PD + threadIdx.x]);
        dbacc += (!RELU || to_f32(sy[r * PD + threadIdx.x]) > 0.f) ? v : 0.f;
      }
    }
  };
  for (int rt = 0; rt < nr; ++rt) {
    if (a.M < BR)   // one short stage
      stage(rt, std::true_type{});
    else
      stage(rt, std::false_type{});
  }
  store_tile_bf16<kDwBK, kDwBN, kDwThreads>(hsmem, a.dw + slot * a.swb,
                                            a.swk, k0, n0, a.K, a.N, wm, wn,
                                            acc,
                                            [](float v, int) { return v; });
  if (with_db && n0 + threadIdx.x < a.N)
    a.db[slot * a.sbb + n0 + threadIdx.x] = from_f32<uint16_t>(dbacc);
}

// ---------------------------------------------------------------------------
// bf16 backward forms for Hopper: TMA rings and wgmma (hopper.cuh)
// ---------------------------------------------------------------------------
//
// dx_tma_kernel and dwdb_tma_kernel take the bf16 backward wherever TMA can
// describe the operands (16-byte aligned pointers, strides of multiples of
// 8 elements; kernel.dx_plan and kernel.dwdb_plan decide); dx_bf16_kernel
// and dwdb_bf16_kernel above keep the rest (fc3's 10-wide rows, odd
// widths, unaligned views). At the round's shapes both are bound by HBM
// bytes (w read once, dw written once), and what held the mma.sync forms
// short of that rate was traffic inside the card and the lack of overlap:
// - dx re-read dz and y (24 KB of every 32 KB stage) in each of a slot's 64
//   CTAs of 64 columns, with one copy in flight and the relu mask applied
//   again on every fragment. Here a CTA covers kTxBK = 192 columns of dx
//   (three consumer warpgroups of 64), so dz and y are fetched a third as
//   often, and the round's fc2 is one wave of 22 x 6 = 132 CTAs; a producer
//   warp keeps a ring of kTxStages 64-deep stages of w, dz and y in flight by
//   TMA (128-byte swizzle); the mask is applied once per staged tile, in
//   shared memory (dz and y share one layout, so it is elementwise); wgmma
//   takes w as A and dz as B, both K-major (the reduction N runs along
//   their rows), computing dx^T: K fills wgmma's 64-row M, and the 96 rows
//   of M (95 at the round) its N.
// - dw/db re-read x and dz in every CTA of a 128 x 64 tile and then stored
//   its tile with nothing left to overlap. Here persistent CTAs, one per SM,
//   each walk a contiguous range of (slot, n-tile, k-tile) tiles of 128 x
//   128, k fastest: dz and y (the whole reduction M <= 96) are staged,
//   masked and summed into db once per (slot, n-tile) run and stay resident
//   while x streams through a ring by TMA; wgmma takes x^T and dz, both
//   MN-major (M runs down their rows: the descriptors' transpose bits); dw
//   leaves through shared memory by TMA stores, so a tile's store drains
//   while the next tile's x lands and multiplies.
// Products are exact bf16 x bf16 in f32, summed in f32 (dx adds each
// stage's products to its running sum, as the mma.sync forms do); dx, dw and
// db are rounded to bf16 once, at the store; dx's split partials stay f32
// for splitk_reduce_kernel. No atomics: the results are deterministic.
// Measured on the H100 (tools/fused_linear_variants.py): dx at the round's
// fc2 reads w at about 2.5 TB/s; dw/db is held by its TMA stores, which
// drain at about 2.1 TB/s where a fill of dw writes at 3.25 (without the
// stores it takes 0.6 of its time).

constexpr int kTxGroups = 3;                  // consumer warpgroups
constexpr int kTxBK = 64 * kTxGroups;         // dx columns (K) per CTA
constexpr int kTxBM = 96;                     // dx rows (M) per CTA
constexpr int kTxBN = 64;                     // reduction (N) per stage
constexpr int kTxStages = 4;
// each stage's products into a zeroed set, then added to the running sum
constexpr bool kTxStageAdd = true;
constexpr int kTxConsumers = 128 * kTxGroups;
constexpr int kTxThreads = kTxConsumers + 32;   // and one producer warp

template <bool RELU>
struct TxSmem {   // byte offsets in the 1024-aligned dynamic shared memory
  static constexpr int W = kTxBK * 128;    // kTxBK rows of 64 n, swizzled
  static constexpr int DZ = kTxBM * 128;
  static constexpr int STAGE = W + DZ * (RELU ? 2 : 1);
  static constexpr int P = kTxBK + 4;      // f32 epilogue tile pitch
  // the epilogue's tile reuses the ring once every stage is consumed
  static constexpr int BAR = kTxStages * STAGE > kTxBM * P * 4
                                 ? kTxStages * STAGE
                                 : kTxBM * P * 4;
  static constexpr int BYTES = BAR + 2 * kTxStages * 8 + 1024;
};

// dz = dy * 1[y > 0] on 16 bytes (eight bf16) of dz and y
__device__ __forceinline__ uint4 relu_mask_16b(uint4 v, uint4 y) {
  v.x = relu_mask_bf16x2(v.x, y.x), v.y = relu_mask_bf16x2(v.y, y.y);
  v.z = relu_mask_bf16x2(v.z, y.z), v.w = relu_mask_bf16x2(v.w, y.w);
  return v;
}

// dx_tma_kernel's consumer warpgroups: the stages' wgmmas, then the
// epilogue.
template <bool RELU>
__device__ __forceinline__ void dx_tma_consumer(
    uint8_t* smem, uint64_t* full, uint64_t* empty,
    const DxArgsT<uint16_t>& a, int m0, int k0, int slot, int split, int nn,
    int cl) {
  using L = TxSmem<RELU>;
  using namespace hopper;
  const int tid = threadIdx.x, wg = tid / 128;
  float acc[kTxBM / 2], step[kTxBM / 2];
#pragma unroll
  for (int i = 0; i < kTxBM / 2; ++i) acc[i] = step[i] = 0.f;
  for (int st = 0; st < nn; ++st) {
    const int s = st % kTxStages;
    mbar_wait(&full[s], (st / kTxStages) & 1);
    uint8_t* stage = smem + s * L::STAGE;
    if constexpr (RELU) {
      uint4* dz = reinterpret_cast<uint4*>(stage + L::W);
      const uint4* yv = reinterpret_cast<const uint4*>(stage + L::W + L::DZ);
#pragma unroll
      for (int i = tid; i < L::DZ / 16; i += kTxConsumers)
        dz[i] = relu_mask_16b(dz[i], yv[i]);
      fence_proxy_async();
      named_sync(1, kTxConsumers);
    }
    const uint64_t da = sw128_desc(stage + wg * 64 * 128, 16, 1024);
    const uint64_t db = sw128_desc(stage + L::W, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTxBN / 16; ++kk) {   // 32 bytes of the row each
      if constexpr (kTxStageAdd)
        wgmma_bf16<0, 0>(step, da + 2 * kk, db + 2 * kk, kk > 0);
      else
        wgmma_bf16<0, 0>(acc, da + 2 * kk, db + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(step);
    fence_regs(acc);
    __syncwarp();
    if ((tid & 31) == 0) {   // this warp is done with the stage
      if (cl == 1)
        mbar_arrive(&empty[s]);
      else
        for (int r = 0; r < cl; ++r) mbar_arrive_cluster(&empty[s], r);
    }
    if constexpr (kTxStageAdd) {
#pragma unroll
      for (int i = 0; i < kTxBM / 2; ++i) acc[i] += step[i];
    }
  }

  // the tile leaves through shared memory (the ring is free: every stage
  // was consumed) as dx[m][k], 16 bytes a store
  fence_proxy_async();
  named_sync(1, kTxConsumers);
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r = wg * 64 + ((tid & 127) >> 5) * 16 + g;   // k in the tile
#pragma unroll
    for (int j = 0; j < kTxBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(8 * j + 2 * t + (e & 1)) * L::P + r + 8 * (e >> 1)] =
            acc[4 * j + e];
  }
  named_sync(1, kTxConsumers);
  const int rows = min(kTxBM, a.M - m0);
  if (a.splits == 1) {
    uint16_t* out = a.dx + slot * a.sxb;
    const bool vec =
        (a.sxm & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int e = tid; e < kTxBM * (kTxBK / 8); e += kTxConsumers) {
      const int r = e / (kTxBK / 8), c = (e % (kTxBK / 8)) * 8;
      const int gk = k0 + c;
      if (r >= rows || gk >= a.K) continue;
      const float* src = tile + r * L::P + c;
      uint16_t* dst = out + (m0 + r) * a.sxm + gk;
      if (vec && gk + 8 <= a.K) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf16x2_rn(src[0], src[1]), bf16x2_rn(src[2], src[3]),
                       bf16x2_rn(src[4], src[5]), bf16x2_rn(src[6], src[7]));
      } else {
        for (int q = 0; q < 8 && gk + q < a.K; ++q)
          dst[q] = from_f32<uint16_t>(src[q]);
      }
    }
  } else {
    float* part = a.part + (static_cast<long long>(split) * a.batch + slot) *
                               a.M * a.K;
    const bool vec = (a.K & 3) == 0;
    for (int e = tid; e < kTxBM * (kTxBK / 4); e += kTxConsumers) {
      const int r = e / (kTxBK / 4), c = (e % (kTxBK / 4)) * 4;
      const int gk = k0 + c;
      if (r >= rows || gk >= a.K) continue;
      const float* src = tile + r * L::P + c;
      float* dst = part + static_cast<long long>(m0 + r) * a.K + gk;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0], src[1], src[2], src[3]);
      } else {
        for (int q = 0; q < 4 && gk + q < a.K; ++q) dst[q] = src[q];
      }
    }
  }
}

// One CTA: dx rows [m0, m0 + 96) x columns [k0, k0 + kTxBK) of one slot,
// over the N range of its split. Consumer warpgroup g computes dx^T rows
// [k0 + 64 g, +64) x the 96 rows of M: wgmma m64n96k16 with A = w[k][n]
// and B = dz[m][n] from the stage. wb: w has one matrix per slot (else
// every slot reads matrix 0). cl: the cluster size along K, 1 or 2; in a
// pair each CTA fetches half of the rows of every dz and y stage and
// multicasts it to both (the maps' boxes are kTxBM / cl rows), so the pair
// fetches them once. A stage is refilled once both CTAs' consumers have
// released it: each warp arrives on its own CTA's empty barrier and on its
// peer's.
template <bool RELU>
__global__ void __launch_bounds__(kTxThreads, 1)
dx_tma_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tdz,
              const __grid_constant__ CUtensorMap ty,
              const DxArgsT<uint16_t> a, const int wb, const int cl) {
  using L = TxSmem<RELU>;
  using namespace hopper;
  extern __shared__ uint8_t tx_raw[];
  uint8_t* smem = align1024(tx_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + kTxStages;
  const int m0 = blockIdx.x * kTxBM, k0 = blockIdx.y * kTxBK;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int nbeg = split * a.nchunk, nend = min(a.N, nbeg + a.nchunk);
  const int nn = (nend - nbeg + kTxBN - 1) / kTxBN;
  const int tid = threadIdx.x;
  const uint32_t rank = cl > 1 ? cluster_ctarank() : 0;
  if (tid == 0) {
    for (int s = 0; s < kTxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cl * (kTxConsumers / 32));   // a warp's arrival
    }
    fence_barrier_init();
  }
  if (cl > 1)
    cluster_sync();   // the peer's barriers exist before anything reaches them
  else
    __syncthreads();

  if (tid >= kTxConsumers) {   // the producer warp: one thread issues
    if (tid == kTxConsumers) {
      const int rows = kTxBM / cl;   // this CTA's share of dz and y
      for (int st = 0; st < nn; ++st) {
        const int s = st % kTxStages;
        if (st >= kTxStages) mbar_wait(&empty[s], (st / kTxStages - 1) & 1);
        uint8_t* stage = smem + s * L::STAGE;
        const int n0 = nbeg + st * kTxBN;
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_3d(stage, &tw, &full[s], n0, k0, wb ? slot : 0);
        uint8_t* dz = stage + L::W + rank * rows * 128;
        const int r0 = m0 + rank * rows;
        if (cl == 1) {
          tma_load_3d(dz, &tdz, &full[s], n0, r0, slot);
          if constexpr (RELU)
            tma_load_3d(dz + L::DZ, &ty, &full[s], n0, r0, slot);
        } else {
          tma_load_3d_multicast(dz, &tdz, &full[s], n0, r0, slot, 3);
          if constexpr (RELU)
            tma_load_3d_multicast(dz + L::DZ, &ty, &full[s], n0, r0, slot, 3);
        }
      }
    }
  } else {
    dx_tma_consumer<RELU>(smem, full, empty, a, m0, k0, slot, split, nn, cl);
  }
  if (cl > 1) {
    __syncwarp();
    cluster_sync();   // no CTA leaves while its peer may still arrive on it
  }
}

constexpr int kTwGroups = 2;                  // consumer warpgroups
constexpr int kTwKT = 64 * kTwGroups;         // dw rows (K) per tile
constexpr int kTwNT = 128;                    // dw columns (N) per tile
constexpr int kTwMR = 96;                     // most rows of M staged
constexpr int kTwStages = 2;                  // x ring
constexpr int kTwOutBufs = 1;                 // dw tiles staged for stores
constexpr int kTwConsumers = 128 * kTwGroups;
constexpr int kTwThreads = kTwConsumers + 32;   // and one producer warp

template <bool RELU>
struct TwSmem {   // byte offsets in the 1024-aligned dynamic shared memory
  // 64 columns of kTwMR rows of 128 bytes, swizzled: TMA's box, and one
  // column block of a wgmma operand
  static constexpr int REGION = kTwMR * 128;
  static constexpr int X = kTwGroups * REGION;          // one x stage
  static constexpr int DZ = kTwStages * X;
  static constexpr int DZ_BYTES = (kTwNT / 64) * REGION;
  static constexpr int Y = DZ + DZ_BYTES;
  static constexpr int OUT = Y + (RELU ? DZ_BYTES : 0);
  static constexpr int OUT_REGION = kTwKT * 128;   // two stores' boxes
  static constexpr int OUT_BUF = (kTwNT / 64) * OUT_REGION;
  static constexpr int BAR = OUT + kTwOutBufs * OUT_BUF;
  static constexpr int BYTES = BAR + (2 * kTwStages + 2) * 8 + 1024;
};

// Persistent CTAs over the tiles of dw (slot, n-tile, k-tile; k fastest):
// CTA c takes tiles [c T / G, (c + 1) T / G) of T on a grid of G. Each run of
// tiles of one (slot, n-tile) stages dz and y (M rows, box rows `mrows` =
// M rounded up to 16), masks dz in place, and, where the run starts at
// k-tile 0, sums db over M in f32, in row order. Per tile, warpgroup g
// computes dw rows [64 g, +64) x the kTwNT columns: wgmma m64n128k16 with A =
// x^T and B = dz, both MN-major, one k-step per 16 rows of M; then its 64
// rows go to shared memory (bf16, in the store boxes' swizzled layout) and
// out by TMA stores, which its next epilogue waits to have read. Each
// warpgroup runs its epilogue alone (its own barrier and bulk group), so
// one's stores overlap the other's multiply.
template <bool RELU>
__global__ void __launch_bounds__(kTwThreads, 1)
dwdb_tma_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tdz,
                const __grid_constant__ CUtensorMap ty,
                const __grid_constant__ CUtensorMap tdw,
                const DwArgsT<uint16_t> a, const int batch,
                const int mrows) {
  using L = TwSmem<RELU>;
  using namespace hopper;
  extern __shared__ uint8_t tw_raw[];
  uint8_t* smem = align1024(tw_raw);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* x_empty = x_full + kTwStages;
  uint64_t* dz_full = x_empty + kTwStages;
  uint64_t* dz_empty = dz_full + 1;
  const int ntiles = (a.N + kTwNT - 1) / kTwNT;
  const int ktiles = (a.K + kTwKT - 1) / kTwKT;
  const long long total = static_cast<long long>(batch) * ntiles * ktiles;
  const int tb = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int te = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  const int ksteps = mrows / 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTwStages; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], kTwConsumers);
    }
    mbar_init(dz_full, 1);
    mbar_init(dz_empty, kTwConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kTwConsumers) {   // the producer warp: one thread issues
    if (tid == kTwConsumers) {
      int runs = 0;
      for (int t = tb; t < te; ++t) {
        const int i = t - tb, kt = t % ktiles;
        const int nt = t / ktiles % ntiles, slot = t / ktiles / ntiles;
        if (t == tb || kt == 0) {   // a new (slot, n-tile) run: dz and y
          if (runs > 0) mbar_wait(dz_empty, (runs - 1) & 1);
          mbar_expect_tx(dz_full,
                         (kTwNT / 64) * mrows * 128 * (RELU ? 2 : 1));
          for (int q = 0; q < kTwNT / 64; ++q) {
            tma_load_3d(smem + L::DZ + q * L::REGION, &tdz, dz_full,
                        nt * kTwNT + 64 * q, 0, slot);
            if constexpr (RELU)
              tma_load_3d(smem + L::Y + q * L::REGION, &ty, dz_full,
                          nt * kTwNT + 64 * q, 0, slot);
          }
          ++runs;
        }
        const int s = i % kTwStages;
        if (i >= kTwStages) mbar_wait(&x_empty[s], (i / kTwStages - 1) & 1);
        mbar_expect_tx(&x_full[s], kTwGroups * mrows * 128);
        for (int g = 0; g < kTwGroups; ++g)
          tma_load_3d(smem + s * L::X + g * L::REGION, &tx, &x_full[s],
                      kt * kTwKT + 64 * g, 0, slot);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const bool elected = (tid & 127) == 0;   // issues its warpgroup's stores
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r = wg * 64 + ((tid & 127) >> 5) * 16 + g;   // dw row in the tile
  float acc[kTwNT / 2];
#pragma unroll
  for (int i = 0; i < kTwNT / 2; ++i) acc[i] = 0.f;
  int runs = 0;
  for (int t = tb; t < te; ++t) {
    const int i = t - tb, kt = t % ktiles;
    const int nt = t / ktiles % ntiles, slot = t / ktiles / ntiles;
    if (t == tb || kt == 0) {
      mbar_wait(dz_full, runs & 1);
      if constexpr (RELU) {
        uint4* dz = reinterpret_cast<uint4*>(smem + L::DZ);
        const uint4* yv = reinterpret_cast<const uint4*>(smem + L::Y);
        for (int q = 0; q < kTwNT / 64; ++q)
          for (int e = tid; e < mrows * 8; e += kTwConsumers) {
            const int o = q * (L::REGION / 16) + e;
            dz[o] = relu_mask_16b(dz[o], yv[o]);
          }
        fence_proxy_async();
        named_sync(1, kTwConsumers);
      }
      if (kt == 0) {   // db: column c of the tile, rows in order
        for (int c = tid; c < kTwNT; c += kTwConsumers) {
          const int n = nt * kTwNT + c;
          if (n >= a.N) continue;
          const uint8_t* col = smem + L::DZ + (c / 64) * L::REGION;
          const int chunk = (c % 64) / 8, within = (c % 8) * 2;
          float sum = 0.f;
          for (int m = 0; m < a.M; ++m)
            sum += to_f32(*reinterpret_cast<const uint16_t*>(
                col + m * 128 + ((chunk ^ (m & 7)) << 4) + within));
          a.db[slot * a.sbb + n] = from_f32<uint16_t>(sum);
        }
      }
      ++runs;
    }
    const int s = i % kTwStages;
    mbar_wait(&x_full[s], (i / kTwStages) & 1);
    const uint64_t da = sw128_desc(smem + s * L::X + wg * L::REGION,
                                   L::REGION, 1024);
    const uint64_t db = sw128_desc(smem + L::DZ, L::REGION, 1024);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)   // 16 rows of M, 2048 bytes each
      wgmma_bf16<1, 1>(acc, da + 128 * kk, db + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&x_empty[s]);
    if (t + 1 == te || (t + 1) % ktiles == 0) mbar_arrive(dz_empty);

    // this warpgroup's epilogue: the stores that last read its half of
    // the staging buffer are done
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
      for (int q = 0; q < kTwNT / 64; ++q)
        tma_store_3d(&tdw, out + q * L::OUT_REGION + wg * 64 * 128,
                     nt * kTwNT + 64 * q, kt * kTwKT + 64 * wg, slot);
      bulk_commit();
    }
  }
  if (elected) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// the bf16 forward for Hopper: a TMA ring and wgmma (hopper.cuh)
// ---------------------------------------------------------------------------
//
// fwd_tma_kernel takes the bf16 forward wherever TMA can describe x and w
// (kernel.fwd_plan); fwd_bf16_kernel keeps the rest (fc3's 10-wide rows,
// odd widths, unaligned views). At the round's fc2 (6 slots of 95 x 4096
// by 4096 x 4096) the forward is bound by HBM bytes: each slot's 32 MB w
// is read once, and 2 M K N = 19 GFLOP take under a third of the time
// those bytes do at the bf16 tensor-core rate. The mma.sync form reached
// 57 % of that bound with CTAs of 96 x 64, three to an SM and a cp.async
// ring of three stages, each CTA re-reading its slot's whole x. Here, as in
// dx_tma_kernel, a CTA covers kTfBN = 192 columns of y (three consumer
// warpgroups of 64), so x is fetched a third as often and the round's fc2
// is one wave of 22 x 6 = 132 CTAs with no split; a producer warp keeps a
// ring of kTfStages 64-deep stages of w (three 64 x 64 boxes) and x (one
// 96 x 64 box) in flight by TMA (128-byte swizzle); wgmma computes y^T,
// N filling its 64-row M and the 96 rows of M (95 at the round, row 96
// read as zero) its N: A = w[k][n] is MN-major (n runs along its rows) and
// B = x[m][k] K-major. Each stage's products go to a zeroed set, added to
// the running sum in f32 (one chain over K = 4096 drifted to 2.5e-6 of
// scale beyond one bf16 ulp, against 4.5e-7); bias and activation are
// applied in f32 on the accumulators, and y leaves through shared memory
// (the ring, free by then) in 16-byte stores of bf16, rounded once
// (cvt.rn.bf16x2.f32): stored by TMA from a swizzled bf16 tile instead
// (tools/fused_linear_variants.py's tf_tma_store), it measured slower.
// Split-K partials, where the grid cannot fill one wave, stay f32 for
// splitk_reduce_kernel, which adds bias and activation: in order, no
// atomics. Measured on the H100 (tools/fused_linear_variants.py):
// the round's fc2 at 85 % of its bytes bound, under bf16 cuBLAS.

constexpr int kTfGroups = 3;                  // consumer warpgroups
constexpr int kTfBN = 64 * kTfGroups;         // y columns (N) per CTA
constexpr int kTfBM = 96;                     // y rows (M) per CTA
constexpr int kTfBK = 64;                     // reduction (K) per stage
constexpr int kTfStages = 4;
// each stage's products into a zeroed set, then added to the running sum
constexpr bool kTfStageAdd = true;
constexpr int kTfConsumers = 128 * kTfGroups;
constexpr int kTfThreads = kTfConsumers + 32;   // and one producer warp

struct TfSmem {   // byte offsets in the 1024-aligned dynamic shared memory
  static constexpr int W_BOX = kTfBK * 128;   // 64 k rows of 64 n, swizzled
  static constexpr int W = kTfGroups * W_BOX;
  static constexpr int X = kTfBM * 128;       // 96 m rows of 64 k, swizzled
  static constexpr int STAGE = W + X;
  static constexpr int RING = kTfStages * STAGE;
  static constexpr int P = kTfBN + 4;         // f32 epilogue tile pitch
  static constexpr int TILE = kTfBM * P * 4;
  // the epilogue's tile reuses the ring once every stage is consumed
  static constexpr int BAR = RING > TILE ? RING : TILE;
  static constexpr int BYTES = BAR + 2 * kTfStages * 8 + 1024;
};

// fwd_tma_kernel's consumer warpgroups: the stages' wgmmas, then bias,
// activation and the store of the CTA's tile (or its split's partials).
__device__ __forceinline__ void fwd_tma_consumer(
    uint8_t* smem, uint64_t* full, uint64_t* empty,
    const FwdArgsT<uint16_t>& a, int m0, int n0, int slot, int split,
    int nk) {
  using L = TfSmem;
  using namespace hopper;
  const int tid = threadIdx.x, wg = tid / 128;
  float acc[kTfBM / 2], step[kTfBM / 2];
#pragma unroll
  for (int i = 0; i < kTfBM / 2; ++i) acc[i] = step[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTfStages;
    mbar_wait(&full[s], (kt / kTfStages) & 1);
    uint8_t* stage = smem + s * L::STAGE;
    // A: this warpgroup's w box, n along its 128-byte rows (MN-major; one
    // 64-column block, so the leading offset is unused); B: x, k along its
    // rows (K-major)
    const uint64_t da = sw128_desc(stage + wg * L::W_BOX, L::W_BOX, 1024);
    const uint64_t db = sw128_desc(stage + L::W, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTfBK / 16; ++kk) {   // 16 rows of w (2048 bytes),
      if constexpr (kTfStageAdd)                // 32 bytes of x's rows
        wgmma_bf16<1, 0>(step, da + 128 * kk, db + 2 * kk, kk > 0);
      else
        wgmma_bf16<1, 0>(acc, da + 128 * kk, db + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(step);
    fence_regs(acc);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);   // this warp is done
    if constexpr (kTfStageAdd) {
#pragma unroll
      for (int i = 0; i < kTfBM / 2; ++i) acc[i] += step[i];
    }
  }

  // The fragment is y^T: thread (warp w, lane 4 g + t) holds n = r and
  // r + 8 (r below) of the CTA's columns, at m = 8 j + 2 t (+1), j < 12.
  // Bias and activation apply in f32 to the columns below N (rows past M
  // are not stored); a split's partials go out without them.
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + ((tid & 127) >> 5) * 16 + g;   // n in the tile
  const bool direct = a.splits == 1;
  if (direct) {
    const uint16_t* bias = a.bias + slot * a.sbb;
    const float b0 = n0 + r < a.N ? to_f32(bias[n0 + r]) : 0.f;
    const float b1 = n0 + r + 8 < a.N ? to_f32(bias[n0 + r + 8]) : 0.f;
#pragma unroll
    for (int i = 0; i < kTfBM / 2; ++i)
      acc[i] = activate(acc[i] + ((i & 2) ? b1 : b0), a.act);
  }
  // every warpgroup is done with the ring before it becomes the tile
  fence_proxy_async();
  named_sync(1, kTfConsumers);
  const int rows = min(kTfBM, a.M - m0);
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kTfBM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(8 * j + 2 * t + (e & 1)) * L::P + r + 8 * (e >> 1)] =
          acc[4 * j + e];
  named_sync(1, kTfConsumers);
  if (direct) {
    uint16_t* out = a.y + slot * a.syb;
    const bool vec =
        (a.sym & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int e = tid; e < kTfBM * (kTfBN / 8); e += kTfConsumers) {
      const int rr = e / (kTfBN / 8), c = (e % (kTfBN / 8)) * 8;
      const int gn = n0 + c;
      if (rr >= rows || gn >= a.N) continue;
      const float* src = tile + rr * L::P + c;
      uint16_t* dst = out + (m0 + rr) * a.sym + gn;
      if (vec && gn + 8 <= a.N) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf16x2_rn(src[0], src[1]), bf16x2_rn(src[2], src[3]),
                       bf16x2_rn(src[4], src[5]), bf16x2_rn(src[6], src[7]));
      } else {
        for (int q = 0; q < 8 && gn + q < a.N; ++q)
          dst[q] = from_f32<uint16_t>(src[q]);
      }
    }
  } else {
    float* part = a.part + (static_cast<long long>(split) * a.batch + slot) *
                               a.M * a.N;
    const bool vec = (a.N & 3) == 0;
    for (int e = tid; e < kTfBM * (kTfBN / 4); e += kTfConsumers) {
      const int rr = e / (kTfBN / 4), c = (e % (kTfBN / 4)) * 4;
      const int gn = n0 + c;
      if (rr >= rows || gn >= a.N) continue;
      const float* src = tile + rr * L::P + c;
      float* dst = part + static_cast<long long>(m0 + rr) * a.N + gn;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0], src[1], src[2], src[3]);
      } else {
        for (int q = 0; q < 4 && gn + q < a.N; ++q) dst[q] = src[q];
      }
    }
  }
}

// One CTA: y rows [m0, m0 + 96) x columns [n0, n0 + kTfBN) of one slot,
// over the K range of its split. Consumer warpgroup g computes y^T rows
// [n0 + 64 g, +64) x the 96 rows of M: wgmma m64n96k16 with A = w[k][n]
// and B = x[m][k] from the stage. wb: w has one matrix per slot (else
// every slot reads matrix 0). The split's K range is a multiple of kTfBK
// deep except at K, where TMA reads zeros past the operand.
__global__ void __launch_bounds__(kTfThreads, 1)
fwd_tma_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const FwdArgsT<uint16_t> a, const int wb) {
  using L = TfSmem;
  using namespace hopper;
  extern __shared__ uint8_t tf_raw[];
  uint8_t* smem = align1024(tf_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + kTfStages;
  const int m0 = blockIdx.x * kTfBM, n0 = blockIdx.y * kTfBN;
  const int slot = blockIdx.z % a.batch, split = blockIdx.z / a.batch;
  const int kbeg = split * a.kchunk, kend = min(a.K, kbeg + a.kchunk);
  const int nk = (kend - kbeg + kTfBK - 1) / kTfBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTfConsumers / 32);   // a warp's arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kTfConsumers) {   // the producer warp: one thread issues
    if (tid == kTfConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTfStages;
        if (kt >= kTfStages) mbar_wait(&empty[s], (kt / kTfStages - 1) & 1);
        uint8_t* stage = smem + s * L::STAGE;
        const int k0 = kbeg + kt * kTfBK;
        mbar_expect_tx(&full[s], L::STAGE);
        for (int g = 0; g < kTfGroups; ++g)
          tma_load_3d(stage + g * L::W_BOX, &tw, &full[s], n0 + 64 * g, k0,
                      wb ? slot : 0);
        tma_load_3d(stage + L::W, &tx, &full[s], k0, m0, slot);
      }
    }
    return;
  }
  fwd_tma_consumer(smem, full, empty, a, m0, n0, slot, split, nk);
}

// Above 48 KB a block's shared memory must be asked for explicitly: allow
// each kernel the card's opt-in maximum, once per process (the launch
// itself fails, and reports it, if a block asks for more).
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  return err;
}

template <int VX, int VW>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(fwd_kernel<VX, VW>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + kFwdBM - 1) / kFwdBM, (a.N + kFwdBN - 1) / kFwdBN,
                  a.batch * a.splits);
  const size_t smem = sizeof(float) * kFwdSmemFloats;
  fwd_kernel<VX, VW><<<grid, kFwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int VX, int VD, bool RELU>
cudaError_t launch_dwdb(const DwArgs& a, int batch, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dwdb_kernel<VX, VD, RELU>);
  if (attr != cudaSuccess) return attr;
  // K = 0 still runs the first K tile, whose CTAs write db
  const int k_tiles = a.K > 0 ? (a.K + kDwBK - 1) / kDwBK : 1;
  const dim3 grid((a.N + kDwBN - 1) / kDwBN, k_tiles, batch);
  const size_t smem = sizeof(float) * dw_smem_floats<RELU>();
  dwdb_kernel<VX, VD, RELU><<<grid, kDwThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dw/db with copy widths vx (x) and vd (dy, y), 16 or 4 bytes
template <bool RELU>
cudaError_t dispatch_dwdb(const DwArgs& a, int batch, int vx, int vd,
                          cudaStream_t st) {
  if (vx == 16)
    return vd == 16 ? launch_dwdb<16, 16, RELU>(a, batch, st)
                    : launch_dwdb<16, 4, RELU>(a, batch, st);
  return vd == 16 ? launch_dwdb<4, 16, RELU>(a, batch, st)
                  : launch_dwdb<4, 4, RELU>(a, batch, st);
}

template <int VD, int VW, bool RELU>
cudaError_t launch_dx(const DxArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dx_kernel<VD, VW, RELU>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + kDxBM - 1) / kDxBM, (a.K + kDxBN - 1) / kDxBN,
                  a.batch * a.splits);
  const size_t smem = sizeof(float) * dx_smem_floats<RELU>();
  dx_kernel<VD, VW, RELU><<<grid, kDxThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dx with copy widths vd (dy, y) and vw (w), 16 or 4 bytes
template <bool RELU>
cudaError_t dispatch_dx(const DxArgs& a, int vd, int vw, cudaStream_t st) {
  if (vd == 16)
    return vw == 16 ? launch_dx<16, 16, RELU>(a, st)
                    : launch_dx<16, 4, RELU>(a, st);
  return vw == 16 ? launch_dx<4, 16, RELU>(a, st)
                  : launch_dx<4, 4, RELU>(a, st);
}

// The second launch of a split-K plan: out (a.y) = the sum over a.splits,
// in order, of the partials, with the forward's bias and activation when
// EPILOGUE.
template <bool EPILOGUE, typename T>
cudaError_t reduce_splits(const FwdArgsT<T>& a, cudaStream_t st) {
  const long long total = static_cast<long long>(a.batch) * a.M * a.N;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_reduce_kernel<EPILOGUE, T><<<blocks, 256, 0, st>>>(a);
  return cudaGetLastError();
}

// the forward with copy widths vx (x) and vw (w), 16 or 4 bytes
cudaError_t dispatch_fwd(const FwdArgs& a, int vx, int vw, cudaStream_t st) {
  if (vx == 16)
    return vw == 16 ? launch_fwd<16, 16>(a, st) : launch_fwd<16, 4>(a, st);
  return vw == 16 ? launch_fwd<4, 16>(a, st) : launch_fwd<4, 4>(a, st);
}

// the bf16 forms: one kernel per form (the copy widths are arguments)
cudaError_t launch_fwd_bf16(const FwdArgsT<uint16_t>& a, Vec2 vec,
                            cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(fwd_bf16_kernel);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + kFwdBM - 1) / kFwdBM, (a.N + kFwdBN - 1) / kFwdBN,
                  a.batch * a.splits);
  fwd_bf16_kernel<<<grid, kFwdThreads, kBfFwdSmem, stream>>>(a, vec);
  return cudaGetLastError();
}

template <bool RELU>
cudaError_t launch_dx_bf16(const DxArgsT<uint16_t>& a, Vec2 vec,
                           cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dx_bf16_kernel<RELU>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + kDxBM - 1) / kDxBM, (a.K + kDxBN - 1) / kDxBN,
                  a.batch * a.splits);
  dx_bf16_kernel<RELU><<<grid, kDxThreads, bf_dx_smem<RELU>(), stream>>>(
      a, vec);
  return cudaGetLastError();
}

template <bool RELU>
cudaError_t launch_dwdb_bf16(const DwArgsT<uint16_t>& a, int batch, Vec2 vec,
                             cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dwdb_bf16_kernel<RELU>);
  if (attr != cudaSuccess) return attr;
  const int k_tiles = a.K > 0 ? (a.K + kDwBK - 1) / kDwBK : 1;
  const dim3 grid((a.N + kDwBN - 1) / kDwBN, k_tiles, batch);
  dwdb_bf16_kernel<RELU><<<grid, kDwThreads, bf_dw_smem<RELU>(), stream>>>(
      a, vec);
  return cudaGetLastError();
}

// a tensor map that cuTensorMapEncodeTiled refused: kEncodeError + its
// CUresult (the C entries return it in place of a CUDA error)
constexpr int kEncodeError = 10000;

template <bool RELU>
int launch_dx_tma(const DxArgsT<uint16_t>& a, int cl, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dx_tma_kernel<RELU>);
  if (attr != cudaSuccess) return attr;
  const int kblocks = (a.K + kTxBK - 1) / kTxBK;
  if ((cl != 1 && cl != 2) || kblocks % cl) return cudaErrorInvalidValue;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tw, tdz, ty;
  CUresult r = hopper::encode_bf16_3d(&tw, a.w, a.N, a.K, a.batch, a.swk,
                                      a.swb, kTxBN, kTxBK, kSw);
  if (r == CUDA_SUCCESS)
    r = hopper::encode_bf16_3d(&tdz, a.dy, a.N, a.M, a.batch, a.sdm, a.sdb,
                               kTxBN, kTxBM / cl, kSw);
  ty = tdz;
  if (r == CUDA_SUCCESS && RELU)
    r = hopper::encode_bf16_3d(&ty, a.y, a.N, a.M, a.batch, a.sym, a.syb,
                               kTxBN, kTxBM / cl, kSw);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  const dim3 grid((a.M + kTxBM - 1) / kTxBM, kblocks, a.batch * a.splits);
  const int wb = a.swb != 0;
  if (cl == 1) {
    dx_tma_kernel<RELU><<<grid, kTxThreads, TxSmem<RELU>::BYTES, stream>>>(
        tw, tdz, ty, a, wb, cl);
    return cudaGetLastError();
  }
  // pairs of CTAs along K, on neighbouring SMs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTxThreads);
  cfg.dynamicSmemBytes = TxSmem<RELU>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute pair;
  pair.id = cudaLaunchAttributeClusterDimension;
  pair.val.clusterDim.x = 1;
  pair.val.clusterDim.y = cl;
  pair.val.clusterDim.z = 1;
  cfg.attrs = &pair;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, dx_tma_kernel<RELU>, tw, tdz, ty, a, wb, cl);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool RELU>
int launch_dwdb_tma(const DwArgsT<uint16_t>& a, int batch, int ctas,
                    cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dwdb_tma_kernel<RELU>);
  if (attr != cudaSuccess) return attr;
  if (a.M < 1 || a.M > kTwMR || ctas < 1) return cudaErrorInvalidValue;
  const int mrows = (a.M + 15) / 16 * 16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tx, tdz, ty, tdw;
  CUresult r = hopper::encode_bf16_3d(&tx, a.x, a.K, a.M, batch, a.sxm,
                                      a.sxb, 64, mrows, kSw);
  if (r == CUDA_SUCCESS)
    r = hopper::encode_bf16_3d(&tdz, a.dy, a.N, a.M, batch, a.sdm, a.sdb,
                               64, mrows, kSw);
  ty = tdz;
  if (r == CUDA_SUCCESS && RELU)
    r = hopper::encode_bf16_3d(&ty, a.y, a.N, a.M, batch, a.sym, a.syb, 64,
                               mrows, kSw);
  if (r == CUDA_SUCCESS)
    r = hopper::encode_bf16_3d(&tdw, a.dw, a.N, a.K, batch, a.swk, a.swb, 64,
                               64, kSw);   // a warpgroup's 64 rows
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  dwdb_tma_kernel<RELU><<<ctas, kTwThreads, TwSmem<RELU>::BYTES, stream>>>(
      tx, tdz, ty, tdw, a, batch, mrows);
  return cudaGetLastError();
}

int launch_fwd_tma(const FwdArgsT<uint16_t>& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(fwd_tma_kernel);
  if (attr != cudaSuccess) return attr;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tx, tw;
  CUresult r = hopper::encode_bf16_3d(&tx, a.x, a.K, a.M, a.batch, a.sxm,
                                      a.sxb, kTfBK, kTfBM, kSw);
  if (r == CUDA_SUCCESS)   // a warpgroup's 64 columns of w per box
    r = hopper::encode_bf16_3d(&tw, a.w, a.N, a.K, a.batch, a.swk, a.swb,
                               64, kTfBK, kSw);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  const dim3 grid((a.M + kTfBM - 1) / kTfBM, (a.N + kTfBN - 1) / kTfBN,
                  a.batch * a.splits);
  fwd_tma_kernel<<<grid, kTfThreads, TfSmem::BYTES, stream>>>(
      tx, tw, a, a.swb != 0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every operand is row-major in
// its last dimension; the other strides are in elements. Each returns the
// launch's cudaGetLastError() (or that of the first failing step) so the
// caller can raise on a refused launch.

// y = act(x @ w + b). The launch plan comes from the wrapper
// (kernel.fwd_plan): splits > 1 splits K into kchunk-deep ranges (a
// multiple of 32) whose partials go to `part` (splits * B * M * N floats)
// and are summed by a second launch; vx and vw are the cp.async widths in
// bytes (16 or 4) of x and w.
extern "C" int fused_linear_fwd(const float* x, const float* w,
                                const float* bias, float* y, float* part,
                                int B, int M, int K, int N, long long sxb,
                                long long sxm, long long swb, long long swk,
                                long long sbb, long long syb, long long sym,
                                int act, int splits, int kchunk, int vx,
                                int vw, void* stream) {
  const FwdArgs a{x, w, bias, y, part, B, M, K, N, act, splits, kchunk,
                  sxb, sxm, swb, swk, sbb, syb, sym};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch_fwd(a, vx, vw, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_splits<true, float>(a, st));
}

// dx = (dy * 1[y > 0] when relu) @ w^T, w read in its (K, N) layout. The
// launch plan comes from the wrapper (kernel.dx_plan): B slots of M rows
// (slots folded into rows there where w is shared), splits > 1 splits N
// into nchunk-deep ranges (a multiple of 16) whose partials go to `part`
// (splits * B * M * K floats) and are summed by a second launch; vd and vw
// are the cp.async widths in bytes (16 or 4) of dy and y, and of w.
extern "C" int fused_linear_bwd_dx(const float* dy, const float* y,
                                   const float* w, float* dx, float* part,
                                   int B, int M, int K, int N, long long sdb,
                                   long long sdm, long long syb,
                                   long long sym, long long swb,
                                   long long swk, long long sxb,
                                   long long sxm, int relu, int splits,
                                   int nchunk, int vd, int vw, void* stream) {
  const DxArgs a{dy, y, w, dx, part, B, M, K, N, splits, nchunk,
                 sdb, sdm, syb, sym, swb, swk, sxb, sxm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = relu ? dispatch_dx<true>(a, vd, vw, st)
                               : dispatch_dx<false>(a, vd, vw, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  FwdArgs r{};
  r.y = dx;
  r.part = part;
  r.batch = B, r.M = M, r.N = K, r.splits = splits;
  r.syb = sxb, r.sym = sxm;
  return static_cast<int>(reduce_splits<false, float>(r, st));
}

// (dw, db) = (x^T @ dz, sum_m dz), dz = dy * 1[y > 0] when relu; vx and vd
// are the cp.async widths in bytes (16 or 4) of x and of dy and y, from the
// wrapper (kernel.dwdb_plan).
extern "C" int fused_linear_bwd_dw_db(const float* x, const float* dy,
                                      const float* y, float* dw, float* db,
                                      int B, int M, int K, int N,
                                      long long sxb, long long sxm,
                                      long long sdb, long long sdm,
                                      long long syb, long long sym,
                                      long long swb, long long swk,
                                      long long sbb, int relu, int vx,
                                      int vd, void* stream) {
  const DwArgs a{x, dy, y, dw, db, M, K, N, sxb, sxm, sdb, sdm, syb, sym,
                 swb, swk, sbb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(relu ? dispatch_dwdb<true>(a, B, vx, vd, st)
                               : dispatch_dwdb<false>(a, B, vx, vd, st));
}

// The bf16 forms of the three entries above, with the same arguments:
// operands are bf16 (passed as their 16-bit patterns), products go to the
// tensor cores in bf16 with f32 accumulation, bias and activation are f32,
// and y, dx, dw and db are rounded to bf16 at the store; split-K partials
// (`part`) are f32. The copy widths may also be 2 (bytes): an odd row
// width, staged by plain loads.
extern "C" int fused_linear_fwd_bf16(const uint16_t* x, const uint16_t* w,
                                     const uint16_t* bias, uint16_t* y,
                                     float* part, int B, int M, int K, int N,
                                     long long sxb, long long sxm,
                                     long long swb, long long swk,
                                     long long sbb, long long syb,
                                     long long sym, int act, int splits,
                                     int kchunk, int vx, int vw,
                                     void* stream) {
  const FwdArgsT<uint16_t> a{x, w, bias, y, part, B, M, K, N, act, splits,
                             kchunk, sxb, sxm, swb, swk, sbb, syb, sym};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_fwd_bf16(a, Vec2{vx, vw}, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_splits<true, uint16_t>(a, st));
}

extern "C" int fused_linear_bwd_dx_bf16(
    const uint16_t* dy, const uint16_t* y, const uint16_t* w, uint16_t* dx,
    float* part, int B, int M, int K, int N, long long sdb, long long sdm,
    long long syb, long long sym, long long swb, long long swk, long long sxb,
    long long sxm, int relu, int splits, int nchunk, int vd, int vw,
    void* stream) {
  const DxArgsT<uint16_t> a{dy, y, w, dx, part, B, M, K, N, splits, nchunk,
                            sdb, sdm, syb, sym, swb, swk, sxb, sxm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vec2 vec{vd, vw};
  const cudaError_t err = relu ? launch_dx_bf16<true>(a, vec, st)
                               : launch_dx_bf16<false>(a, vec, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  FwdArgsT<uint16_t> r{};
  r.y = dx;
  r.part = part;
  r.batch = B, r.M = M, r.N = K, r.splits = splits;
  r.syb = sxb, r.sym = sxm;
  return static_cast<int>(reduce_splits<false, uint16_t>(r, st));
}

extern "C" int fused_linear_bwd_dw_db_bf16(
    const uint16_t* x, const uint16_t* dy, const uint16_t* y, uint16_t* dw,
    uint16_t* db, int B, int M, int K, int N, long long sxb, long long sxm,
    long long sdb, long long sdm, long long syb, long long sym, long long swb,
    long long swk, long long sbb, int relu, int vx, int vd, void* stream) {
  const DwArgsT<uint16_t> a{x, dy, y, dw, db, M, K, N, sxb, sxm, sdb, sdm,
                            syb, sym, swb, swk, sbb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vec2 vec{vx, vd};
  return static_cast<int>(relu ? launch_dwdb_bf16<true>(a, B, vec, st)
                               : launch_dwdb_bf16<false>(a, B, vec, st));
}


// The Hopper forms of the two bf16 backward entries (dx_tma_kernel,
// dwdb_tma_kernel), for operands that TMA can describe (kernel.dx_plan and
// kernel.dwdb_plan): no copy widths; dx takes the plan's split as above and
// its cluster size along K (1, or 2 where the K blocks pair up), dw/db its
// persistent grid of `ctas` CTAs and M <= 96. The tensor maps are encoded
// here, per launch; one that does not encode returns kEncodeError (10000)
// + its CUresult.
extern "C" int fused_linear_bwd_dx_tma_bf16(
    const uint16_t* dy, const uint16_t* y, const uint16_t* w, uint16_t* dx,
    float* part, int B, int M, int K, int N, long long sdb, long long sdm,
    long long syb, long long sym, long long swb, long long swk, long long sxb,
    long long sxm, int relu, int splits, int nchunk, int cluster,
    void* stream) {
  const DxArgsT<uint16_t> a{dy, y, w, dx, part, B, M, K, N, splits, nchunk,
                            sdb, sdm, syb, sym, swb, swk, sxb, sxm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = relu ? launch_dx_tma<true>(a, cluster, st)
                       : launch_dx_tma<false>(a, cluster, st);
  if (err != 0 || splits == 1) return err;
  FwdArgsT<uint16_t> r{};
  r.y = dx;
  r.part = part;
  r.batch = B, r.M = M, r.N = K, r.splits = splits;
  r.syb = sxb, r.sym = sxm;
  return static_cast<int>(reduce_splits<false, uint16_t>(r, st));
}

// The Hopper form of the bf16 forward (fwd_tma_kernel), for x and w that
// TMA can describe (kernel.fwd_plan): the arguments of
// fused_linear_fwd_bf16 without the copy widths; a split plan's partials
// are summed, with bias and activation, by a second launch.
extern "C" int fused_linear_fwd_tma_bf16(const uint16_t* x, const uint16_t* w,
                                         const uint16_t* bias, uint16_t* y,
                                         float* part, int B, int M, int K,
                                         int N, long long sxb, long long sxm,
                                         long long swb, long long swk,
                                         long long sbb, long long syb,
                                         long long sym, int act, int splits,
                                         int kchunk, void* stream) {
  const FwdArgsT<uint16_t> a{x, w, bias, y, part, B, M, K, N, act, splits,
                             kchunk, sxb, sxm, swb, swk, sbb, syb, sym};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_fwd_tma(a, st);
  if (err != 0 || splits == 1) return err;
  return static_cast<int>(reduce_splits<true, uint16_t>(a, st));
}

extern "C" int fused_linear_bwd_dw_db_tma_bf16(
    const uint16_t* x, const uint16_t* dy, const uint16_t* y, uint16_t* dw,
    uint16_t* db, int B, int M, int K, int N, long long sxb, long long sxm,
    long long sdb, long long sdm, long long syb, long long sym, long long swb,
    long long swk, long long sbb, int relu, int ctas, void* stream) {
  const DwArgsT<uint16_t> a{x, dy, y, dw, db, M, K, N, sxb, sxm, sdb, sdm,
                            syb, sym, swb, swk, sbb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return relu ? launch_dwdb_tma<true>(a, B, ctas, st)
              : launch_dwdb_tma<false>(a, B, ctas, st);
}
