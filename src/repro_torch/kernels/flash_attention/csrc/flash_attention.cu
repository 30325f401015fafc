// Flash attention, forward and the dq / dk-dv backward pair, CUDA for
// Hopper (sm_90a), on f32 or bf16 operands.
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/flash_attention/kernel.py:
//   flash_attention          (kernel.py:96)  o = softmax(q k^T * scale) v, lse
//   flash_attention_bwd, dq  (kernel.py:227) dq = (p * (do v^T - delta)) k * scale
//   flash_attention_bwd, dkdv (kernel.py:227) dv = p^T do, dk = ds^T q * scale
// with p = exp(s - lse) rebuilt from the forward's log-sum-exp and
// delta = sum(do * o, -1) computed by the caller, as the reference does.
//
// What bounds them on an H100: attention does 4*S*S*D (forward) and
// 8*S*S*D (backward) operations per head on 4*S*D elements in and out, so
// at S >= 64 it is bound by arithmetic, not by device memory. The tiled
// forms run it on the tensor cores as 3xTF32 (each operand split into a
// TF32 high part and a TF32 remainder, three products summed in f32 per
// stage), which the fused linear kernels run within the reference's 1e-5
// f32 contract, against 165 TFLOP/s where plain f32 FMA has 67. At the FL
// path's S <= 32 with D = 32 a head is far too small for a tile and the
// kernels are bound by latency: the forward and the backward pair run
// their short forms there (below).
//
// The tiled forward (tensor cores). A block of 4 warps per (batch*head,
// 64-row query tile); each warp owns 16 query rows and walks the visible
// 64-key tiles, which the block stages by cp.async into a two-stage ring. S = Q K^T and P V are
// mma.m16n8k8 in 3xTF32; the running max, denominator and the output
// accumulator stay in registers, in the MMA's fragment layout (below,
// before fwd_tc_kernel).
//
// The tiled backward (tensor cores; dq_tc_kernel, dkdv_tc_kernel). The
// TPU grid's sequential innermost axis becomes a loop inside the block
// over the other operand's 64-row tiles, streamed through a cp.async ring
// of two, with the dq / dk / dv accumulators in registers in the MMA's
// fragment layout. A block of 4 warps per (batch*head, 64-row tile), a
// warp per 16 rows: dq's warps own query rows and form S and dP, dk/dv's
// own key rows and form S^T and dP^T (the scores transposed). P and dS are
// formed in the C fragments of the scores and are, split into TF32 parts,
// the A fragments of the second products (dS K; P^T dO and dS^T Q) with
// no trip through shared memory. Below, after the tiled forward.
//
// Operands are (batch, head, seq, d) with any batch / head / seq strides
// and unit d stride, so the slot-batched (rows, seq, heads, d) projections
// are read in place; rows past the sequence end are masked on load and
// store, so any S runs. Tiles that a causal or window mask hides entirely
// are skipped, not run, in every tiled kernel. The tiled forms take exp2f
// of log2(e)-scaled exponents, the FMA short forms expf (no fast-math
// intrinsics).
//
// The short forms (S <= 32, D = 32: every shape of the FL path). A 64-row
// tile there is half padding, and a block per head runs 2.2 waves of mostly
// idle threads behind several barriers. Instead one warp owns one
// (batch, head) and one lane owns one row: for the forward and dq lane i
// holds q_i (dq: and do_i) and its accumulator in registers and walks the
// keys in order; for dk/dv lane j holds k_j, v_j and both accumulators and
// walks the queries in order. The other operands' rows are staged once in
// shared memory by cp.async (16-byte copies where the plan's `vec` allows)
// and read by broadcast; lse and delta come by shuffle or straight from
// global. A block holds `heads_per_block` warps (the plan's: one, which
// measured best) that share nothing, so there is no __syncthreads: each
// warp waits on its own copies and __syncwarp()s. Rows
// past S are neither copied nor multiplied (the loops end at S); masked
// pairs contribute exactly 0. Each warp writes its outputs to its own
// staging rows and stores them as whole rows with the other lanes.
//
// The bf16 forms. Every kernel is a template on the operands' element type
// T (float or __nv_bfloat16), as the Pallas kernels take any operand dtype:
// they upcast on load, compute in f32 and write the operand dtype. For T =
// bf16 only the loaders and the stores differ. The loaders read 16, 4 or
// 2 bytes of bf16 per copy (the plan's `vec`) with plain loads, widen them
// with __bfloat162float and write f32 into the same shared-memory layouts
// and pitches the f32 forms fill by cp.async, so everything downstream (the
// short forms' passes, the tiled forms' 3xTF32 MMAs) is the f32 code. bf16 values are exact in TF32, so the small parts
// of Q, K and V's 3xTF32 split are zero there: right, not fast. Each output
// is rounded once, to nearest even (__float2bfloat16_rn); lse and delta
// are f32 in both forms.
//
// The bf16 backward on the tensor cores (bwd_short_mma_kernel, the plan's
// "mma" form: S <= 32, D = 32, 16-byte copies, every bf16 backward of the
// FL path). dq, dk and dv of a head in one launch, where the dq and dk/dv
// short forms each stage all four operands and form S and dP again, as FMA
// chains on widened f32 rows. q, k, v and do stay bf16 in shared memory;
// the scores are taken transposed (rows keys), so P^T and dS^T, split into
// two bf16 parts each (one part alone lies 1.2e-3 of scale beyond one
// ulp), are dV's and dK's A fragments in the registers they were formed
// in; dQ reads dS^T's parts back transposed from shared memory. Below,
// before the kernel.
//
// The bf16 forward on the tensor cores (fwd_short_mma_kernel, the plan's
// "mma" form at the same shapes: every bf16 forward of the FL path). S = Q
// K^T from exact bf16 products; P, in f32, split into two bf16 parts, is
// P V's A fragments in the registers it was formed in; the row max and the
// row sum stay within the warp that owns the rows. Below, after the
// backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;           // element strides; d is unit-stride
};

struct Problem {
  int heads, seq;
  float scale;
  int causal, window;          // window <= 0: no window
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// an f32 result in the operands' type: rounded once, to nearest even
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC bytes of bf16 at src (VEC / 2 elements), widened into the floats at
// dst (16-byte aligned for VEC = 16, 8-byte for VEC = 4)
template <int VEC>
__device__ __forceinline__ void widen(float* dst, const bf16* src) {
  if constexpr (VEC == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float2*>(dst) =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  } else {
    *dst = __bfloat162float(*src);
  }
}

// The reverse: VEC / 2 floats at src, each rounded once, as VEC bytes of
// bf16 at dst
template <int VEC>
__device__ __forceinline__ void narrow(bf16* dst, const float* src) {
  if constexpr (VEC == 16) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                           __floats2bfloat162_rn(a.z, a.w),
                           __floats2bfloat162_rn(b.x, b.y),
                           __floats2bfloat162_rn(b.z, b.w)};
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(src[0], src[1]);
  } else {
    *dst = __float2bfloat16_rn(*src);
  }
}

// the copy widths, in bytes, that the forms of element type T take
template <typename T>
bool vec_ok(int vec) {
  return vec == 16 || vec == 4 || (sizeof(T) == 2 && vec == 2);
}

__device__ __forceinline__ bool visible(const Problem& pr, int q, int k) {
  return q < pr.seq && k < pr.seq && (!pr.causal || k <= q) &&
         (pr.window <= 0 || k > q - pr.window);
}

__device__ __forceinline__ int n_tiles(const Problem& pr) {
  return (pr.seq + kTile - 1) / kTile;
}

// key tiles [lo, hi) of `k_rows` keys that hold a visible key for some
// row of the query rows [q0, q0 + q_rows)
__device__ __forceinline__ void key_tiles(const Problem& pr, int q0, int* lo,
                                          int* hi, int q_rows = kTile,
                                          int k_rows = kTile) {
  const int q_last = min(q0 + q_rows, pr.seq) - 1;
  *hi = pr.causal ? q_last / k_rows + 1 : (pr.seq + k_rows - 1) / k_rows;
  *lo = pr.window > 0 ? max(0, q0 - pr.window + 1) / k_rows : 0;
}

// query tiles [lo, hi) of kTile queries that see some key of the key
// rows [k0, k0 + k_rows)
__device__ __forceinline__ void query_tiles(const Problem& pr, int k0,
                                            int* lo, int* hi,
                                            int k_rows = kTile) {
  const int k_last = min(k0 + k_rows, pr.seq) - 1;
  *lo = pr.causal ? k0 / kTile : 0;
  *hi = pr.window > 0 ? min(n_tiles(pr), (k_last + pr.window - 1) / kTile + 1)
                      : n_tiles(pr);
}

// ---------------------------------------------------------------------------
// short form: a warp per (batch, head), a lane per row
// ---------------------------------------------------------------------------

constexpr int kShortD = 32;                 // head dim of the short form
constexpr int kShortMaxSeq = 32;            // one lane per row
constexpr int kShortPitch = kShortD + 4;    // lane-own float4 rows: no bank
                                            // conflicts within a quarter warp
constexpr int kShortRows = kShortMaxSeq * kShortPitch;  // floats per operand
constexpr int kMaxHeadsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// *dst = *src, global to shared without a register round trip: a lane
// issues all its copies before it waits on any. Only `bytes` of the copy
// are read (0 or all of it), the rest zero-filled. Both widths allocate in
// L1 (.ca): the 16-byte copies measured faster that way than with L1
// bypassed (.cg) at the FL round's shape, and no slower at the statistics
// pass's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes = 16) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, seq) of one head's operand (global row stride `ld`) into
// dst[seq][kShortPitch], copied by the warp's 32 lanes: 8 lanes per row in
// 16-byte pieces, or a lane per column in 4-byte pieces.
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld, int seq, int lane) {
  static_assert(VEC == 16 || VEC == 4, "f32 copies are 16 or 4 bytes");
  if (VEC == 16) {
    for (int e = lane; e < seq * (kShortD / 4); e += 32) {
      const int r = e / (kShortD / 4), c = (e % (kShortD / 4)) * 4;
      cp_async16(dst + r * kShortPitch + c, src + r * ld + c);
    }
  } else {
    for (int r = 0; r < seq; ++r)
      cp_async4(dst + r * kShortPitch + lane, src + r * ld + lane);
  }
}

// The bf16 operand's rows, widened into the same f32 rows: VEC / 2
// elements per load, 32 / (VEC / 2) lanes per row.
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, const bf16* src,
                                           long long ld, int seq, int lane) {
  constexpr int kPer = VEC / 2, kPieces = kShortD / kPer;
  for (int e = lane; e < seq * kPieces; e += 32) {
    const int r = e / kPieces, c = (e % kPieces) * kPer;
    widen<VEC>(dst + r * kShortPitch + c, src + r * ld + c);
  }
}

// The reverse: src[seq][kShortPitch] to rows [0, seq) of a global operand.
template <int VEC>
__device__ __forceinline__ void store_rows(float* dst, long long ld,
                                           const float* src, int seq,
                                           int lane) {
  if (VEC == 16) {
    for (int e = lane; e < seq * (kShortD / 4); e += 32) {
      const int r = e / (kShortD / 4), c = (e % (kShortD / 4)) * 4;
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          *reinterpret_cast<const float4*>(src + r * kShortPitch + c);
    }
  } else {
    for (int r = 0; r < seq; ++r)
      dst[r * ld + lane] = src[r * kShortPitch + lane];
  }
}

// ... and to a bf16 operand, each element rounded once
template <int VEC>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const float* src, int seq,
                                           int lane) {
  constexpr int kPer = VEC / 2, kPieces = kShortD / kPer;
  for (int e = lane; e < seq * kPieces; e += 32) {
    const int r = e / kPieces, c = (e % kPieces) * kPer;
    narrow<VEC>(dst + r * ld + c, src + r * kShortPitch + c);
  }
}

// A lane's own staged row into registers (zeros past the sequence end,
// whose rows were not staged).
__device__ __forceinline__ void row_to_regs(float (&dst)[kShortD],
                                            const float* rows, int lane,
                                            int seq) {
  const float4* row = reinterpret_cast<const float4*>(rows + lane * kShortPitch);
#pragma unroll
  for (int c = 0; c < kShortD / 4; ++c) {
    const float4 t = lane < seq ? row[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * c] = t.x;
    dst[4 * c + 1] = t.y;
    dst[4 * c + 2] = t.z;
    dst[4 * c + 3] = t.w;
  }
}

// a . x for a register row a and a broadcast shared row x: four partial
// sums over d = m (mod 4), in order of d, summed pairwise at the end, so
// the dependent chains are 8 FMAs long.
__device__ __forceinline__ float dot(const float (&a)[kShortD],
                                     const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kShortD / 4; ++c) {
    const float4 xv = x4[c];
    s[0] = fmaf(a[4 * c], xv.x, s[0]);
    s[1] = fmaf(a[4 * c + 1], xv.y, s[1]);
    s[2] = fmaf(a[4 * c + 2], xv.z, s[2]);
    s[3] = fmaf(a[4 * c + 3], xv.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// (a . x, b . y): two independent chains, interleaved once inlined
__device__ __forceinline__ float2 dot2(const float (&a)[kShortD],
                                       const float (&b)[kShortD],
                                       const float* x, const float* y) {
  return make_float2(dot(a, x), dot(b, y));
}

// acc += w * x for a broadcast shared row x
__device__ __forceinline__ void axpy(float (&acc)[kShortD], float w,
                                     const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int c = 0; c < kShortD / 4; ++c) {
    const float4 xv = x4[c];
    acc[4 * c] = fmaf(w, xv.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, xv.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, xv.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, xv.w, acc[4 * c + 3]);
  }
}

// a lane's accumulator, times `scale`, into its own staged row
__device__ __forceinline__ void regs_to_row(float* rows, int lane,
                                            const float (&src)[kShortD],
                                            float scale) {
  float4* row = reinterpret_cast<float4*>(rows + lane * kShortPitch);
#pragma unroll
  for (int c = 0; c < kShortD / 4; ++c)
    row[c] = make_float4(src[4 * c] * scale, src[4 * c + 1] * scale,
                         src[4 * c + 2] * scale, src[4 * c + 3] * scale);
}

// o and lse of one (batch, head) per warp, in two passes over the keys
// instead of the online softmax's per-key rescale of the accumulator (which
// costs as much as the accumulation itself). Lane i holds q_i. Pass 1, keys
// j = 0 .. S-1 in order: s_ij = (q_i . k_j) * scale into the warp's score
// buffer at [j][i] (consecutive lanes, consecutive banks), and m_i = the max
// over the visible j. Pass 2, j = 0 .. S-1 in order: p = exp(s_ij - m_i)
// (exactly 0 where masked), l_i += p, acc_i += p * v_j. The max is exact
// before the first p, so nothing is rescaled. Stores o_i = acc_i * (1 /
// max(l_i, 1e-30)) and lse_i = m_i + log(max(l_i, 1e-30)). The q rows'
// staging buffer holds the scores once q_i is in registers, and o's rows
// after the last score is read. Both passes are unrolled by 4 (four
// independent keys in flight: faster than one at every FL shape).
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock, 1)
fwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, Problem pr, int n_heads) {
  extern __shared__ __align__(16) float short_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bh >= n_heads) return;
  const int b = bh / pr.heads, h = bh % pr.heads, seq = pr.seq;
  float* qs = short_smem + warp * 3 * kShortRows;
  float* ks = qs + kShortRows;
  float* vs = ks + kShortRows;
  stage_rows<VEC>(qs, q + b * sq.b + h * sq.h, sq.s, seq, lane);
  stage_rows<VEC>(ks, k + b * sk.b + h * sk.h, sk.s, seq, lane);
  stage_rows<VEC>(vs, v + b * sv.b + h * sv.h, sv.s, seq, lane);
  cp_async_wait_all();
  __syncwarp();

  float qr[kShortD], acc[kShortD];
  row_to_regs(qr, qs, lane, seq);
  __syncwarp();  // every q row is in registers: qs holds the scores now
  float m = kNegInf;
#pragma unroll 4
  for (int j = 0; j < seq; ++j) {
    const float s = dot(qr, ks + j * kShortPitch) * pr.scale;
    qs[j * 32 + lane] = s;
    if (visible(pr, lane, j)) m = fmaxf(m, s);
  }
  float l = 0.f;
#pragma unroll
  for (int d = 0; d < kShortD; ++d) acc[d] = 0.f;
#pragma unroll 4
  for (int j = 0; j < seq; ++j) {
    const float p = visible(pr, lane, j) ? expf(qs[j * 32 + lane] - m) : 0.f;
    l += p;
    axpy(acc, p, vs + j * kShortPitch);
  }
  const float denom = fmaxf(l, 1e-30f);
  __syncwarp();  // every score is read: o's rows go into qs
  regs_to_row(qs, lane, acc, 1.f / denom);
  if (lane < seq)
    lse[static_cast<long long>(bh) * seq + lane] = m + logf(denom);
  __syncwarp();
  store_rows<VEC>(o + b * so.b + h * so.h, so.s, qs, seq, lane);
}

// dq of one (batch, head) per warp: lane i walks keys j = 0 .. S-1 with
// p = exp(q_i . k_j * scale - lse_i) (0 where masked), ds = p * (do_i . v_j
// - delta_i), dq_i += ds * k_j; stores dq_i * scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock, 1)
dq_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                Problem pr, int n_heads) {
  extern __shared__ __align__(16) float short_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bh >= n_heads) return;
  const int b = bh / pr.heads, h = bh % pr.heads, seq = pr.seq;
  float* qs = short_smem + warp * 4 * kShortRows;
  float* dos = qs + kShortRows;
  float* ks = dos + kShortRows;
  float* vs = ks + kShortRows;
  stage_rows<VEC>(qs, q + b * sq.b + h * sq.h, sq.s, seq, lane);
  stage_rows<VEC>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, seq, lane);
  stage_rows<VEC>(ks, k + b * sk.b + h * sk.h, sk.s, seq, lane);
  stage_rows<VEC>(vs, v + b * sv.b + h * sv.h, sv.s, seq, lane);
  const long long row0 = static_cast<long long>(bh) * seq;
  const float lse_i = lane < seq ? lse[row0 + lane] : 0.f;
  const float delta_i = lane < seq ? delta[row0 + lane] : 0.f;
  cp_async_wait_all();
  __syncwarp();

  float qr[kShortD], dor[kShortD], acc[kShortD];
  row_to_regs(qr, qs, lane, seq);
  row_to_regs(dor, dos, lane, seq);
#pragma unroll
  for (int d = 0; d < kShortD; ++d) acc[d] = 0.f;
  for (int j = 0; j < seq; ++j) {
    const float* kj = ks + j * kShortPitch;
    const float2 sdp = dot2(qr, dor, kj, vs + j * kShortPitch);
    const float p = visible(pr, lane, j) ? expf(sdp.x * pr.scale - lse_i)
                                         : 0.f;
    axpy(acc, p * (sdp.y - delta_i), kj);
  }
  // dq_i * scale into the lane's own q row (no other lane reads it), then
  // whole rows out
  regs_to_row(qs, lane, acc, pr.scale);
  __syncwarp();
  store_rows<VEC>(dq + b * sdq.b + h * sdq.h, sdq.s, qs, seq, lane);
}

// dk, dv of one (batch, head) per warp: lane j walks queries i = 0 .. S-1
// with the same p and ds, dv_j += p * do_i, dk_j += ds * q_i; stores
// dk_j * scale and dv_j. lse_i and delta_i come from lane i by shuffle.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock, 1)
dkdv_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                  Strides sdo, Strides sdk, Strides sdv, Problem pr,
                  int n_heads) {
  extern __shared__ __align__(16) float short_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bh >= n_heads) return;
  const int b = bh / pr.heads, h = bh % pr.heads, seq = pr.seq;
  float* ks = short_smem + warp * 4 * kShortRows;
  float* vs = ks + kShortRows;
  float* qs = vs + kShortRows;
  float* dos = qs + kShortRows;
  stage_rows<VEC>(ks, k + b * sk.b + h * sk.h, sk.s, seq, lane);
  stage_rows<VEC>(vs, v + b * sv.b + h * sv.h, sv.s, seq, lane);
  stage_rows<VEC>(qs, q + b * sq.b + h * sq.h, sq.s, seq, lane);
  stage_rows<VEC>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, seq, lane);
  const long long row0 = static_cast<long long>(bh) * seq;
  const float lse_l = lane < seq ? lse[row0 + lane] : 0.f;
  const float delta_l = lane < seq ? delta[row0 + lane] : 0.f;
  cp_async_wait_all();
  __syncwarp();

  float kr[kShortD], vr[kShortD], dk_acc[kShortD], dv_acc[kShortD];
  row_to_regs(kr, ks, lane, seq);
  row_to_regs(vr, vs, lane, seq);
#pragma unroll
  for (int d = 0; d < kShortD; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int i = 0; i < seq; ++i) {
    const float lse_i = __shfl_sync(kFull, lse_l, i);
    const float delta_i = __shfl_sync(kFull, delta_l, i);
    const float* qi = qs + i * kShortPitch;
    const float* doi = dos + i * kShortPitch;
    const float2 sdp = dot2(kr, vr, qi, doi);
    const float p = visible(pr, i, lane) ? expf(sdp.x * pr.scale - lse_i)
                                         : 0.f;
    axpy(dv_acc, p, doi);
    axpy(dk_acc, p * (sdp.y - delta_i), qi);
  }
  regs_to_row(ks, lane, dk_acc, pr.scale);
  regs_to_row(vs, lane, dv_acc, 1.f);
  __syncwarp();
  store_rows<VEC>(dk + b * sdk.b + h * sdk.h, sdk.s, ks, seq, lane);
  store_rows<VEC>(dv + b * sdv.b + h * sdv.h, sdv.s, vs, seq, lane);
}

// ---------------------------------------------------------------------------
// the bf16 backward on the tensor cores: dq, dk and dv of a head in one pass
// ---------------------------------------------------------------------------

// bf16 rows of 80 bytes: 16-byte aligned for cp.async and the stores, and
// the eight rows an ldmatrix phase reads fall in distinct banks
constexpr int kMmaPitch = kShortD + 8;
constexpr int kMmaTile = kShortMaxSeq * kMmaPitch;  // bf16 per staged tile
// The design's choices, as measured (tools/flash_attention_variants.py
// --bwd, H100, the round's 1,140 heads and the statistics pass's 2,280):
// Heads staged ahead (a ring of kBwdRing items: the next head's copies in
// flight while the warps work on this one) on a persistent grid (as many
// blocks as fit at once, walking the heads): a block per
// `heads_per_block` heads is 5 % (round) and 14 % (statistics) slower,
// the persistent grid without the ring 4 % and 2 %.
constexpr int kBwdRing = 2;
constexpr bool kBwdPersistent = true;
// Warps per head: each owns 32 / kBwdWarpsPerHead keys (dK, dV) and as
// many queries (dQ). Two halve each warp's chain of dependent work and
// double the warps that hide its latency: one is 19 % (round) and 12 %
// (statistics) slower.
constexpr int kBwdWarpsPerHead = 2;

// a head's shared memory: kBwdRing stages of q, k, v and do, then dS^T's
// big and small parts
__host__ __device__ constexpr int bwd_mma_head_bytes() {
  return 2 * kMmaTile * (4 * kBwdRing + 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global to shared, of which `bytes` (0 or 16) are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16_b(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four 8 x 8 b16 matrices from shared memory (lane l gives row l % 8 of
// matrix l / 8); with TRANS each is transposed in the load (ssd_scan.cu's
// twin).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  }
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16): the products of
// two bf16 are exact in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (to nearest even) in one instruction: lo in
// the low half, hi in the high half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (lo, hi) as a bf16 pair `big` plus the pair of what rounding left out,
// `small`: big + small holds an f32 to about 2^-17 of itself, so an f32 x
// bf16 product runs as two bf16 products
__device__ __forceinline__ void split_bf16x2(float lo, float hi,
                                             uint32_t& big, uint32_t& small) {
  big = bf16x2_rn(lo, hi);
  small = bf16x2_rn(lo - __uint_as_float(big << 16),
                    hi - __uint_as_float(big & 0xffff0000u));
}

// Under a causal mask a tile of queries [q0, q0 + nq) and keys [k0, k0 +
// nk) holds a visible pair only where k0 <= q0 + nq - 1: the kernel skips
// the MMAs of the others (2-3 % of its time). Tiles are fixed at compile
// time, so the skip costs no branch and leaves the other tiles' MMA chains
// free to interleave: a run-time test per tile, which also skipped the
// tiles a window hides, read 0.0129 ms at the round where the same kernel
// with the compile-time skip read 0.0111 (one warp a head, two calls).
constexpr bool kBwdCausalSkip = true;

template <bool CAUSAL, bool SKIP = kBwdCausalSkip>
__device__ __forceinline__ constexpr bool tile_on(int q0, int nq, int k0) {
  return !(CAUSAL && SKIP) || k0 <= q0 + nq - 1;
}

// P's exponent base: 2 (exp2f of log2(e)-scaled scores and lse: one
// MUFU.EX2 where expf adds its own range reduction) or e (expf: 7-12 %
// slower at the FL path's shapes)
constexpr bool kBwdExp2 = true;
constexpr float kBwdLog2e = 1.4426950408889634f;

// lse, or the scores' scale, in P's exponent base
__device__ __forceinline__ float in_base(float x) {
  return kBwdExp2 ? x * kBwdLog2e : x;
}

// p = exp(s * scale - lse) of a visible pair's score s, from scale and lse
// in the exponent's base (in_base)
__device__ __forceinline__ float bwd_exp(float s, float scale_b,
                                         float lse_b) {
  return kBwdExp2 ? exp2f(s * scale_b - lse_b) : expf(s * scale_b - lse_b);
}

// B fragments (k16 x n8) of a [k][n] tile by ldmatrix.trans: k-steps kk of
// rows k, n-tiles of columns n; f[kk][n] for n-tiles 0-3 (32 columns)
__device__ __forceinline__ void b_frags_kn(uint32_t (&f)[2][4][2],
                                           const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r4[4];
      ldmatrix_x4<true>(r4, t + (16 * kk + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * kMmaPitch +
                                8 * (2 * jj + (lane >> 4)));
      f[kk][2 * jj][0] = r4[0], f[kk][2 * jj][1] = r4[1];
      f[kk][2 * jj + 1][0] = r4[2], f[kk][2 * jj + 1][1] = r4[3];
    }
}

// B fragments (k16 x n8) of an [n][k] tile: n-tiles n of rows, k-steps kk
// of columns; f[n][kk]
__device__ __forceinline__ void b_frags_nk(uint32_t (&f)[4][2][2],
                                           const bf16* t, int lane) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t r4[4];
      ldmatrix_x4<false>(r4, t + (16 * jj + (lane >> 4) * 8 + (lane & 7)) *
                                     kMmaPitch + 16 * kk +
                                 ((lane >> 3) & 1) * 8);
      f[2 * jj][kk][0] = r4[0], f[2 * jj][kk][1] = r4[1];
      f[2 * jj + 1][kk][0] = r4[2], f[2 * jj + 1][kk][1] = r4[3];
    }
}

// The transposed scores of a head as accumulator tiles (m-tiles MI0 ..
// MI0 + MT - 1 of 16 keys, n-tiles n of 8 queries; rows r, columns c):
// S^T = K Q^T and dP^T = V dO^T from A fragments of K and V (the warp's
// m-tiles) and B fragments of Q and dO (every query), exact bf16 products;
// P^T = exp(S^T * scale - lse_c) (exactly 0 where the pair is not
// visible), dS^T = P^T (dP^T - delta_c), each split into bf16 big and
// small parts laid out as the A fragments of the next product (k = c:
// n-tiles 2 kk and 2 kk + 1 are k-step kk, so no shuffle). lse_q (in P's
// exponent base) and delta_q hold the queries 8 n + 2 t + e.
template <bool CAUSAL, int MI0, int MT>
__device__ __forceinline__ void probs(
    const Problem& pr, const uint32_t (&fk)[MT][2][4],
    const uint32_t (&fq)[4][2][2], const uint32_t (&fv)[MT][2][4],
    const uint32_t (&fdo)[4][2][2], const float (&lse_q)[4][2],
    const float (&delta_q)[4][2], uint32_t (&pb)[MT][2][4],
    uint32_t (&ps)[MT][2][4], uint32_t (&db)[MT][2][4],
    uint32_t (&dsm)[MT][2][4], int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_b = in_base(pr.scale);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int m = MI0 + mi;
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      if (tile_on<CAUSAL>(8 * n, 8, 16 * m)) {
        mma_bf16(st, fk[mi][0], fq[n][0]);
        mma_bf16(st, fk[mi][1], fq[n][1]);
        mma_bf16(dp, fv[mi][0], fdo[n][0]);
        mma_bf16(dp, fv[mi][1], fdo[n][1]);
      }
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1), c = 8 * n + 2 * t4 + (e & 1);
        p[e] = visible(pr, c, r) ? bwd_exp(st[e], scale_b, lse_q[n][e & 1])
                                 : 0.f;
        ds[e] = p[e] * (dp[e] - delta_q[n][e & 1]);
      }
      const int kk = n >> 1, base = (n & 1) * 2;
      split_bf16x2(p[0], p[1], pb[mi][kk][base], ps[mi][kk][base]);
      split_bf16x2(p[2], p[3], pb[mi][kk][base + 1], ps[mi][kk][base + 1]);
      split_bf16x2(ds[0], ds[1], db[mi][kk][base], dsm[mi][kk][base]);
      split_bf16x2(ds[2], ds[3], db[mi][kk][base + 1],
                   dsm[mi][kk][base + 1]);
    }
}

// (A big + A small) B * scale for the warp's m-tiles MI0 .. MI0 + MT - 1,
// each element rounded once to bf16, as packed pairs out[mi][np][h] (rows
// 16 (MI0 + mi) + g + 8 h, columns 8 np + 2 t): per m-tile the k-steps
// whose A is not all zero (ON(m, kk), fixed at compile time), small part
// then big part per k-step, two k-steps chained on the tensor cores
template <int MI0, int MT, typename On>
__device__ __forceinline__ void product(uint32_t (&out)[MT][4][2],
                                        const uint32_t (&ab)[MT][2][4],
                                        const uint32_t (&as)[MT][2][4],
                                        const uint32_t (&fb)[2][4][2],
                                        float scale, On on) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (!on(MI0 + mi, kk)) continue;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(acc[np], as[mi][kk], fb[kk][np]);
        mma_bf16(acc[np], ab[mi][kk], fb[kk][np]);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      out[mi][np][0] = bf16x2_rn(acc[np][0] * scale, acc[np][1] * scale);
      out[mi][np][1] = bf16x2_rn(acc[np][2] * scale, acc[np][3] * scale);
    }
  }
}

// packed bf16 pairs (product's layout) of rows 16 MI0 .. into a tile
template <int MI0, int MT>
__device__ __forceinline__ void pairs_to_tile(bf16* tile,
                                              const uint32_t (&v)[MT][4][2],
                                              int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(
            tile + (16 * (MI0 + mi) + g + 8 * hh) * kMmaPitch + 8 * np +
            2 * t4) = v[mi][np][hh];
}

// The W warps of one head meet: a named barrier over their threads (id 1 +
// the head's place in the block; 0 is __syncthreads'), or __syncwarp for
// a head of one warp.
template <int W>
__device__ __forceinline__ void head_sync(int head) {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + head), "r"(32 * W)
                 : "memory");
  }
}

// One head's dq, dk and dv from its staged tiles, by the warp that owns
// m-tiles MI0 .. MI0 + MT - 1: keys 16 MI0 .. for dK and dV, queries
// 16 MI0 .. for dQ. Every warp of the head meets twice (head_sync): once
// dS^T's parts are all written and every read of Q, V and dO is done (the
// outputs then go to the warp's rows of those tiles), and (in the kernel)
// before the stage is refilled.
template <bool CAUSAL, int MI0>
__device__ __forceinline__ void bwd_mma_head(
    const Problem& pr, bf16* qs, bf16* ks, bf16* vs, bf16* dos, bf16* dsh,
    bf16* dsl, float lse_l, float delta_l, int head, int lane) {
  constexpr int MT = 2 / kBwdWarpsPerHead, P = kMmaPitch;
  const int t4 = lane & 3;
  // the queries' lse and delta at the accumulators' columns
  float lse_c[4][2], delta_c[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lse_c[n][e] = __shfl_sync(kFull, lse_l, 8 * n + 2 * t4 + e);
      delta_c[n][e] = __shfl_sync(kFull, delta_l, 8 * n + 2 * t4 + e);
    }
  uint32_t pb[MT][2][4], ps[MT][2][4], db[MT][2][4], dsm[MT][2][4];
  {
    uint32_t fk[MT][2][4], fv[MT][2][4], fq[4][2][2], fdo[4][2][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int at = (16 * (MI0 + mi) + (lane & 7) +
                        ((lane >> 3) & 1) * 8) * P + 16 * kk +
                       (lane >> 4) * 8;
        ldmatrix_x4<false>(fk[mi][kk], ks + at);
        ldmatrix_x4<false>(fv[mi][kk], vs + at);
      }
    b_frags_nk(fq, qs, lane);
    b_frags_nk(fdo, dos, lane);
    probs<CAUSAL, MI0, MT>(pr, fk, fq, fv, fdo, lse_c, delta_c, pb, ps, db,
                           dsm, lane);
  }
  // dS^T's parts (rows: the warp's keys) for every warp's dQ: A fragment
  // register 2 (n % 2) + h of k-step n / 2 is the pair of n-tile n at row
  // g + 8 h
  {
    uint32_t big[MT][4][2], small[MT][4][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          big[mi][n][hh] = db[mi][n >> 1][(n & 1) * 2 + hh];
          small[mi][n][hh] = dsm[mi][n >> 1][(n & 1) * 2 + hh];
        }
    pairs_to_tile<MI0, MT>(dsh, big, lane);
    pairs_to_tile<MI0, MT>(dsl, small, lane);
  }
  // dV = P^T dO and dK = dS^T Q, A fragments from registers: k-step kk
  // (queries 16 kk ..) of m-tile mi (keys 16 mi ..)
  auto keys_on = [](int mi, int kk) {
    return tile_on<CAUSAL>(16 * kk, 16, 16 * mi);
  };
  uint32_t fb[2][4][2], dvp[MT][4][2], dkp[MT][4][2], dqp[MT][4][2];
  b_frags_kn(fb, dos, lane);
  product<MI0, MT>(dvp, pb, ps, fb, 1.f, keys_on);
  b_frags_kn(fb, qs, lane);
  product<MI0, MT>(dkp, db, dsm, fb, pr.scale, keys_on);
  // dS^T written; Q, V and dO read by every warp
  head_sync<kBwdWarpsPerHead>(head);
  {
    // dQ = dS K: dS's A fragments (m-tile mq: queries 16 mq .., k-step kj:
    // keys 16 kj ..) by ldmatrix.trans of dS^T's parts
    uint32_t ab[MT][2][4], as[MT][2][4];
#pragma unroll
    for (int mq = 0; mq < MT; ++mq)
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const int at = (16 * kj + (lane & 7) + ((lane >> 4) << 3)) * P +
                       16 * (MI0 + mq) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4<true>(ab[mq][kj], dsh + at);
        ldmatrix_x4<true>(as[mq][kj], dsl + at);
      }
    b_frags_kn(fb, ks, lane);
    auto queries_on = [](int mq, int kj) {
      return tile_on<CAUSAL>(16 * mq, 16, 16 * kj);
    };
    product<MI0, MT>(dqp, ab, as, fb, pr.scale, queries_on);
  }
  pairs_to_tile<MI0, MT>(vs, dvp, lane);    // dV: the warp's rows of V
  pairs_to_tile<MI0, MT>(dos, dkp, lane);   // dK: the warp's rows of dO
  pairs_to_tile<MI0, MT>(qs, dqp, lane);    // dQ: the warp's rows of Q
}

// dq, dk and dv of one (batch, head) per kBwdWarpsPerHead warps, on bf16
// mma.sync m16n8k16 with f32 accumulators, at S <= 32 and D = 32. A block
// holds `heads_per_block` heads that share nothing; head slot w takes heads
// w, w + (the grid's head slots), ... (one each unless the grid is
// persistent), staging q, k, v and do as bf16 by 16-byte cp.async into
// tiles of pitch kMmaPitch (rows past S zero-filled), kBwdRing heads ahead.
// Per head, each warp for its 32 / kBwdWarpsPerHead keys and queries:
// - S^T = K Q^T and dP^T = V dO^T (rows keys j, columns queries i), exact
//   bf16 products; with CAUSAL (pr.causal) the tiles above the diagonal
//   skipped;
// - P^T = exp(S^T * scale - lse_i) (by exp2f, kBwdExp2; exactly 0 where
//   (i, j) is not visible, rows and columns past S included), dS^T = P^T
//   (dP^T - delta_i) in f32, each split into bf16 big and small parts in
//   the accumulators' registers, which are the A fragments of dV = P^T dO
//   and dK = dS^T Q (dO and Q as B fragments by ldmatrix.trans);
// - dQ = dS K: dS^T's two parts written to the head's tiles as bf16 and
//   read back by ldmatrix.trans as dS's A fragments, K by ldmatrix.trans
//   (forming S and dP again with rows = queries measured 27 % slower);
// - dk and dq times scale, each output rounded once to bf16 into rows its
//   operands left (dV: V's, dK: dO's, dQ: Q's), then stored as 16-byte
//   rows.
// lse_i (in P's exponent base) and delta_i come from lane i by shuffle.
template <bool CAUSAL>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock)
bwd_short_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdq,
                     Strides sdk, Strides sdv, Problem pr, int n_heads) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  constexpr int RING = kBwdRing, P = kMmaPitch, TILE = kMmaTile;
  constexpr int W = kBwdWarpsPerHead, ROWS = 32 / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int head = warp / W, wh = warp % W, tid = threadIdx.x % (32 * W);
  const int seq = pr.seq;
  bf16* area = reinterpret_cast<bf16*>(mma_smem + head * bwd_mma_head_bytes());
  bf16* dsh = area + 4 * RING * TILE;   // dS^T's big part
  bf16* dsl = dsh + TILE;               // ... and its small part
  const int heads_per_block = blockDim.x / (32 * W);
  const int first = blockIdx.x * heads_per_block + head;
  const int stride = gridDim.x * heads_per_block;
  const int items = first < n_heads ? (n_heads - first + stride - 1) / stride
                                    : 0;

  // item it's q, k, v and do into its stage by the head's threads; an empty
  // group past the last
  auto stage = [&](int it) {
    if (it < items) {
      const int bh = first + it * stride, b = bh / pr.heads, h = bh % pr.heads;
      bf16* dst = area + (it % RING) * 4 * TILE;
      const bf16* src[4] = {q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                            v + b * sv.b + h * sv.h,
                            dout + b * sdo.b + h * sdo.h};
      const long long ld[4] = {sq.s, sk.s, sv.s, sdo.s};
#pragma unroll
      for (int op = 0; op < 4; ++op)
#pragma unroll
        for (int e = tid; e < kShortMaxSeq * 4; e += 32 * W) {
          const int r = e >> 2, c = (e & 3) * 8;
          const bool in = r < seq;
          cp_async16_b(dst + op * TILE + r * P + c,
                       in ? src[op] + r * ld[op] + c : src[op], in ? 16 : 0);
        }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < RING; ++it) stage(it);

  for (int it = 0; it < items; ++it) {
    const int bh = first + it * stride, b = bh / pr.heads, h = bh % pr.heads;
    const long long row0 = static_cast<long long>(bh) * seq;
    const float lse_l = lane < seq ? in_base(lse[row0 + lane]) : 0.f;
    const float delta_l = lane < seq ? delta[row0 + lane] : 0.f;
    cp_async_wait<RING - 1>();
    head_sync<W>(head);   // every thread's copies of this stage are in
    bf16* qs = area + (it % RING) * 4 * TILE;
    bf16* ks = qs + TILE;
    bf16* vs = ks + TILE;
    bf16* dos = vs + TILE;
    if (W == 1 || wh == 0)
      bwd_mma_head<CAUSAL, 0>(pr, qs, ks, vs, dos, dsh, dsl, lse_l, delta_l,
                              head, lane);
    else if constexpr (W == 2)
      bwd_mma_head<CAUSAL, 1>(pr, qs, ks, vs, dos, dsh, dsl, lse_l, delta_l,
                              head, lane);
    __syncwarp();
    // the warp's whole rows out: dv from V's rows, dk from dO's, dq from
    // Q's
    bf16* dvg = dv + b * sdv.b + h * sdv.h;
    bf16* dkg = dk + b * sdk.b + h * sdk.h;
    bf16* dqg = dq + b * sdq.b + h * sdq.h;
    const int r0 = wh * ROWS, r1 = min(r0 + ROWS, seq);
    for (int e = lane; e < (r1 - r0) * 4; e += 32) {
      const int r = r0 + (e >> 2), c = (e & 3) * 8;
      *reinterpret_cast<uint4*>(dvg + r * sdv.s + c) =
          *reinterpret_cast<const uint4*>(vs + r * P + c);
      *reinterpret_cast<uint4*>(dkg + r * sdk.s + c) =
          *reinterpret_cast<const uint4*>(dos + r * P + c);
      *reinterpret_cast<uint4*>(dqg + r * sdq.s + c) =
          *reinterpret_cast<const uint4*>(qs + r * P + c);
    }
    head_sync<W>(head);   // this stage and dS^T's tiles are read: refill
    stage(it + RING);
  }
}

// ---------------------------------------------------------------------------
// the bf16 forward on the tensor cores: o and lse of a head
// ---------------------------------------------------------------------------

// The design's choices, each undone by a variant of
// tools/flash_attention_variants.py --fwd (H100, two calls; the round's
// 1,140 heads and the statistics pass's 2,280; base 0.0050-0.0051 and
// 0.0069-0.0073 ms). Staging and stores alone take 0.0038 and 0.0055: the
// time follows the instructions a head executes, not one warp's chain of
// dependent work (fewer instructions, not shorter chains, took the round
// from 0.0063 to 0.0050).
// - heads staged kFwdRing stages deep on a persistent grid
//   (kFwdPersistent): a block per `heads_per_block` heads is 8-10 % and
//   14-20 % slower; a ring of two, the next head's copies in flight while
//   the warps work on this one, 0-6 % and 7-13 % slower (the copies of
//   two heads share the card's bytes before the first head can start);
// - kFwdWarpsPerHead warps a head, each owning 32 / kFwdWarpsPerHead
//   queries: one is 6-10 % and 11-17 % slower;
// - the causal mask's hidden tiles skipped at compile time: multiplying
//   them is 4-10 % slower;
// - P's exponent in base 2 by ex2.approx.ftz (fwd_exp): expf is 4-9 %
//   slower, exp2f 1-9 %;
// - P V as kFwdParts bf16 products (2: P's bf16 rounding and the rounding
//   of what it left out; 1: the rounding alone, no faster, and 6e-4 to
//   8e-4 of scale beyond one bf16 ulp).
constexpr int kFwdRing = 1;
constexpr bool kFwdPersistent = true;
constexpr int kFwdWarpsPerHead = 2;
constexpr bool kFwdCausalSkip = true;
constexpr bool kFwdExp2 = true;
constexpr int kFwdParts = 2;
constexpr float kFwdLn2 = 0.6931471805599453f;

// a head's shared memory: kFwdRing stages of q, k and v
__host__ __device__ constexpr int fwd_mma_head_bytes() {
  return 2 * kMmaTile * 3 * kFwdRing;
}

// P's exponential: ex2.approx.ftz, exp2f's own MUFU.EX2 without the three
// instructions exp2f adds to keep a result below 2^-126 (which the forward
// flushes to 0: it adds under 2^-126 of l >= 1 to a row's sum), or expf
__device__ __forceinline__ float fwd_exp(float x) {
  if constexpr (kFwdExp2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return expf(x);
  }
}

// o and lse of one head's queries 16 MI0 .. 16 (MI0 + MT) - 1 from its
// staged tiles, by the warp that owns them (MT = 2 / kFwdWarpsPerHead
// m-tiles). Per m-tile m (rows r: queries 16 m + g + 8 h; columns c):
// - S = Q K^T, n-tiles n of 8 keys, from A fragments of Q and [n][k] B
//   fragments of K: exact bf16 products, f32 sums;
// - row r sees keys c in [lo_r, hi_r] (CAUSAL: hi_r = r; a window:
//   lo_r = r - window + 1; rows past S none): the others' scores become
//   -1e30; the row max m of the scores, then p = exp(s * scale - m *
//   scale) in P's exponent base (one fma: scale > 0, so m * scale is the
//   max of the scaled scores; exactly 0 where (r, c) is not visible) and
//   l = sum p, each over the lane's values then the quad's four lanes (xor
//   1, then xor 2);
// - P V from P's big and small bf16 parts, which in the accumulators'
//   layout are the A fragments of P V (k = keys: n-tiles 2 kk and 2 kk + 1
//   are k-step kk), and [k][n] B fragments of V by ldmatrix.trans: small
//   part then big part per k-step, into f32;
// - o = acc * (1 / max(l, 1e-30)), each element rounded once to bf16 into
//   the warp's own rows of Q (which no other warp reads), and lse =
//   m * scale + log(max(l, 1e-30)) for rows < S.
// Rows past S see no key and give garbage that is never stored; every
// other row sees its own key, so its max is a visible score. P is formed
// for every m-tile before V's fragments are loaded, so K's and V's are
// never live at once.
template <bool CAUSAL, int MI0>
__device__ __forceinline__ void fwd_mma_head(const Problem& pr, bf16* qs,
                                             const bf16* ks, const bf16* vs,
                                             float* lse, int lane) {
  constexpr int MT = 2 / kFwdWarpsPerHead, P = kMmaPitch;
  const int g = lane >> 2, c0 = 2 * (lane & 3);
  const float scale_b = kFwdExp2 ? pr.scale * kBwdLog2e : pr.scale;
  uint32_t pb[MT][2][4], ps[MT][2][4];   // P's A fragments, k-step kk
  float mx[MT][2], l[MT][2];
  {
    uint32_t fq[MT][2][4], fk[4][2][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4<false>(fq[mi][kk],
                           qs + (16 * (MI0 + mi) + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * P + 16 * kk +
                               (lane >> 4) * 8);
    b_frags_nk(fk, ks, lane);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = MI0 + mi;
      // the visible keys [lo, hi] of rows g and g + 8, less the lane's
      // first column c0
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        hi[h] = (r < pr.seq ? (CAUSAL ? r : pr.seq - 1) : -1) - c0;
        lo[h] = (pr.window > 0 ? r - pr.window + 1 : 0) - c0;
      }
      float s[4][4];
      mx[mi][0] = mx[mi][1] = kNegInf;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        if (tile_on<CAUSAL, kFwdCausalSkip>(16 * m, 16, 8 * n)) {
          mma_bf16(s[n], fq[mi][0], fk[n][0]);
          mma_bf16(s[n], fq[mi][1], fk[n][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + (e & 1), h = e >> 1;   // less c0
          s[n][e] = c >= lo[h] && c <= hi[h] ? s[n][e] : kNegInf;
          mx[mi][h] = fmaxf(mx[mi][h], s[n][e]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[mi][h] = fmaxf(mx[mi][h], __shfl_xor_sync(kFull, mx[mi][h], 1));
        mx[mi][h] = fmaxf(mx[mi][h], __shfl_xor_sync(kFull, mx[mi][h], 2));
        mx[mi][h] *= scale_b;   // the max scaled score
        l[mi][h] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // a tile the causal skip left out is all masked
        const bool on = tile_on<CAUSAL, kFwdCausalSkip>(16 * m, 16, 8 * n);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = on ? fwd_exp(fmaf(s[n][e], scale_b, -mx[mi][e >> 1]))
                    : 0.f;
          l[mi][e >> 1] += p[e];
        }
        const int kk = n >> 1, base = (n & 1) * 2;
        split_bf16x2(p[0], p[1], pb[mi][kk][base], ps[mi][kk][base]);
        split_bf16x2(p[2], p[3], pb[mi][kk][base + 1],
                     ps[mi][kk][base + 1]);
      }
    }
  }
  uint32_t fv[2][4][2], out[MT][4][2];
  b_frags_kn(fv, vs, lane);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m = MI0 + mi;
    float acc[4][4] = {}, inv[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (!tile_on<CAUSAL, kFwdCausalSkip>(16 * m, 16, 16 * kk)) continue;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (kFwdParts == 2) mma_bf16(acc[np], ps[mi][kk], fv[kk][np]);
        mma_bf16(acc[np], pb[mi][kk], fv[kk][np]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mi][h];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float denom = fmaxf(sum, 1e-30f);
      inv[h] = 1.f / denom;
      const int row = 16 * m + g + 8 * h;
      if (c0 == 0 && row < pr.seq)
        lse[row] = (kFwdExp2 ? mx[mi][h] * kFwdLn2 : mx[mi][h]) +
                   logf(denom);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        out[mi][np][h] = bf16x2_rn(acc[np][2 * h] * inv[h],
                                   acc[np][2 * h + 1] * inv[h]);
  }
  __syncwarp();   // every lane's fragments of Q are loaded
  pairs_to_tile<MI0, MT>(qs, out, lane);
}

// o and lse of one (batch, head) per kFwdWarpsPerHead warps, on bf16
// mma.sync m16n8k16 with f32 accumulators, at S <= 32 and D = 32: the
// arithmetic of fwd_mma_head. A block holds `heads_per_block` heads that
// share nothing; head slot w takes heads w, w + (the grid's head slots),
// ... (one each unless the grid is persistent), staging q, k and v as bf16
// by 16-byte cp.async into tiles of pitch kMmaPitch (rows past S
// zero-filled) in a ring of kFwdRing stages (of one: the next head's
// copies start when the warps are done with this one). The warps of a
// head share the staged K and V and meet twice a head: once the stage is
// in, and before it is refilled. Each warp stores its rows of o from its
// rows of Q as 16-byte rows.
template <bool CAUSAL>
__global__ void __launch_bounds__(32 * kFwdWarpsPerHead * kMaxHeadsPerBlock)
fwd_short_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, Problem pr, int n_heads) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  constexpr int RING = kFwdRing, P = kMmaPitch, TILE = kMmaTile;
  constexpr int W = kFwdWarpsPerHead, ROWS = 32 / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int head = warp / W, wh = warp % W, tid = threadIdx.x % (32 * W);
  const int seq = pr.seq;
  bf16* area = reinterpret_cast<bf16*>(mma_smem + head * fwd_mma_head_bytes());
  const int heads_per_block = blockDim.x / (32 * W);
  const int first = blockIdx.x * heads_per_block + head;
  const int stride = gridDim.x * heads_per_block;
  const int items = first < n_heads ? (n_heads - first + stride - 1) / stride
                                    : 0;
  // (batch, head) of the item to stage and of the item to compute, each
  // moved on by `stride` heads per item without a division
  const int step_b = stride / pr.heads, step_h = stride % pr.heads;
  int stage_b = first / pr.heads, stage_h = first % pr.heads;
  int b = stage_b, h = stage_h;
  auto advance = [&](int& bb, int& hh) {
    bb += step_b;
    hh += step_h;
    if (hh >= pr.heads) hh -= pr.heads, ++bb;
  };

  // item it's q, k and v into its stage by the head's threads (items in
  // order, one call each); an empty group past the last
  auto stage = [&](int it) {
    if (it < items) {
      const int sb = stage_b, sh = stage_h;
      advance(stage_b, stage_h);
      bf16* dst = area + (it % RING) * 3 * TILE;
      const bf16* src[3] = {q + sb * sq.b + sh * sq.h,
                            k + sb * sk.b + sh * sk.h,
                            v + sb * sv.b + sh * sv.h};
      const long long ld[3] = {sq.s, sk.s, sv.s};
#pragma unroll
      for (int op = 0; op < 3; ++op)
#pragma unroll
        for (int e = tid; e < kShortMaxSeq * 4; e += 32 * W) {
          const int r = e >> 2, c = (e & 3) * 8;
          const bool in = r < seq;
          cp_async16_b(dst + op * TILE + r * P + c,
                       in ? src[op] + r * ld[op] + c : src[op], in ? 16 : 0);
        }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < RING; ++it) stage(it);

  for (int it = 0; it < items; ++it, advance(b, h)) {
    cp_async_wait<RING - 1>();
    head_sync<W>(head);   // every thread's copies of this stage are in
    bf16* qs = area + (it % RING) * 3 * TILE;
    const bf16* ks = qs + TILE;
    const bf16* vs = ks + TILE;
    float* lse_h = lse + static_cast<long long>(first + it * stride) * seq;
    if (W == 1 || wh == 0)
      fwd_mma_head<CAUSAL, 0>(pr, qs, ks, vs, lse_h, lane);
    else if constexpr (W == 2)
      fwd_mma_head<CAUSAL, 1>(pr, qs, ks, vs, lse_h, lane);
    __syncwarp();
    // the warp's whole rows of o out of its rows of Q
    bf16* og = o + b * so.b + h * so.h;
    const int r0 = wh * ROWS, r1 = min(r0 + ROWS, seq);
    for (int e = lane; e < (r1 - r0) * 4; e += 32) {
      const int r = r0 + (e >> 2), c = (e & 3) * 8;
      *reinterpret_cast<uint4*>(og + r * so.s + c) =
          *reinterpret_cast<const uint4*>(qs + r * P + c);
    }
    head_sync<W>(head);   // every warp is done with this stage: refill
    stage(it + RING);
  }
}

// ---------------------------------------------------------------------------
// the tiled forward on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// rna_tf32, split_tf32 and mma_tf32 are twins of fused_linear.cu's (each
// source is built by its own nvcc, so they are copied, not shared).
//
// cvt.rna.tf32.f32 on the integer units: round the magnitude to 10
// mantissa bits, ties away from zero.
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

// c[j] += a * b[j] for N n-tiles in 3xTF32: small*big, big*small, then
// big*big (fused_linear.cu's order), each term over all n-tiles before the
// next, so the N chains interleave.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);
}

// Rows [r0, r0 + rows) of one head's operand (global row stride `ld`) into
// dst with row pitch `pitch`, by all the block's threads in VEC-byte
// copies; rows at or past seq are zero-filled. The chunks per row are a
// compile-time constant (a power of two but at D = 80), so a chunk's row
// and column cost a shift and a mask, or a multiply by a constant, not a
// division.
template <int D, int VEC>
__device__ __forceinline__ void stage_tile_by(float* dst, int pitch,
                                              const float* src, long long ld,
                                              int r0, int rows, int seq) {
  static_assert(VEC == 16 || VEC == 4, "f32 copies are 16 or 4 bytes");
  constexpr int kPer = VEC / 4, kChunks = D / kPer;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * kPer, gr = r0 + r;
    const bool in = gr < seq;
    const float* from = in ? src + gr * ld + c : src;
    if (VEC == 16)
      cp_async16(dst + r * pitch + c, from, in ? 16 : 0);
    else
      cp_async4(dst + r * pitch + c, from, in ? 4 : 0);
  }
}

// The bf16 operand's rows, widened into the same f32 rows by plain loads
// of VEC bytes; rows at or past seq are zero-filled.
template <int D, int VEC>
__device__ __forceinline__ void stage_tile_by(float* dst, int pitch,
                                              const bf16* src, long long ld,
                                              int r0, int rows, int seq) {
  constexpr int kPer = VEC / 2, kChunks = D / kPer;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * kPer, gr = r0 + r;
    if (gr < seq) {
      widen<VEC>(dst + r * pitch + c, src + gr * ld + c);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[r * pitch + c + i] = 0.f;
    }
  }
}

template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const T* src, long long ld,
                                           int r0, int rows, int seq,
                                           int vec) {
  if (vec == 16) {
    stage_tile_by<D, 16>(dst, pitch, src, ld, r0, rows, seq);
  } else if constexpr (sizeof(T) == 2) {
    if (vec == 2)
      stage_tile_by<D, 2>(dst, pitch, src, ld, r0, rows, seq);
    else
      stage_tile_by<D, 4>(dst, pitch, src, ld, r0, rows, seq);
  } else {
    stage_tile_by<D, 4>(dst, pitch, src, ld, r0, rows, seq);
  }
}

// Two neighbouring outputs of one row, each rounded once to T: as one pair
// store where `pair` (the plan's copy width allows it), else one by one.
__device__ __forceinline__ void store_pair(float* out, float v0, float v1,
                                           bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    out[0] = v0;
    out[1] = v1;
  }
}

__device__ __forceinline__ void store_pair(bf16* out, float v0, float v1,
                                           bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
  } else {
    out[0] = __float2bfloat16_rn(v0);
    out[1] = __float2bfloat16_rn(v1);
  }
}

constexpr int kTcRows = 16;   // query rows per warp: one m16 tile
// Tile sizes as measured (tools/flash_attention_variants.py): 64 keys and
// 64-column P V chunks (eight independent MMA chains, where four left the
// tensor cores waiting on their own results) beat 32 and 32 at causal
// 1024 and full 256; a ring of two beats one there (three do not fit in
// shared memory at D = 128).
constexpr int kTcKeys = 64;   // keys per tile: eight n8 tiles
constexpr int kTcN = kTcKeys / 8;
constexpr int kTcStages = 2;  // key/value tiles in the ring
constexpr int kTcPvN = 8;     // n8 tiles of d per P V chunk, at most
// Four warps, 64 query rows, per block: the warps share every key/value
// tile the block stages, and 64 rows beat 32 and 16 at every multi-tile
// shape of chip_smoke.py, even at full 256, where they leave 100 of the
// 132 SMs idle (32 blocks against 128 of 16 rows; PERF.md section 6).
constexpr int kTcWarps = 4;
constexpr int kTcQRows = kTcWarps * kTcRows;
// The tiled forward's softmax runs in base 2: s2 = (q . k) * scale *
// log2(e), p = exp2(s2 - m2), one MUFU.EX2 each where expf adds its own
// range reduction; lse = m2 * ln(2) + log(l).
constexpr float kTcLog2e = 1.4426950408889634f;
constexpr float kTcLn2 = 0.6931471805599453f;

__device__ __forceinline__ float tc_exp(float x) { return exp2f(x); }

// The tiled kernels take head dims that are multiples of 16 (HEAD_DIMS:
// 32, 64, 80, 128): a score stage of d is 32 wide, or 16 at the end of an
// odd multiple of 16 (D = 80: stages of 32, 32 and 16).
//
// The least row pitch >= D whose residue mod `mod` is `res` (a residue
// class, not D plus a constant, is what keeps loads free of bank conflicts).
__host__ __device__ constexpr int pitch_at(int d, int res, int mod) {
  return d + ((res - d % mod) % mod + mod) % mod;
}

// Pitches that keep every fragment load free of bank conflicts (see
// fused_linear.cu's warp_mma). Q and K are read as float2 pairs along d:
// lane (g, t) at row g, words 2t and 2t + 1, a half-warp (g = 0..3) at a
// time. With pitch = 8 mod 16 the four rows start at banks 8 x (g x odd
// mod 4), a permutation of 0, 8, 16, 24, so the 16 pairs fill the 32 banks
// once (D + 8 at every D = 0 mod 16: 8 mod 32 at D = 32, 64 and 128, 24 at
// D = 80). V is read as scalars along d at rows 2t and 2t + 1, column g:
// with pitch = 4 mod 8 the rows 2t start at banks 8 x (t x odd mod 4),
// again 0, 8, 16, 24 in some order, and g fills each group (D + 4: 4 mod
// 32, or 20 at D = 80).
template <int D>
struct TcPitch {
  static_assert(D % 16 == 0, "the tiled kernels take D = 0 mod 16");
  static constexpr int qk = pitch_at(D, 8, 16), v = pitch_at(D, 4, 8);
  static constexpr int stage = kTcKeys * (qk + v);  // one K and V tile
};

// n8 tiles of d per P V chunk: the most, up to kTcPvN, that divide D / 8,
// so no chunk runs past d (D = 80: two chunks of five). The chunks only
// group independent columns: each column's sum is the same in any of them.
template <int D>
__host__ __device__ constexpr int pv_chunk() {
  int nc = kTcPvN < D / 8 ? kTcPvN : D / 8;
  while ((D / 8) % nc) --nc;
  return nc;
}

// One warp, one key tile: the warp's 16 query rows (qs, staged) against
// keys [k0, k0 + kTcKeys) (ks, vs, staged). Fragments are mma.m16n8k8's:
// lane = 4 g + t; A (row g [+8], k-slot t [+4]), B (k-slot t [+4], col g),
// C (row g [+8], col 2t [+1]). K-slots t and t + 4 read physical k = 2t
// and 2t + 1 of the k-step, in A and B alike (a k-step's sum is the same
// in any order), so a Q or K pair along d is one float2 load, and a C
// fragment of S is, element for element, the A fragment of P for the
// k-step of its eight keys: P goes from the scores' registers to the P V
// product with no trip through shared memory.
//
// Order of the sums. S: per 32-wide stage of d (the last 16 wide at D =
// 80), its four k-steps (two) chained on the tensor cores (3 MMAs each),
// then added to S in f32. Then the online
// softmax per row, in base 2: m_new = max(m, tile max), alpha = exp2(m -
// m_new), p = exp2(s * (scale * log2 e) - m_new) (exactly 0 where masked),
// l = alpha * l + the row's sum of p (each lane's values in order, then
// across the quad's four lanes, xor 1 then xor 2). P V: per chunk of
// 8 * pv_chunk<D>() columns of d, the tile's k-steps chained on the
// tensor cores, then acc = fma(acc, alpha, that), so each tile's product
// reaches acc in
// one f32 add (chained MMAs drift, the tensor cores truncating what
// they accumulate: fused_linear.cu's flush).
template <int D>
__device__ __forceinline__ void tc_tile(const float* qs, const float* ks,
                                        const float* vs, const Problem& pr,
                                        int wq0, int k0, float (&acc)[D / 8][4],
                                        float (&m)[2], float (&l)[2]) {
  constexpr int PQK = TcPitch<D>::qk, PV = TcPitch<D>::v;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[kTcN][4] = {};
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 32) {
    float st[kTcN][4] = {};
#pragma unroll
    for (int kk = d0; kk < d0 + 32 && kk < D; kk += 8) {
      const float2 lo =
          *reinterpret_cast<const float2*>(qs + g * PQK + kk + 2 * t);
      const float2 hi =
          *reinterpret_cast<const float2*>(qs + (g + 8) * PQK + kk + 2 * t);
      uint32_t ab[4], as[4];
      split_tf32(lo.x, ab[0], as[0]);
      split_tf32(hi.x, ab[1], as[1]);
      split_tf32(lo.y, ab[2], as[2]);
      split_tf32(hi.y, ab[3], as[3]);
      uint32_t bb[kTcN][2], bs[kTcN][2];
#pragma unroll
      for (int j = 0; j < kTcN; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * PQK + kk + 2 * t);
        split_tf32(kv.x, bb[j][0], bs[j][0]);
        split_tf32(kv.y, bb[j][1], bs[j][1]);
      }
      mma_3xtf32(st, ab, as, bb, bs);
    }
#pragma unroll
    for (int j = 0; j < kTcN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += st[j][e];
  }

  // the online softmax of rows wq0 + g (r = 0) and wq0 + g + 8 (r = 1)
  const float scale2 = pr.scale * kTcLog2e;
  bool vis[kTcN][4];
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTcN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vis[j][e] = visible(pr, wq0 + g + 8 * (e >> 1),
                          k0 + 8 * j + 2 * t + (e & 1));
      s[j][e] = vis[j][e] ? s[j][e] * scale2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = tc_exp(m[r] - m_new);
    m[r] = m_new;
  }
  uint32_t pb[kTcN][4], ps[kTcN][4];  // P's A fragment, k-step j: keys 8j ..
#pragma unroll
  for (int j = 0; j < kTcN; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = vis[j][e] ? tc_exp(s[j][e] - m[e >> 1]) : 0.f;
      sum[e >> 1] += p[e];
    }
    // C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> A (g, t), (g+8, t),
    // (g, t+4), (g+8, t+4)
    split_tf32(p[0], pb[j][0], ps[j][0]);
    split_tf32(p[2], pb[j][1], ps[j][1]);
    split_tf32(p[1], pb[j][2], ps[j][2]);
    split_tf32(p[3], pb[j][3], ps[j][3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    l[r] = alpha[r] * l[r] + sum[r];
  }

  constexpr int NC = pv_chunk<D>();  // n-tiles per chunk
#pragma unroll
  for (int c = 0; c < D / 8; c += NC) {
    float st[NC][4] = {};
#pragma unroll
    for (int j = 0; j < kTcN; ++j) {
      uint32_t bb[NC][2], bs[NC][2];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          split_tf32(vs[(8 * j + 2 * t + hh) * PV + 8 * (c + n) + g],
                     bb[n][hh], bs[n][hh]);
      mma_3xtf32(st, pb[j], ps[j], bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c + n][e] = fmaf(acc[c + n][e], alpha[e >> 1], st[n][e]);
  }
}

// o and lse of one (batch*head, query tile): kTcWarps warps of 16 rows.
// The block stages its query rows once and the visible key tiles
// into a ring of kTcStages (the next tiles' copies in flight while the
// warps work on this one); a warp skips the tiles its own 16 rows cannot
// see.
// Query tiles run last first, so a causal mask's longest tiles start first.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kTcWarps)
fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
              Strides so, Problem pr, int vec) {
  constexpr int PQK = TcPitch<D>::qk, STAGE = TcPitch<D>::stage;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem;
  float* ring = qs + kTcQRows * PQK;  // stage i: K at ring + i * STAGE, then V
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcQRows;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  lse += static_cast<long long>(bh) * pr.seq;

  int lo, hi, wlo = 0, whi = 0;
  key_tiles(pr, q0, &lo, &hi, kTcQRows, kTcKeys);
  const int wq0 = q0 + warp * kTcRows;
  if (wq0 < pr.seq) key_tiles(pr, wq0, &wlo, &whi, kTcRows, kTcKeys);
  auto stage_kv = [&](int kt) {
    float* ks = ring + ((kt - lo) % kTcStages) * STAGE;
    stage_tile<D>(ks, PQK, k, sk.s, kt * kTcKeys, kTcKeys, pr.seq, vec);
    stage_tile<D>(ks + kTcKeys * PQK, TcPitch<D>::v, v, sv.s, kt * kTcKeys,
                  kTcKeys, pr.seq, vec);
    cp_async_commit();
  };
  // the query rows go with the first group; one group per tile, empty past
  // the last tile, so the count of groups in flight stays kTcStages - 1
  stage_tile<D>(qs, PQK, q, sq.s, q0, kTcQRows, pr.seq, vec);
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (lo + i < hi) stage_kv(lo + i);
    else cp_async_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = lo; kt < hi; ++kt) {
    // into the stage that tile kt - 1 left
    if (kt + kTcStages - 1 < hi) stage_kv(kt + kTcStages - 1);
    else cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncthreads();  // tile kt is in, for every thread's copies
    if (kt >= wlo && kt < whi) {
      const float* ks = ring + ((kt - lo) % kTcStages) * STAGE;
      tc_tile<D>(qs + warp * kTcRows * PQK, ks, ks + kTcKeys * PQK, pr, wq0,
                 kt * kTcKeys, acc, m, l);
    }
    __syncthreads();  // done with this stage before it is refilled
  }

  const int g = lane >> 2, t = lane & 3;
  // a pair of f32 needs 8-byte alignment (16-byte copies), of bf16 4-byte
  const bool pair = sizeof(T) == 4 ? vec == 16 : vec >= 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= pr.seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + row * so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(out + 8 * n, acc[n][2 * r] / denom,
                 acc[n][2 * r + 1] / denom, pair);
    if (t == 0) lse[row] = m[r] * kTcLn2 + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// the tiled backward on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// Design choices of the tiled backward, as measured at chip_smoke.py's
// tiled cases (tools/flash_attention_variants.py --tiled-bwd; PERF.md
// section 6): the forward's ring of kTcStages streamed tiles (with one, dq
// is 4-6 % slower at causal 1024, both within 2 % elsewhere); the blocks
// with the most tiles first (in grid order both are 35-41 % slower at
// causal 1024, 14-17 % at lm 4096); P in base 2 (expf 2-12 % slower);
// three TF32 products a k-step (one alone takes a quarter to a half less
// time but lies 5e-4 to 9e-4 of scale off, over FA_RTOL); from D =
// kTbSplitMinD two warps per 16 rows (TbSplit below; unsplit, D = 128
// spills 84 (dq) and 368 (dk/dv) bytes and is 1.2-1.3x and 2.0-2.4x
// slower).
constexpr int kTbSplitMinD = 128;
static_assert(kTcQRows == kTcKeys, "the backward's query and key tiles "
              "are one size");

// The pitch of every tile the backward stages, the least >= D that is 4
// mod 8 (D + 4: 4 mod 32, or 20 at D = 80): each operand is read two ways,
// and both are free of bank conflicts. Along d, as the scores' operand (A
// or B), lane (g, t) reads row g (+ 8, + 8j) at columns t and t + 4: rows
// g start at banks 4 x (g x odd mod 8), a permutation of 0, 4, .., 28, and
// t fills each group. Along rows, as the second product's B operand, it
// reads rows 2t and 2t + 1 at column g: rows 2t start at 8 x (t x odd mod
// 4), and g fills each group. (The forward's float2 loads along d want 8
// mod 16, under which the row reads of rows 2t and 2t + 2 collide.)
template <int D>
struct TbPitch {
  static_assert(D % 16 == 0, "the tiled kernels take D = 0 mod 16");
  static constexpr int p = pitch_at(D, 4, 8);
  static constexpr int tile = kTcKeys * p;  // floats of one staged tile
};

// At D = 128 a warp's accumulators alone take 64 (dq) or 128 (dk and dv)
// registers a lane, and the block's tiles about 200 KB of shared memory,
// so one block of 4 warps fits on an SM. There a block holds 8 warps: the
// two warps of each 16 rows take one half each of the streamed tile's 64
// rows (n8 tiles [j0, j0 + nj) of the scores, the same k-steps of the
// second product), so a warp holds half the scores' fragments, and the two
// partial accumulators are added (the second half's into the first's)
// through shared memory at the end.
template <int D>
struct TbSplit {
  static constexpr int split = D >= kTbSplitMinD ? 2 : 1;
  static constexpr int warps = kTcWarps * split;
  static constexpr int nj = kTcN / split;  // n8 tiles of a tile a warp
};

// p of a visible pair from its score s and its row's lse: exp(s * scale -
// lse), in base 2 as exp2(fma(s, scale2, -lse2)) with scale2 = scale *
// log2 e and lse2 = lse * log2 e (the forward's lse is a natural log), one
// MUFU.EX2 where expf adds its own range reduction.
__device__ __forceinline__ float tb_p(float s, float scale2, float lse2) {
  return exp2f(fmaf(s, scale2, -lse2));
}

// s (16 x 8NJ, C fragments: row g [+8], column 8j + 2t [+1]) = the warp's
// 16 rows of a against 8NJ rows of b, both of pitch TbPitch<D>::p, over d:
// per 32-wide stage of d (the last 16 wide at D = 80), its k-steps
// chained on the tensor cores, then added to s in f32 (tc_tile's order).
// K-slots t and t + 4 are columns t and t + 4 of the k-step, the mma's
// own layout.
template <int D, int NJ>
__device__ __forceinline__ void tb_scores(const float* a, const float* b,
                                          float (&s)[NJ][4]) {
  constexpr int P = TbPitch<D>::p;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 32) {
    float st[NJ][4] = {};
#pragma unroll
    for (int kk = d0; kk < d0 + 32 && kk < D; kk += 8) {
      uint32_t ab[4], as[4];
      split_tf32(a[g * P + kk + t], ab[0], as[0]);
      split_tf32(a[(g + 8) * P + kk + t], ab[1], as[1]);
      split_tf32(a[g * P + kk + t + 4], ab[2], as[2]);
      split_tf32(a[(g + 8) * P + kk + t + 4], ab[3], as[3]);
      uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split_tf32(b[(8 * j + g) * P + kk + t], bb[j][0], bs[j][0]);
        split_tf32(b[(8 * j + g) * P + kk + t + 4], bb[j][1], bs[j][1]);
      }
      mma_3xtf32(st, ab, as, bb, bs);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += st[j][e];
  }
}

// acc (16 x D) += x (16 x 8NJ, C fragments as tb_scores leaves them) times
// m (8NJ rows of pitch TbPitch<D>::p). x goes from its registers to the
// product: C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of n-tile j are A
// (g, t), (g, t+4), (g+8, t), (g+8, t+4) of k-step j, split into TF32
// parts here, so k-slots t and t + 4 are m's rows 2t and 2t + 1. Per chunk
// of pv_chunk<D>() n-tiles of d, the NJ k-steps chained on the tensor
// cores, then one f32 add into acc: a chain over every tile would drift
// (the tensor cores truncate what they accumulate).
template <int D, int NJ>
__device__ __forceinline__ void tb_product(const float (&x)[NJ][4],
                                           const float* m,
                                           float (&acc)[D / 8][4]) {
  constexpr int P = TbPitch<D>::p;
  constexpr int NC = pv_chunk<D>();  // n-tiles per chunk
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < D / 8; c += NC) {
    float st[NC][4] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(x[j][0], ab[0], as[0]);
      split_tf32(x[j][2], ab[1], as[1]);
      split_tf32(x[j][1], ab[2], as[2]);
      split_tf32(x[j][3], ab[3], as[3]);
      uint32_t bb[NC][2], bs[NC][2];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          split_tf32(m[(8 * j + 2 * t + hh) * P + 8 * (c + n) + g],
                     bb[n][hh], bs[n][hh]);
      mma_3xtf32(st, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c + n][e] += st[n][e];
  }
}

// The split blocks' partial sums: the second half's warps (half 1) hand
// their accumulators to the first's through `red` (lane-major, so a warp's
// stores and loads are consecutive), which add them to their own. Every
// thread of the block calls it; `red` may alias the ring, whose last tile
// every warp is done with.
template <int D>
__device__ __forceinline__ void tb_reduce(float* red, int rw, int half,
                                          float (&acc)[D / 8][4]) {
  float* mine = red + rw * (D / 2) * 32 + (threadIdx.x & 31);
  if (half) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (!half) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += mine[(4 * n + e) * 32];
  }
  __syncthreads();
}

// The warp's 16 output rows r0 + g (+ 8) of acc * mul, rounded once to T,
// as pairs along d where `pair` (the plan's copy width allows it).
template <typename T, int D>
__device__ __forceinline__ void tb_store(T* out, long long ld, int r0,
                                         int seq, const float (&acc)[D / 8][4],
                                         float mul, bool pair) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= seq) continue;
    T* o = out + row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(o + 8 * n, acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul,
                 pair);
  }
}

// Rows [r0, r0 + kTcQRows) of lse, then of delta, into dst by 4-byte
// copies; rows at or past seq are zero-filled.
__device__ __forceinline__ void stage_stats(float* dst, const float* lse,
                                            const float* delta, int r0,
                                            int seq) {
  for (int i = threadIdx.x; i < 2 * kTcQRows; i += blockDim.x) {
    const int r = r0 + (i & (kTcQRows - 1));
    const float* src = i < kTcQRows ? lse : delta;
    cp_async4(dst + i, r < seq ? src + r : src, r < seq ? 4 : 0);
  }
}

// dq of one (batch*head, 64-row query tile): TbSplit<D>::warps warps, 16
// rows each (and half of each key tile where split). The block stages its
// q and do rows once and streams the visible key tiles' k and v through a
// ring of kTcStages (the next tiles' copies in flight while the warps work
// on this one); a warp skips the tiles its own rows cannot see. Per tile
// and warp: S = Q K^T and dP = dO V^T (tb_scores), then in the same
// registers p = exp(s * scale - lse) (exactly 0 where masked) and dS = p *
// (dP - delta), and dq += dS K (tb_product, dS as its A fragments); dq =
// acc * scale at the store. The query tiles run last first, so a causal
// mask's longest tiles start first.
template <typename T, int D>
__global__ void __launch_bounds__(32 * TbSplit<D>::warps)
dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
             Strides sdo, Strides sdq, Problem pr, int vec) {
  constexpr int P = TbPitch<D>::p, TILE = TbPitch<D>::tile;
  constexpr int NJ = TbSplit<D>::nj;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % kTcWarps, half = warp / kTcWarps, j0 = half * NJ;
  float* qs = smem;
  float* dos = qs + TILE;
  float* ring = dos + TILE;  // stage i: K at ring + 2 i TILE, then V
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcQRows;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
  lse += static_cast<long long>(bh) * pr.seq;
  delta += static_cast<long long>(bh) * pr.seq;

  int lo, hi, wlo = 0, whi = 0;
  key_tiles(pr, q0, &lo, &hi, kTcQRows, kTcKeys);
  const int wq0 = q0 + rw * kTcRows;
  if (wq0 < pr.seq) key_tiles(pr, wq0, &wlo, &whi, kTcRows, kTcKeys);
  auto stage_kv = [&](int kt) {
    float* ks = ring + ((kt - lo) % kTcStages) * 2 * TILE;
    stage_tile<D>(ks, P, k, sk.s, kt * kTcKeys, kTcKeys, pr.seq, vec);
    stage_tile<D>(ks + TILE, P, v, sv.s, kt * kTcKeys, kTcKeys, pr.seq, vec);
    cp_async_commit();
  };
  // q and do go with the first group; one group per tile, empty past the
  // last tile, so the count of groups in flight stays kTcStages - 1
  stage_tile<D>(qs, P, q, sq.s, q0, kTcQRows, pr.seq, vec);
  stage_tile<D>(dos, P, dout, sdo.s, q0, kTcQRows, pr.seq, vec);
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (lo + i < hi) stage_kv(lo + i);
    else cp_async_commit();
  }

  // lse and delta of the rows wq0 + g (r = 0) and wq0 + g + 8 (r = 1)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    lse2[r] = row < pr.seq ? lse[row] * kTcLog2e : 0.f;
    dl[r] = row < pr.seq ? delta[row] : 0.f;
  }
  const float scale2 = pr.scale * kTcLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = lo; kt < hi; ++kt) {
    // into the stage that tile kt - 1 left
    if (kt + kTcStages - 1 < hi) stage_kv(kt + kTcStages - 1);
    else cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncthreads();  // tile kt is in, for every thread's copies
    if (kt >= wlo && kt < whi) {
      // the warp's keys: rows 8 j0 .. of the staged tile
      const float* ks = ring + ((kt - lo) % kTcStages) * 2 * TILE
                        + 8 * j0 * P;
      const int k0 = kt * kTcKeys + 8 * j0;
      float s[NJ][4], dp[NJ][4];
      tb_scores<D>(qs + rw * kTcRows * P, ks, s);
      tb_scores<D>(dos + rw * kTcRows * P, ks + TILE, dp);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = visible(pr, wq0 + g + 8 * r,
                                  k0 + 8 * j + 2 * t + (e & 1))
                              ? tb_p(s[j][e], scale2, lse2[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[r]);
        }
      tb_product<D>(s, ks, acc);
    }
    __syncthreads();  // done with this stage before it is refilled
  }
  if constexpr (TbSplit<D>::split == 2) tb_reduce<D>(ring, rw, half, acc);
  // a pair of f32 needs 8-byte alignment (16-byte copies), of bf16 4-byte
  const bool pair = sizeof(T) == 4 ? vec == 16 : vec >= 4;
  if (!half) tb_store<T, D>(dq, sdq.s, wq0, pr.seq, acc, pr.scale, pair);
}

// dk and dv of one (batch*head, 64-row key tile): TbSplit<D>::warps warps,
// 16 key rows each (and half of each query tile where split). The block
// stages its k and v rows once and streams the query tiles that see them
// (q, do, lse and delta) through a ring of kTcStages. The scores are taken
// transposed, rows keys and columns queries: S^T = K Q^T, P^T = exp(S^T *
// scale - lse) (exactly 0 where masked), dV += P^T dO; dP^T = V dO^T,
// dS^T = P^T * (dP^T - delta), dK += dS^T Q; P^T and dS^T are the A
// fragments of their products in the registers they were formed in. The
// key tiles run in order, so a causal mask's longest tiles (the first keys
// see every query) start first.
template <typename T, int D>
__global__ void __launch_bounds__(32 * TbSplit<D>::warps)
dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
               Strides sdo, Strides sdk, Strides sdv, Problem pr, int vec) {
  constexpr int P = TbPitch<D>::p, TILE = TbPitch<D>::tile;
  constexpr int NJ = TbSplit<D>::nj;
  constexpr int STAGE = 2 * TILE + 2 * kTcQRows;  // q, do, lse, delta
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % kTcWarps, half = warp / kTcWarps, j0 = half * NJ;
  float* ks = smem;
  float* vs = ks + TILE;
  float* ring = vs + TILE;
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int k0 = blockIdx.y * kTcKeys;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dk += b * sdk.b + h * sdk.h;
  dv += b * sdv.b + h * sdv.h;
  lse += static_cast<long long>(bh) * pr.seq;
  delta += static_cast<long long>(bh) * pr.seq;

  int lo, hi, wlo = 0, whi = 0;
  query_tiles(pr, k0, &lo, &hi, kTcKeys);
  const int wk0 = k0 + rw * kTcRows;
  if (wk0 < pr.seq) query_tiles(pr, wk0, &wlo, &whi, kTcRows);
  auto stage_q = [&](int qt) {
    float* qs = ring + ((qt - lo) % kTcStages) * STAGE;
    const int q0 = qt * kTcQRows;
    stage_tile<D>(qs, P, q, sq.s, q0, kTcQRows, pr.seq, vec);
    stage_tile<D>(qs + TILE, P, dout, sdo.s, q0, kTcQRows, pr.seq, vec);
    stage_stats(qs + 2 * TILE, lse, delta, q0, pr.seq);
    cp_async_commit();
  };
  // k and v go with the first group
  stage_tile<D>(ks, P, k, sk.s, k0, kTcKeys, pr.seq, vec);
  stage_tile<D>(vs, P, v, sv.s, k0, kTcKeys, pr.seq, vec);
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (lo + i < hi) stage_q(lo + i);
    else cp_async_commit();
  }

  const float scale2 = pr.scale * kTcLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  for (int qt = lo; qt < hi; ++qt) {
    if (qt + kTcStages - 1 < hi) stage_q(qt + kTcStages - 1);
    else cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncthreads();  // tile qt is in, for every thread's copies
    if (qt >= wlo && qt < whi) {
      // the warp's queries: rows 8 j0 .. of the staged tile
      const float* base = ring + ((qt - lo) % kTcStages) * STAGE;
      const float* qs = base + 8 * j0 * P;
      const float* dos = qs + TILE;
      const float* ls = base + 2 * TILE + 8 * j0;
      const float* ds = ls + kTcQRows;
      const int q0 = qt * kTcQRows + 8 * j0;
      float s[NJ][4], dp[NJ][4];
      tb_scores<D>(ks + rw * kTcRows * P, qs, s);
      // C (key g [+8], query 8j + 2t [+1])
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          s[j][e] = visible(pr, q0 + qc, wk0 + g + 8 * (e >> 1))
                        ? tb_p(s[j][e], scale2, ls[qc] * kTcLog2e)
                        : 0.f;
        }
      tb_product<D>(s, dos, dv_acc);
      tb_scores<D>(vs + rw * kTcRows * P, dos, dp);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - ds[8 * j + 2 * t + (e & 1)]);
      tb_product<D>(dp, qs, dk_acc);
    }
    __syncthreads();  // done with this stage before it is refilled
  }
  if constexpr (TbSplit<D>::split == 2) {
    tb_reduce<D>(ring, rw, half, dk_acc);
    tb_reduce<D>(ring, rw, half, dv_acc);
  }
  // a pair of f32 needs 8-byte alignment (16-byte copies), of bf16 4-byte
  const bool pair = sizeof(T) == 4 ? vec == 16 : vec >= 4;
  if (!half) {
    tb_store<T, D>(dk, sdk.s, wk0, pr.seq, dk_acc, pr.scale, pair);
    tb_store<T, D>(dv, sdv.s, wk0, pr.seq, dv_acc, 1.f, pair);
  }
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Above 48 KB a block's shared memory must be asked for explicitly: allow
// each kernel the card's opt-in maximum, once per process (the launch
// itself fails, and reports it, if a block asks for more). The tiled
// kernels' blocks are checked at compile time against the H100's 227 KB.
constexpr size_t kSmemOptin = 227 * 1024;
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

// The tiled backward: a block of TbSplit<D>::warps warps per
// (batch*head, 64-row tile), its two staged tiles and the ring in shared
// memory (dk/dv's ring
// stages carry the query tile's lse and delta too).
dim3 tb_grid(int batch, const Problem& pr) {
  return dim3(batch * pr.heads, (pr.seq + kTcQRows - 1) / kTcQRows);
}

template <typename T, int D>
int launch_dq_tc(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* delta, T* dq, int batch,
                 const long long* st, Problem pr, int vec,
                 cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (2 + 2 * kTcStages) * TbPitch<D>::tile;
  static_assert(smem <= kSmemOptin, "dq_tc_kernel's tiles exceed the card");
  static const cudaError_t attr = allow_max_smem(dq_tc_kernel<T, D>);
  if (attr != cudaSuccess) return attr;
  dq_tc_kernel<T, D><<<tb_grid(batch, pr), 32 * TbSplit<D>::warps, smem,
                      stream>>>(
      q, k, v, dout, lse, delta, dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), pr, vec);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv_tc(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, T* dk, T* dv,
                   int batch, const long long* st, Problem pr, int vec,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (2 * TbPitch<D>::tile + kTcStages *
                                           (2 * TbPitch<D>::tile +
                                            2 * kTcQRows));
  static_assert(smem <= kSmemOptin, "dkdv_tc_kernel's tiles exceed the card");
  static const cudaError_t attr = allow_max_smem(dkdv_tc_kernel<T, D>);
  if (attr != cudaSuccess) return attr;
  dkdv_tc_kernel<T, D><<<tb_grid(batch, pr), 32 * TbSplit<D>::warps, smem,
                        stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pr, vec);
  return cudaGetLastError();
}

// The short form's launch: a block of `hpb` warps, one per (batch, head),
// each with its own four staged operands.
dim3 short_grid(int batch, const Problem& pr, int hpb) {
  return dim3((batch * pr.heads + hpb - 1) / hpb);
}

// `operands` staged rows of kShortRows floats per warp
size_t short_smem_bytes(int hpb, int operands) {
  return sizeof(float) * operands * kShortRows * hpb;
}

template <typename T, int VEC>
int launch_fwd_short(const T* q, const T* k, const T* v, T* o, float* lse,
                     int batch, const long long* st, Problem pr, int hpb,
                     cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(fwd_short_kernel<T, VEC>);
  if (attr != cudaSuccess) return attr;
  fwd_short_kernel<T, VEC><<<short_grid(batch, pr, hpb), 32 * hpb,
                             short_smem_bytes(hpb, 3), stream>>>(
      q, k, v, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pr, batch * pr.heads);
  return cudaGetLastError();
}

// The tiled forward: a block per (batch*head, query tile), the query rows
// and the key/value ring in shared memory.
template <typename T, int D>
int launch_fwd_tc(const T* q, const T* k, const T* v, T* o, float* lse,
                  int batch, const long long* st, Problem pr, int vec,
                  cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (kTcQRows * TcPitch<D>::qk +
                                           kTcStages * TcPitch<D>::stage);
  static_assert(smem <= kSmemOptin, "fwd_tc_kernel's tiles exceed the card");
  static const cudaError_t attr = allow_max_smem(fwd_tc_kernel<T, D>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(batch * pr.heads, (pr.seq + kTcQRows - 1) / kTcQRows);
  fwd_tc_kernel<T, D><<<grid, 32 * kTcWarps, smem, stream>>>(
      q, k, v, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pr, vec);
  return cudaGetLastError();
}

template <typename T, int VEC>
int launch_dq_short(const T* q, const T* k, const T* v, const T* dout,
                    const float* lse, const float* delta, T* dq, int batch,
                    const long long* st, Problem pr, int hpb,
                    cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dq_short_kernel<T, VEC>);
  if (attr != cudaSuccess) return attr;
  dq_short_kernel<T, VEC><<<short_grid(batch, pr, hpb), 32 * hpb,
                            short_smem_bytes(hpb, 4), stream>>>(
      q, k, v, dout, lse, delta, dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), pr,
      batch * pr.heads);
  return cudaGetLastError();
}

template <typename T, int VEC>
int launch_dkdv_short(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dk, T* dv,
                      int batch, const long long* st, Problem pr, int hpb,
                      cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dkdv_short_kernel<T, VEC>);
  if (attr != cudaSuccess) return attr;
  dkdv_short_kernel<T, VEC><<<short_grid(batch, pr, hpb), 32 * hpb,
                              short_smem_bytes(hpb, 4), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pr, batch * pr.heads);
  return cudaGetLastError();
}

// The grid of a tensor-core short form: a block per `hpb` heads, or with
// `persistent` at most as many blocks as fit on the card at once (queried
// once per process and block size into the launcher's `wave`).
template <typename Kernel>
cudaError_t mma_grid(Kernel kernel, int n_heads, int hpb, int threads,
                     size_t smem, bool persistent,
                     int (&wave)[kMaxHeadsPerBlock + 1], int* blocks) {
  *blocks = (n_heads + hpb - 1) / hpb;
  if (!persistent) return cudaSuccess;
  if (wave[hpb] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    wave[hpb] = max(1, sms * per_sm);
  }
  *blocks = min(*blocks, wave[hpb]);
  return cudaSuccess;
}

// The bf16 backward on the tensor cores: a block of `hpb` heads of
// kBwdWarpsPerHead warps; with kBwdPersistent as many blocks as fit on the
// card at once, walking the heads.
template <bool CAUSAL>
int launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, bf16* dk, bf16* dv, int batch,
                   const long long* st, Problem pr, int hpb,
                   cudaStream_t stream) {
  static const cudaError_t attr =
      allow_max_smem(bwd_short_mma_kernel<CAUSAL>);
  if (attr != cudaSuccess) return attr;
  const int n_heads = batch * pr.heads, threads = 32 * kBwdWarpsPerHead * hpb;
  const size_t smem = static_cast<size_t>(hpb) * bwd_mma_head_bytes();
  static int wave[kMaxHeadsPerBlock + 1] = {};
  int blocks = 0;
  const cudaError_t err =
      mma_grid(bwd_short_mma_kernel<CAUSAL>, n_heads, hpb, threads, smem,
               kBwdPersistent, wave, &blocks);
  if (err != cudaSuccess) return err;
  bwd_short_mma_kernel<CAUSAL><<<blocks, threads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), strides_at(st, 6), pr, n_heads);
  return cudaGetLastError();
}

// The bf16 forward on the tensor cores: a block of `hpb` heads of
// kFwdWarpsPerHead warps; with kFwdPersistent as many blocks as fit on the
// card at once, walking the heads.
template <bool CAUSAL>
int launch_fwd_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int batch, const long long* st, Problem pr,
                   int hpb, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_max_smem(fwd_short_mma_kernel<CAUSAL>);
  if (attr != cudaSuccess) return attr;
  const int n_heads = batch * pr.heads, threads = 32 * kFwdWarpsPerHead * hpb;
  const size_t smem = static_cast<size_t>(hpb) * fwd_mma_head_bytes();
  static int wave[kMaxHeadsPerBlock + 1] = {};
  int blocks = 0;
  const cudaError_t err =
      mma_grid(fwd_short_mma_kernel<CAUSAL>, n_heads, hpb, threads, smem,
               kFwdPersistent, wave, &blocks);
  if (err != cudaSuccess) return err;
  fwd_short_mma_kernel<CAUSAL><<<blocks, threads, smem, stream>>>(
      q, k, v, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pr, n_heads);
  return cudaGetLastError();
}

// The plan's forms (kernel.py `_FORMS`): the tiled kernels, the short
// forms, the bf16 backward on the tensor cores.
constexpr int kFormTiled = 0, kFormShort = 1, kFormMma = 2;

// The plan's short forms run only where they apply; a 16-byte copy plan
// with a stride or pointer that is not 16-byte aligned is the caller's
// error (the plan checks both). The mma forms (bf16 on the tensor cores)
// run where the short form does, only with 16-byte copies. A block holds
// at most `max_hpb` heads: kMaxHeadsPerBlock, but the fused backward's
// blocks at most kMaxHeadsPerBlock warps.
template <typename T>
bool short_plan_ok(int form, int seq, int d, int hpb, int vec,
                   int max_hpb = kMaxHeadsPerBlock) {
  return (form == kFormShort ||
          (form == kFormMma && sizeof(T) == 2 && vec == 16)) &&
         d == kShortD && seq >= 1 && seq <= kShortMaxSeq && hpb >= 1 &&
         hpb <= max_hpb && vec_ok<T>(vec);
}

// The short form's launch at the plan's copy width: `launch(VEC)` is
// called with the width as a compile-time constant (2 for bf16 only).
template <typename T, typename Launch>
int by_vec(int vec, Launch launch) {
  if (vec == 16) return launch(std::integral_constant<int, 16>());
  if constexpr (sizeof(T) == 2)
    if (vec == 2) return launch(std::integral_constant<int, 2>());
  return launch(std::integral_constant<int, 4>());
}

template <typename T>
int fwd_entry(const T* q, const T* k, const T* v, T* o, float* lse,
              int batch, int heads, int seq, int d, const long long* strides,
              float scale, int causal, int window, int form,
              int heads_per_block, int vec, cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  if (form != kFormTiled) {
    if (!short_plan_ok<T>(form, seq, d, heads_per_block, vec))
      return cudaErrorInvalidValue;
    if (form == kFormMma) {
      if constexpr (std::is_same_v<T, bf16>)
        return causal ? launch_fwd_mma<true>(q, k, v, o, lse, batch, strides,
                                             pr, heads_per_block, stream)
                      : launch_fwd_mma<false>(q, k, v, o, lse, batch, strides,
                                              pr, heads_per_block, stream);
      return cudaErrorInvalidValue;
    }
    return by_vec<T>(vec, [&](auto w) {
      return launch_fwd_short<T, decltype(w)::value>(
          q, k, v, o, lse, batch, strides, pr, heads_per_block, stream);
    });
  }
  if (!vec_ok<T>(vec)) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_fwd_tc<T, 32>(q, k, v, o, lse, batch, strides, pr, vec, stream);
    case 64: return launch_fwd_tc<T, 64>(q, k, v, o, lse, batch, strides, pr, vec, stream);
    case 80: return launch_fwd_tc<T, 80>(q, k, v, o, lse, batch, strides, pr, vec, stream);
    case 128: return launch_fwd_tc<T, 128>(q, k, v, o, lse, batch, strides, pr, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dq_entry(const T* q, const T* k, const T* v, const T* dout,
             const float* lse, const float* delta, T* dq, int batch,
             int heads, int seq, int d, const long long* strides,
             float scale, int causal, int window, int form,
             int heads_per_block, int vec, cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  if (form != kFormTiled) {
    if (form != kFormShort ||
        !short_plan_ok<T>(form, seq, d, heads_per_block, vec))
      return cudaErrorInvalidValue;
    return by_vec<T>(vec, [&](auto w) {
      return launch_dq_short<T, decltype(w)::value>(
          q, k, v, dout, lse, delta, dq, batch, strides, pr,
          heads_per_block, stream);
    });
  }
  if (!vec_ok<T>(vec)) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_dq_tc<T, 32>(q, k, v, dout, lse, delta, dq, batch, strides, pr, vec, stream);
    case 64: return launch_dq_tc<T, 64>(q, k, v, dout, lse, delta, dq, batch, strides, pr, vec, stream);
    case 80: return launch_dq_tc<T, 80>(q, k, v, dout, lse, delta, dq, batch, strides, pr, vec, stream);
    case 128: return launch_dq_tc<T, 128>(q, k, v, dout, lse, delta, dq, batch, strides, pr, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dkdv_entry(const T* q, const T* k, const T* v, const T* dout,
               const float* lse, const float* delta, T* dk, T* dv, int batch,
               int heads, int seq, int d, const long long* strides,
               float scale, int causal, int window, int form,
               int heads_per_block, int vec, cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  if (form != kFormTiled) {
    if (form != kFormShort ||
        !short_plan_ok<T>(form, seq, d, heads_per_block, vec))
      return cudaErrorInvalidValue;
    return by_vec<T>(vec, [&](auto w) {
      return launch_dkdv_short<T, decltype(w)::value>(
          q, k, v, dout, lse, delta, dk, dv, batch, strides, pr,
          heads_per_block, stream);
    });
  }
  if (!vec_ok<T>(vec)) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_dkdv_tc<T, 32>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, vec, stream);
    case 64: return launch_dkdv_tc<T, 64>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, vec, stream);
    case 80: return launch_dkdv_tc<T, 80>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, vec, stream);
    case 128: return launch_dkdv_tc<T, 128>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes). Operands are (batch, heads, seq, d)
// with unit d stride, f32 (the entries without a suffix) or bf16 (`_bf16`:
// the same kernels' bf16 forms); `strides` holds (b, h, s) element strides
// per operand, in argument order. lse and delta are contiguous f32
// (batch*heads, seq) in both. window <= 0 means no window. Every entry
// also takes the launch plan (kernel.py `attention_plan`): form 1 runs the
// short form (seq <= 32, d = 32) with `heads_per_block` warps per block and
// `vec`-byte staging copies (16 needs every pointer and (b, h, s) stride
// 16-byte aligned; 2, one bf16 at a time, only in the bf16 forms), form 0
// the tiled kernels on the tensor cores with `vec`-byte copies by the same
// rule (heads_per_block unused). Form 2,
// bf16 on the tensor cores at seq <= 32, d = 32 with 16-byte copies and
// `heads_per_block` heads a block, is the bf16 forward's
// (flash_attention_fwd_bf16: fwd_short_mma_kernel) and the only form of
// the fused bf16 backward, flash_attention_bwd_bf16 (dq, dk and dv in one
// launch).
// Returns the CUDA error code of the launch (0 on success); the kernels
// run asynchronously on `stream`.
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   int batch, int heads, int seq, int d,
                                   const long long* strides, float scale,
                                   int causal, int window, int form,
                                   int heads_per_block, int vec,
                                   cudaStream_t stream) {
  return fwd_entry(q, k, v, o, lse, batch, heads, seq, d, strides, scale,
                   causal, window, form, heads_per_block, vec, stream);
}

extern "C" int flash_attention_fwd_bf16(const bf16* q, const bf16* k,
                                        const bf16* v, bf16* o, float* lse,
                                        int batch, int heads, int seq, int d,
                                        const long long* strides, float scale,
                                        int causal, int window,
                                        int form, int heads_per_block,
                                        int vec, cudaStream_t stream) {
  return fwd_entry(q, k, v, o, lse, batch, heads, seq, d, strides, scale,
                   causal, window, form, heads_per_block, vec, stream);
}

extern "C" int flash_attention_bwd_dq(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* delta,
                                      float* dq, int batch, int heads,
                                      int seq, int d,
                                      const long long* strides, float scale,
                                      int causal, int window, int form,
                                      int heads_per_block, int vec,
                                      cudaStream_t stream) {
  return dq_entry(q, k, v, dout, lse, delta, dq, batch, heads, seq, d,
                  strides, scale, causal, window, form,
                  heads_per_block, vec, stream);
}

extern "C" int flash_attention_bwd_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, bf16* dq, int batch, int heads,
    int seq, int d, const long long* strides, float scale, int causal,
    int window, int form, int heads_per_block, int vec,
    cudaStream_t stream) {
  return dq_entry(q, k, v, dout, lse, delta, dq, batch, heads, seq, d,
                  strides, scale, causal, window, form,
                  heads_per_block, vec, stream);
}

extern "C" int flash_attention_bwd_dkdv(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* delta,
                                        float* dk, float* dv, int batch,
                                        int heads, int seq, int d,
                                        const long long* strides,
                                        float scale, int causal, int window,
                                        int form, int heads_per_block,
                                        int vec, cudaStream_t stream) {
  return dkdv_entry(q, k, v, dout, lse, delta, dk, dv, batch, heads, seq, d,
                    strides, scale, causal, window, form,
                    heads_per_block, vec, stream);
}

extern "C" int flash_attention_bwd_dkdv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, bf16* dk, bf16* dv, int batch,
    int heads, int seq, int d, const long long* strides, float scale,
    int causal, int window, int form, int heads_per_block, int vec,
    cudaStream_t stream) {
  return dkdv_entry(q, k, v, dout, lse, delta, dk, dv, batch, heads, seq, d,
                    strides, scale, causal, window, form,
                    heads_per_block, vec, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv,
    int batch, int heads, int seq, int d, const long long* strides,
    float scale, int causal, int window, int form, int heads_per_block,
    int vec, cudaStream_t stream) {
  if (form != kFormMma ||
      !short_plan_ok<bf16>(form, seq, d, heads_per_block, vec,
                           kMaxHeadsPerBlock / kBwdWarpsPerHead))
    return cudaErrorInvalidValue;
  const Problem pr{heads, seq, scale, causal, window};
  return causal ? launch_bwd_mma<true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       batch, strides, pr, heads_per_block,
                                       stream)
                : launch_bwd_mma<false>(q, k, v, dout, lse, delta, dq, dk,
                                        dv, batch, strides, pr,
                                        heads_per_block, stream);
}
