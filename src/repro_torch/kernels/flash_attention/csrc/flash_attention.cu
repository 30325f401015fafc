// Flash attention, forward and the dq / dk-dv backward pair, f32 CUDA for
// Hopper (sm_90a).
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
// at S >= 64 it is bound by arithmetic, not by device memory. The work here
// is plain f32 FMA against the 67 TFLOP/s f32 rate. The tensor cores would
// take it as 3xTF32 (each operand split into a TF32 high part and a TF32
// remainder, three products summed in f32 per stage), which the fused
// linear kernels run within the reference's 1e-5 f32 contract; that form of
// the tiled kernels is not written yet. At the FL path's S <= 32 with
// D = 32 a head is far too small for a tile and the kernels are bound by
// latency: the backward pair runs its short form there (below).
//
// The tiled design. One block of 256 threads per (batch*head, 64-row
// tile); the TPU grid's sequential innermost axis becomes a loop inside the
// block over the other operand's 64-row tiles, with the running max,
// denominator and output accumulator kept in registers (forward), or the
// dq / dk / dv accumulators (backward). Tiles that a causal or window mask
// hides entirely are skipped, not run. Every tile sits in shared memory
// row-major with an odd row pitch (D + 1): thread (ty, tx) owns rows
// ty*4 .. ty*4+3 and columns tx + 16*c, so a warp reads one row by
// broadcast and 16 consecutive columns without bank conflicts. Row
// reductions (max, sum) run across the 16 lanes of a row with shuffles.
// Operands are (batch, head, seq, d) with any batch / head / seq strides
// and unit d stride, so the slot-batched (rows, seq, heads, d) projections
// are read in place; rows past the sequence end are masked on load and
// store, so any S runs. expf / logf throughout (no fast-math intrinsics).
//
// The short form of the backward pair (S <= 32, D = 32: every shape of the
// FL path). A 64-row tile there is half padding, and a block per head runs
// 2.2 waves of mostly idle threads behind 4-6 barriers. Instead one warp
// owns one (batch, head) and one lane owns one row: for dq lane i holds
// q_i, do_i and its dq accumulator in registers and walks the keys in order;
// for dk/dv lane j holds k_j, v_j and both accumulators and walks the
// queries in order. The other operand's rows are staged once in shared
// memory by cp.async (16-byte copies where the plan's `vec` allows) and
// read by broadcast; lse and delta come by shuffle or straight from global.
// A block holds `heads_per_block` warps (the plan's: one, which measured
// best) that share nothing, so there is no __syncthreads: each warp waits
// on its own copies and __syncwarp()s. Rows
// past S are neither copied nor multiplied (the loops end at S); masked
// pairs contribute exactly 0. Each warp writes its outputs to its own
// staging rows and stores them as whole rows with the other lanes.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // rows per thread
constexpr int kPitchP = kTile + 1;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;           // element strides; d is unit-stride
};

struct Problem {
  int heads, seq;
  float scale;
  int causal, window;          // window <= 0: no window
};

__device__ __forceinline__ bool visible(const Problem& pr, int q, int k) {
  return q < pr.seq && k < pr.seq && (!pr.causal || k <= q) &&
         (pr.window <= 0 || k > q - pr.window);
}

__device__ __forceinline__ int n_tiles(const Problem& pr) {
  return (pr.seq + kTile - 1) / kTile;
}

// key tiles [lo, hi) that hold a visible key for some row of the q tile
__device__ __forceinline__ void key_tiles(const Problem& pr, int q0, int* lo,
                                          int* hi) {
  const int q_last = min(q0 + kTile, pr.seq) - 1;
  *hi = pr.causal ? q_last / kTile + 1 : n_tiles(pr);
  *lo = pr.window > 0 ? max(0, q0 - pr.window + 1) / kTile : 0;
}

// query tiles [lo, hi) that see some key of the k tile
__device__ __forceinline__ void query_tiles(const Problem& pr, int k0,
                                            int* lo, int* hi) {
  const int k_last = min(k0 + kTile, pr.seq) - 1;
  *lo = pr.causal ? k0 / kTile : 0;
  *hi = pr.window > 0 ? min(n_tiles(pr), (k_last + pr.window - 1) / kTile + 1)
                      : n_tiles(pr);
}

// rows [row0, row0 + 64) of one (batch, head) operand into dst[64][D+1];
// rows past the sequence end read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int seq) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < seq ? src[row * row_stride + d] : 0.f;
  }
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[r][j] = sum_d a[(ty*4+r)][d] * b[(tx+16j)][d] over two [64][D+1] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx,
                                         float acc[kRows][4]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a[(ty * kRows + r) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
}

// acc[r][c] += sum_j p[(ty*4+r)][j] * m[j][(tx+16c)]: p is [64][65], m is
// [64][D+1]
template <int D>
__device__ __forceinline__ void tile_matmul(const float* p, const float* m,
                                            int ty, int tx,
                                            float acc[kRows][D / 16]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float mv[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) mv[c] = m[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pv = p[(ty * kRows + r) * kPitchP + j];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(pv, mv[c], acc[r][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
           Strides so, Problem pr) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* ps = vs + kTile * (D + 1);
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  lse += static_cast<long long>(bh) * pr.seq;

  load_tile<D>(qs, q, sq.s, q0, pr.seq);
  float m[kRows], l[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;
  }
  int lo, hi;
  key_tiles(pr, q0, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k, sk.s, k0, pr.seq);
    load_tile<D>(vs, v, sv.s, k0, pr.seq);
    __syncthreads();
    float s[kRows][4] = {};
    tile_dot<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + ty * kRows + r;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(pr, qi, k0 + tx + 16 * j);
        s[r][j] = vis[j] ? s[r][j] * pr.scale : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[r][j] - m_new) : 0.f;
        ps[(ty * kRows + r) * kPitchP + tx + 16 * j] = p;
        sum += p;
      }
      l[r] = alpha * l[r] + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    tile_matmul<D>(ps, vs, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi >= pr.seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      o[qi * so.s + tx + 16 * c] = acc[r][c] / denom;
    if (tx == 0) lse[qi] = m[r] + logf(denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdq, Problem pr) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 1);
  float* ks = dos + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* ps = vs + kTile * (D + 1);
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
  lse += static_cast<long long>(bh) * pr.seq;
  delta += static_cast<long long>(bh) * pr.seq;

  load_tile<D>(qs, q, sq.s, q0, pr.seq);
  load_tile<D>(dos, dout, sdo.s, q0, pr.seq);
  float lse_r[kRows], delta_r[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    lse_r[r] = qi < pr.seq ? lse[qi] : 0.f;
    delta_r[r] = qi < pr.seq ? delta[qi] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;
  }
  int lo, hi;
  key_tiles(pr, q0, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(ks, k, sk.s, k0, pr.seq);
    load_tile<D>(vs, v, sv.s, k0, pr.seq);
    __syncthreads();
    float s[kRows][4] = {}, dp[kRows][4] = {};
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + ty * kRows + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(pr, qi, k0 + tx + 16 * j)
                            ? expf(s[r][j] * pr.scale - lse_r[r]) : 0.f;
        ps[(ty * kRows + r) * kPitchP + tx + 16 * j] =
            p * (dp[r][j] - delta_r[r]);
      }
    }
    __syncthreads();
    tile_matmul<D>(ps, ks, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi >= pr.seq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dq[qi * sdq.s + tx + 16 * c] = acc[r][c] * pr.scale;
  }
}

// One block per (batch*head, 64-key tile); here the thread's rows are keys
// and its columns queries, so p^T and ds^T are formed directly and never
// transposed.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, Strides sq,
            Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
            Problem pr) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* ps = dos + kTile * (D + 1);
  float* lse_s = ps + kTile * kPitchP;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x, b = bh / pr.heads, h = bh % pr.heads;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dk += b * sdk.b + h * sdk.h;
  dv += b * sdv.b + h * sdv.h;
  lse += static_cast<long long>(bh) * pr.seq;
  delta += static_cast<long long>(bh) * pr.seq;

  load_tile<D>(ks, k, sk.s, k0, pr.seq);
  load_tile<D>(vs, v, sv.s, k0, pr.seq);
  float dk_acc[kRows][D / 16], dv_acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  int lo, hi;
  query_tiles(pr, k0, &lo, &hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(qs, q, sq.s, q0, pr.seq);
    load_tile<D>(dos, dout, sdo.s, q0, pr.seq);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < pr.seq ? lse[qi] : 0.f;
      delta_s[threadIdx.x] = qi < pr.seq ? delta[qi] : 0.f;
    }
    __syncthreads();
    // st[r][j]: key ty*4+r against query tx+16j
    float st[kRows][4] = {}, dpt[kRows][4] = {};
    tile_dot<D>(ks, qs, ty, tx, st);
    tile_dot<D>(vs, dos, ty, tx, dpt);
    float p[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = k0 + ty * kRows + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        p[r][j] = visible(pr, q0 + qc, kj)
                      ? expf(st[r][j] * pr.scale - lse_s[qc]) : 0.f;
        ps[(ty * kRows + r) * kPitchP + qc] = p[r][j];
      }
    }
    __syncthreads();
    tile_matmul<D>(ps, dos, ty, tx, dv_acc);       // dv += p^T do
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        ps[(ty * kRows + r) * kPitchP + qc] =
            p[r][j] * (dpt[r][j] - delta_s[qc]);
      }
    __syncthreads();
    tile_matmul<D>(ps, qs, ty, tx, dk_acc);        // dk += ds^T q
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + ty * kRows + r;
    if (kj >= pr.seq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[kj * sdk.s + tx + 16 * c] = dk_acc[r][c] * pr.scale;
      dv[kj * sdv.s + tx + 16 * c] = dv_acc[r][c];
    }
  }
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
// issues all its copies before it waits on any. Both widths allocate in L1
// (.ca): the 16-byte copies measured faster that way than with L1 bypassed
// (.cg) at the FL round's shape, and no slower at the statistics pass's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, seq) of one head's operand (global row stride `ld`) into
// dst[seq][kShortPitch], copied by the warp's 32 lanes: 8 lanes per row in
// 16-byte pieces, or a lane per column in 4-byte pieces.
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld, int seq, int lane) {
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

// (a . x, b . y) for register rows a, b and a broadcast shared row pair
// x, y: four partial sums each over d = m (mod 4), in order of d, summed
// pairwise at the end, so the dependent chains are 8 FMAs long.
__device__ __forceinline__ float2 dot2(const float (&a)[kShortD],
                                       const float (&b)[kShortD],
                                       const float* x, const float* y) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kShortD / 4; ++c) {
    const float4 xv = x4[c], yv = y4[c];
    s[0] = fmaf(a[4 * c], xv.x, s[0]);
    s[1] = fmaf(a[4 * c + 1], xv.y, s[1]);
    s[2] = fmaf(a[4 * c + 2], xv.z, s[2]);
    s[3] = fmaf(a[4 * c + 3], xv.w, s[3]);
    t[0] = fmaf(b[4 * c], yv.x, t[0]);
    t[1] = fmaf(b[4 * c + 1], yv.y, t[1]);
    t[2] = fmaf(b[4 * c + 2], yv.z, t[2]);
    t[3] = fmaf(b[4 * c + 3], yv.w, t[3]);
  }
  return make_float2((s[0] + s[1]) + (s[2] + s[3]),
                     (t[0] + t[1]) + (t[2] + t[3]));
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

// dq of one (batch, head) per warp: lane i walks keys j = 0 .. S-1 with
// p = exp(q_i . k_j * scale - lse_i) (0 where masked), ds = p * (do_i . v_j
// - delta_i), dq_i += ds * k_j; stores dq_i * scale.
template <int VEC>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock, 1)
dq_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
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
template <int VEC>
__global__ void __launch_bounds__(32 * kMaxHeadsPerBlock, 1)
dkdv_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
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

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
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

dim3 grid_of(int batch, int heads, int seq) {
  return dim3(batch * heads, (seq + kTile - 1) / kTile);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int batch, const long long* st, Problem pr,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kTile * (D + 1) + kTile * kPitchP);
  static const cudaError_t attr = allow_max_smem(fwd_kernel<D>);
  if (attr != cudaSuccess) return attr;
  fwd_kernel<D><<<grid_of(batch, pr.heads, pr.seq), kThreads, smem, stream>>>(
      q, k, v, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pr);
  return cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int batch, const long long* st, Problem pr,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + kTile * kPitchP);
  static const cudaError_t attr = allow_max_smem(dq_kernel<D>);
  if (attr != cudaSuccess) return attr;
  dq_kernel<D><<<grid_of(batch, pr.heads, pr.seq), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), pr);
  return cudaGetLastError();
}

template <int D>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dk, float* dv, int batch, const long long* st,
                Problem pr, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * kTile * (D + 1) + kTile * kPitchP + 2 * kTile);
  static const cudaError_t attr = allow_max_smem(dkdv_kernel<D>);
  if (attr != cudaSuccess) return attr;
  dkdv_kernel<D><<<grid_of(batch, pr.heads, pr.seq), kThreads, smem,
                   stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pr);
  return cudaGetLastError();
}

// The short form's launch: a block of `hpb` warps, one per (batch, head),
// each with its own four staged operands.
dim3 short_grid(int batch, const Problem& pr, int hpb) {
  return dim3((batch * pr.heads + hpb - 1) / hpb);
}

size_t short_smem_bytes(int hpb) {
  return sizeof(float) * 4 * kShortRows * hpb;
}

template <int VEC>
int launch_dq_short(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* dq, int batch, const long long* st, Problem pr,
                    int hpb, cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dq_short_kernel<VEC>);
  if (attr != cudaSuccess) return attr;
  dq_short_kernel<VEC><<<short_grid(batch, pr, hpb), 32 * hpb,
                         short_smem_bytes(hpb), stream>>>(
      q, k, v, dout, lse, delta, dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), pr,
      batch * pr.heads);
  return cudaGetLastError();
}

template <int VEC>
int launch_dkdv_short(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dk, float* dv, int batch,
                      const long long* st, Problem pr, int hpb,
                      cudaStream_t stream) {
  static const cudaError_t attr = allow_max_smem(dkdv_short_kernel<VEC>);
  if (attr != cudaSuccess) return attr;
  dkdv_short_kernel<VEC><<<short_grid(batch, pr, hpb), 32 * hpb,
                           short_smem_bytes(hpb), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pr, batch * pr.heads);
  return cudaGetLastError();
}

// The plan's short form runs only where it applies; a 16-byte copy plan
// with a stride or pointer that is not 16-byte aligned is the caller's
// error (the plan checks both).
bool short_plan_ok(int seq, int d, int hpb, int vec) {
  return d == kShortD && seq >= 1 && seq <= kShortMaxSeq && hpb >= 1 &&
         hpb <= kMaxHeadsPerBlock && (vec == 4 || vec == 16);
}

}  // namespace

// C interface (loaded with ctypes). Operands are (batch, heads, seq, d)
// f32 with unit d stride; `strides` holds (b, h, s) element strides per
// operand, in argument order. lse and delta are contiguous (batch*heads,
// seq). window <= 0 means no window. The backward pair also takes the
// launch plan (kernel.py `attention_plan`): short_form != 0 runs the
// short form (seq <= 32, d = 32) with `heads_per_block` warps per block
// and `vec`-byte staging copies (16 needs every pointer and (b, h, s)
// stride 16-byte aligned), else the 64-row tiled kernels. Returns the CUDA
// error code of the launch (0 on success); the kernels run asynchronously
// on `stream`.
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   int batch, int heads, int seq, int d,
                                   const long long* strides, float scale,
                                   int causal, int window,
                                   cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  switch (d) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, batch, strides, pr, stream);
    case 64: return launch_fwd<64>(q, k, v, o, lse, batch, strides, pr, stream);
    case 128: return launch_fwd<128>(q, k, v, o, lse, batch, strides, pr, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dq(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* delta,
                                      float* dq, int batch, int heads,
                                      int seq, int d,
                                      const long long* strides, float scale,
                                      int causal, int window, int short_form,
                                      int heads_per_block, int vec,
                                      cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  if (short_form) {
    if (!short_plan_ok(seq, d, heads_per_block, vec))
      return cudaErrorInvalidValue;
    return vec == 16
        ? launch_dq_short<16>(q, k, v, dout, lse, delta, dq, batch, strides, pr, heads_per_block, stream)
        : launch_dq_short<4>(q, k, v, dout, lse, delta, dq, batch, strides, pr, heads_per_block, stream);
  }
  switch (d) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, batch, strides, pr, stream);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, strides, pr, stream);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, strides, pr, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkdv(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* delta,
                                        float* dk, float* dv, int batch,
                                        int heads, int seq, int d,
                                        const long long* strides,
                                        float scale, int causal, int window,
                                        int short_form, int heads_per_block,
                                        int vec, cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  if (short_form) {
    if (!short_plan_ok(seq, d, heads_per_block, vec))
      return cudaErrorInvalidValue;
    return vec == 16
        ? launch_dkdv_short<16>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, heads_per_block, stream)
        : launch_dkdv_short<4>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, heads_per_block, stream);
  }
  switch (d) {
    case 32: return launch_dkdv<32>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    case 64: return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    case 128: return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    default: return cudaErrorInvalidValue;
  }
}
