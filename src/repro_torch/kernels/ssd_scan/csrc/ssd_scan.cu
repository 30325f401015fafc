// Mamba-2 SSD chunked scan, forward and backward, CUDA for Hopper (sm_90a),
// on f32 or bf16 operands.
//
// The forward replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py:77 `ssd_scan`: for each batch row
// and head, over chunks of Q steps,
//   cum      = inclusive cumsum of dt * a          (a = -exp(a_log))
//   y_intra  = sum_{k<=q} (c_q . b_k) exp(cum_q - cum_k) dt_k x_k
//   y_inter  = exp(cum_q) c_q . h                   (h: state before chunk)
//   h        = h exp(cum_last) + sum_k b_k (exp(cum_last - cum_k) dt_k x_k)
// and y = y_intra + y_inter. Two forms: the FMA form (ssd_kernel<T, TA>,
// below) for every shape, and for bf16 at the FL path's shape (chunk 32,
// ds 16, p 32) the tensor-core form (ssd_mma_kernel, further down).
//
// The backward (ssd_bwd_kernel<T>, ssd_bwd_sum_kernel<T>, at the end) has
// no Pallas counterpart: the reference's op takes jax.vjp through its
// sequential oracle (src/repro/kernels/ssd_scan/ops.py:64 `_ssd_bwd`),
// which XLA compiles into one scan. It is the adjoint of that recurrence,
// the exact adjoint of the chunked forward.
//
// What bounds it on an H100: per chunk and head it does about
// Q^2 (ds + p) + 2 Q ds p FMAs on Q (p + ds + ds + 1) inputs, a few tens of
// operations per byte at the FL path's shapes (Q = 32, ds = 16, p = 32):
// neither memory nor the f32 rate is the limit there, latency is. A block's
// serial chain (one chunk after another, and inside a chunk the steps that
// wait on each other) sets the time.
//
// The design. A block takes one batch row and `heads` heads (up to 4 share
// the row's staged c and b and its Q x Q score matrix c b^T: n_groups = 1).
// Per chunk: the block stages c, b and every head's x and dt with cp.async
// (every copy in flight at once; warps over rows, lanes over columns: no
// index division), computes the scores, and
// one warp per head runs the cumsum as an inclusive warp scan
// (__shfl_up_sync, in a fixed order, 32 steps at a time) and forms the
// end-of-chunk weights exp(cum_last - cum_q) dt_q, one per lane. Then the
// block builds each head's decayed weights W[k][q] = (c_q . b_k)
// exp(cum_q - cum_k) dt_k once (the difference is exponentiated, never
// exp(cum_q) / exp(cum_k), which overflows over a long chunk; cum is kept
// in log2 units for exp2f), and its warps share out independent tasks:
// - output tiles (head, 32 steps, 32 of p): lane p owns column p and keeps
//   the 32 steps' outputs in registers, adding W[k][q] x_k[p] by FMA from
//   registers with W read as broadcast float4s; the diagonal block's
//   triangle is skipped at compile time; the stores are coalesced rows.
//   The inter term exp(cum_q) c_q . h is added the same way, and only where
//   the state is not zero;
// - state tiles (head, 32 of ds, 32 of p), after a row's every chunk but
//   its last: lane p keeps 32 state entries in registers.
// No step runs on one thread alone and no barrier separates heads: a chunk
// costs five block barriers whatever the number of heads. The products are
// K = 16-64 deep and run as FMA from registers, not on the tensor cores:
// the intra product, the one a tensor-core form would shorten, is about a
// fifth of the FL round's time, staging and the weight build as much again
// (tools/ssd_scan_variants.py).
//
// Where rows x head blocks cannot fill the card and there are several
// chunks (long sequences, few rows), the kernel runs Mamba-2's three-pass
// form instead of walking the chunks in order: (1) each (row, head, chunk)
// block computes its chunk's own end state from zero and its total decay
// exp(cum_last); (2) ssd_chunk_scan_kernel walks the chunks in order per
// state entry, h_in[c + 1] = h_in[c] exp(cum_last[c]) + state[c], writing
// each chunk's incoming state; (3) each (row, head, chunk) block computes
// its outputs from its incoming state. The plan (kernel.ssd_plan, pure
// Python) picks the form, the heads per block and the warps.
//
// a_log arrives per slot: row r reads slot r / rows_per_slot with the
// slot's stride (0 when every row shares one a_log), so nothing is
// materialised per row. x, dt, b and c are read through their row and
// step strides (the slot-batched model hands in split views); y is
// contiguous. expf for the rates, exp2f on log2-scaled cumsums for the
// decays (no fast-math flags).
//
// bf16 in the FMA form. The kernel is a template on the type T of x, b, c
// and y (float or __nv_bfloat16), as the Pallas kernel takes any operand
// dtype: it upcasts on load, computes in f32 and writes y in x's dtype. For
// T = bf16 x, b and c are staged by plain loads of 16, 4 or 2 bytes (the
// plan's copy widths), widened with __bfloat162float into the same f32
// tiles the f32 form fills by cp.async; y is rounded once at its store
// (__float2bfloat16_rn). a_log is read in its own dtype (f32, or bf16 as
// a cast param is), so a call is one launch; dt, the decays, the chunk
// states and the chunk scan stay f32 in both dtypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;   // steps, state rows or p columns per task
// Blocks of up to 4 warps, five of them resident per SM: the FL round's 570
// (row, 4 heads) blocks fit in one wave of 660 (at most 102 registers).
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 5;

enum Pass { kSequential = 0, kChunkStates = 1, kChunkOutputs = 2 };

using bf16 = __nv_bfloat16;

template <typename T>
struct Args {
  const T* x;          // (B, S, n, p)
  const float* dt;     // (B, S, n)
  const void* a_log;   // (slots, n), f32 or (a_bf16) bf16
  const T* b;          // (B, S, ds)
  const T* c;          // (B, S, ds)
  T* y;                // (B, S, n, p), contiguous
  float* states;       // (B, n, chunks, ds, p): chunk-parallel scratch
  float* decays;       // (B, n, chunks)
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sa_slot;
  int seq, n, p, ds, chunk, heads, rows_per_slot, chunks;
  int vec_x, vec_bc;   // copy widths in bytes of x, and of b and c: 16 or
                       // 4, or (bf16) 2
  int a_bf16;          // a_log is bf16 (else f32)
  int batch;
};

inline __host__ __device__ int round4(int v) { return (v + 3) & ~3; }
inline __host__ __device__ int round32(int v) { return (v + 31) & ~31; }

// Shared memory, in floats. Once per block: c and b (rows of pitch CSP,
// DSP: ds rounded up to 4, and CSP 4 mod 8 so that lane q's float4 reads of
// row q are conflict-free; QR rows of c, QR = Q rounded up to 32) and the
// scores c b^T transposed (QR rows of pitch QR). Per head: x (QR rows of
// pitch PP = p rounded up to 4), the decayed weights W transposed (QR x
// QR), the state (ds rows of pitch PP; only where a state enters a chunk),
// dt, the cumsum in log2 units and the end-of-chunk weights (QR each), and
// the chunk's total decay. Every row is 16-byte aligned for cp.async; pad
// rows and columns stay zero.
struct Layout {
  int qr, pp, dsp, csp, cs, bs, sc, xs, ws, hs, dts, cum, wk, dec, total;
};

inline __host__ __device__ Layout layout(int q, int p, int ds, int heads,
                                         bool state) {
  Layout l;
  l.qr = round32(q);
  l.pp = round4(p);
  l.dsp = round4(ds);
  l.csp = l.dsp | 4;
  l.cs = 0;
  l.bs = l.cs + l.qr * l.csp;
  l.sc = l.bs + q * l.dsp;
  l.xs = l.sc + l.qr * l.qr;
  l.ws = l.xs + heads * l.qr * l.pp;
  l.hs = l.ws + heads * l.qr * l.qr;
  l.dts = l.hs + (state ? heads * ds * l.pp : 0);
  l.cum = l.dts + heads * l.qr;
  l.wk = l.cum + heads * l.qr;
  l.dec = l.wk + heads * l.qr;
  l.total = round4(l.dec + heads);
  return l;
}

constexpr float kLog2e = 1.4426950408889634f;

// *dst = *src, copied from global to shared memory without a register
// round trip: a thread issues all its copies before it waits for any, so
// staging pays the load latency once and not once per loop trip.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Stage `rows` rows of `cols` floats (global row stride ld) at pitch `pitch`
// with the whole block: 16-byte copies where vec says the rows allow them.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, long long ld,
                                           int rows, int cols, int vec) {
  if (vec == 16) {
    const int per = cols >> 2;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) << 2;
      cp_async16(dst + r * pitch + c, src + r * ld + c);
    }
  } else {
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5)
      for (int c = threadIdx.x & 31; c < cols; c += 32)
        cp_async4(dst + r * pitch + c, src + r * ld + c);
  }
}

// The bf16 operand's rows, widened into the same f32 tiles by plain loads
// of vec bytes (8, 2 or 1 elements) with the whole block.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const bf16* src, long long ld,
                                           int rows, int cols, int vec) {
  if (vec == 16) {
    const int per = cols >> 3;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) << 3;
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * ld + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]);
      const float2 f3 = __bfloat1622float2(h[3]);
      float4* d = reinterpret_cast<float4*>(dst + r * pitch + c);
      d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  } else if (vec == 4) {
    const int per = cols >> 1;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) << 1;
      *reinterpret_cast<float2*>(dst + r * pitch + c) = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + r * ld + c));
    }
  } else {
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5)
      for (int c = threadIdx.x & 31; c < cols; c += 32)
        dst[r * pitch + c] = __bfloat162float(src[r * ld + c]);
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// element i of a tensor of f32 (is_bf16 = 0) or bf16, as f32
__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// an f32 result in y's type: rounded once, to nearest even
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Inclusive cumsum of dt * rate over one head's chunk as warp scans of 32
// steps (a fixed order), kept in log2 units, then the end-of-chunk weights
// exp(cum_last - cum_q) dt_q, one per lane; returns cum_last (log2 units).
// Run by one whole warp.
__device__ float warp_scan(const float* dts, float* cum2, float* wk,
                           float rate, int Q) {
  const int lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    float v = q < Q ? dts[q] * rate : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (q < Q) cum2[q] = v * kLog2e;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  const float last = carry * kLog2e;
  __syncwarp();
  for (int q = lane; q < Q; q += 32) wk[q] = exp2f(last - cum2[q]) * dts[q];
  return last;
}

// acc[qq] += sum over 32 steps k of W[k][qq] x_k, lane p holding x_k's
// column p: w points at W's row k0, column q0 (pitch QR), x at x's row k0,
// the lane's column (pitch PP). On the diagonal block W[k][q] = 0 for
// q < k, so each k's columns start at its own 4-aligned position: the
// triangle is skipped at compile time.
template <bool DIAG>
__device__ __forceinline__ void intra_block(float (&acc)[kTile],
                                            const float* w, int QR,
                                            const float* x, int PP) {
#pragma unroll
  for (int kk = 0; kk < kTile; ++kk) {
    const float xk = x[kk * PP];
#pragma unroll
    for (int qq = DIAG ? (kk & ~3) : 0; qq < kTile; qq += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + kk * QR + qq);
      acc[qq] = fmaf(v.x, xk, acc[qq]);
      acc[qq + 1] = fmaf(v.y, xk, acc[qq + 1]);
      acc[qq + 2] = fmaf(v.z, xk, acc[qq + 2]);
      acc[qq + 3] = fmaf(v.w, xk, acc[qq + 3]);
    }
  }
}

// T: x, b, c and y; TA: a_log (float or bf16)
template <typename T, typename TA>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ssd_kernel(const Args<T> a, int pass) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.chunk, P = a.p, DS = a.ds, H = a.heads;
  // a state enters some chunk: the sequential walk over several chunks, or
  // the outputs of the chunk-parallel form
  const bool state =
      pass == kChunkOutputs || (pass == kSequential && a.chunks > 1);
  const Layout L = layout(Q, P, DS, H, state);
  const int QR = L.qr, PP = L.pp, DSP = L.dsp, CSP = L.csp;
  float* cs = smem + L.cs;
  float* bs = smem + L.bs;
  float* sc = smem + L.sc;
  const int row = blockIdx.x, h0 = blockIdx.y * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* x = a.x + row * a.sx_b;
  const float* dt = a.dt + row * a.sdt_b;
  const T* bg = a.b + row * a.sb_b;
  const T* cg = a.c + row * a.sc_b;
  const TA* a_log = static_cast<const TA*>(a.a_log) +
                   (row / a.rows_per_slot) * a.sa_slot;
  T* y = a.y + static_cast<long long>(row) * a.seq * a.n * P;
  const int cbeg = pass == kSequential ? 0 : blockIdx.z;
  const int cend = pass == kSequential ? a.chunks : cbeg + 1;
  const int hsz = DS * P;
  // (row, head, chunk) -> its ds x p state in the chunk-parallel scratch
  auto state_at = [&](int h, int ci) {
    return a.states + ((static_cast<long long>(row) * a.n + h) * a.chunks +
                       ci) * hsz;
  };

  // pads stay zero; the state starts at zero, or from pass 2
  for (int e = 4 * threadIdx.x; e < L.total; e += 4 * blockDim.x)
    *reinterpret_cast<float4*>(smem + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (pass == kChunkOutputs)
    for (int hh = 0; hh < H; ++hh)
      for (int s = warp; s < DS; s += warps)
        for (int pp = lane; pp < P; pp += 32)
          cp_async4(smem + L.hs + (hh * DS + s) * PP + pp,
                    state_at(h0 + hh, cbeg) + s * P + pp);

  const int qt = QR / kTile, pt = (P + kTile - 1) / kTile;
  const int st = (DS + kTile - 1) / kTile;
  for (int ci = cbeg; ci < cend; ++ci) {
    const int c0 = ci * Q;
    const bool outputs = pass != kChunkStates;
    const bool inter = ci > 0 && outputs;   // the state before chunk 0 is 0
    const bool update = ci + 1 < a.chunks && pass != kChunkOutputs;
    __syncthreads();   // the previous chunk's readers are done
    if (outputs)
      stage_rows(cs, CSP, cg + c0 * a.sc_s, a.sc_s, Q, DS, a.vec_bc);
    stage_rows(bs, DSP, bg + c0 * a.sb_s, a.sb_s, Q, DS, a.vec_bc);
    for (int hh = 0; hh < H; ++hh)
      stage_rows(smem + L.xs + hh * QR * PP, PP,
                 x + c0 * a.sx_s + (h0 + hh) * a.sx_h, a.sx_s, Q, P,
                 a.vec_x);
    for (int e = threadIdx.x; e < H * Q; e += blockDim.x) {
      const int hh = e / Q, t = e - hh * Q;
      cp_async4(smem + L.dts + hh * QR + t, dt + (c0 + t) * a.sdt_s + h0 + hh);
    }
    cp_async_wait_all();
    __syncthreads();
    if (outputs)   // scores, transposed: sc[k][q] = c_q . b_k for k <= q
      for (int k = warp; k < Q; k += warps)
        for (int q = lane + (k & ~31); q < Q; q += 32) {
          float acc = 0.f;
          for (int s = 0; s < DS; s += 4) {
            const float4 cv =
                *reinterpret_cast<const float4*>(cs + q * CSP + s);
            const float4 bv =
                *reinterpret_cast<const float4*>(bs + k * DSP + s);
            acc = fmaf(cv.x, bv.x, acc);
            acc = fmaf(cv.y, bv.y, acc);
            acc = fmaf(cv.z, bv.z, acc);
            acc = fmaf(cv.w, bv.w, acc);
          }
          sc[k * QR + q] = acc;
        }
    for (int hh = warp; hh < H; hh += warps) {
      const float last =
          warp_scan(smem + L.dts + hh * QR, smem + L.cum + hh * QR,
                    smem + L.wk + hh * QR,
                    -expf(to_f32(a_log[h0 + hh])), Q);
      if (lane == 0) {
        smem[L.dec + hh] = exp2f(last);
        if (pass == kChunkStates)
          a.decays[(static_cast<long long>(row) * a.n + h0 + hh) * a.chunks +
                   ci] = exp2f(last);
      }
    }
    __syncthreads();

    if (outputs) {
      // decayed weights, transposed: W[k][q] = sc[k][q] exp(cum_q - cum_k)
      // dt_k for k <= q < Q, else 0
      for (int hh = 0; hh < H; ++hh) {
        const float* cum2 = smem + L.cum + hh * QR;
        const float* dts = smem + L.dts + hh * QR;
        float* ws = smem + L.ws + hh * QR * QR;
#pragma unroll 4
        for (int k = warp; k < Q; k += warps)
          for (int q = lane; q < QR; q += 32)
            ws[k * QR + q] =
                q >= k && q < Q
                    ? sc[k * QR + q] * exp2f(cum2[q] - cum2[k]) * dts[k]
                    : 0.f;
      }
      __syncthreads();
      // output tiles: lane p of tile (hh, qb, pb) owns column pb * 32 + lane
      // of the 32 steps from qb * 32
      for (int task = warp; task < H * qt * pt; task += warps) {
        const int hh = task / (qt * pt), qb = task / pt % qt, pb = task % pt;
        const int q0 = qb * kTile, p = pb * kTile + lane;
        const int pc = min(p, PP - 1);   // a lane past p reads in bounds
        const float* xh = smem + L.xs + hh * QR * PP + pc;
        const float* ws = smem + L.ws + hh * QR * QR;
        float acc[kTile] = {};
        if (inter) {
          const float* hcol = smem + L.hs + hh * DS * PP + pc;
          for (int s = 0; s < DS; ++s) {
            const float hv = hcol[s * PP];
            const float* ccol = cs + q0 * CSP + s;
#pragma unroll
            for (int i = 0; i < kTile; ++i)
              acc[i] = fmaf(ccol[i * CSP], hv, acc[i]);
          }
          const float* cum2 = smem + L.cum + hh * QR + q0;
#pragma unroll
          for (int i = 0; i < kTile; ++i) acc[i] *= exp2f(cum2[i]);
        }
        for (int kb = 0; kb < qb; ++kb)
          intra_block<false>(acc, ws + kb * kTile * QR + q0, QR,
                             xh + kb * kTile * PP, PP);
        intra_block<true>(acc, ws + qb * kTile * QR + q0, QR,
                          xh + qb * kTile * PP, PP);
        if (p < P) {
          T* out = y + (static_cast<long long>(c0 + q0) * a.n + h0 + hh) *
                           P + p;
          const long long ld = static_cast<long long>(a.n) * P;
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if (q0 + i < Q) out[i * ld] = from_f32<T>(acc[i]);
        }
      }
    }

    if (update) {
      __syncthreads();   // every read of the state before this chunk done
      // state tiles: lane p of tile (hh, sb, pb) owns column pb * 32 + lane
      for (int task = warp; task < H * st * pt; task += warps) {
        const int hh = task / (st * pt), sb = task / pt % st, pb = task % pt;
        const int s0 = sb * kTile, p = pb * kTile + lane;
        const int pc = min(p, PP - 1);
        const float* wk = smem + L.wk + hh * QR;
        const float* xh = smem + L.xs + hh * QR * PP + pc;
        float acc[kTile] = {};
        for (int k = 0; k < Q; ++k) {
          const float xw = xh[k * PP] * wk[k];
          const float* brow = bs + k * DSP + s0;
#pragma unroll
          for (int i = 0; i < kTile; i += 4)
            if (s0 + i < DS) {
              const float4 v = *reinterpret_cast<const float4*>(brow + i);
              acc[i] = fmaf(v.x, xw, acc[i]);
              acc[i + 1] = fmaf(v.y, xw, acc[i + 1]);
              acc[i + 2] = fmaf(v.z, xw, acc[i + 2]);
              acc[i + 3] = fmaf(v.w, xw, acc[i + 3]);
            }
        }
        if (p >= P) continue;
        if (pass == kChunkStates) {
          float* out = state_at(h0 + hh, ci) + p;
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if (s0 + i < DS) out[(s0 + i) * P] = acc[i];
        } else {
          const float decay = smem[L.dec + hh];
          float* hcol = smem + L.hs + hh * DS * PP + p;
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if (s0 + i < DS)
              hcol[(s0 + i) * PP] = hcol[(s0 + i) * PP] * decay + acc[i];
        }
      }
    }
  }
}

// Pass 2 of the chunk-parallel form: per state entry, in chunk order,
// replace each chunk's own end state by the state entering it.
template <typename T>
__global__ void ssd_chunk_scan_kernel(const Args<T> a, int batch) {
  const long long hsz = static_cast<long long>(a.ds) * a.p;
  const long long total = static_cast<long long>(batch) * a.n * hsz;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long rh = e / hsz, r = e % hsz;
    float* st = a.states + rh * a.chunks * hsz + r;
    const float* dec = a.decays + rh * a.chunks;
    float h = 0.f;
    for (int ci = 0; ci < a.chunks; ++ci) {
      const float own = ci + 1 < a.chunks ? st[ci * hsz] : 0.f;
      st[ci * hsz] = h;
      if (ci + 1 < a.chunks) h = h * dec[ci] + own;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core form (ssd_mma_kernel): the FL path's shape only
// ---------------------------------------------------------------------------

constexpr int kMmaQ = 32;        // chunk: two m-tiles of 16 steps
constexpr int kMmaDs = 16;       // state width: one k-step of m16n8k16
constexpr int kMmaP = 32;        // head width: four n-tiles of 8
constexpr int kMmaMaxHeads = 8;  // a warp per head
constexpr int kMmaRing = 2;      // cp.async stages: rows in flight a block
// bf16 rows of c and b (48 bytes) and of x and y (80 bytes), f32 rows of
// the state (144 bytes): 16-byte aligned, and the eight rows an ldmatrix
// phase reads fall in distinct banks
constexpr int kBcPitch = kMmaDs + 8;
constexpr int kXPitch = kMmaP + 8;
constexpr int kHPitch = kMmaP + 4;

// bytes of one ring stage: c, b and every head's x (bf16), then dt (Q rows
// of n floats)
__host__ __device__ inline int mma_stage_bytes(int heads) {
  return 2 * (2 * kMmaQ * kBcPitch + heads * kMmaQ * kXPitch) +
         4 * kMmaQ * heads;
}

// the block's shared memory: the ring, then each head's f32 state where a
// row has several chunks
__host__ __device__ inline int mma_smem_bytes(int heads, bool state) {
  return kMmaRing * mma_stage_bytes(heads) +
         (state ? 4 * heads * kMmaDs * kHPitch : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp_async16 and cp_async4 on any element type
__device__ __forceinline__ void cp_async16_b(void* dst, const void* src) {
  cp_async16(static_cast<float*>(dst), static_cast<const float*>(src));
}

__device__ __forceinline__ void cp_async4_b(void* dst, const void* src) {
  cp_async4(static_cast<float*>(dst), static_cast<const float*>(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory (lane l gives row l % 8 of
// matrix l / 8); with TRANS each is transposed in the load, so a register
// holds two k-consecutive elements of an operand whose k runs down the
// rows of its tile.
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

// two floats rounded to bf16 (to nearest even, as from_f32) in one
// instruction: lo in the low half, hi in the high half
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

// The bf16 form at (Q, ds, p) = (32, 16, 32), sequential over a row's
// chunks. A persistent grid of one wave: block b walks rows b, b + grid,
// ..., chunk by chunk, through a ring of kMmaRing cp.async stages (item
// k + kMmaRing stages while item k computes). A warp per head; per item it
// - forms the scores c b^T on mma.sync (c's A fragments and b's B
//   fragments by ldmatrix; the blocks above the diagonal are skipped),
// - runs the cumsum of dt * rate as a warp scan (lane = step, log2 units)
//   and builds W = scores exp2(cum_q - cum_k) dt_k in the scores'
//   accumulator registers, which are the next product's A fragments,
// - splits W (f32) into bf16 big and small parts and runs W X as two
//   mma.sync into f32 (x exact in bf16; x's B fragments by ldmatrix.trans),
//   on top of the inter term exp(cum_q) c_q . h (two mma.sync over the
//   state's split parts) where a state enters the chunk,
// - rounds y once to bf16 into its x tile, which the warp alone read, and
//   stores whole 64-byte rows;
// - where a later chunk follows, h = h exp(cum_last) + (b wk)^T X, with
//   b^T by ldmatrix.trans scaled by the end-of-chunk weights and split in
//   two, into registers and the head's f32 state rows.
__global__ void __launch_bounds__(32 * kMmaMaxHeads)
ssd_mma_kernel(const Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int Q = kMmaQ, P = kMmaP, RING = kMmaRing;
  const int H = a.n, chunks = a.chunks;
  const int hh = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int stage = mma_stage_bytes(H);
  float* hsm = reinterpret_cast<float*>(smem_b + RING * stage) +
               hh * kMmaDs * kHPitch;
  const int items =
      (a.batch - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) -
       1) / static_cast<int>(gridDim.x) * chunks;
  auto item_row = [&](int k) {
    return static_cast<int>(blockIdx.x) + (k / chunks) *
                                              static_cast<int>(gridDim.x);
  };

  // stage item k (its row's chunk): c, b, x by 16-byte copies, dt by 4
  auto stage_item = [&](int k) {
    if (k < items) {
      const int row = item_row(k), c0 = (k % chunks) * Q;
      bf16* cs = reinterpret_cast<bf16*>(smem_b + (k % RING) * stage);
      bf16* bs = cs + Q * kBcPitch;
      bf16* xs = bs + Q * kBcPitch;
      float* dts = reinterpret_cast<float*>(xs + H * Q * kXPitch);
      const bf16* cg = a.c + row * a.sc_b + c0 * a.sc_s;
      const bf16* bg = a.b + row * a.sb_b + c0 * a.sb_s;
      for (int e = threadIdx.x; e < 2 * Q; e += blockDim.x) {
        const int r = e >> 1, part = (e & 1) * 8;
        cp_async16_b(cs + r * kBcPitch + part, cg + r * a.sc_s + part);
        cp_async16_b(bs + r * kBcPitch + part, bg + r * a.sb_s + part);
      }
      const bf16* xg = a.x + row * a.sx_b + c0 * a.sx_s;
      for (int e = threadIdx.x; e < H * Q * 4; e += blockDim.x) {
        const int h = e / (4 * Q), r = (e >> 2) % Q, part = (e & 3) * 8;
        cp_async16_b(xs + (h * Q + r) * kXPitch + part,
                     xg + r * a.sx_s + h * a.sx_h + part);
      }
      const float* dg = a.dt + row * a.sdt_b + c0 * a.sdt_s;
      for (int e = threadIdx.x; e < Q * H; e += blockDim.x)
        cp_async4_b(dts + e, dg + (e / H) * a.sdt_s + e % H);
    }
    cp_async_commit();   // an empty group past the last item
  };

  for (int k = 0; k < RING; ++k) stage_item(k);
  float hreg[4][4] = {};   // the head's state: rows s = g, g + 8, columns
                           // p = 8 np + 2 t4, + 1 (accumulator layout)
  for (int k = 0; k < items; ++k) {
    cp_async_wait<RING - 1>();
    __syncthreads();
    const int row = item_row(k), ci = k % chunks, c0 = ci * Q;
    const bool inter = ci > 0, update = ci + 1 < chunks;
    bf16* cs = reinterpret_cast<bf16*>(smem_b + (k % RING) * stage);
    bf16* bs = cs + Q * kBcPitch;
    bf16* xs = bs + Q * kBcPitch + hh * Q * kXPitch;
    const float* dts =
        reinterpret_cast<const float*>(bs + Q * kBcPitch + H * Q * kXPitch);
    const float rate = -expf(load_f32(
        a.a_log, (row / a.rows_per_slot) * a.sa_slot + hh, a.a_bf16));

    // inclusive cumsum of dt * rate, lane = step, in log2 units
    const float dtq = dts[lane * H + hh];
    float v = dtq * rate;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    const float cum2 = v * kLog2e;
    const float last2 = __shfl_sync(0xffffffffu, cum2, 31);
    // the fragments' steps: columns k = 8 j + 2 t4 + i, rows q = g + 8 r
    float ck[4][2], dk[4][2], cq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ck[j][i] = __shfl_sync(0xffffffffu, cum2, 8 * j + 2 * t4 + i);
        dk[j][i] = __shfl_sync(0xffffffffu, dtq, 8 * j + 2 * t4 + i);
      }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cq[r] = __shfl_sync(0xffffffffu, cum2, g + 8 * r);

    // A fragments of c (per m-tile), B fragments of b (per n-tile of 8
    // steps) and of x (per k-step and n-tile of 8 columns)
    uint32_t fc[2][4], fb[4][2], fx[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4<false>(fc[mi], cs + (16 * mi + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * kBcPitch +
                                     (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r4[4];
      ldmatrix_x4<false>(r4, bs + (16 * jj + (lane >> 4) * 8 + (lane & 7)) *
                                      kBcPitch + ((lane >> 3) & 1) * 8);
      fb[2 * jj][0] = r4[0], fb[2 * jj][1] = r4[1];
      fb[2 * jj + 1][0] = r4[2], fb[2 * jj + 1][1] = r4[3];
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int npp = 0; npp < 2; ++npp) {
        uint32_t r4[4];
        ldmatrix_x4<true>(r4, xs + (16 * kk + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kXPitch +
                                  8 * (2 * npp + (lane >> 4)));
        fx[kk][2 * npp][0] = r4[0], fx[kk][2 * npp][1] = r4[1];
        fx[kk][2 * npp + 1][0] = r4[2], fx[kk][2 * npp + 1][1] = r4[3];
      }
    // the state entering the chunk as B fragments (k = s, n = p), split
    uint32_t fh[4][2], fhs[4][2];
    if (inter) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const float* hc = hsm + 8 * np + g;
        split_bf16x2(hc[2 * t4 * kHPitch], hc[(2 * t4 + 1) * kHPitch],
                     fh[np][0], fhs[np][0]);
        split_bf16x2(hc[(2 * t4 + 8) * kHPitch], hc[(2 * t4 + 9) * kHPitch],
                     fh[np][1], fhs[np][1]);
      }
    }
    __syncwarp();   // x and the state read: y and the new state may land

#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float acc[4][4] = {};
      if (inter) {
        const float e0 = exp2f(cq[2 * mi]), e1 = exp2f(cq[2 * mi + 1]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_bf16(acc[np], fc[mi], fhs[np]);
          mma_bf16(acc[np], fc[mi], fh[np]);
          acc[np][0] *= e0, acc[np][1] *= e0;
          acc[np][2] *= e1, acc[np][3] *= e1;
        }
      }
      // W's A fragments (big, small) per k-step, from the scores of the
      // n-tiles at or left of the diagonal
      uint32_t wb[2][4], ws[2][4];
#pragma unroll
      for (int j = 0; j < 2 * mi + 2; ++j) {
        float sc[4] = {};
        mma_bf16(sc, fc[mi], fb[j]);
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e & 1, r = 2 * mi + (e >> 1);
          const int q = 16 * mi + g + 8 * (e >> 1), kc = 8 * j + 2 * t4 + i;
          w[e] = kc <= q ? sc[e] * exp2f(cq[r] - ck[j][i]) * dk[j][i] : 0.f;
        }
        const int kk = j >> 1, base = (j & 1) * 2;
        split_bf16x2(w[0], w[1], wb[kk][base], ws[kk][base]);
        split_bf16x2(w[2], w[3], wb[kk][base + 1], ws[kk][base + 1]);
      }
#pragma unroll
      for (int kk = 0; kk <= mi; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_bf16(acc[np], ws[kk], fx[kk][np]);
          mma_bf16(acc[np], wb[kk], fx[kk][np]);
        }
      // y rounded once into the head's x tile
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int q = 16 * mi + g, col = 8 * np + 2 * t4;
        *reinterpret_cast<uint32_t*>(xs + q * kXPitch + col) =
            bf16x2_rn(acc[np][0], acc[np][1]);
        *reinterpret_cast<uint32_t*>(xs + (q + 8) * kXPitch + col) =
            bf16x2_rn(acc[np][2], acc[np][3]);
      }
    }

    if (update) {
      // h = h exp(cum_last) + sum_k b_k (exp(cum_last - cum_k) dt_k x_k)^T
      const float decay = exp2f(last2);
      float wk[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wk[j][i] = exp2f(last2 - ck[j][i]) * dk[j][i];
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hreg[np][e] = inter ? hreg[np][e] * decay : 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t r4[4], big[4], small[4];
        ldmatrix_x4<true>(r4, bs + (16 * kk + (lane >> 4) * 8 + (lane & 7)) *
                                       kBcPitch + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + (e >> 1);
          split_bf16x2(__uint_as_float(r4[e] << 16) * wk[j][0],
                       __uint_as_float(r4[e] & 0xffff0000u) * wk[j][1],
                       big[e], small[e]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_bf16(hreg[np], small, fx[kk][np]);
          mma_bf16(hreg[np], big, fx[kk][np]);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int col = 8 * np + 2 * t4;
        *reinterpret_cast<float2*>(hsm + g * kHPitch + col) =
            make_float2(hreg[np][0], hreg[np][1]);
        *reinterpret_cast<float2*>(hsm + (g + 8) * kHPitch + col) =
            make_float2(hreg[np][2], hreg[np][3]);
      }
    }
    __syncwarp();
    // y out as whole 64-byte rows, four 16-byte pieces each
    bf16* y = a.y + (static_cast<long long>(row) * a.seq + c0) * H * P +
              hh * P;
    for (int e = lane; e < Q * 4; e += 32) {
      const int q = e >> 2, part = (e & 3) * 8;
      *reinterpret_cast<uint4*>(y + static_cast<long long>(q) * H * P +
                                part) =
          *reinterpret_cast<const uint4*>(xs + q * kXPitch + part);
    }
    __syncthreads();   // every warp is done with this stage
    stage_item(k + RING);
  }
}

// ---------------------------------------------------------------------------
// The backward: the adjoint of the recurrence (ssd_bwd_kernel), then the
// ordered sums over heads and rows (ssd_bwd_sum_kernel)
// ---------------------------------------------------------------------------

constexpr int kBwdCols = 4;    // p columns per lane at most: p <= 128
constexpr int kRedPitch = 33;  // the per-step sums' rows: conflict-free

template <typename T>
struct BwdArgs {
  const T* x;          // (B, S, n, p)
  const float* dt;     // (B, S, n)
  const void* a_log;   // (slots, n), f32 or (a_bf16) bf16
  const T* b;          // (B, S, ds)
  const T* c;          // (B, S, ds)
  const T* dy;         // (B, S, n, p)
  T* dx;               // (B, S, n, p), contiguous
  float* ddt;          // (B, S, n), contiguous
  T* db;               // (B, S, ds), contiguous
  T* dc;               // (B, S, ds), contiguous
  void* da_log;        // (slots, n), contiguous, in a_log's dtype
  float* states;       // (B, n, segments - 1, ds, p): the state entering
                       // every segment but the first
  float* part_bc;      // (2, B, S, n, ds): per head, dt g x and h dy
  float* part_da;      // (B, n): per row and head, a dL/da
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sdy_b,
      sdy_s, sdy_h, sa_slot;
  int batch, seq, n, p, ds, seg, rows_per_slot, groups, a_bf16, cols;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The adjoint of h_t = h_{t-1} exp(dt_t a) + dt_t b_t x_t^T, y_t = h_t^T c_t
// for one (row, head): a one-warp block, lane j owning p columns j,
// j + 32, ... (a.cols of them). Every state, decay and sum in f32.
// Each segment of a.seg steps has its b, c, x, dy and dt staged into
// shared memory first, so the serial walk reads no device memory. A
// forward sweep saves the state entering each segment but the first
// (global scratch; never rebuilt by dividing by a decay, which can be near
// 0). The reverse walk then recomputes each segment's states h_{t-1} into
// shared memory (the lane's own columns: no barrier) and steps back
// through it with g_t = dL/dh_t = c_t dy_t^T + exp(dt_{t+1} a)
// g_{t+1}:
//   dx_t = dt_t g_t^T b_t                         (per lane),
//   db_t = dt_t g_t x_t, dc_t = h_t dy_t          (per head: summed over p
//                                                  through shared memory),
//   ddt_t = <g_t, b_t x_t^T> + a exp(dt_t a) <g_t, h_{t-1}>,
//   dL/da += dt_t exp(dt_t a) <g_t, h_{t-1}>     (warp sums).
// Per-head db and dc and per-row a dL/da go to f32 partials, which
// ssd_bwd_sum_kernel sums in order: no float atomics.
template <typename T>
__global__ void __launch_bounds__(32) ssd_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const int S = a.seq, P = a.p, DS = a.ds, L = a.seg, NC = a.cols;
  const int PP = 32 * NC, hsz = DS * PP;
  float* g = smem;                       // dL/dh_t (DS rows of PP)
  float* hs = g + hsz;                   // h_{t-1} of the segment's steps
  float* red = hs + L * hsz;             // the step's db and dc lanes
  float* bsg = red + 2 * DS * kRedPitch;   // the segment's b, c (L x DS),
  float* csg = bsg + L * DS;               // x and dy (L x PP, the lane's
  float* xsg = csg + L * DS;               // columns) and dt (L)
  float* dysg = xsg + L * PP;
  float* dsg = dysg + L * PP;
  const T* x = a.x + row * a.sx_b + h * a.sx_h;
  const float* dt = a.dt + row * a.sdt_b + h;
  const T* bg = a.b + row * a.sb_b;
  const T* cg = a.c + row * a.sc_b;
  const T* dy = a.dy + row * a.sdy_b + h * a.sdy_h;
  const float rate = -expf(
      load_f32(a.a_log, (row / a.rows_per_slot) * a.sa_slot + h, a.a_bf16));
  const int nseg = (S + L - 1) / L;
  float* st = nseg > 1 ? a.states + (static_cast<long long>(row) * a.n + h) *
                                        (nseg - 1) * DS * P
                       : nullptr;
  // steps [t0, t1) into shared memory, every lane's loads in flight at
  // once (the serial walk below then reads no device memory); with
  // `back`, c and dy too
  auto stage = [&](int t0, int t1, bool back) {
    __syncwarp();   // the previous segment's readers are done
    for (int e = lane; e < (t1 - t0) * DS; e += 32) {
      const int i = e / DS, s = e - i * DS;
      bsg[e] = to_f32(bg[(t0 + i) * a.sb_s + s]);
      if (back) csg[e] = to_f32(cg[(t0 + i) * a.sc_s + s]);
    }
    for (int i = 0; i < t1 - t0; ++i)
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        const bool in = col < P;
        xsg[i * PP + col] = in ? to_f32(x[(t0 + i) * a.sx_s + col]) : 0.f;
        if (back)
          dysg[i * PP + col] = in ? to_f32(dy[(t0 + i) * a.sdy_s + col]) : 0.f;
      }
    for (int i = lane; i < t1 - t0; i += 32) dsg[i] = dt[(t0 + i) * a.sdt_s];
    __syncwarp();
  };
  // h_{t+1} = h_t exp(dt a) + dt b x^T for the lane's columns, step i of
  // the staged segment (in place where hn == hp)
  auto step = [&](const float* hp, float* hn, int i) {
    const float d = dsg[i], e = expf(d * rate);
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      const float xv = xsg[i * PP + col];
      for (int s = 0; s < DS; ++s)
        hn[s * PP + col] = hp[s * PP + col] * e + d * bsg[i * DS + s] * xv;
    }
  };

  // forward sweep: the state entering each segment but the first
  for (int e = lane; e < hsz; e += 32) g[e] = 0.f;
  for (int k = 0; k + 1 < nseg; ++k) {
    stage(k * L, (k + 1) * L, false);
    for (int i = 0; i < L; ++i) step(g, g, i);
    float* out = st + static_cast<long long>(k) * DS * P;
    for (int s = 0; s < DS; ++s)
      for (int col = lane; col < P; col += 32)
        out[s * P + col] = g[s * PP + col];
  }

  // reverse walk
  for (int e = lane; e < hsz; e += 32) g[e] = 0.f;
  float e_next = 0.f, da = 0.f;
  for (int k = nseg - 1; k >= 0; --k) {
    const int t0 = k * L, t1 = min(S, t0 + L);
    stage(t0, t1, true);
    for (int s = 0; s < DS; ++s)
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        hs[s * PP + col] =
            k > 0 && col < P
                ? st[static_cast<long long>(k - 1) * DS * P + s * P + col]
                : 0.f;
      }
    for (int i = 0; i + 1 < t1 - t0; ++i)
      step(hs + i * hsz, hs + (i + 1) * hsz, i);
    for (int i = t1 - t0 - 1; i >= 0; --i) {
      const int t = t0 + i;
      const float d = dsg[i], e = expf(d * rate);
      const float* hp = hs + i * hsz;
      const float* bv = bsg + i * DS;
      const float* cv = csg + i * DS;
      float xv[kBwdCols], dyv[kBwdCols], dxa[kBwdCols];
#pragma unroll
      for (int j = 0; j < kBwdCols; ++j) {
        xv[j] = j < NC ? xsg[i * PP + lane + 32 * j] : 0.f;
        dyv[j] = j < NC ? dysg[i * PP + lane + 32 * j] : 0.f;
        dxa[j] = 0.f;
      }
      float s2 = 0.f;   // <g_t, h_{t-1}>, this lane's columns
      for (int s = 0; s < DS; ++s) {
        float pdb = 0.f, pdc = 0.f;
#pragma unroll
        for (int j = 0; j < kBwdCols; ++j) {
          if (j < NC) {
            const int q = s * PP + lane + 32 * j;
            const float hprev = hp[q];
            const float ht = hprev * e + d * bv[s] * xv[j];
            const float gv = g[q] * e_next + cv[s] * dyv[j];
            g[q] = gv;
            pdc += ht * dyv[j];
            pdb += gv * xv[j];
            dxa[j] += bv[s] * gv;
            s2 += gv * hprev;
          }
        }
        red[s * kRedPitch + lane] = pdb;
        red[(DS + s) * kRedPitch + lane] = pdc;
      }
      float s1 = 0.f;   // <g_t, b_t x_t^T>, this lane's columns
#pragma unroll
      for (int j = 0; j < kBwdCols; ++j) {
        const int col = lane + 32 * j;
        if (j < NC && col < P)
          a.dx[((static_cast<long long>(row) * S + t) * a.n + h) * P + col] =
              from_f32<T>(d * dxa[j]);
        s1 += xv[j] * dxa[j];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      __syncwarp();
      const long long rth = (static_cast<long long>(row) * S + t) * a.n + h;
      float* pb = a.part_bc + rth * DS;
      float* pc = pb + static_cast<long long>(a.batch) * S * a.n * DS;
      for (int r = lane; r < 2 * DS; r += 32) {
        float acc = 0.f;
        for (int q = 0; q < 32; ++q) acc += red[r * kRedPitch + q];
        if (r < DS)
          pb[r] = d * acc;
        else
          pc[r - DS] = acc;
      }
      __syncwarp();
      if (lane == 0) a.ddt[rth] = s1 + rate * e * s2;
      da += d * e * s2;
      e_next = e;
    }
  }
  if (lane == 0) a.part_da[static_cast<long long>(row) * a.n + h] = rate * da;
}

// db and dc: the per-head partials summed over heads in order, rounded once
// to T; da_log: a dL/da summed over a slot's rows in order, in a_log's dtype
template <typename T>
__global__ void ssd_bwd_sum_kernel(const BwdArgs<T> a) {
  const long long nbc = static_cast<long long>(a.batch) * a.seq * a.ds;
  const long long half = nbc * a.n;
  const long long total = nbc + static_cast<long long>(a.groups) * a.n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (e < nbc) {
      const long long rt = e / a.ds;
      const float* pb = a.part_bc + rt * a.n * a.ds + (e - rt * a.ds);
      float sb = 0.f, sc = 0.f;
      for (int h = 0; h < a.n; ++h) {
        sb += pb[h * a.ds];
        sc += pb[half + h * a.ds];
      }
      a.db[e] = from_f32<T>(sb);
      a.dc[e] = from_f32<T>(sc);
    } else {
      const int i = static_cast<int>(e - nbc), slot = i / a.n;
      const float* pd = a.part_da +
                        static_cast<long long>(slot) * a.rows_per_slot * a.n +
                        (i - slot * a.n);
      float acc = 0.f;
      for (int r = 0; r < a.rows_per_slot; ++r) acc += pd[r * a.n];
      if (a.a_bf16)
        static_cast<bf16*>(a.da_log)[i] = __float2bfloat16_rn(acc);
      else
        static_cast<float*>(a.da_log)[i] = acc;
    }
  }
}

// A copy width of `vec` bytes over rows of `cols` elements of T: 16 or 4
// bytes, or one bf16; the width must divide the row.
template <typename T>
bool copy_ok(int vec, int cols) {
  if (vec != 16 && vec != 4 && !(sizeof(T) == 2 && vec == 2)) return false;
  return cols % (vec / static_cast<int>(sizeof(T))) == 0;
}

// Above 48 KB a block's shared memory must be asked for explicitly: allow
// the card's opt-in maximum, and all of the SM's unified L1 as shared
// memory (the launch itself fails, and reports it, if a block asks for
// more).
template <typename K>
cudaError_t allow_smem(K kernel) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The bf16 tensor-core form: a persistent grid of as many blocks as fit on
// the card at once (at most one per row).
cudaError_t launch_mma(const Args<bf16>& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(ssd_mma_kernel);
  if (attr != cudaSuccess) return attr;
  const int threads = 32 * a.n;
  const int smem = mma_smem_bytes(a.n, a.chunks > 1);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_mma_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = a.batch < per_sm * sms ? a.batch : per_sm * sms;
  ssd_mma_kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The FMA form: sequential, or the chunk-parallel form's three launches.
template <typename T, typename TA>
cudaError_t launch_fma(const Args<T>& a, int batch, int heads, int warps,
                       int chunk_parallel, cudaStream_t stream) {
  // five blocks fit an SM
  static const cudaError_t attr = allow_smem(ssd_kernel<T, TA>);
  if (attr != cudaSuccess) return attr;
  const int threads = 32 * warps;
  const int hblocks = a.n / heads;
  auto smem = [&](bool state) {
    return sizeof(float) * layout(a.chunk, a.p, a.ds, heads, state).total;
  };
  if (!chunk_parallel) {
    ssd_kernel<T, TA><<<dim3(batch, hblocks, 1), threads,
                        smem(a.chunks > 1), stream>>>(a, kSequential);
    return cudaGetLastError();
  }
  cudaError_t err = cudaSuccess;
  if (a.chunks > 1) {
    ssd_kernel<T, TA><<<dim3(batch, hblocks, a.chunks - 1), threads,
                        smem(false), stream>>>(a, kChunkStates);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long entries = static_cast<long long>(batch) * a.n * a.ds * a.p;
  const long long want = (entries + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssd_chunk_scan_kernel<T><<<blocks, 256, 0, stream>>>(a, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_kernel<T, TA><<<dim3(batch, hblocks, a.chunks), threads, smem(true),
                      stream>>>(a, kChunkOutputs);
  return cudaGetLastError();
}

template <typename T>
int ssd_entry(const T* x, const float* dt, const void* a_log, const T* b,
              const T* c, T* y, float* states, float* decays, int batch,
              int seq, int n, int p, int ds, int chunk, int heads, int warps,
              int chunk_parallel, int rows_per_slot, int vec_x, int vec_bc,
              int a_bf16, int form, const long long* strides,
              cudaStream_t stream) {
  if (chunk <= 0 || seq % chunk || heads <= 0 || n % heads ||
      rows_per_slot <= 0 || warps <= 0 || 32 * warps > kMaxThreads ||
      (chunk_parallel && (!states || !decays)) ||
      !copy_ok<T>(vec_x, p) || !copy_ok<T>(vec_bc, ds))
    return cudaErrorInvalidValue;
  Args<T> a{x, dt, a_log, b, c, y, states, decays,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         seq, n, p, ds, chunk, heads, rows_per_slot, seq / chunk,
         vec_x, vec_bc, a_bf16, batch};
  if (form) {
    // the tensor-core form: bf16 at (kMmaQ, kMmaDs, kMmaP), a warp per
    // head, sequential, 16-byte copies
    if constexpr (std::is_same<T, bf16>::value) {
      if (chunk != kMmaQ || ds != kMmaDs || p != kMmaP || n > kMmaMaxHeads ||
          heads != n || chunk_parallel || vec_x != 16 || vec_bc != 16)
        return cudaErrorInvalidValue;
      return launch_mma(a, stream);
    }
    return cudaErrorInvalidValue;
  }
  return a_bf16 ? launch_fma<T, bf16>(a, batch, heads, warps, chunk_parallel,
                                      stream)
                : launch_fma<T, float>(a, batch, heads, warps,
                                       chunk_parallel, stream);
}

template <typename T>
int ssd_bwd_entry(const T* x, const float* dt, const void* a_log, const T* b,
                  const T* c, const T* dy, T* dx, float* ddt, T* db, T* dc,
                  void* da_log, float* states, float* part_bc,
                  float* part_da, int batch, int seq, int n, int p, int ds,
                  int segment, int rows_per_slot, int groups, int a_bf16,
                  int cols, const long long* strides, cudaStream_t stream) {
  if (segment <= 0 || cols <= 0 || cols > kBwdCols || p > 32 * cols ||
      rows_per_slot <= 0 || groups * rows_per_slot != batch ||
      (seq > segment && !states))
    return cudaErrorInvalidValue;
  BwdArgs<T> a{x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log, states,
               part_bc, part_da, strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5], strides[6], strides[7],
               strides[8], strides[9], strides[10], strides[11], strides[12],
               batch, seq, n, p, ds, segment, rows_per_slot, groups, a_bf16,
               cols};
  static const cudaError_t attr = allow_smem(ssd_bwd_kernel<T>);
  if (attr != cudaSuccess) return attr;
  const size_t smem =
      sizeof(float) * ((segment + 1) * ds * 32 * cols + 2 * ds * kRedPitch +
                       segment * (2 * ds + 2 * 32 * cols + 1));
  ssd_bwd_kernel<T><<<dim3(batch, n), 32, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(batch) * seq * ds +
                          static_cast<long long>(groups) * n;
  const long long want = (total + 255) / 256;
  ssd_bwd_sum_kernel<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). x (B, S, n, p), dt (B, S, n), b and c
// (B, S, ds) with a unit last stride: x, b, c and y f32 (ssd_scan_fwd) or
// bf16 (ssd_scan_fwd_bf16), dt f32 in both, a_log f32 or (a_bf16) bf16;
// `strides` holds, in order, x's (row, step, head) strides, dt's (row,
// step), b's (row, step), c's (row, step) and a_log's slot stride. Row r
// uses a_log slot r / rows_per_slot. y is contiguous (B, S, n, p). The plan
// comes from the wrapper (kernel.ssd_plan): form 0, the FMA form with
// `heads` heads per block of `warps` warps, with chunk_parallel the
// three-pass form, whose scratch `states` holds B * n * chunks * ds * p
// floats and `decays` B * n * chunks (both unused otherwise); form 1 (bf16
// only, at chunk 32, ds 16, p 32, heads = n <= 8, sequential, 16-byte
// copies), the tensor-core form; vec_x and vec_bc are the copy widths in bytes (16 where the rows' pointers and
// strides allow it, else 4, else one bf16) of x, and of b and c. S must be
// a multiple of chunk and n of heads. Returns the CUDA error code of the
// first failing launch (0 on success); the kernels run asynchronously on
// `stream`.
extern "C" int ssd_scan_fwd(const float* x, const float* dt,
                            const void* a_log, const float* b,
                            const float* c, float* y, float* states,
                            float* decays, int batch, int seq, int n, int p,
                            int ds, int chunk, int heads, int warps,
                            int chunk_parallel, int rows_per_slot,
                            int vec_x, int vec_bc, int a_bf16, int form,
                            const long long* strides, cudaStream_t stream) {
  return ssd_entry(x, dt, a_log, b, c, y, states, decays, batch, seq, n, p,
                   ds, chunk, heads, warps, chunk_parallel, rows_per_slot,
                   vec_x, vec_bc, a_bf16, form, strides, stream);
}

extern "C" int ssd_scan_fwd_bf16(const bf16* x, const float* dt,
                                 const void* a_log, const bf16* b,
                                 const bf16* c, bf16* y, float* states,
                                 float* decays, int batch, int seq, int n,
                                 int p, int ds, int chunk, int heads,
                                 int warps, int chunk_parallel,
                                 int rows_per_slot, int vec_x, int vec_bc,
                                 int a_bf16, int form,
                                 const long long* strides,
                                 cudaStream_t stream) {
  return ssd_entry(x, dt, a_log, b, c, y, states, decays, batch, seq, n, p,
                   ds, chunk, heads, warps, chunk_parallel, rows_per_slot,
                   vec_x, vec_bc, a_bf16, form, strides, stream);
}

// The backward: the same operands, the cotangent dy (x's dtype; row, step
// and head strides after c's in `strides`, then a_log's slot stride) ->
// dx (B, S, n, p) and db, dc (B, S, ds) in x's dtype, ddt (B, S, n) f32 and
// da_log (groups, n) in a_log's dtype, all contiguous. The plan comes from
// the wrapper (kernel.ssd_bwd_plan): `segment` steps recomputed per pass,
// `cols` p columns per lane (p <= 32 cols, cols <= 4). Scratch: `states`
// (B * n * (ceil(S / segment) - 1) * ds * p floats; unused for one
// segment), `part_bc` (2 * B * S * n * ds), `part_da` (B * n). Two launches:
// the scan, then the ordered sums over heads and a slot's rows.
extern "C" int ssd_scan_bwd(const float* x, const float* dt,
                            const void* a_log, const float* b,
                            const float* c, const float* dy, float* dx,
                            float* ddt, float* db, float* dc, void* da_log,
                            float* states, float* part_bc, float* part_da,
                            int batch, int seq, int n, int p, int ds,
                            int segment, int rows_per_slot, int groups,
                            int a_bf16, int cols, const long long* strides,
                            cudaStream_t stream) {
  return ssd_bwd_entry(x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log,
                       states, part_bc, part_da, batch, seq, n, p, ds,
                       segment, rows_per_slot, groups, a_bf16, cols, strides,
                       stream);
}

extern "C" int ssd_scan_bwd_bf16(const bf16* x, const float* dt,
                                 const void* a_log, const bf16* b,
                                 const bf16* c, const bf16* dy, bf16* dx,
                                 float* ddt, bf16* db, bf16* dc,
                                 void* da_log, float* states, float* part_bc,
                                 float* part_da, int batch, int seq, int n,
                                 int p, int ds, int segment,
                                 int rows_per_slot, int groups, int a_bf16,
                                 int cols, const long long* strides,
                                 cudaStream_t stream) {
  return ssd_bwd_entry(x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log,
                       states, part_bc, part_da, batch, seq, n, p, ds,
                       segment, rows_per_slot, groups, a_bf16, cols, strides,
                       stream);
}
