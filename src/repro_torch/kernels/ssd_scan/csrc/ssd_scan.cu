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
// and y = y_intra + y_inter. Three forms: the FMA form (ssd_kernel<T, TA>,
// below) for every shape, for bf16 at the FL path's shape (chunk 32, ds 16,
// p 32) the tensor-core form (ssd_mma_kernel, further down), and for few
// rows over many chunks (mamba2-2.7b's step) the chunk-parallel
// tensor-core form (ssd_tc_state_kernel, ssd_tc_pass_kernel,
// ssd_tc_out_kernel: 3xTF32 passes over chunks of 64; its own note is at
// its section).
//
// The backward (ssd_bwd_chunk_kernel<T, TA>, ssd_bwd_mma_kernel,
// ssd_bwd_tf32_kernel, the chunk-parallel ssd_tc_bwd_kernel<T> after the
// same chunk states and state pass, and ssd_bwd_sum_kernel<T>) has no
// Pallas counterpart: the reference's op takes jax.vjp through its
// sequential oracle (src/repro/kernels/ssd_scan/ops.py:64 `_ssd_bwd`). It
// is the adjoint of the chunked form; its own note is at its section.
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
// chunks (long sequences, few rows), the FMA form can run Mamba-2's
// three-pass form instead of walking the chunks in order (f32 takes the
// tensor-core chunk-parallel form there instead): (1) each (row, head, chunk)
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
// The backward: the adjoint of the chunked dual form (ssd_bwd_chunk_kernel,
// and for bf16 at the FL path's shape ssd_bwd_mma_kernel), then the ordered
// sums over head groups and a slot's rows (ssd_bwd_sum_kernel)
// ---------------------------------------------------------------------------
//
// No Pallas kernel is replaced: the reference's op takes jax.vjp through its
// sequential oracle (src/repro/kernels/ssd_scan/ops.py:64 `_ssd_bwd`), which
// XLA compiles into one scan. These kernels compute the same gradients as
// the adjoint of the chunked form, chunk by chunk with matrix products.
//
// For one row, one head and one chunk of Q = 32 steps (local q, k), with
// A_k = dt_k a, cum the inclusive cumsum of A (log2 units here), S = C B^T
// (Q x Q, shared by the heads), L_qk = exp(cum_q - cum_k) for q >= k else 0,
// W = S o L o dt_k, e_q = exp(cum_q), u_k = exp(cum_last - cum_k) dt_k, h_in
// the state entering the chunk, G = dL/dh at its end, dY its cotangent:
//   dX   = W^T dY + diag(u) B G
//   dW   = dY X^T (q >= k),  M = dW o W,  dS_h = dW o L o dt_k
//   dC   = (sum_h dS_h) B + sum_h diag(e) dY h_in^T
//   dB   = (sum_h dS_h)^T C + sum_h diag(u) X G^T
//   ddt_k = sum_q dW_qk S_qk L_qk + exp(cum_last - cum_k) <G, b_k x_k^T>
//           + a dA_k
//   dA_j = sum_{q >= j > k} M_qk + sum_{q >= j} e_q <dY_q, h_in^T c_q>
//          + sum_{k < j} u_k <G, b_k x_k^T> + exp(cum_last) <G, h_in>
//   da  += sum_j dt_j dA_j,  da_log = a da (summed over a slot's rows)
//   G   <- exp(cum_last) G + C^T diag(e) dY   (the chunk before's G)
// The states entering each chunk come from a forward sweep over chunks
// (h_out = exp(cum_last) h_in + B^T diag(u) X), saved in f32 scratch. On
// the FL path S = Q = 32: one chunk, h_in = 0 and G = 0, so neither the
// sweep nor the state terms run.
//
// Numerics. dA's first term is summed as the straddle it is (each M_qk once,
// for the j with k < j <= q), never as the reverse cumsum of M's row sums
// minus its column sums, where the diagonal and most of each sum cancel.
// Nothing is divided by a decay or by dt; only differences that are <= 0
// are exponentiated (log2 units, exp2f). Sums over heads and over a slot's
// rows run in a fixed order, with no float atomics: a block holds all of a
// row's heads and sums dS over them in head order before its products,
// writing dB and dC once; where the rows alone cannot fill the card (few
// rows over many chunks) the plan splits heads across blocks and
// ssd_bwd_sum_kernel sums the head groups' f32 partials in order.
//
// What bounds it on an H100: bytes. At the FL path's shapes (Q = 32,
// ds = 16, p = 32, 4 heads) a row reads x, dy, b, c, dt and writes dx, db,
// dc, ddt once (about 58 KB in f32) for about 0.8 MFLOP of products (the
// count chip_smoke.py bounds it by): 14 operations a byte, under the
// card's 20 for f32 FMA, 49 for 3xTF32 and 295 for bf16 tensor cores. The
// design therefore reads every operand once, keeps every intermediate (S,
// W, dW, dS, the straddle sums) in registers or shared memory, and runs
// the products where they cost least:
// - ssd_bwd_chunk_kernel<T, TA> (every shape, f32 and bf16 operands, f32
//   arithmetic): a block per (row, head group), a warp per head. Per chunk
//   the block stages c, b and each head's x, dy and dt (bf16 widened to f32
//   on load) and forms S; each head's warp scans its cumsum, then lane k
//   takes step k: column k of dW by FMA from registers (x's row k against
//   dy's rows, broadcast float4s), then W, M, dS and the column sums of
//   dW o S o L in one pass down the column, the straddle's suffix sums
//   through a 32 x 33 tile, and dX's row k as W^T dY; the state terms where
//   a chunk has them. A second phase sums dS over heads in order and forms
//   dB and dC, updates G, and stores dX from shared memory in whole rows.
// - ssd_bwd_mma_kernel (bf16 at S = 32, ds = 16, p = 32): a persistent grid
//   whose blocks walk rows through a two-deep cp.async ring, a warp per
//   head, every product on bf16 mma.sync m16n8k16: S^T = B C^T and
//   dW^T = X dY^T exact in one product each (bf16 operands, f32
//   accumulators), W^T dY and the dS products with their f32 operand as two
//   bf16 parts (split_bf16x2), dS summed over heads in shared memory.
// - ssd_bwd_tf32_kernel (f32 at the same shape): the same walk on f32
//   tiles, one row staged at a time (a second stage halves the blocks an
//   SM holds and lost, tools/ssd_scan_variants.py), every product in
//   3xTF32 on mma.sync m16n8k8 (each operand split into TF32 big and small
//   parts as it leaves shared memory, small * small dropped); it replaced
//   the chunked form at this shape by a measured variant (PERF.md §6).

constexpr int kBwdQ = 32;            // the chunk: lane = step
constexpr int kBwdMaxThreads = 256;  // a warp per head, up to 8
constexpr int kTp = 33;              // pitch of the 32 x 32 step tiles

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
  void* da_log;        // (groups, n), contiguous, in a_log's dtype
  float* states;       // (B, n, chunks - 1, ds, p): the state entering
                       // every chunk but the first
  float* part_bc;      // (2, n / heads, B, S, ds): db and dc per head group
                       // (only where heads < n)
  float* part_da;      // (B, n, da_parts): per row and head, a dL/da (per
                       // chunk in the tensor-core chunk-parallel form)
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sdy_b,
      sdy_s, sdy_h, sa_slot;
  int batch, seq, n, p, ds, heads, chunks, rows_per_slot, groups, a_bf16;
  int vec_x, vec_bc;   // copy widths in bytes of x and dy, and of b and c
  int da_parts;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

inline __host__ __device__ int round8(int v) { return (v + 7) & ~7; }

// Shared memory of ssd_bwd_chunk_kernel, in floats. Rows of c, b and the
// state products are DSP = ds rounded up to 8, plus 4 (4 mod 8: lane k's
// float4 reads of row k are conflict-free), rows of x and dy PP = p rounded
// up to 4, or-ed with 4. Once per block: c, b (Q rows each), S (S[q][k],
// pitch kTp). Per head: x (dX once x is read), dy, the step tile (the
// straddle's suffix sums, then dS_h[q][k]), and dt, cum (log2 units), u,
// e. Where a row has several chunks, per head: the state entering the chunk
// and G (DSR = ds rounded up to 4 rows of PP), X G^T scaled by u and
// dY h_in^T scaled by e (Q rows of DSP); and each head's exp(cum_last).
struct BwdLayout {
  int pp, dsp, dsr, cs, bs, sc, xs, dys, tile, dts, cum, us, es, hs, gs,
      pb, pc, dec, total;
};

inline __host__ __device__ BwdLayout bwd_layout(int p, int ds, int heads,
                                                bool state) {
  constexpr int Q = kBwdQ;
  BwdLayout l;
  l.pp = round4(p) | 4;
  l.dsp = round8(ds) | 4;
  l.dsr = round4(ds);
  l.cs = 0;
  l.bs = l.cs + Q * l.dsp;
  l.sc = l.bs + Q * l.dsp;
  l.xs = l.sc + Q * kTp;
  l.dys = l.xs + heads * Q * l.pp;
  l.tile = l.dys + heads * Q * l.pp;
  l.dts = l.tile + heads * Q * kTp;
  l.cum = l.dts + heads * Q;
  l.us = l.cum + heads * Q;
  l.es = l.us + heads * Q;
  l.hs = l.es + heads * Q;
  const int sz = state ? heads * l.dsr * l.pp : 0;
  l.gs = l.hs + sz;
  l.pb = l.gs + sz;
  l.pc = l.pb + (state ? heads * Q * l.dsp : 0);
  l.dec = l.pc + (state ? heads * Q * l.dsp : 0);
  l.total = round4(l.dec + heads);
  return l;
}

// rows [rows, q) of a staged tile of q rows set to zero (a ragged last
// chunk)
__device__ __forceinline__ void zero_rows(float* dst, int pitch, int rows,
                                          int q = kBwdQ) {
  for (int e = threadIdx.x; e < (q - rows) * pitch; e += blockDim.x)
    dst[rows * pitch + e] = 0.f;
}

// dst[r][0, cols) = src rows (pitch `pitch`) in T, by the whole block,
// four elements at a time where the rows allow it
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long ld,
                                           const float* src, int pitch,
                                           int rows, int cols) {
  if (cols % 4 == 0) {
    const int per = cols >> 2;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) << 2;
      const float4 v = *reinterpret_cast<const float4*>(src + r * pitch + c);
      T* d = dst + r * ld + c;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(d) = v;
      } else {
        uint2 u;
        u.x = bf16x2_rn(v.x, v.y);
        u.y = bf16x2_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(d) = u;
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] = from_f32<T>(src[r * pitch + c]);
    }
  }
}

// acc[0, 8) to out[0, min(8, n)): one 32-byte (f32) or 16-byte (bf16)
// store where all 8 are in and `vec` says the row allows it
template <typename T>
__device__ __forceinline__ void store8(T* out, const float (&acc)[8], int n,
                                       bool vec) {
  if (vec && n >= 8) {
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float4*>(out)[0] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(out)[1] =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      uint4 u;
      u.x = bf16x2_rn(acc[0], acc[1]);
      u.y = bf16x2_rn(acc[2], acc[3]);
      u.z = bf16x2_rn(acc[4], acc[5]);
      u.w = bf16x2_rn(acc[6], acc[7]);
      *reinterpret_cast<uint4*>(out) = u;
    }
  } else {
    for (int i = 0; i < 8 && i < n; ++i) out[i] = from_f32<T>(acc[i]);
  }
}

// acc[0, 32) += sum over the chunk's steps q of w_q c[q][s0 + i] x_q, lane
// owning column `col` of x (a state tile: 32 state rows, one column)
__device__ __forceinline__ void state_tile(float (&acc)[kTile],
                                           const float* rows, int rpitch,
                                           int s0, int DS, const float* xcol,
                                           int xpitch, const float* w) {
  for (int q = 0; q < kBwdQ; ++q) {
    const float xw = xcol[q * xpitch] * w[q];
    const float* r = rows + q * rpitch + s0;
#pragma unroll
    for (int i = 0; i < kTile; i += 4)
      if (s0 + i < DS) {
        const float4 v = *reinterpret_cast<const float4*>(r + i);
        acc[i] = fmaf(v.x, xw, acc[i]);
        acc[i + 1] = fmaf(v.y, xw, acc[i + 1]);
        acc[i + 2] = fmaf(v.z, xw, acc[i + 2]);
        acc[i + 3] = fmaf(v.w, xw, acc[i + 3]);
      }
  }
}

// T: x, b, c, dy and their gradients; TA: a_log (float or bf16)
template <typename T, typename TA>
__global__ void __launch_bounds__(kBwdMaxThreads, 2)
ssd_bwd_chunk_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int Q = kBwdQ;
  const int P = a.p, DS = a.ds, H = a.heads, chunks = a.chunks;
  const bool state = chunks > 1;
  const BwdLayout L = bwd_layout(P, DS, H, state);
  const int PP = L.pp, DSP = L.dsp;
  float* cs = smem + L.cs;
  float* bs = smem + L.bs;
  float* sc = smem + L.sc;
  const int row = blockIdx.x, h0 = blockIdx.y * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* xg = a.x + row * a.sx_b;
  const float* dtg = a.dt + row * a.sdt_b;
  const T* bg = a.b + row * a.sb_b;
  const T* cg = a.c + row * a.sc_b;
  const T* dyg = a.dy + row * a.sdy_b;
  const long long hsz = static_cast<long long>(DS) * P;
  // head hh's state entering chunk ci (ci >= 1) in the scratch
  auto state_at = [&](int hh, int ci) {
    return a.states + ((static_cast<long long>(row) * a.n + h0 + hh) *
                           (chunks - 1) + ci - 1) * hsz;
  };
  // warp hh < H takes head h0 + hh in the per-head phases
  const bool head_warp = warp < H;
  const int hh = warp;
  const float rate =
      head_warp ? -expf(to_f32(static_cast<const TA*>(a.a_log)[
                      (row / a.rows_per_slot) * a.sa_slot + h0 + hh]))
                : 0.f;

  for (int e = 4 * threadIdx.x; e < L.total; e += 4 * blockDim.x)
    *reinterpret_cast<float4*>(smem + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // stage chunk ci: b, x and dt, and with `back` c, dy and the entering
  // states; rows past a ragged chunk's end are zero
  auto stage = [&](int ci, bool back) {
    const int c0 = ci * Q, qv = min(Q, a.seq - c0);
    stage_rows(bs, DSP, bg + c0 * a.sb_s, a.sb_s, qv, DS, a.vec_bc);
    if (back) stage_rows(cs, DSP, cg + c0 * a.sc_s, a.sc_s, qv, DS, a.vec_bc);
    for (int h = 0; h < H; ++h) {
      stage_rows(smem + L.xs + h * Q * PP, PP,
                 xg + c0 * a.sx_s + (h0 + h) * a.sx_h, a.sx_s, qv, P,
                 a.vec_x);
      if (back)
        stage_rows(smem + L.dys + h * Q * PP, PP,
                   dyg + c0 * a.sdy_s + (h0 + h) * a.sdy_h, a.sdy_s, qv, P,
                   a.vec_x);
      if (back && ci > 0)
        stage_rows(smem + L.hs + h * L.dsr * PP, PP, state_at(h, ci), P, DS,
                   P, P % 4 ? 4 : 16);
    }
    for (int e = threadIdx.x; e < H * Q; e += blockDim.x) {
      const int h = e / Q, t = e - h * Q;
      if (t < qv)
        cp_async4(smem + L.dts + e, dtg + (c0 + t) * a.sdt_s + h0 + h);
      else
        smem[L.dts + e] = 0.f;
    }
    if (qv < Q) {
      zero_rows(bs, DSP, qv);
      if (back) zero_rows(cs, DSP, qv);
      for (int h = 0; h < H; ++h) {
        zero_rows(smem + L.xs + h * Q * PP, PP, qv);
        if (back) zero_rows(smem + L.dys + h * Q * PP, PP, qv);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  };
  // each head's cumsum (log2 units), u and exp(cum_last); returns cum_last
  auto scan = [&]() {
    float last = 0.f;
    if (head_warp) {
      last = warp_scan(smem + L.dts + hh * Q, smem + L.cum + hh * Q,
                       smem + L.us + hh * Q, rate, Q);
      if (lane == 0) smem[L.dec + hh] = exp2f(last);
    }
    return last;
  };

  // forward sweep: the state entering each chunk but the first, h = h
  // exp(cum_last) + B^T diag(u) X, in shared memory and to the scratch
  const int pt = (P + kTile - 1) / kTile, st = (DS + kTile - 1) / kTile;
  for (int ci = 0; ci + 1 < chunks; ++ci) {
    __syncthreads();   // the previous chunk's readers are done
    stage(ci, false);
    scan();
    __syncthreads();
    for (int task = warp; task < H * st * pt; task += warps) {
      const int h = task / (st * pt), s0 = task / pt % st * kTile;
      const int p = task % pt * kTile + lane, pc = min(p, PP - 1);
      float acc[kTile] = {};
      state_tile(acc, bs, DSP, s0, DS, smem + L.xs + h * Q * PP + pc, PP,
                 smem + L.us + h * Q);
      if (p >= P) continue;
      const float decay = smem[L.dec + h];
      float* hcol = smem + L.hs + h * L.dsr * PP + p;
      float* out = state_at(h, ci + 1) + p;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        if (s0 + i < DS) {
          const float v = hcol[(s0 + i) * PP] * decay + acc[i];
          hcol[(s0 + i) * PP] = v;
          out[(s0 + i) * P] = v;
        }
    }
  }

  // the reverse walk over chunks
  const int hgroups = a.n / H;
  float da = 0.f;
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int c0 = ci * Q, qv = min(Q, a.seq - c0);
    const bool has_g = ci + 1 < chunks, has_h = ci > 0;
    __syncthreads();
    stage(ci, true);
    // S[q][k] = c_q . b_k
    for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
      const int q = e >> 5, k = e & 31;
      float acc = 0.f;
      for (int s = 0; s < DS; s += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + q * DSP + s);
        const float4 bv = *reinterpret_cast<const float4*>(bs + k * DSP + s);
        acc = fmaf(cv.x, bv.x, acc);
        acc = fmaf(cv.y, bv.y, acc);
        acc = fmaf(cv.z, bv.z, acc);
        acc = fmaf(cv.w, bv.w, acc);
      }
      sc[q * kTp + k] = acc;
    }
    const float last = scan();
    __syncthreads();

    // per head, lane = step: R (the straddle), ddt's first term, v_k =
    // <G, b_k x_k^T> and r_q = e_q <dY_q, h_in^T c_q>, hg = <G, h_in>
    float R = 0.f, ddt1 = 0.f, v = 0.f, r = 0.f, hg = 0.f;
    if (head_warp) {
      float* xh = smem + L.xs + hh * Q * PP;
      const float* dyh = smem + L.dys + hh * Q * PP;
      float* tl = smem + L.tile + hh * Q * kTp;
      const float* cum = smem + L.cum + hh * Q;
      const int k = lane;
      const float cumk = cum[k], dtk = smem[L.dts + hh * Q + k];
      const float uk = smem[L.us + hh * Q + k];
      smem[L.es + hh * Q + k] = exp2f(cumk);
      // column k of dW = dY X^T
      float acc[Q], w[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = 0.f;
      for (int p4 = 0; p4 < P; p4 += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xh + k * PP + p4);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 d = *reinterpret_cast<const float4*>(dyh + q * PP + p4);
          acc[q] = fmaf(d.x, xv.x, acc[q]);
          acc[q] = fmaf(d.y, xv.y, acc[q]);
          acc[q] = fmaf(d.z, xv.z, acc[q]);
          acc[q] = fmaf(d.w, xv.w, acc[q]);
        }
      }
      // down the column, last step first: W, the column sum of dW o S o L,
      // M's suffix sums (tile[k][q] = sum_{q' >= q} M[q'][k]), dS_h
      float tsum = 0.f;
#pragma unroll
      for (int q = Q - 1; q >= 0; --q) {
        const float l = q >= k ? exp2f(cum[q] - cumk) : 0.f;
        const float sl = sc[q * kTp + k] * l;
        const float dw = acc[q];
        w[q] = sl * dtk;
        const float dm = dw * sl;
        ddt1 += dm;
        tsum = fmaf(dm, dtk, tsum);
        tl[k * kTp + q] = tsum;
        acc[q] = dw * l * dtk;
      }
      __syncwarp();
      // R_j = sum_{k < j} sum_{q >= j} M[q][k], lane j
      for (int kk = 0; kk < Q; ++kk)
        if (kk < lane) R += tl[kk * kTp + lane];
      __syncwarp();
#pragma unroll
      for (int q = 0; q < Q; ++q) tl[q * kTp + k] = acc[q];   // dS_h[q][k]
      const float* gh = smem + L.gs + hh * L.dsr * PP;
      const float* hin = smem + L.hs + hh * L.dsr * PP;
      if (has_g) {
        // row k of X G^T: v_k, and u_k X G^T for dB
        float* pbh = smem + L.pb + hh * Q * DSP;
        for (int s4 = 0; s4 < DS; s4 += 4) {
          float o[4] = {};
          for (int p4 = 0; p4 < P; p4 += 4) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xh + k * PP + p4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 g =
                  *reinterpret_cast<const float4*>(gh + (s4 + i) * PP + p4);
              o[i] = fmaf(xv.x, g.x, o[i]);
              o[i] = fmaf(xv.y, g.y, o[i]);
              o[i] = fmaf(xv.z, g.z, o[i]);
              o[i] = fmaf(xv.w, g.w, o[i]);
            }
          }
          const float4 bv =
              *reinterpret_cast<const float4*>(bs + k * DSP + s4);
          v = fmaf(bv.x, o[0], v);
          v = fmaf(bv.y, o[1], v);
          v = fmaf(bv.z, o[2], v);
          v = fmaf(bv.w, o[3], v);
          *reinterpret_cast<float4*>(pbh + k * DSP + s4) =
              make_float4(uk * o[0], uk * o[1], uk * o[2], uk * o[3]);
        }
      }
      if (has_h) {
        // row q = lane of dY h_in^T: r_q, and e_q dY h_in^T for dC
        const float eq = exp2f(cumk);
        float* pch = smem + L.pc + hh * Q * DSP;
        for (int s4 = 0; s4 < DS; s4 += 4) {
          float o[4] = {};
          for (int p4 = 0; p4 < P; p4 += 4) {
            const float4 dv =
                *reinterpret_cast<const float4*>(dyh + k * PP + p4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(hin + (s4 + i) * PP + p4);
              o[i] = fmaf(dv.x, hv.x, o[i]);
              o[i] = fmaf(dv.y, hv.y, o[i]);
              o[i] = fmaf(dv.z, hv.z, o[i]);
              o[i] = fmaf(dv.w, hv.w, o[i]);
            }
          }
          const float4 cv =
              *reinterpret_cast<const float4*>(cs + k * DSP + s4);
          r = fmaf(cv.x, o[0], r);
          r = fmaf(cv.y, o[1], r);
          r = fmaf(cv.z, o[2], r);
          r = fmaf(cv.w, o[3], r);
          *reinterpret_cast<float4*>(pch + k * DSP + s4) =
              make_float4(eq * o[0], eq * o[1], eq * o[2], eq * o[3]);
        }
        r *= eq;
        if (has_g) {
          for (int s = 0; s < DS; ++s)
            for (int p = lane; p < P; p += 32)
              hg = fmaf(gh[s * PP + p], hin[s * PP + p], hg);
          hg = warp_sum(hg);
        }
      }
      // row k of dX = W^T dY + u_k B G, over x's row k (read only by lane k)
      for (int p4 = 0; p4 < P; p4 += 4) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 d = *reinterpret_cast<const float4*>(dyh + q * PP + p4);
          o.x = fmaf(w[q], d.x, o.x);
          o.y = fmaf(w[q], d.y, o.y);
          o.z = fmaf(w[q], d.z, o.z);
          o.w = fmaf(w[q], d.w, o.w);
        }
        if (has_g) {
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int s4 = 0; s4 < DS; s4 += 4) {
            const float4 bv =
                *reinterpret_cast<const float4*>(bs + k * DSP + s4);
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 g =
                  *reinterpret_cast<const float4*>(gh + (s4 + i) * PP + p4);
              t.x = fmaf(bb[i], g.x, t.x);
              t.y = fmaf(bb[i], g.y, t.y);
              t.z = fmaf(bb[i], g.z, t.z);
              t.w = fmaf(bb[i], g.w, t.w);
            }
          }
          o.x = fmaf(uk, t.x, o.x);
          o.y = fmaf(uk, t.y, o.y);
          o.z = fmaf(uk, t.z, o.z);
          o.w = fmaf(uk, t.w, o.w);
        }
        *reinterpret_cast<float4*>(xh + k * PP + p4) = o;
      }
    }
    __syncthreads();

    if (head_warp) {
      // dA_j = R_j + sum_{q >= j} r_q + sum_{k < j} u_k v_k
      //        + exp(cum_last) <G, h_in>; then ddt and da
      float rs = r, uv = smem[L.us + hh * Q + lane] * v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, rs, off);
        const float up = __shfl_up_sync(0xffffffffu, uv, off);
        if (lane + off < 32) rs += dn;
        if (lane >= off) uv += up;
      }
      float before = __shfl_up_sync(0xffffffffu, uv, 1);
      if (lane == 0) before = 0.f;
      const float dA = R + rs + before + exp2f(last) * hg;
      const float cj = smem[L.cum + hh * Q + lane];
      if (lane < qv)
        a.ddt[(static_cast<long long>(row) * a.seq + c0 + lane) * a.n + h0 +
              hh] = ddt1 + exp2f(last - cj) * v + rate * dA;
      da += warp_sum(smem[L.dts + hh * Q + lane] * dA);
    }
    // dX rows out; dS summed over the block's heads in order, in S's place
    for (int h = 0; h < H; ++h)
      store_rows(a.dx + ((static_cast<long long>(row) * a.seq + c0) * a.n +
                         h0 + h) * P,
                 static_cast<long long>(a.n) * P, smem + L.xs + h * Q * PP,
                 PP, qv, P);
    for (int e = threadIdx.x; e < Q * kTp; e += blockDim.x) {
      float d = smem[L.tile + e];
      for (int h = 1; h < H; ++h) d += smem[L.tile + h * Q * kTp + e];
      sc[e] = d;
    }
    __syncthreads();
    // dC[q] = sum_k dS[q][k] b_k + e_q dY h_in^T, dB[k] = sum_q dS[q][k] c_q
    // + u_k X G^T, the state terms summed over the block's heads in order
    const int nsc = (DS + 7) / 8;
    for (int task = threadIdx.x; task < 2 * Q * nsc; task += blockDim.x) {
      const int rq = task & 31, s0 = (task >> 5) % nsc * 8;
      const bool is_dc = task < Q * nsc;
      if (rq >= qv) continue;
      float acc[8] = {};
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float d = is_dc ? sc[rq * kTp + j] : sc[j * kTp + rq];
        const float* o = (is_dc ? bs : cs) + j * DSP + s0;
        const float4 v0 = *reinterpret_cast<const float4*>(o);
        const float4 v1 = *reinterpret_cast<const float4*>(o + 4);
        acc[0] = fmaf(d, v0.x, acc[0]);
        acc[1] = fmaf(d, v0.y, acc[1]);
        acc[2] = fmaf(d, v0.z, acc[2]);
        acc[3] = fmaf(d, v0.w, acc[3]);
        acc[4] = fmaf(d, v1.x, acc[4]);
        acc[5] = fmaf(d, v1.y, acc[5]);
        acc[6] = fmaf(d, v1.z, acc[6]);
        acc[7] = fmaf(d, v1.w, acc[7]);
      }
      if (is_dc ? has_h : has_g)
        for (int h = 0; h < H; ++h) {
          const float* o = smem + (is_dc ? L.pc : L.pb) + h * Q * DSP +
                           rq * DSP + s0;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += o[i];
        }
      const long long at =
          (static_cast<long long>(row) * a.seq + c0 + rq) * DS + s0;
      if (hgroups == 1)
        store8((is_dc ? a.dc : a.db) + at, acc, DS - s0, DS % 8 == 0);
      else
        store8(a.part_bc + ((is_dc ? hgroups : 0) + blockIdx.y) *
                               (static_cast<long long>(a.batch) * a.seq *
                                DS) + at,
               acc, DS - s0, DS % 8 == 0);
    }
    // the chunk before's G = exp(cum_last) G + C^T diag(e) dY: state tiles,
    // lane = column
    if (has_h)
      for (int task = warp; task < H * st * pt; task += warps) {
        const int h = task / (st * pt), s0 = task / pt % st * kTile;
        const int p = task % pt * kTile + lane, pc = min(p, PP - 1);
        float acc[kTile] = {};
        state_tile(acc, cs, DSP, s0, DS, smem + L.dys + h * Q * PP + pc, PP,
                   smem + L.es + h * Q);
        if (p >= P) continue;
        const float decay = smem[L.dec + h];
        float* gcol = smem + L.gs + h * L.dsr * PP + p;
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (s0 + i < DS)
            gcol[(s0 + i) * PP] = (has_g ? gcol[(s0 + i) * PP] * decay : 0.f) +
                                  acc[i];
      }
  }
  if (head_warp && lane == 0)
    a.part_da[static_cast<long long>(row) * a.n + h0 + hh] = rate * da;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core form of the backward (ssd_bwd_mma_kernel): S = 32,
// ds = 16, p = 32, one chunk
// ---------------------------------------------------------------------------

constexpr int kBwdRing = 2;   // cp.async stages: rows in flight a block
constexpr int kDsPitch = 36;  // f32 rows of a head's dS^T tile

// bytes of one ring stage: c and b, then per head its x and dy (bf16),
// then dt (Q rows of n floats). A head's x and dy, once read into
// fragments, hold its f32 step tiles (M, then dS^T) and its bf16 dX.
__host__ __device__ inline int bwd_mma_stage_bytes(int heads) {
  return 2 * (2 * kMmaQ * kBcPitch + 2 * heads * kMmaQ * kXPitch) +
         4 * kMmaQ * heads;
}

// Per row, warp hh = head hh:
// - the cumsum of dt * rate as a warp scan (lane = step, log2 units);
// - S^T = B C^T and dW^T = X dY^T on mma.sync (rows k, columns q; the
//   tiles below the diagonal, q < k, skipped), exact bf16 products;
// - in their accumulators: W^T = S^T exp2(cum_q - cum_k) dt_k, split into
//   bf16 big and small parts as the A fragments of dX = W^T dY; dS^T =
//   dW^T exp2(cum_q - cum_k) dt_k; M = dW^T o W^T to the step tile for the
//   straddle sums; the row sums of dW^T o S^T o L (ddt's first term);
// - dX rounded once to bf16 through its x and dy area, stored in whole
//   64-byte rows; ddt and the row's a dL/da partial;
// - dS^T (f32) to its step tile; after a block barrier four warp tasks sum
//   the heads' tiles in order, split the sum in two and form dB = dS^T C
//   and dC = dS B on mma.sync, rounded once to bf16.
__global__ void __launch_bounds__(32 * kMmaMaxHeads)
ssd_bwd_mma_kernel(const BwdArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int Q = kMmaQ, P = kMmaP, DS = kMmaDs, RING = kBwdRing;
  const int H = a.n;
  const int hh = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int stage = bwd_mma_stage_bytes(H);
  const int items = (a.batch - static_cast<int>(blockIdx.x) +
                     static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);
  auto item_row = [&](int k) {
    return static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x);
  };
  auto head_area = [&](int slot, int h) {   // x, then dy, of head h
    return reinterpret_cast<bf16*>(smem_b + slot * stage) +
           2 * Q * kBcPitch + 2 * h * Q * kXPitch;
  };

  // stage row item k: c, b, x and dy by 16-byte copies, dt by 4
  auto stage_item = [&](int k) {
    if (k < items) {
      const int row = item_row(k);
      bf16* cs = reinterpret_cast<bf16*>(smem_b + (k % RING) * stage);
      bf16* bs = cs + Q * kBcPitch;
      float* dts = reinterpret_cast<float*>(head_area(k % RING, H));
      const bf16* cg = a.c + row * a.sc_b;
      const bf16* bg = a.b + row * a.sb_b;
      for (int e = threadIdx.x; e < 2 * Q; e += blockDim.x) {
        const int r = e >> 1, part = (e & 1) * 8;
        cp_async16_b(cs + r * kBcPitch + part, cg + r * a.sc_s + part);
        cp_async16_b(bs + r * kBcPitch + part, bg + r * a.sb_s + part);
      }
      const bf16* xg = a.x + row * a.sx_b;
      const bf16* dyg = a.dy + row * a.sdy_b;
      for (int e = threadIdx.x; e < H * Q * 4; e += blockDim.x) {
        const int h = e / (4 * Q), r = (e >> 2) % Q, part = (e & 3) * 8;
        bf16* xs = head_area(k % RING, h);
        cp_async16_b(xs + r * kXPitch + part,
                     xg + r * a.sx_s + h * a.sx_h + part);
        cp_async16_b(xs + (Q + r) * kXPitch + part,
                     dyg + r * a.sdy_s + h * a.sdy_h + part);
      }
      const float* dg = a.dt + row * a.sdt_b;
      for (int e = threadIdx.x; e < Q * H; e += blockDim.x)
        cp_async4_b(dts + e, dg + (e / H) * a.sdt_s + e % H);
    }
    cp_async_commit();   // an empty group past the last item
  };

  for (int k = 0; k < RING; ++k) stage_item(k);
  float da = 0.f;
  for (int k = 0; k < items; ++k) {
    cp_async_wait<RING - 1>();
    __syncthreads();
    const int row = item_row(k), slot = k % RING;
    const bf16* cs = reinterpret_cast<const bf16*>(smem_b + slot * stage);
    const bf16* bs = cs + Q * kBcPitch;
    bf16* xs = head_area(slot, hh);
    const bf16* dys = xs + Q * kXPitch;
    float* tile = reinterpret_cast<float*>(xs);
    const float* dts = reinterpret_cast<const float*>(head_area(slot, H));
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
    // the fragments' steps: rows k = 16 mi + g + 8 h2, columns q =
    // 8 j + 2 t4 + i
    float ck[2][2], dk[2][2], cq[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        ck[mi][h2] = __shfl_sync(0xffffffffu, cum2, 16 * mi + 8 * h2 + g);
        dk[mi][h2] = __shfl_sync(0xffffffffu, dtq, 16 * mi + 8 * h2 + g);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cq[j][i] = __shfl_sync(0xffffffffu, cum2, 8 * j + 2 * t4 + i);

    // B fragments of c and of dy (n = q: per n-tile of 8 steps; dy per
    // k-step of 16 columns), of dy^T for dX (k = q, n = p), and the A
    // fragments of b and x (rows k)
    uint32_t fc[4][2], fdy[2][4][2], fdyt[2][4][2], fb[2][4], fx[2][2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r4[4];
      ldmatrix_x4<false>(r4, cs + (16 * jj + (lane >> 4) * 8 + (lane & 7)) *
                                      kBcPitch + ((lane >> 3) & 1) * 8);
      fc[2 * jj][0] = r4[0], fc[2 * jj][1] = r4[1];
      fc[2 * jj + 1][0] = r4[2], fc[2 * jj + 1][1] = r4[3];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldmatrix_x4<false>(r4, dys + (16 * jj + (lane >> 4) * 8 +
                                      (lane & 7)) * kXPitch +
                                   16 * kk + ((lane >> 3) & 1) * 8);
        fdy[kk][2 * jj][0] = r4[0], fdy[kk][2 * jj][1] = r4[1];
        fdy[kk][2 * jj + 1][0] = r4[2], fdy[kk][2 * jj + 1][1] = r4[3];
        ldmatrix_x4<true>(r4, dys + (16 * kk + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * kXPitch +
                                  8 * (2 * jj + (lane >> 4)));
        fdyt[kk][2 * jj][0] = r4[0], fdyt[kk][2 * jj][1] = r4[1];
        fdyt[kk][2 * jj + 1][0] = r4[2], fdyt[kk][2 * jj + 1][1] = r4[3];
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rr = 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4<false>(fb[mi], bs + rr * kBcPitch + (lane >> 4) * 8);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4<false>(fx[mi][kk],
                           xs + rr * kXPitch + 16 * kk + (lane >> 4) * 8);
    }
    __syncwarp();   // x and dy read: the step tile may land on them

    // S^T and dW^T per (m-tile mi, n-tile j >= 2 mi); W^T's A fragments
    // (big, small), dS^T kept, M to the tile (pitch kTp), ddt's first term
    uint32_t wb[2][2][4], wsm[2][2][4];
    float dsr[2][4][4], rowsum[2][2] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 2 * mi; j < 4; ++j) {
        float st[4] = {}, dw[4] = {};
        mma_bf16(st, fb[mi], fc[j]);
        mma_bf16(dw, fx[mi][0], fdy[0][j]);
        mma_bf16(dw, fx[mi][1], fdy[1][j]);
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1, i = e & 1;
          const int kr = 16 * mi + g + 8 * h2, qc = 8 * j + 2 * t4 + i;
          const float l =
              qc >= kr ? exp2f(cq[j][i] - ck[mi][h2]) : 0.f;
          const float sl = st[e] * l;
          w[e] = sl * dk[mi][h2];
          const float dm = dw[e] * sl;
          rowsum[mi][h2] += dm;
          tile[kr * kTp + qc] = dm * dk[mi][h2];
          dsr[mi][j][e] = dw[e] * l * dk[mi][h2];
        }
        const int kk = j >> 1, base = (j & 1) * 2;
        split_bf16x2(w[0], w[1], wb[mi][kk][base], wsm[mi][kk][base]);
        split_bf16x2(w[2], w[3], wb[mi][kk][base + 1],
                     wsm[mi][kk][base + 1]);
      }
    // ddt's first term by row: over the four lanes of a row, then lane k
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        rowsum[mi][h2] += __shfl_xor_sync(0xffffffffu, rowsum[mi][h2], 1);
        rowsum[mi][h2] += __shfl_xor_sync(0xffffffffu, rowsum[mi][h2], 2);
      }
    float ddt1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float t = __shfl_sync(0xffffffffu, rowsum[mi][h2],
                                    (lane & 7) * 4);
        if ((lane >> 4) == mi && ((lane >> 3) & 1) == h2) ddt1 = t;
      }
    __syncwarp();
    // the straddle: lane k's suffix sums of its row of M, then R_j, lane j
    {
      float tsum = 0.f;
#pragma unroll
      for (int q = Q - 1; q >= 0; --q) {
        if (q > lane) tsum += tile[lane * kTp + q];
        tile[lane * kTp + q] = tsum;
      }
    }
    __syncwarp();
    float R = 0.f;
    for (int kk = 0; kk < Q; ++kk)
      if (kk < lane) R += tile[kk * kTp + lane];
    __syncwarp();
    a.ddt[(static_cast<long long>(row) * Q + lane) * H + hh] =
        ddt1 + rate * R;
    da += warp_sum(dtq * R);

    // dX = W^T dY, rows k, rounded once into the head's area
    bf16* dxs = xs;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float acc[4][4] = {};
#pragma unroll
      for (int kk = mi; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_bf16(acc[np], wsm[mi][kk], fdyt[kk][np]);
          mma_bf16(acc[np], wb[mi][kk], fdyt[kk][np]);
        }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int kr = 16 * mi + g, col = 8 * np + 2 * t4;
        *reinterpret_cast<uint32_t*>(dxs + kr * kXPitch + col) =
            bf16x2_rn(acc[np][0], acc[np][1]);
        *reinterpret_cast<uint32_t*>(dxs + (kr + 8) * kXPitch + col) =
            bf16x2_rn(acc[np][2], acc[np][3]);
      }
    }
    __syncwarp();
    bf16* dx = a.dx + static_cast<long long>(row) * Q * H * P + hh * P;
    for (int e = lane; e < Q * 4; e += 32) {
      const int q = e >> 2, part = (e & 3) * 8;
      *reinterpret_cast<uint4*>(dx + static_cast<long long>(q) * H * P +
                                part) =
          *reinterpret_cast<const uint4*>(dxs + q * kXPitch + part);
    }
    __syncwarp();
    // dS^T to the step tile (pitch kDsPitch), zero below the diagonal tiles
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = 16 * mi + g, qc = 8 * j + 2 * t4;
        const bool on = j >= 2 * mi;
        *reinterpret_cast<float2*>(tile + kr * kDsPitch + qc) =
            on ? make_float2(dsr[mi][j][0], dsr[mi][j][1])
               : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(tile + (kr + 8) * kDsPitch + qc) =
            on ? make_float2(dsr[mi][j][2], dsr[mi][j][3])
               : make_float2(0.f, 0.f);
      }
    __syncthreads();

    // dB (rows k) = dS^T C and dC (rows q) = dS B: A fragments of the sum
    // of the heads' tiles in order, split in two; C and B as B fragments
    // (k = step, n = s) by ldmatrix.trans
    for (int task = hh; task < 4; task += H) {
      const bool is_dc = task >= 2;
      const int mi = task & 1;
      const bf16* src = is_dc ? bs : cs;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // A element e: row 16 mi + g + 8 (e / 2 % 2), column
          // 16 kk + 2 t4 + e % 2 + 8 (e / 4)
          const int rr = 16 * mi + g + 8 * ((e >> 1) & 1);
          const int cc = 16 * kk + 2 * t4 + (e & 1) + 8 * (e >> 2);
          const int at = is_dc ? cc * kDsPitch + rr : rr * kDsPitch + cc;
          float s = 0.f;
          for (int h = 0; h < H; ++h)
            s += reinterpret_cast<const float*>(head_area(slot, h))[at];
          f[e] = s;
        }
        uint32_t big[4], small[4];
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4)
          split_bf16x2(f[2 * r4], f[2 * r4 + 1], big[r4], small[r4]);
        uint32_t r4[4], fo[2][2];
        ldmatrix_x4<true>(r4, src + (16 * kk + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * kBcPitch +
                                  8 * (lane >> 4));
        fo[0][0] = r4[0], fo[0][1] = r4[1];
        fo[1][0] = r4[2], fo[1][1] = r4[3];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[np], small, fo[np]);
          mma_bf16(acc[np], big, fo[np]);
        }
      }
      bf16* out = (is_dc ? a.dc : a.db) + static_cast<long long>(row) * Q * DS;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int rr = 16 * mi + g, col = 8 * np + 2 * t4;
        *reinterpret_cast<uint32_t*>(out + rr * DS + col) =
            bf16x2_rn(acc[np][0], acc[np][1]);
        *reinterpret_cast<uint32_t*>(out + (rr + 8) * DS + col) =
            bf16x2_rn(acc[np][2], acc[np][3]);
      }
    }
    if (lane == 0)
      a.part_da[static_cast<long long>(row) * H + hh] = rate * da;
    da = 0.f;
    __syncthreads();   // every warp is done with this stage
    stage_item(k + RING);
  }
}

// ---------------------------------------------------------------------------
// The f32 tensor-core form of the backward (ssd_bwd_tf32_kernel): S = 32,
// ds = 16, p = 32, one chunk, every product in 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int kTfRing = 1;     // cp.async stages: rows in flight a block
constexpr int kTfBcPitch = 20;  // f32 rows of c and b (4 mod 8: fragment
                                // loads conflict-free)
constexpr int kTfXPitch = 36;   // f32 rows of x, dy and the step tiles

// floats of one ring stage: c and b, then per head its x and dy, then dt
// (Q rows of n floats). A head's x area, once read into fragments, holds
// its step tiles (M, W^T, dX, then dS^T) in turn.
__host__ __device__ inline int bwd_tf32_stage_floats(int heads) {
  return 2 * kMmaQ * kTfBcPitch + 2 * heads * kMmaQ * kTfXPitch +
         kMmaQ * heads;
}

// cvt.rna.tf32.f32 on the integer units: the magnitude rounded to 10
// mantissa bits, ties away from zero
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = big + small, each a TF32 value: 3xTF32 drops only small * small
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

// An A fragment (16 x 8) of a row-major f32 tile at (row0, k0), split
struct Tf32A {
  uint32_t big[4], small[4];
};
struct Tf32B {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ Tf32A tf32_a(const float* t, int pitch, int row0,
                                        int k0) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float* r = t + (row0 + g) * pitch + k0 + t4;
  Tf32A f;
  split_tf32(r[0], f.big[0], f.small[0]);
  split_tf32(r[8 * pitch], f.big[1], f.small[1]);
  split_tf32(r[4], f.big[2], f.small[2]);
  split_tf32(r[8 * pitch + 4], f.big[3], f.small[3]);
  return f;
}

// a B fragment (8 x 8, k x n) of a tile stored n-major (row n holds its k
// values: c, b and dy rows against steps) or k-major (row k holds its n
// values)
template <bool KMAJOR>
__device__ __forceinline__ Tf32B tf32_b(const float* t, int pitch, int n0,
                                        int k0) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  Tf32B f;
  if constexpr (KMAJOR) {
    split_tf32(t[(k0 + t4) * pitch + n0 + g], f.big[0], f.small[0]);
    split_tf32(t[(k0 + t4 + 4) * pitch + n0 + g], f.big[1], f.small[1]);
  } else {
    split_tf32(t[(n0 + g) * pitch + k0 + t4], f.big[0], f.small[0]);
    split_tf32(t[(n0 + g) * pitch + k0 + t4 + 4], f.big[1], f.small[1]);
  }
  return f;
}

// c += a b in 3xTF32: the small products first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32A& a,
                                           const Tf32B& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// Per row, warp hh = head hh, as ssd_bwd_mma_kernel but on f32 tiles
// staged by 16-byte cp.async, every fragment split into TF32 big and small
// parts as it leaves shared memory: S^T = B C^T and dW^T = X dY^T (rows k,
// columns q; tiles below the diagonal skipped); W^T, dS^T, M and ddt's
// first term in their accumulators; W^T through the head's x area as dX's
// A fragments; dS^T summed over heads in order for dB and dC.
__global__ void __launch_bounds__(32 * kMmaMaxHeads)
ssd_bwd_tf32_kernel(const BwdArgs<float> a) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int Q = kMmaQ, P = kMmaP, DS = kMmaDs, RING = kTfRing;
  const int H = a.n;
  const int hh = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int stage = bwd_tf32_stage_floats(H);
  const int items = (a.batch - static_cast<int>(blockIdx.x) +
                     static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);
  auto item_row = [&](int k) {
    return static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x);
  };
  auto head_area = [&](int slot, int h) {   // x, then dy, of head h
    return smem_f + slot * stage + 2 * Q * kTfBcPitch + 2 * h * Q * kTfXPitch;
  };

  auto stage_item = [&](int k) {
    if (k < items) {
      const int row = item_row(k);
      float* cs = smem_f + (k % RING) * stage;
      float* bs = cs + Q * kTfBcPitch;
      float* dts = head_area(k % RING, H);
      const float* cg = a.c + row * a.sc_b;
      const float* bg = a.b + row * a.sb_b;
      for (int e = threadIdx.x; e < 4 * Q; e += blockDim.x) {
        const int r = e >> 2, part = (e & 3) * 4;
        cp_async16(cs + r * kTfBcPitch + part, cg + r * a.sc_s + part);
        cp_async16(bs + r * kTfBcPitch + part, bg + r * a.sb_s + part);
      }
      const float* xg = a.x + row * a.sx_b;
      const float* dyg = a.dy + row * a.sdy_b;
      for (int e = threadIdx.x; e < H * Q * 8; e += blockDim.x) {
        const int h = e / (8 * Q), r = (e >> 3) % Q, part = (e & 7) * 4;
        float* xs = head_area(k % RING, h);
        cp_async16(xs + r * kTfXPitch + part,
                   xg + r * a.sx_s + h * a.sx_h + part);
        cp_async16(xs + (Q + r) * kTfXPitch + part,
                   dyg + r * a.sdy_s + h * a.sdy_h + part);
      }
      const float* dg = a.dt + row * a.sdt_b;
      for (int e = threadIdx.x; e < Q * H; e += blockDim.x)
        cp_async4(dts + e, dg + (e / H) * a.sdt_s + e % H);
    }
    cp_async_commit();   // an empty group past the last item
  };

  for (int k = 0; k < RING; ++k) stage_item(k);
  for (int k = 0; k < items; ++k) {
    cp_async_wait<RING - 1>();
    __syncthreads();
    const int row = item_row(k), slot = k % RING;
    const float* cs = smem_f + slot * stage;
    const float* bs = cs + Q * kTfBcPitch;
    float* xs = head_area(slot, hh);
    const float* dys = xs + Q * kTfXPitch;
    const float* dts = head_area(slot, H);
    const float rate = -expf(load_f32(
        a.a_log, (row / a.rows_per_slot) * a.sa_slot + hh, a.a_bf16));

    const float dtq = dts[lane * H + hh];
    float v = dtq * rate;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    const float cum2 = v * kLog2e;
    float ck[2][2], dk[2][2], cq[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        ck[mi][h2] = __shfl_sync(0xffffffffu, cum2, 16 * mi + 8 * h2 + g);
        dk[mi][h2] = __shfl_sync(0xffffffffu, dtq, 16 * mi + 8 * h2 + g);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cq[j][i] = __shfl_sync(0xffffffffu, cum2, 8 * j + 2 * t4 + i);

    // S^T and dW^T per (m-tile mi, n-tile j >= 2 mi): W^T and dS^T kept,
    // M's entries and ddt's first term
    float wt[2][4][4], dsr[2][4][4], mt[2][4][4], rowsum[2][2] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      Tf32A fb[2], fx[4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) fb[ks] = tf32_a(bs, kTfBcPitch, 16 * mi,
                                                     8 * ks);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fx[ks] = tf32_a(xs, kTfXPitch, 16 * mi,
                                                     8 * ks);
#pragma unroll
      for (int j = 2 * mi; j < 4; ++j) {
        float st[4] = {}, dw[4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma_3xtf32(st, fb[ks], tf32_b<false>(cs, kTfBcPitch, 8 * j, 8 * ks));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_3xtf32(dw, fx[ks], tf32_b<false>(dys, kTfXPitch, 8 * j, 8 * ks));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1, i = e & 1;
          const int kr = 16 * mi + g + 8 * h2, qc = 8 * j + 2 * t4 + i;
          const float l = qc >= kr ? exp2f(cq[j][i] - ck[mi][h2]) : 0.f;
          const float sl = st[e] * l;
          wt[mi][j][e] = sl * dk[mi][h2];
          const float dm = dw[e] * sl;
          rowsum[mi][h2] += dm;
          mt[mi][j][e] = dm * dk[mi][h2];
          dsr[mi][j][e] = dw[e] * l * dk[mi][h2];
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        rowsum[mi][h2] += __shfl_xor_sync(0xffffffffu, rowsum[mi][h2], 1);
        rowsum[mi][h2] += __shfl_xor_sync(0xffffffffu, rowsum[mi][h2], 2);
      }
    float ddt1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float t = __shfl_sync(0xffffffffu, rowsum[mi][h2],
                                    (lane & 7) * 4);
        if ((lane >> 4) == mi && ((lane >> 3) & 1) == h2) ddt1 = t;
      }
    // the head's step tile from C-layout registers (`tri`: zero below
    // the diagonal tiles)
    auto put = [&](int pitch, const float (&v)[2][4][4], bool tri) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = 16 * mi + g, qc = 8 * j + 2 * t4;
          const bool on = !tri || j >= 2 * mi;
          xs[kr * pitch + qc] = on ? v[mi][j][0] : 0.f;
          xs[kr * pitch + qc + 1] = on ? v[mi][j][1] : 0.f;
          xs[(kr + 8) * pitch + qc] = on ? v[mi][j][2] : 0.f;
          xs[(kr + 8) * pitch + qc + 1] = on ? v[mi][j][3] : 0.f;
        }
    };
    __syncwarp();   // x read: its area takes the step tiles
    put(kTp, mt, true);
    __syncwarp();
    {
      float tsum = 0.f;
#pragma unroll
      for (int q = Q - 1; q >= 0; --q) {
        if (q > lane) tsum += xs[lane * kTp + q];
        xs[lane * kTp + q] = tsum;
      }
    }
    __syncwarp();
    float R = 0.f;
    for (int kk = 0; kk < Q; ++kk)
      if (kk < lane) R += xs[kk * kTp + lane];
    a.ddt[(static_cast<long long>(row) * Q + lane) * H + hh] =
        ddt1 + rate * R;
    const float da = warp_sum(dtq * R);
    if (lane == 0) a.part_da[static_cast<long long>(row) * H + hh] = rate * da;
    __syncwarp();

    // dX = W^T dY (rows k): W^T through the x area as A fragments
    put(kTfXPitch, wt, true);
    __syncwarp();
    float dxa[2][4][4] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int kq = 2 * mi; kq < 4; ++kq) {
        const Tf32A fw = tf32_a(xs, kTfXPitch, 16 * mi, 8 * kq);
#pragma unroll
        for (int np = 0; np < 4; ++np)
          mma_3xtf32(dxa[mi][np], fw,
                     tf32_b<true>(dys, kTfXPitch, 8 * np, 8 * kq));
      }
    __syncwarp();
    put(kTfXPitch, dxa, false);
    __syncwarp();
    float* dx = a.dx + static_cast<long long>(row) * Q * H * P + hh * P;
    for (int e = lane; e < Q * 8; e += 32) {
      const int q = e >> 3, part = (e & 7) * 4;
      *reinterpret_cast<float4*>(dx + static_cast<long long>(q) * H * P +
                                 part) =
          *reinterpret_cast<const float4*>(xs + q * kTfXPitch + part);
    }
    __syncwarp();
    put(kTfXPitch, dsr, true);   // dS^T
    __syncthreads();

    // dB (rows k) = dS^T C and dC (rows q) = dS B, A fragments of the sum
    // of the heads' dS^T tiles in order
    for (int task = hh; task < 4; task += H) {
      const bool is_dc = task >= 2;
      const int mi = task & 1;
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // A element e: row 16 mi + g + 8 (e % 2), column 8 ks + t4 +
          // 4 (e / 2)
          const int rr = 16 * mi + g + 8 * (e & 1);
          const int cc = 8 * ks + t4 + 4 * (e >> 1);
          const int at = is_dc ? cc * kTfXPitch + rr : rr * kTfXPitch + cc;
          float s = 0.f;
          for (int h = 0; h < H; ++h) s += head_area(slot, h)[at];
          f[e] = s;
        }
        Tf32A fa;
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(f[e], fa.big[e], fa.small[e]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          mma_3xtf32(acc[np], fa,
                     tf32_b<true>(is_dc ? bs : cs, kTfBcPitch, 8 * np,
                                  8 * ks));
      }
      float* out =
          (is_dc ? a.dc : a.db) + static_cast<long long>(row) * Q * DS;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int rr = 16 * mi + g, col = 8 * np + 2 * t4;
        *reinterpret_cast<float2*>(out + rr * DS + col) =
            make_float2(acc[np][0], acc[np][1]);
        *reinterpret_cast<float2*>(out + (rr + 8) * DS + col) =
            make_float2(acc[np][2], acc[np][3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
    stage_item(k + RING);
  }
}

// db and dc: the head groups' f32 partials summed in order, rounded once to
// T (where heads < n; the first bc_blocks blocks, a thread an element);
// da_log: a dL/da summed over a slot's rows and each row's da_parts parts,
// in a_log's dtype (the blocks after them, a warp per (slot, head): lane l
// adds parts l, l + 32, ... of the slot's (row, part) list in order, then
// a butterfly over the lanes, the same order every run)
template <typename T>
__global__ void ssd_bwd_sum_kernel(const BwdArgs<T> a, int bc_blocks) {
  if (static_cast<int>(blockIdx.x) < bc_blocks) {
    const int hgroups = a.n / a.heads;
    const long long nbc = static_cast<long long>(a.batch) * a.seq * a.ds;
    for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         e < nbc; e += static_cast<long long>(bc_blocks) * blockDim.x) {
      float sb = 0.f, sc = 0.f;
      for (int h = 0; h < hgroups; ++h) {
        sb += a.part_bc[h * nbc + e];
        sc += a.part_bc[(hgroups + h) * nbc + e];
      }
      a.db[e] = from_f32<T>(sb);
      a.dc[e] = from_f32<T>(sc);
    }
    return;
  }
  const int i = ((static_cast<int>(blockIdx.x) - bc_blocks) * blockDim.x +
                 threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= a.groups * a.n) return;   // whole warps
  const int slot = i / a.n;
  const int parts = a.da_parts;
  const float* pd = a.part_da +
                    (static_cast<long long>(slot) * a.rows_per_slot * a.n +
                     (i - slot * a.n)) * parts;
  float acc = 0.f;
  for (int j = lane; j < a.rows_per_slot * parts; j += 32)
    acc += pd[static_cast<long long>(j / parts) * a.n * parts + j % parts];
  acc = warp_sum(acc);
  if (lane == 0) {
    if (a.a_bf16)
      static_cast<bf16*>(a.da_log)[i] = __float2bfloat16_rn(acc);
    else
      static_cast<float*>(a.da_log)[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// The chunk-parallel tensor-core forms (ssd_tc_state_kernel,
// ssd_tc_pass_kernel, ssd_tc_out_kernel, ssd_tc_bwd_kernel): few rows over
// many chunks, mamba2-2.7b's step
// ---------------------------------------------------------------------------
//
// Mamba-2's own chunked decomposition (arXiv:2405.21060), over chunks of
// kTcQ = 64 steps, with a block per (head, chunk, row) where the forms
// above walk a row's chunks in one block:
// 1. chunk states (ssd_tc_state_kernel): the cumsum in log2 units, the
//    chunk's own end state s_c = B^T diag(u) X and its total decay
//    exp(cum_last); for the backward also the chunk's own boundary
//    cotangent g_c = C^T diag(e) dY (u, e as in the backward's note above);
// 2. state passing (ssd_tc_pass_kernel), per (row, head) and four state
//    entries a thread, over the chunks in order: h_in[c + 1] = h_in[c]
//    dec[c] + s_c forwards, and for the backward G[c - 1] = G[c] dec[c] +
//    g_c in reverse, each in place of the chunk's own term;
// 3. forward (ssd_tc_out_kernel): y = (L o C B^T) diag(dt) X + diag(e) C
//    h_in; backward (ssd_tc_bwd_kernel): the chunk's adjoint from its h_in
//    and G, the terms of ssd_bwd_chunk_kernel's note (S, W, dW, M, dS, the
//    straddle, X G^T, dY h_in^T) with dB and dC per head;
// 4. (backward) ssd_bwd_sum_kernel sums dB and dC over heads and da over a
//    slot's rows and chunks, each in a fixed order: no float atomics.
// Every product runs in 3xTF32 on mma.sync m16n8k8 (tf32_a, tf32_b,
// mma_3xtf32: operands split into TF32 big and small parts as they leave
// shared memory, small * small dropped), warps sharing out tasks of 16
// rows by 16 or 32 columns; the elementwise terms (decays, masks, row
// sums) come from the accumulators' registers.
//
// What bounds them on an H100, at mamba2-2.7b's (1, 4096, 80, 64), ds
// 128. The work is 12 GFLOP a forward and twice that a backward (the
// chunked form at chunks of 64): 0.07 and 0.15 ms at the 3xTF32 rate. The
// bytes the design adds are the scratch: h_in and G are (B, n, chunks,
// ds, p) in f32, 168 MB each at chunks of 64 (twice that at 32), written by
// pass 1, read and written by pass 2, read by pass 3, and the backward's
// per-head dB and dC partials 336 MB more. A chunk of 64 halves those
// bytes against 32 while its Q x Q tiles and a block's operands still fit
// the card's shared memory (the adjoint's block takes 206 KB, one an SM;
// the output block 105 KB, two an SM, its state loaded into b's place once
// the scores are formed). What holds the adjoint and the outputs at
// several times those bounds is latency inside a block (its phases apart
// by barriers, one or two blocks an SM, each operand split as it is
// read; PERF.md §6). The state pass was a thread's serial chain of
// dependent loads in ssd_chunk_scan_kernel (a chunk's load issued after
// the previous chunk's store); here a thread issues kTcDepth chunks'
// 16-byte loads before it walks them.

constexpr int kTcQ = 64;             // the chunk: four m-tiles of 16 steps
constexpr int kTcThreads = 512;      // outputs: 16 warps
constexpr int kTcOutCols = 16;       // ... each task 16 steps by 16 of p
constexpr int kTcBwdThreads = 512;   // the adjoint: 16 warps
constexpr int kTcStateThreads = 256; // chunk states: 8 warps
// the adjoint's score tasks 16 columns wide (ten) instead of up to 32 (six)
constexpr bool kTcFineUpper = true;
// a warp takes each score task, and one more warp the cumsum meanwhile
static_assert(kTcThreads / 32 > 6, "the outputs' block: too few warps");
static_assert(kTcBwdThreads / 32 > (kTcFineUpper ? 10 : 6),
              "the adjoint's block: too few warps");
constexpr int kTcDepth = 8;          // the state pass's chunks in flight
constexpr int kTcTp = kTcQ + 4;      // pitch of the Q x Q tiles

template <typename T>
struct TcArgs {
  const T* x;          // (B, S, n, p)
  const float* dt;     // (B, S, n)
  const void* a_log;   // (slots, n), f32 or (a_bf16) bf16
  const T* b;          // (B, S, ds)
  const T* c;          // (B, S, ds)
  const T* dy;         // (B, S, n, p): the backward's cotangent
  T* y;                // (B, S, n, p), contiguous: y, or the backward's dx
  float* ddt;          // (B, S, n), contiguous (backward)
  float* states;       // (B, n, chunks, ds, p): s_c, then h_in
  float* grads;        // (B, n, chunks, ds, p): g_c, then G (backward)
  float* decays;       // (B, n, chunks): exp(cum_last)
  float* part_bc;      // (2, n, B, S, ds): dB and dC per head (backward)
  float* part_da;      // (B, n, chunks): a dL/da per chunk (backward)
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sdy_b,
      sdy_s, sdy_h, sa_slot;
  int batch, seq, n, p, ds, chunks, rows_per_slot, a_bf16, vec_x, vec_bc;
};

// An A fragment (16 x 8) at (row0, k0) of a tile stored transposed (row k
// of the tile holds the operand's column k), split
__device__ __forceinline__ Tf32A tf32_at(const float* t, int pitch, int row0,
                                         int k0) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float* r = t + (k0 + t4) * pitch + row0 + g;
  Tf32A f;
  split_tf32(r[0], f.big[0], f.small[0]);
  split_tf32(r[8], f.big[1], f.small[1]);
  split_tf32(r[4 * pitch], f.big[2], f.small[2]);
  split_tf32(r[4 * pitch + 8], f.big[3], f.small[3]);
  return f;
}

// acc[j] (the C tiles of n-tiles j < nt from column n0) += A (16 rows from
// row0, k in [k0, k1)) B in 3xTF32; AT: A stored transposed, BK: B stored
// k-major (tf32_b)
template <bool AT, bool BK>
__device__ __forceinline__ void tc_gemm(float (&acc)[4][4], const float* a,
                                        int lda, int row0, const float* b,
                                        int ldb, int n0, int nt, int k0,
                                        int k1) {
  for (int k = k0; k < k1; k += 8) {
    Tf32A fa;
    if constexpr (AT)
      fa = tf32_at(a, lda, row0, k);
    else
      fa = tf32_a(a, lda, row0, k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nt) mma_3xtf32(acc[j], fa, tf32_b<BK>(b, ldb, n0 + 8 * j, k));
  }
}

// two adjacent f32 results in T, one store (8 bytes f32, 4 bf16)
template <typename T>
__device__ __forceinline__ void store2(T* out, float lo, float hi) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(out) = make_float2(lo, hi);
  else
    *reinterpret_cast<uint32_t*>(out) = bf16x2_rn(lo, hi);
}

// a chunk's dt (rows past its end zero), by cp.async
__device__ __forceinline__ void tc_stage_dt(float* dts, const float* dt,
                                            long long ld, int qv) {
  for (int t = threadIdx.x; t < kTcQ; t += blockDim.x)
    if (t < qv)
      cp_async4(dts + t, dt + t * ld);
    else
      dts[t] = 0.f;
}

// The cumsum of the chunk (log2 units), u and e by one warp; returns
// cum_last
__device__ __forceinline__ float tc_scan(const float* dts, float* cum,
                                         float* us, float* es, float rate) {
  const float last = warp_scan(dts, cum, us, rate, kTcQ);
  for (int q = threadIdx.x & 31; q < kTcQ; q += 32) es[q] = exp2f(cum[q]);
  return last;
}

// Shared memory of ssd_tc_state_kernel, in floats: b (and with `grad` c),
// kTcQ rows of pitch ds + 8 (read transposed as A fragments: the pitch
// makes those reads conflict-free), x (and dy), kTcQ rows of pitch p + 8
// (read k-major as B fragments), then dt, cum, u and e.
struct TcStateLayout {
  int bp, xp, bs, cs, xs, dys, dts, cum, us, es, total;
};

inline __host__ __device__ TcStateLayout tc_state_layout(int p, int ds,
                                                         bool grad) {
  TcStateLayout l;
  l.bp = ds + 8;
  l.xp = p + 8;
  l.bs = 0;
  l.cs = l.bs + kTcQ * l.bp;
  l.xs = l.cs + (grad ? kTcQ * l.bp : 0);
  l.dys = l.xs + kTcQ * l.xp;
  l.dts = l.dys + (grad ? kTcQ * l.xp : 0);
  l.cum = l.dts + kTcQ;
  l.us = l.cum + kTcQ;
  l.es = l.us + kTcQ;
  l.total = l.es + kTcQ;
  return l;
}

// Pass 1: block (head, chunk, row). s_c = B^T (u X) where a later chunk
// takes it, g_c = C^T (e dY) (with `grad`) where an earlier one does, each
// (ds x p) as tasks of 16 state rows by 32 columns; the chunk's decay.
template <typename T>
__global__ void __launch_bounds__(kTcStateThreads)
ssd_tc_state_kernel(const TcArgs<T> a, int grad) {
  extern __shared__ __align__(16) float smem[];
  constexpr int Q = kTcQ;
  const int P = a.p, DS = a.ds;
  const TcStateLayout L = tc_state_layout(P, DS, grad);
  const int h = blockIdx.x, ci = blockIdx.y, row = blockIdx.z;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int c0 = ci * Q, qv = min(Q, a.seq - c0);
  const bool own = ci + 1 < a.chunks, back = grad && ci > 0;
  float* bs = smem + L.bs;
  float* cs = smem + L.cs;
  float* xs = smem + L.xs;
  float* dys = smem + L.dys;
  float* dts = smem + L.dts;
  stage_rows(bs, L.bp, a.b + row * a.sb_b + c0 * a.sb_s, a.sb_s, qv, DS,
             a.vec_bc);
  stage_rows(xs, L.xp, a.x + row * a.sx_b + c0 * a.sx_s + h * a.sx_h,
             a.sx_s, qv, P, a.vec_x);
  if (back) {
    stage_rows(cs, L.bp, a.c + row * a.sc_b + c0 * a.sc_s, a.sc_s, qv, DS,
               a.vec_bc);
    stage_rows(dys, L.xp, a.dy + row * a.sdy_b + c0 * a.sdy_s + h * a.sdy_h,
               a.sdy_s, qv, P, a.vec_x);
  }
  tc_stage_dt(dts, a.dt + row * a.sdt_b + c0 * a.sdt_s + h, a.sdt_s, qv);
  if (qv < Q) {
    zero_rows(bs, L.bp, qv, kTcQ);
    zero_rows(xs, L.xp, qv, kTcQ);
    if (back) {
      zero_rows(cs, L.bp, qv, kTcQ);
      zero_rows(dys, L.xp, qv, kTcQ);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    const float rate = -expf(load_f32(
        a.a_log, (row / a.rows_per_slot) * a.sa_slot + h, a.a_bf16));
    const float last =
        tc_scan(dts, smem + L.cum, smem + L.us, smem + L.es, rate);
    if ((threadIdx.x & 31) == 0)
      a.decays[(static_cast<long long>(row) * a.n + h) * a.chunks + ci] =
          exp2f(last);
  }
  __syncthreads();
  // u X and e dY, in place
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int r = e / P, col = e - r * P;
    xs[r * L.xp + col] *= smem[L.us + r];
    if (back) dys[r * L.xp + col] *= smem[L.es + r];
  }
  __syncthreads();
  const int ng = (P + 31) / 32, per = (DS / 16) * ng;
  const int tasks = (own + back) * per;
  const long long at =
      ((static_cast<long long>(row) * a.n + h) * a.chunks + ci) * DS * P;
  for (int task = warp; task < tasks; task += warps) {
    const bool is_g = !own || task >= per;
    const int t = task - (own && is_g ? per : 0);
    const int s0 = t / ng * 16, n0 = t % ng * 32, nt = min(4, (P - n0) / 8);
    float acc[4][4] = {};
    tc_gemm<true, true>(acc, is_g ? cs : bs, L.bp, s0, is_g ? dys : xs,
                        L.xp, n0, nt, 0, Q);
    float* out = (is_g ? a.grads : a.states) + at;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nt) {
        const int col = n0 + 8 * j + 2 * t4;
        store2(out + (s0 + g) * P + col, acc[j][0], acc[j][1]);
        store2(out + (s0 + g + 8) * P + col, acc[j][2], acc[j][3]);
      }
  }
}

// Pass 2: the state pass, a thread per (row, head) and four state entries.
// blockIdx.y = 0: states in chunk order, each slot's s_c replaced by the
// state entering its chunk (h_in[0] = 0); 1: grads in reverse, each slot's
// g_c replaced by G at its chunk's end (G[last] = 0). A thread loads
// kTcDepth chunks' entries (16 bytes each) before it walks them, so the
// loads are in flight together, not one chained after another.
__global__ void __launch_bounds__(256)
ssd_tc_pass_kernel(float* __restrict__ states, float* __restrict__ grads,
                   const float* __restrict__ decays, long long entries4,
                   int hsz4, int chunks) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= entries4) return;
  const long long rh = i / hsz4, e = i - rh * hsz4;
  const bool back = blockIdx.y == 1;
  float4* base = reinterpret_cast<float4*>(back ? grads : states) +
                 rh * chunks * hsz4 + e;
  const float* dec = decays + rh * chunks;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < chunks; k0 += kTcDepth) {
    float4 own[kTcDepth];
    float d[kTcDepth];
#pragma unroll
    for (int k = 0; k < kTcDepth; ++k) {
      const int ci = back ? chunks - 1 - (k0 + k) : k0 + k;
      const bool in = k0 + k < chunks;
      const bool has = in && (back ? ci >= 1 : ci + 1 < chunks);
      own[k] = has ? base[ci * static_cast<long long>(hsz4)]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      d[k] = in ? dec[ci] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kTcDepth; ++k) {
      if (k0 + k >= chunks) break;
      const int ci = back ? chunks - 1 - (k0 + k) : k0 + k;
      base[ci * static_cast<long long>(hsz4)] = h;
      h.x = fmaf(h.x, d[k], own[k].x);
      h.y = fmaf(h.y, d[k], own[k].y);
      h.z = fmaf(h.z, d[k], own[k].z);
      h.w = fmaf(h.w, d[k], own[k].w);
    }
  }
}

// Shared memory of ssd_tc_out_kernel, in floats: c (kTcQ rows of pitch
// ds + 4: A fragments), b (the same: n-major B fragments) whose place takes
// h_in (ds rows of pitch p + 8: k-major B fragments) once the scores are
// formed, x (kTcQ rows of pitch p + 8), W (kTcQ x kTcTp), dt, cum, e.
struct TcOutLayout {
  int cp, xp, cs, bh, xs, ws, dts, cum, es, total;
};

inline __host__ __device__ TcOutLayout tc_out_layout(int p, int ds) {
  TcOutLayout l;
  l.cp = ds + 4;
  l.xp = p + 8;
  l.cs = 0;
  l.bh = l.cs + kTcQ * l.cp;
  l.xs = l.bh + (kTcQ * l.cp > ds * l.xp ? kTcQ * l.cp : ds * l.xp);
  l.ws = l.xs + kTcQ * l.xp;
  l.dts = l.ws + kTcQ * kTcTp;
  l.cum = l.dts + kTcQ;
  l.es = l.cum + kTcQ;
  l.total = l.es + kTcQ;
  return l;
}

// The score tiles of a chunk's lower triangle (k <= q), as (m-tile of 16
// rows, first column, n-tiles): six tasks
__device__ __constant__ int kTcLower[6][3] = {{0, 0, 2}, {1, 0, 4},
                                              {2, 0, 4}, {2, 32, 2},
                                              {3, 0, 4}, {3, 32, 4}};
// ... and of its upper triangle (q >= k) with rows k, and which of a row's
// column groups each is: up to 32 columns a task, or (kTcUpperFine) 16
__device__ __constant__ int kTcUpper[6][4] = {{0, 0, 4, 0}, {0, 32, 4, 1},
                                              {1, 16, 4, 0}, {1, 48, 2, 1},
                                              {2, 32, 4, 0}, {3, 48, 2, 0}};
__device__ __constant__ int kTcUpperFine[10][4] = {
    {0, 0, 2, 0},  {0, 16, 2, 1}, {0, 32, 2, 2}, {0, 48, 2, 3},
    {1, 16, 2, 0}, {1, 32, 2, 1}, {1, 48, 2, 2}, {2, 32, 2, 0},
    {2, 48, 2, 1}, {3, 48, 2, 0}};

// Pass 3 of the forward: block (head, chunk, row), S = s % kTcQ == 0.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_tc_out_kernel(const TcArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int Q = kTcQ;
  const int P = a.p, DS = a.ds;
  const TcOutLayout L = tc_out_layout(P, DS);
  const int h = blockIdx.x, ci = blockIdx.y, row = blockIdx.z;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int c0 = ci * Q;
  const bool inter = ci > 0;   // the state entering chunk 0 is zero
  float* cs = smem + L.cs;
  float* bh = smem + L.bh;
  float* xs = smem + L.xs;
  float* ws = smem + L.ws;
  float* dts = smem + L.dts;
  const float* cum = smem + L.cum;
  const float* es = smem + L.es;
  stage_rows(cs, L.cp, a.c + row * a.sc_b + c0 * a.sc_s, a.sc_s, Q, DS,
             a.vec_bc);
  stage_rows(bh, L.cp, a.b + row * a.sb_b + c0 * a.sb_s, a.sb_s, Q, DS,
             a.vec_bc);
  stage_rows(xs, L.xp, a.x + row * a.sx_b + c0 * a.sx_s + h * a.sx_h,
             a.sx_s, Q, P, a.vec_x);
  tc_stage_dt(dts, a.dt + row * a.sdt_b + c0 * a.sdt_s + h, a.sdt_s, Q);
  cp_async_wait_all();
  __syncthreads();
  // S = C B^T over the lower triangle, in registers
  float sacc[4][4] = {};
  if (warp < 6)
    tc_gemm<false, false>(sacc, cs, L.cp, 16 * kTcLower[warp][0], bh, L.cp,
                          kTcLower[warp][1], kTcLower[warp][2], 0, DS);
  __syncthreads();   // b read: h_in takes its place
  if (inter)
    stage_rows(bh, L.xp,
               a.states + ((static_cast<long long>(row) * a.n + h) *
                               a.chunks + ci) * DS * P,
               P, DS, P, 16);
  if (warp == warps - 1)
    tc_scan(dts, smem + L.cum, smem + L.es, smem + L.es,
            -expf(load_f32(a.a_log, (row / a.rows_per_slot) * a.sa_slot + h,
                           a.a_bf16)));
  __syncthreads();
  // W[q][k] = S exp(cum_q - cum_k) dt_k for k <= q, else 0
  if (warp < 6) {
    const int q0 = 16 * kTcLower[warp][0], n0 = kTcLower[warp][1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < kTcLower[warp][2])
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + g + 8 * (e >> 1);
          const int k = n0 + 8 * j + 2 * t4 + (e & 1);
          ws[q * kTcTp + k] =
              q >= k ? sacc[j][e] * exp2f(cum[q] - cum[k]) * dts[k] : 0.f;
        }
  }
  cp_async_wait_all();
  __syncthreads();
  // y tiles (16 steps, kTcOutCols columns): e_q (C h_in)_q + (W X)_q
  const int ng = (P + kTcOutCols - 1) / kTcOutCols;
  for (int task = warp; task < 4 * ng; task += warps) {
    const int mi = task / ng, n0 = task % ng * kTcOutCols;
    const int nt = min(kTcOutCols / 8, (P - n0) / 8);
    float acc[4][4] = {};
    if (inter) {
      tc_gemm<false, true>(acc, cs, L.cp, 16 * mi, bh, L.xp, n0, nt, 0, DS);
      const float e0 = es[16 * mi + g], e1 = es[16 * mi + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    tc_gemm<false, true>(acc, ws, kTcTp, 16 * mi, xs, L.xp, n0, nt, 0,
                         16 * (mi + 1));
    T* out = a.y + ((static_cast<long long>(row) * a.seq + c0 + 16 * mi + g) *
                        a.n + h) * P;
    const long long ld8 = 8LL * a.n * P;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nt) {
        const int col = n0 + 8 * j + 2 * t4;
        store2(out + col, acc[j][0], acc[j][1]);
        store2(out + ld8 + col, acc[j][2], acc[j][3]);
      }
  }
}

// Shared memory of ssd_tc_bwd_kernel, in floats: c and b (kTcQ rows of
// pitch ds + 4), x and dy (kTcQ rows of pitch p + 4), h_in and G (ds rows of
// pitch p + 4), W^T (first M^T, for the straddle) and dS^T (kTcQ x kTcTp),
// then dt, cum, u, e, R (the straddle), ddt's first term in four column
// groups, r's and v's partials per 32 state columns and the warps' <G,
// h_in> partials and cum_last.
struct TcBwdLayout {
  int cp, xp, cs, bs, xs, dys, hs, gs, wt, dst, dts, cum, us, es, rr, rs,
      rp, vp, red, last, total;
};

inline __host__ __device__ TcBwdLayout tc_bwd_layout(int p, int ds) {
  TcBwdLayout l;
  const int ngd = (ds + 31) / 32;
  l.cp = ds + 4;
  l.xp = p + 4;
  l.cs = 0;
  l.bs = l.cs + kTcQ * l.cp;
  l.xs = l.bs + kTcQ * l.cp;
  l.dys = l.xs + kTcQ * l.xp;
  l.hs = l.dys + kTcQ * l.xp;
  l.gs = l.hs + ds * l.xp;
  l.wt = l.gs + ds * l.xp;
  l.dst = l.wt + kTcQ * kTcTp;
  l.dts = l.dst + kTcQ * kTcTp;
  l.cum = l.dts + kTcQ;
  l.us = l.cum + kTcQ;
  l.es = l.us + kTcQ;
  l.rr = l.es + kTcQ;
  l.rs = l.rr + kTcQ;
  l.rp = l.rs + 4 * kTcQ;
  l.vp = l.rp + ngd * kTcQ;
  l.red = l.vp + ngd * kTcQ;
  l.last = l.red + kTcBwdThreads / 32;
  l.total = l.last + 1;
  return l;
}

// Pass 3 of the backward: block (head, chunk, row), the adjoint of the
// chunk from its h_in and G (the backward's note above), every product in
// 3xTF32: S^T = B C^T and dW^T = X dY^T over the upper triangle (rows k);
// W^T, M^T, dS^T and ddt's first term from their registers; the straddle;
// dX = u B G + W^T dY, dC = e dY h_in^T + dS B and dB = u X G^T + dS^T C
// (the head's partials), r and v from the state products' registers; then
// ddt and the chunk's a dL/da.
template <typename T>
__global__ void __launch_bounds__(kTcBwdThreads, 1)
ssd_tc_bwd_kernel(const TcArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int Q = kTcQ;
  const int P = a.p, DS = a.ds;
  const TcBwdLayout L = tc_bwd_layout(P, DS);
  const int h = blockIdx.x, ci = blockIdx.y, row = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = ci * Q, qv = min(Q, a.seq - c0);
  const bool has_g = ci + 1 < a.chunks, has_h = ci > 0;
  float* cs = smem + L.cs;
  float* bs = smem + L.bs;
  float* xs = smem + L.xs;
  float* dys = smem + L.dys;
  float* hs = smem + L.hs;
  float* gs = smem + L.gs;
  float* wt = smem + L.wt;
  float* dst = smem + L.dst;
  float* dts = smem + L.dts;
  const float* cum = smem + L.cum;
  const float* us = smem + L.us;
  const float* es = smem + L.es;
  const float rate = -expf(load_f32(
      a.a_log, (row / a.rows_per_slot) * a.sa_slot + h, a.a_bf16));
  const long long slot =
      ((static_cast<long long>(row) * a.n + h) * a.chunks + ci) * DS * P;

  stage_rows(cs, L.cp, a.c + row * a.sc_b + c0 * a.sc_s, a.sc_s, qv, DS,
             a.vec_bc);
  stage_rows(bs, L.cp, a.b + row * a.sb_b + c0 * a.sb_s, a.sb_s, qv, DS,
             a.vec_bc);
  stage_rows(xs, L.xp, a.x + row * a.sx_b + c0 * a.sx_s + h * a.sx_h,
             a.sx_s, qv, P, a.vec_x);
  stage_rows(dys, L.xp, a.dy + row * a.sdy_b + c0 * a.sdy_s + h * a.sdy_h,
             a.sdy_s, qv, P, a.vec_x);
  if (has_h) stage_rows(hs, L.xp, a.states + slot, P, DS, P, 16);
  if (has_g) stage_rows(gs, L.xp, a.grads + slot, P, DS, P, 16);
  tc_stage_dt(dts, a.dt + row * a.sdt_b + c0 * a.sdt_s + h, a.sdt_s, qv);
  if (qv < Q) {
    zero_rows(cs, L.cp, qv, kTcQ);
    zero_rows(bs, L.cp, qv, kTcQ);
    zero_rows(xs, L.xp, qv, kTcQ);
    zero_rows(dys, L.xp, qv, kTcQ);
  }
  // the step tiles (their unwritten corners) and ddt's first term: zero
  for (int e = threadIdx.x; e < 2 * Q * kTcTp; e += blockDim.x) wt[e] = 0.f;
  for (int e = threadIdx.x; e < 4 * Q; e += blockDim.x) smem[L.rs + e] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  // (1) S^T and dW^T (rows k, columns q >= k) in registers; the last warp
  // scans the chunk's cumsum meanwhile
  float sacc[4][4] = {}, dacc[4][4] = {};
  constexpr int kUp = kTcFineUpper ? 10 : 6;
  const int ut = warp < kUp ? warp : 0;
  const int k0 = 16 * (kTcFineUpper ? kTcUpperFine[ut][0] : kTcUpper[ut][0]);
  const int n0 = kTcFineUpper ? kTcUpperFine[ut][1] : kTcUpper[ut][1];
  const int nt = kTcFineUpper ? kTcUpperFine[ut][2] : kTcUpper[ut][2];
  const int grp = kTcFineUpper ? kTcUpperFine[ut][3] : kTcUpper[ut][3];
  if (warp < kUp) {
    tc_gemm<false, false>(sacc, bs, L.cp, k0, cs, L.cp, n0, nt, 0, DS);
    tc_gemm<false, false>(dacc, xs, L.xp, k0, dys, L.xp, n0, nt, 0, P);
  } else if (warp == warps - 1) {
    const float last =
        tc_scan(dts, smem + L.cum, smem + L.us, smem + L.es, rate);
    if (lane == 0) smem[L.last] = last;
  }
  __syncthreads();
  // (2) per element (k, q): l = exp(cum_q - cum_k) (q >= k), W^T = S^T l
  // dt_k (kept), M^T = dW^T S^T l dt_k, dS^T = dW^T l dt_k; ddt's first
  // term, sum_q dW^T S^T l, per row and column group
  if (warp < kUp) {
    float rsum[2] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + g + 8 * (e >> 1);
          const int q = n0 + 8 * j + 2 * t4 + (e & 1);
          const float l = q >= k ? exp2f(cum[q] - cum[k]) : 0.f;
          const float sl = sacc[j][e] * l, dk = dts[k];
          const float dm = dacc[j][e] * sl;
          rsum[e >> 1] += dm;
          sacc[j][e] = sl * dk;
          wt[k * kTcTp + q] = dm * dk;
          dst[k * kTcTp + q] = dacc[j][e] * l * dk;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
    }
    if (t4 == 0) {
      smem[L.rs + grp * Q + k0 + g] = rsum[0];
      smem[L.rs + grp * Q + k0 + g + 8] = rsum[1];
    }
  }
  __syncthreads();
  // (3) the straddle R_j = sum_{k < j} sum_{q >= j} M[q][k]: suffix sums
  // along each row k of M^T (q > k), then each column j's sum over k < j
  if (threadIdx.x < Q) {
    const int k = threadIdx.x;
    float tsum = 0.f;
    for (int q = Q - 1; q > k; --q) {
      tsum += wt[k * kTcTp + q];
      wt[k * kTcTp + q] = tsum;
    }
  }
  __syncthreads();
  if (threadIdx.x < Q) {
    const int j = threadIdx.x;
    float r = 0.f;
    for (int k = 0; k < j; ++k) r += wt[k * kTcTp + j];
    smem[L.rr + j] = r;
  }
  __syncthreads();
  // W^T into its tile
  if (warp < kUp)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wt[(k0 + g + 8 * (e >> 1)) * kTcTp + n0 + 8 * j + 2 * t4 +
             (e & 1)] = sacc[j][e];
  // <G, h_in>, per warp
  if (has_g && has_h) {
    float v = 0.f;
    for (int e = threadIdx.x; e < DS * P; e += blockDim.x) {
      const int s = e / P, col = e - s * P;
      v = fmaf(gs[s * L.xp + col], hs[s * L.xp + col], v);
    }
    v = warp_sum(v);
    if (lane == 0) smem[L.red + warp] = v;
  }
  __syncthreads();

  // (4) the products: dX (16 rows k, 32 columns of p), dC (16 rows q, 32
  // columns of ds), dB (16 rows k, 32 columns of ds)
  const int ngp = (P + 31) / 32, ngd = (DS + 31) / 32;
  const int nx = 4 * ngp, nc = 4 * ngd;
  const long long nbc = static_cast<long long>(a.batch) * a.seq * DS;
  for (int task = warp; task < nx + 2 * nc; task += warps) {
    float acc[4][4] = {};
    if (task < nx) {
      const int mi = task / ngp, m0 = 16 * mi, c = task % ngp * 32;
      const int ntc = min(4, (P - c) / 8);
      if (has_g) {
        tc_gemm<false, true>(acc, bs, L.cp, m0, gs, L.xp, c, ntc, 0, DS);
        const float u0 = us[m0 + g], u1 = us[m0 + g + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] *= u0;
          acc[j][1] *= u0;
          acc[j][2] *= u1;
          acc[j][3] *= u1;
        }
      }
      tc_gemm<false, true>(acc, wt, kTcTp, m0, dys, L.xp, c, ntc, m0, Q);
      T* out = a.y + ((static_cast<long long>(row) * a.seq + c0 + m0 + g) *
                          a.n + h) * P;
      const long long ld8 = 8LL * a.n * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntc) {
          const int col = c + 8 * j + 2 * t4;
          if (m0 + g < qv) store2(out + col, acc[j][0], acc[j][1]);
          if (m0 + g + 8 < qv) store2(out + ld8 + col, acc[j][2], acc[j][3]);
        }
      continue;
    }
    const bool is_dc = task < nx + nc;
    const int t = task - nx - (is_dc ? 0 : nc);
    const int mi = t / ngd, m0 = 16 * mi, grp = t % ngd, c = 32 * grp;
    const int ntc = min(4, (DS - c) / 8);
    const bool state = is_dc ? has_h : has_g;
    const float* sc = is_dc ? es : us;   // the rows' scale
    if (state) {
      // dY h_in^T (dC) or X G^T (dB), then its rows' dot with c or b
      if (is_dc)
        tc_gemm<false, false>(acc, dys, L.xp, m0, hs, L.xp, c, ntc, 0, P);
      else
        tc_gemm<false, false>(acc, xs, L.xp, m0, gs, L.xp, c, ntc, 0, P);
      const float* o = is_dc ? cs : bs;
      float dot[2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntc)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dot[e >> 1] = fmaf(
                o[(m0 + g + 8 * (e >> 1)) * L.cp + c + 8 * j + 2 * t4 +
                  (e & 1)],
                acc[j][e], dot[e >> 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 1);
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 2);
      }
      if (t4 == 0) {
        float* part = smem + (is_dc ? L.rp : L.vp) + grp * Q + m0 + g;
        part[0] = dot[0];
        part[8] = dot[1];
      }
      const float s0 = sc[m0 + g], s1 = sc[m0 + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= s0;
        acc[j][1] *= s0;
        acc[j][2] *= s1;
        acc[j][3] *= s1;
      }
    }
    if (is_dc)   // dS B: dS[q][k] = dS^T[k][q], k <= q
      tc_gemm<true, true>(acc, dst, kTcTp, m0, bs, L.cp, c, ntc, 0, m0 + 16);
    else         // dS^T C, q >= k
      tc_gemm<false, true>(acc, dst, kTcTp, m0, cs, L.cp, c, ntc, m0, Q);
    float* out = a.part_bc + (is_dc ? a.n : 0) * nbc + h * nbc +
                 (static_cast<long long>(row) * a.seq + c0 + m0 + g) * DS;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntc) {
        const int col = c + 8 * j + 2 * t4;
        if (m0 + g < qv) store2(out + col, acc[j][0], acc[j][1]);
        if (m0 + g + 8 < qv)
          store2(out + 8 * DS + col, acc[j][2], acc[j][3]);
      }
  }
  __syncthreads();

  // (5) per step, lane j and j + 32 of warp 0: r_j = e_j sum of its
  // partials, v_j likewise, dA_j = R_j + sum_{q >= j} r_q + sum_{k < j}
  // u_k v_k + exp(cum_last) <G, h_in>; ddt_j = ddt1_j + exp(cum_last -
  // cum_j) v_j + a dA_j; the chunk's a dL/da = a sum_j dt_j dA_j
  if (warp == 0) {
    const float last = smem[L.last];
    float hg = 0.f;
    if (has_g && has_h)
      for (int w = 0; w < warps; ++w) hg += smem[L.red + w];
    float r[2], v[2], rs[2], uv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      float rv = 0.f, vv = 0.f;
      for (int grp = 0; grp < ngd; ++grp) {
        rv += smem[L.rp + grp * Q + j];
        vv += smem[L.vp + grp * Q + j];
      }
      r[i] = has_h ? es[j] * rv : 0.f;
      v[i] = has_g ? vv : 0.f;
      rs[i] = r[i];
      uv[i] = us[j] * v[i];
    }
    // suffix sums of r and prefix sums of u v within each half of 32
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float dn = __shfl_down_sync(0xffffffffu, rs[i], off);
        const float upv = __shfl_up_sync(0xffffffffu, uv[i], off);
        if (lane + off < 32) rs[i] += dn;
        if (lane >= off) uv[i] += upv;
      }
    rs[0] += __shfl_sync(0xffffffffu, rs[1], 0);   // the upper half's total
    const float lower = __shfl_sync(0xffffffffu, uv[0], 31);
    uv[1] += lower;
    float before[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      before[i] = __shfl_up_sync(0xffffffffu, uv[i], 1);
      if (lane == 0) before[i] = i ? lower : 0.f;
    }
    float da = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      const float dA = smem[L.rr + j] + rs[i] + before[i] + exp2f(last) * hg;
      if (j < qv)
        a.ddt[(static_cast<long long>(row) * a.seq + c0 + j) * a.n + h] =
            smem[L.rs + j] + smem[L.rs + Q + j] + smem[L.rs + 2 * Q + j] +
                smem[L.rs + 3 * Q + j] +
            exp2f(last - cum[j]) * v[i] + rate * dA;
      da = fmaf(dts[j], dA, da);
    }
    da = warp_sum(da);
    if (lane == 0)
      a.part_da[(static_cast<long long>(row) * a.n + h) * a.chunks + ci] =
          rate * da;
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

// db and dc summed over head groups (with `bc`: where heads < n, and in
// the tensor-core chunk-parallel form) and da over a slot's rows and parts
template <typename T>
cudaError_t launch_bwd_sum(const BwdArgs<T>& a, bool bc,
                           cudaStream_t stream) {
  const long long nbc =
      bc ? static_cast<long long>(a.batch) * a.seq * a.ds : 0;
  const int bc_blocks = static_cast<int>(nbc < 4096 * 256LL ? (nbc + 255) / 256
                                                           : 4096);
  const int da_blocks = (a.groups * a.n * 32 + 255) / 256;
  ssd_bwd_sum_kernel<T><<<bc_blocks + da_blocks, 256, 0, stream>>>(
      a, bc_blocks);
  return cudaGetLastError();
}

// The chunk-parallel tensor-core forms: the chunk states, the state pass,
// then the outputs (forward) or the adjoint and the ordered sums
// (backward).
template <typename T>
cudaError_t launch_tc_pass(const TcArgs<T>& a, bool grads,
                           cudaStream_t stream) {
  const long long entries4 =
      static_cast<long long>(a.batch) * a.n * a.ds * a.p / 4;
  const unsigned blocks = static_cast<unsigned>((entries4 + 255) / 256);
  ssd_tc_pass_kernel<<<dim3(blocks, grads ? 2 : 1), 256, 0, stream>>>(
      a.states, a.grads, a.decays, entries4, a.ds * a.p / 4, a.chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_fwd(const TcArgs<T>& a, cudaStream_t stream) {
  static const cudaError_t attr_state = allow_smem(ssd_tc_state_kernel<T>);
  static const cudaError_t attr_out = allow_smem(ssd_tc_out_kernel<T>);
  if (attr_state != cudaSuccess) return attr_state;
  if (attr_out != cudaSuccess) return attr_out;
  ssd_tc_state_kernel<T><<<dim3(a.n, a.chunks - 1, a.batch), kTcStateThreads,
                           sizeof(float) *
                               tc_state_layout(a.p, a.ds, false).total,
                           stream>>>(a, 0);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_tc_pass(a, false, stream);
  if (err != cudaSuccess) return err;
  ssd_tc_out_kernel<T><<<dim3(a.n, a.chunks, a.batch), kTcThreads,
                         sizeof(float) * tc_out_layout(a.p, a.ds).total,
                         stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_bwd(const TcArgs<T>& a, const BwdArgs<T>& sums,
                          cudaStream_t stream) {
  static const cudaError_t attr_state = allow_smem(ssd_tc_state_kernel<T>);
  static const cudaError_t attr_bwd = allow_smem(ssd_tc_bwd_kernel<T>);
  if (attr_state != cudaSuccess) return attr_state;
  if (attr_bwd != cudaSuccess) return attr_bwd;
  const dim3 grid(a.n, a.chunks, a.batch);
  ssd_tc_state_kernel<T><<<grid, kTcStateThreads,
                           sizeof(float) *
                               tc_state_layout(a.p, a.ds, true).total,
                           stream>>>(a, 1);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_tc_pass(a, true, stream);
  if (err != cudaSuccess) return err;
  ssd_tc_bwd_kernel<T><<<grid, kTcBwdThreads,
                         sizeof(float) * tc_bwd_layout(a.p, a.ds).total,
                         stream>>>(a);
  err = cudaGetLastError();
  return err == cudaSuccess ? launch_bwd_sum(sums, true, stream) : err;
}

template <typename T>
int ssd_entry(const T* x, const float* dt, const void* a_log, const T* b,
              const T* c, T* y, float* states, float* decays, int batch,
              int seq, int n, int p, int ds, int chunk, int heads, int warps,
              int chunk_parallel, int rows_per_slot, int vec_x, int vec_bc,
              int a_bf16, int form, const long long* strides,
              cudaStream_t stream) {
  if (form == 2) {
    // the chunk-parallel tensor-core form: chunks of kTcQ, a block per
    // head, several chunks, widths of whole m-tiles
    if (chunk != kTcQ || seq % chunk || seq / chunk < 2 || heads != 1 ||
        !chunk_parallel || !states || !decays || rows_per_slot <= 0 ||
        p % 16 || ds % 16 || !copy_ok<T>(vec_x, p) || !copy_ok<T>(vec_bc, ds))
      return cudaErrorInvalidValue;
    const TcArgs<T> t{x, dt, a_log, b, c, nullptr, y, nullptr, states,
                      nullptr, decays, nullptr, nullptr, strides[0],
                      strides[1], strides[2], strides[3], strides[4],
                      strides[5], strides[6], strides[7], strides[8], 0, 0, 0,
                      strides[9], batch, seq, n, p, ds, seq / chunk,
                      rows_per_slot, a_bf16, vec_x, vec_bc};
    return launch_tc_fwd(t, stream);
  }
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

// The f32 tensor-core form: as launch_bwd_mma.
cudaError_t launch_bwd_tf32(const BwdArgs<float>& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(ssd_bwd_tf32_kernel);
  if (attr != cudaSuccess) return attr;
  const int threads = 32 * a.n;
  const int smem = 4 * kTfRing * bwd_tf32_stage_floats(a.n);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_bwd_tf32_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = a.batch < per_sm * sms ? a.batch : per_sm * sms;
  ssd_bwd_tf32_kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The chunked form: a block per (row, head group) of `warps` warps.
template <typename T, typename TA>
cudaError_t launch_bwd_chunk(const BwdArgs<T>& a, int warps,
                             cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(ssd_bwd_chunk_kernel<T, TA>);
  if (attr != cudaSuccess) return attr;
  const size_t smem =
      sizeof(float) * bwd_layout(a.p, a.ds, a.heads, a.chunks > 1).total;
  ssd_bwd_chunk_kernel<T, TA><<<dim3(a.batch, a.n / a.heads), 32 * warps,
                                 smem, stream>>>(a);
  return cudaGetLastError();
}

// The bf16 tensor-core form: a persistent grid of as many blocks as fit on
// the card at once (at most one per row).
cudaError_t launch_bwd_mma(const BwdArgs<bf16>& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(ssd_bwd_mma_kernel);
  if (attr != cudaSuccess) return attr;
  const int threads = 32 * a.n;
  const int smem = kBwdRing * bwd_mma_stage_bytes(a.n);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_bwd_mma_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = a.batch < per_sm * sms ? a.batch : per_sm * sms;
  ssd_bwd_mma_kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int ssd_bwd_entry(const T* x, const float* dt, const void* a_log, const T* b,
                  const T* c, const T* dy, T* dx, float* ddt, T* db, T* dc,
                  void* da_log, float* states, float* part_bc,
                  float* part_da, float* grads, float* decays, int batch,
                  int seq, int n, int p, int ds, int heads, int warps,
                  int rows_per_slot, int groups, int a_bf16, int vec_x,
                  int vec_bc, int form, const long long* strides,
                  cudaStream_t stream) {
  if (form == 2) {
    // the chunk-parallel tensor-core form: chunks of kTcQ (the last ragged
    // where S is not a multiple), a block per (head, chunk, row)
    const int chunks = (seq + kTcQ - 1) / kTcQ;
    if (chunks < 2 || heads != 1 || rows_per_slot <= 0 ||
        groups * rows_per_slot != batch || !states || !grads || !decays ||
        !part_bc || p % 16 || ds % 16 || !copy_ok<T>(vec_x, p) ||
        !copy_ok<T>(vec_bc, ds))
      return cudaErrorInvalidValue;
    const TcArgs<T> t{x, dt, a_log, b, c, dy, dx, ddt, states, grads,
                      decays, part_bc, part_da, strides[0], strides[1],
                      strides[2], strides[3], strides[4], strides[5],
                      strides[6], strides[7], strides[8], strides[9],
                      strides[10], strides[11], strides[12], batch, seq, n,
                      p, ds, chunks, rows_per_slot, a_bf16, vec_x, vec_bc};
    const BwdArgs<T> sums{x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log,
                          states, part_bc, part_da, strides[0], strides[1],
                          strides[2], strides[3], strides[4], strides[5],
                          strides[6], strides[7], strides[8], strides[9],
                          strides[10], strides[11], strides[12], batch, seq,
                          n, p, ds, 1, chunks, rows_per_slot, groups, a_bf16,
                          vec_x, vec_bc, chunks};
    return launch_tc_bwd(t, sums, stream);
  }
  const int chunks = (seq + kBwdQ - 1) / kBwdQ;
  if (heads <= 0 || n % heads || heads > kMmaMaxHeads || warps < heads ||
      32 * warps > kBwdMaxThreads || rows_per_slot <= 0 ||
      groups * rows_per_slot != batch || (chunks > 1 && !states) ||
      (heads < n && !part_bc) || !copy_ok<T>(vec_x, p) ||
      !copy_ok<T>(vec_bc, ds))
    return cudaErrorInvalidValue;
  BwdArgs<T> a{x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log, states,
               part_bc, part_da, strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5], strides[6], strides[7],
               strides[8], strides[9], strides[10], strides[11], strides[12],
               batch, seq, n, p, ds, heads, chunks, rows_per_slot, groups,
               a_bf16, vec_x, vec_bc, 1};
  cudaError_t err = cudaErrorInvalidValue;
  if (form) {
    // the tensor-core forms: one chunk of (kMmaQ, kMmaDs, kMmaP), a warp
    // per head, 16-byte copies; bf16 mma.sync, or 3xTF32 for f32
    if (seq != kMmaQ || ds != kMmaDs || p != kMmaP || n > kMmaMaxHeads ||
        heads != n || warps != n || vec_x != 16 || vec_bc != 16)
      return cudaErrorInvalidValue;
    if constexpr (std::is_same<T, bf16>::value)
      err = launch_bwd_mma(a, stream);
    else
      err = launch_bwd_tf32(a, stream);
  } else {
    err = a_bf16 ? launch_bwd_chunk<T, bf16>(a, warps, stream)
                 : launch_bwd_chunk<T, float>(a, warps, stream);
  }
  return err == cudaSuccess ? launch_bwd_sum(a, heads < n, stream) : err;
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
// copies), the tensor-core form; form 2 (chunk 64, heads 1,
// chunk_parallel, several chunks, p and ds multiples of 16), the
// chunk-parallel tensor-core form, with the same scratch. vec_x and vec_bc
// are the copy widths in bytes (16 where the rows' pointers and strides
// allow it, else 4, else one bf16) of x, and of b and c. S must be a
// multiple of chunk and n of heads. Returns the CUDA error code of the
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
// the wrapper (kernel.ssd_bwd_plan): form 0, the chunked form with `heads`
// heads per block of `warps` warps; form 1 (at S = 32, ds = 16, p = 32,
// heads = warps = n <= 8, 16-byte copies), the tensor-core form (bf16
// mma.sync, or 3xTF32 for f32); vec_x and vec_bc the copy widths in bytes
// of x and dy, and of b and c.
// Scratch: `states` (B * n * (ceil(S / 32) - 1) * ds * p floats; unused
// for one chunk), `part_bc` (2 * B * S * ds * n / heads; unused where
// heads = n), `part_da` (B * n); `grads` and `decays` unused. Two
// launches: the backward, then the ordered sums over head groups and a
// slot's rows. Form 2 (heads 1, S over several chunks of 64, p and ds
// multiples of 16), the chunk-parallel tensor-core form: `states` and
// `grads` B * n * ceil(S / 64) * ds * p floats each, `decays` and
// `part_da` B * n * ceil(S / 64), `part_bc` 2 * B * S * ds * n; four
// launches (chunk states, the state passes, the adjoint, the sums).
extern "C" int ssd_scan_bwd(const float* x, const float* dt,
                            const void* a_log, const float* b,
                            const float* c, const float* dy, float* dx,
                            float* ddt, float* db, float* dc, void* da_log,
                            float* states, float* part_bc, float* part_da,
                            float* grads, float* decays, int batch,
                            int seq, int n, int p, int ds, int heads,
                            int warps, int rows_per_slot,
                            int groups, int a_bf16, int vec_x, int vec_bc,
                            int form, const long long* strides,
                            cudaStream_t stream) {
  return ssd_bwd_entry(x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log,
                       states, part_bc, part_da, grads, decays, batch, seq,
                       n, p, ds, heads, warps, rows_per_slot, groups, a_bf16,
                       vec_x, vec_bc, form, strides, stream);
}

extern "C" int ssd_scan_bwd_bf16(const bf16* x, const float* dt,
                                 const void* a_log, const bf16* b,
                                 const bf16* c, const bf16* dy, bf16* dx,
                                 float* ddt, bf16* db, bf16* dc,
                                 void* da_log, float* states, float* part_bc,
                                 float* part_da, float* grads, float* decays,
                                 int batch, int seq, int n,
                                 int p, int ds, int heads, int warps,
                                 int rows_per_slot, int groups, int a_bf16,
                                 int vec_x, int vec_bc, int form,
                                 const long long* strides,
                                 cudaStream_t stream) {
  return ssd_bwd_entry(x, dt, a_log, b, c, dy, dx, ddt, db, dc, da_log,
                       states, part_bc, part_da, grads, decays, batch, seq,
                       n, p, ds, heads, warps, rows_per_slot, groups, a_bf16,
                       vec_x, vec_bc, form, strides, stream);
}
