// Mamba-2 SSD chunked scan (forward), CUDA for Hopper (sm_90a), on f32 or
// bf16 operands.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:77
// `ssd_scan`: for each batch row and head, over chunks of Q steps,
//   cum      = inclusive cumsum of dt * a          (a = -exp(a_log))
//   y_intra  = sum_{k<=q} (c_q . b_k) exp(cum_q - cum_k) dt_k x_k
//   y_inter  = exp(cum_q) c_q . h                   (h: state before chunk)
//   h        = h exp(cum_last) + sum_k b_k (exp(cum_last - cum_k) dt_k x_k)
// and y = y_intra + y_inter. There is no backward kernel: as in the
// reference, the op's backward is autograd through the sequential
// recurrence.
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
// The bf16 form. The kernel is a template on the type T of x, b, c and y
// (float or __nv_bfloat16), as the Pallas kernel takes any operand dtype:
// it upcasts on load, computes in f32 and writes y in x's dtype. For T =
// bf16 x, b and c are staged by plain loads of 16, 4 or 2 bytes (the
// plan's copy widths), widened with __bfloat162float into the same f32
// tiles the f32 form fills by cp.async; y is rounded once at its store
// (__float2bfloat16_rn). dt and a_log (the wrapper upcasts the small
// (slots, n) a_log), the decays, the chunk states and the chunk scan stay
// f32 in both forms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const float* a_log;  // (slots, n)
  const T* b;          // (B, S, ds)
  const T* c;          // (B, S, ds)
  T* y;                // (B, S, n, p), contiguous
  float* states;       // (B, n, chunks, ds, p): chunk-parallel scratch
  float* decays;       // (B, n, chunks)
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sa_slot;
  int seq, n, p, ds, chunk, heads, rows_per_slot, chunks;
  int vec_x, vec_bc;   // copy widths in bytes of x, and of b and c: 16 or
                       // 4, or (bf16) 2
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

template <typename T>
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
  const float* a_log = a.a_log + (row / a.rows_per_slot) * a.sa_slot;
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
                    smem + L.wk + hh * QR, -expf(a_log[h0 + hh]), Q);
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

// A copy width of `vec` bytes over rows of `cols` elements of T: 16 or 4
// bytes, or one bf16; the width must divide the row.
template <typename T>
bool copy_ok(int vec, int cols) {
  if (vec != 16 && vec != 4 && !(sizeof(T) == 2 && vec == 2)) return false;
  return cols % (vec / static_cast<int>(sizeof(T))) == 0;
}

template <typename T>
int ssd_entry(const T* x, const float* dt, const float* a_log, const T* b,
              const T* c, T* y, float* states, float* decays, int batch,
              int seq, int n, int p, int ds, int chunk, int heads, int warps,
              int chunk_parallel, int rows_per_slot, int vec_x, int vec_bc,
              const long long* strides, cudaStream_t stream) {
  if (chunk <= 0 || seq % chunk || heads <= 0 || n % heads ||
      rows_per_slot <= 0 || warps <= 0 || 32 * warps > kMaxThreads ||
      (chunk_parallel && (!states || !decays)) ||
      !copy_ok<T>(vec_x, p) || !copy_ok<T>(vec_bc, ds))
    return cudaErrorInvalidValue;
  Args<T> a{x, dt, a_log, b, c, y, states, decays,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         seq, n, p, ds, chunk, heads, rows_per_slot, seq / chunk,
         vec_x, vec_bc};
  // Above 48 KB a block's shared memory must be asked for explicitly:
  // allow the card's opt-in maximum, once per process (the launch itself
  // fails, and reports it, if a block asks for more).
  static const cudaError_t attr = [] {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          max_smem);
    // all of the SM's unified L1 as shared memory: five blocks fit
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (attr != cudaSuccess) return attr;

  const int threads = 32 * warps;
  const int hblocks = n / heads;
  auto smem = [&](bool state) {
    return sizeof(float) * layout(chunk, p, ds, heads, state).total;
  };
  if (!chunk_parallel) {
    ssd_kernel<T><<<dim3(batch, hblocks, 1), threads, smem(a.chunks > 1),
                    stream>>>(a, kSequential);
    return cudaGetLastError();
  }
  cudaError_t err = cudaSuccess;
  if (a.chunks > 1) {
    ssd_kernel<T><<<dim3(batch, hblocks, a.chunks - 1), threads,
                    smem(false), stream>>>(a, kChunkStates);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long entries = static_cast<long long>(batch) * n * ds * p;
  const long long want = (entries + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssd_chunk_scan_kernel<T><<<blocks, 256, 0, stream>>>(a, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(batch, hblocks, a.chunks), threads, smem(true),
                  stream>>>(a, kChunkOutputs);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). x (B, S, n, p), dt (B, S, n), b and c
// (B, S, ds) with a unit last stride: x, b, c and y f32 (ssd_scan_fwd) or
// bf16 (ssd_scan_fwd_bf16), dt and a_log f32 in both; `strides` holds, in
// order, x's (row, step, head) strides, dt's (row, step), b's (row, step),
// c's (row, step) and a_log's slot stride. Row r uses a_log slot r / rows_per_slot.
// y is contiguous (B, S, n, p). The plan comes from the wrapper
// (kernel.ssd_plan): `heads` heads per block of `warps` warps; with
// chunk_parallel the three-pass form, whose scratch `states` holds
// B * n * chunks * ds * p floats and `decays` B * n * chunks (both unused
// otherwise); vec_x and vec_bc are the copy widths in bytes (16 where the
// rows' pointers and strides allow it, else 4, else one bf16) of x, and of
// b and c. S must
// be a multiple of chunk and n of heads. Returns the
// CUDA error code of the first failing launch (0 on success); the kernels
// run asynchronously on `stream`.
extern "C" int ssd_scan_fwd(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, float* y, float* states,
                            float* decays, int batch, int seq, int n, int p,
                            int ds, int chunk, int heads, int warps,
                            int chunk_parallel, int rows_per_slot,
                            int vec_x, int vec_bc, const long long* strides,
                            cudaStream_t stream) {
  return ssd_entry(x, dt, a_log, b, c, y, states, decays, batch, seq, n, p,
                   ds, chunk, heads, warps, chunk_parallel, rows_per_slot,
                   vec_x, vec_bc, strides, stream);
}

extern "C" int ssd_scan_fwd_bf16(const bf16* x, const float* dt,
                                 const float* a_log, const bf16* b,
                                 const bf16* c, bf16* y, float* states,
                                 float* decays, int batch, int seq, int n,
                                 int p, int ds, int chunk, int heads,
                                 int warps, int chunk_parallel,
                                 int rows_per_slot, int vec_x, int vec_bc,
                                 const long long* strides,
                                 cudaStream_t stream) {
  return ssd_entry(x, dt, a_log, b, c, y, states, decays, batch, seq, n, p,
                   ds, chunk, heads, warps, chunk_parallel, rows_per_slot,
                   vec_x, vec_bc, strides, stream);
}
