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
// at S >= 64 it is bound by arithmetic, not by device memory. f32 operands
// cannot use the tensor cores without TF32 rounding, which the reference's
// f32 contract does not survive, so the work is plain FMA against the
// 67 TFLOP/s f32 rate. At the FL path's S = 32 a head is one half-filled
// tile and the kernels are bound by launch and latency.
//
// The simple design. One block of 256 threads per (batch*head, 64-row
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
#include <cuda_runtime.h>

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

}  // namespace

// C interface (loaded with ctypes). Operands are (batch, heads, seq, d)
// f32 with unit d stride; `strides` holds (b, h, s) element strides per
// operand, in argument order. lse and delta are contiguous (batch*heads,
// seq). window <= 0 means no window. Returns the CUDA error code of the
// launch (0 on success); the kernels run asynchronously on `stream`.
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
                                      int causal, int window,
                                      cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
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
                                        cudaStream_t stream) {
  const Problem pr{heads, seq, scale, causal, window};
  switch (d) {
    case 32: return launch_dkdv<32>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    case 64: return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    case 128: return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, batch, strides, pr, stream);
    default: return cudaErrorInvalidValue;
  }
}
