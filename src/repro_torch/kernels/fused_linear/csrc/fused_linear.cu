// Fused linear layer, forward and backward, f32 CUDA for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/fused_linear/kernel.py:
//   fused_linear            (kernel.py:81)  y  = act(x @ w + b), act in {none, relu}
//   fused_linear_bwd_dx     (kernel.py:123) dx = (dy * 1[y > 0]) @ w^T
//   fused_linear_bwd_dw_db  (kernel.py:179) dw = x^T @ dz, db = sum_m dz
//
// What bounds them on an H100: at the split-FL round's shapes (VGG-11 fc
// layers, M = 95 rows per slot, K and N up to 4096) every kernel does
// 2*M*K*N operations on about 4*K*N weight bytes, i.e. ~M/2 = 47 FLOP per
// byte, above the f32 ridge point of 67 TFLOP/s / 3.35 TB/s = 20 FLOP per
// byte: the f32 FMA units bound them, not device memory. (At M = 1, the
// per-sample gradients of the statistics pass, they are bound by bytes.)
// f32 operands cannot use the tensor cores without TF32 rounding, which the
// reference's 1e-5 f32 contract does not survive, so the work is plain FMA.
//
// The simple design: 64x64 output tiles, one block of 256 threads each
// owning a 4x4 sub-tile, a 16-deep reduction slab staged through shared
// memory per step. Operands are read as float4 from shared memory so the
// inner loop issues 2 shared loads per 16 FMAs. The TPU grid's sequential
// reduction axis becomes the loop inside the block; nothing carries over
// between blocks. Ragged M, K and N are masked on load and store, so no
// shape leaves the kernel. A batch (slot) index rides blockIdx.z and every
// operand has its own batch stride: stride 0 shares one weight matrix
// across all slots without a copy.
//
// Backward: dx reads w in its stored (K, N) layout and transposes the tile
// while staging it; both backward kernels rebuild the relu mask from the
// saved output y per tile, so dz never reaches device memory. The dw
// kernel's blocks whose K-tile index is 0 also sum their dz columns over
// the M loop they already run, which gives db in the same pass with no
// atomics (deterministic).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kDepth = 16;    // reduction slab per shared-memory step
constexpr int kPad = 4;       // keeps rows 16-byte aligned for float4 reads
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

struct Tiles {
  // a[r][i]: the left operand, reduction index r, output row i
  // b[r][j]: the right operand, reduction index r, output column j
  __align__(16) float a[kDepth][kTile + kPad];
  __align__(16) float b[kDepth][kTile + kPad];
};

// acc[i][j] += sum_r a[r][ty*4+i] * b[r][tx*4+j] over the staged slab.
__device__ __forceinline__ void mma_slab(const Tiles& t, int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < kDepth; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(&t.a[r][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&t.b[r][tx * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
  }
}

// dz = dy, or dy * 1[y > 0] when relu (y is the saved forward output).
__device__ __forceinline__ float masked_dz(const float* dy, const float* y,
                                           long long off_dy, long long off_y,
                                           int relu) {
  const float g = dy[off_dy];
  return (relu && !(y[off_y] > 0.f)) ? 0.f : g;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ y, int M, int K,
           int N, long long sxb, long long sxm, long long swb, long long swk,
           long long sbb, long long syb, long long sym, int relu) {
  __shared__ Tiles t;
  const int bz = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  x += bz * sxb;
  w += bz * swb;
  bias += bz * sbb;
  y += bz * syb;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int i = e / kDepth, r = e % kDepth;   // x row-major: k fastest
      const int m = m0 + i, k = k0 + r;
      t.a[r][i] = (m < M && k < K) ? x[m * sxm + k] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kTile, j = e % kTile;     // w row-major: n fastest
      const int k = k0 + r, n = n0 + j;
      t.b[r][j] = (k < K && n < N) ? w[k * swk + n] : 0.f;
    }
    __syncthreads();
    mma_slab(t, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      y[m * sym + n] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ dy, const float* __restrict__ yv,
          const float* __restrict__ w, float* __restrict__ dx, int M, int K,
          int N, long long sdb, long long sdm, long long syb, long long sym,
          long long swb, long long swk, long long sxb, long long sxm,
          int relu) {
  __shared__ Tiles t;
  const int bz = blockIdx.z;
  const int m0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  dy += bz * sdb;
  if (relu) yv += bz * syb;
  w += bz * swb;
  dx += bz * sxb;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int i = e / kDepth, r = e % kDepth;   // dz row-major: n fastest
      const int m = m0 + i, n = n0 + r;
      t.a[r][i] = (m < M && n < N)
                      ? masked_dz(dy, yv, m * sdm + n, m * sym + n, relu)
                      : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int j = e / kDepth, r = e % kDepth;   // w (K, N): n fastest
      const int k = k0 + j, n = n0 + r;
      t.b[r][j] = (k < K && n < N) ? w[k * swk + n] : 0.f;
    }
    __syncthreads();
    mma_slab(t, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) dx[m * sxm + k] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dwdb_kernel(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ yv, float* __restrict__ dw,
            float* __restrict__ db, int M, int K, int N, long long sxb,
            long long sxm, long long sdb, long long sdm, long long syb,
            long long sym, long long swb, long long swk, long long sbb,
            int relu) {
  __shared__ Tiles t;
  const int bz = blockIdx.z;
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool with_db = blockIdx.y == 0 && ty == 0;
  x += bz * sxb;
  dy += bz * sdb;
  if (relu) yv += bz * syb;
  dw += bz * swb;
  db += bz * sbb;
  float acc[4][4] = {};
  float dbacc[4] = {};
  for (int mr = 0; mr < M; mr += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kTile, i = e % kTile;     // x (M, K): k fastest
      const int m = mr + r, k = k0 + i;
      t.a[r][i] = (m < M && k < K) ? x[m * sxm + k] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kTile, j = e % kTile;     // dz (M, N): n fastest
      const int m = mr + r, n = n0 + j;
      t.b[r][j] = (m < M && n < N)
                      ? masked_dz(dy, yv, m * sdm + n, m * sym + n, relu)
                      : 0.f;
    }
    __syncthreads();
    mma_slab(t, ty, tx, acc);
    if (with_db) {
#pragma unroll
      for (int r = 0; r < kDepth; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) dbacc[j] += t.b[r][tx * 4 + j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dw[k * swk + n] = acc[i][j];
    }
  }
  if (with_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) db[n] = dbacc[j];
    }
  }
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Plain C entry points (loaded with ctypes). Every operand is row-major in
// its last dimension; the other strides are in elements. Each returns the
// launch's cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fused_linear_fwd(const float* x, const float* w,
                                const float* bias, float* y, int B, int M,
                                int K, int N, long long sxb, long long sxm,
                                long long swb, long long swk, long long sbb,
                                long long syb, long long sym, int relu,
                                void* stream) {
  const dim3 grid(tiles(N), tiles(M), B);
  fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, M, K, N, sxb, sxm, swb, swk, sbb, syb, sym, relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_linear_bwd_dx(const float* dy, const float* y,
                                   const float* w, float* dx, int B, int M,
                                   int K, int N, long long sdb, long long sdm,
                                   long long syb, long long sym, long long swb,
                                   long long swk, long long sxb, long long sxm,
                                   int relu, void* stream) {
  const dim3 grid(tiles(K), tiles(M), B);
  dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, y, w, dx, M, K, N, sdb, sdm, syb, sym, swb, swk, sxb, sxm, relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_linear_bwd_dw_db(const float* x, const float* dy,
                                      const float* y, float* dw, float* db,
                                      int B, int M, int K, int N,
                                      long long sxb, long long sxm,
                                      long long sdb, long long sdm,
                                      long long syb, long long sym,
                                      long long swb, long long swk,
                                      long long sbb, int relu, void* stream) {
  const dim3 grid(tiles(N), tiles(K), B);
  dwdb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dy, y, dw, db, M, K, N, sxb, sxm, sdb, sdm, syb, sym, swb, swk, sbb,
      relu);
  return static_cast<int>(cudaGetLastError());
}
