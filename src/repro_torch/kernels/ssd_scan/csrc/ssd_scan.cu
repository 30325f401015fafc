// Mamba-2 SSD chunked scan (forward), f32 CUDA for Hopper (sm_90a).
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
// 2 Q^2 (ds + p) + 4 Q ds p operations on Q (p + ds + ds + 1) inputs, a few
// tens of operations per byte at the FL path's shapes (Q = 32, ds = 16,
// p = 32), so neither memory nor the f32 rate is the limit there: the scan
// over chunks is sequential inside a block and the blocks are small.
//
// The simple design. One block of 256 threads per (batch row, head block);
// the TPU grid's sequential chunk axis becomes a loop inside the block, and
// the (block_h, ds, p) f32 state stays in shared memory across chunks. Per
// chunk the block stages c and b once and forms the Q x Q score matrix
// c b^T once for all its heads (B/C are shared across heads); per head it
// stages x and dt, runs the cumsum on one thread (Q steps, in order), builds
// the decayed weights, then writes y and updates the state, each output
// element on one thread with the reduction loop inside it. Shared tiles
// have odd row pitches so the column-parallel reads are conflict-free.
// a_log arrives per slot: row r reads slot r / rows_per_slot with the
// slot's stride (0 when every row shares one a_log), so nothing is
// materialised per row. x, dt, b and c are read through their row and
// step strides (the slot-batched model hands in split views); y is
// contiguous. expf throughout (no fast-math intrinsics).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* x;      // (B, S, n, p)
  const float* dt;     // (B, S, n)
  const float* a_log;  // (slots, n)
  const float* b;      // (B, S, ds)
  const float* c;      // (B, S, ds)
  float* y;            // (B, S, n, p), contiguous
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sb_b, sb_s, sc_b, sc_s, sa_slot;
  int seq, n, p, ds, chunk, block_h, rows_per_slot;
};

size_t smem_floats(const Args& a) {
  const int q = a.chunk;
  return 2 * q * (a.ds + 1)          // c, b
         + 2 * q * (q + 1)           // scores, decayed weights
         + q * a.p                   // x of one head
         + 3 * q                     // dt, cum, end-of-chunk weights
         + a.block_h * a.ds * a.p;   // carried state
}

__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  extern __shared__ float smem[];
  const int Q = a.chunk, P = a.p, DS = a.ds;
  float* cs = smem;                      // [Q][DS+1]
  float* bs = cs + Q * (DS + 1);         // [Q][DS+1]
  float* sc = bs + Q * (DS + 1);         // [Q][Q+1] c b^T
  float* w = sc + Q * (Q + 1);           // [Q][Q+1] decayed, one head
  float* xs = w + Q * (Q + 1);           // [Q][P]
  float* dts = xs + Q * P;               // [Q]
  float* cum = dts + Q;                  // [Q]
  float* wk = cum + Q;                   // [Q]
  float* hs = wk + Q;                    // [block_h][DS][P]

  const int row = blockIdx.x, h0 = blockIdx.y * a.block_h;
  const float* x = a.x + row * a.sx_b;
  const float* dt = a.dt + row * a.sdt_b;
  const float* bg = a.b + row * a.sb_b;
  const float* cg = a.c + row * a.sc_b;
  const float* a_log = a.a_log + (row / a.rows_per_slot) * a.sa_slot;
  float* y = a.y + static_cast<long long>(row) * a.seq * a.n * P;

  for (int e = threadIdx.x; e < a.block_h * DS * P; e += kThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < a.seq; c0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < Q * DS; e += kThreads) {
      const int t = e / DS, s = e % DS;
      cs[t * (DS + 1) + s] = cg[(c0 + t) * a.sc_s + s];
      bs[t * (DS + 1) + s] = bg[(c0 + t) * a.sb_s + s];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
      const int qi = e / Q, kj = e % Q;
      float acc = 0.f;
      if (kj <= qi)
        for (int s = 0; s < DS; ++s)
          acc = fmaf(cs[qi * (DS + 1) + s], bs[kj * (DS + 1) + s], acc);
      sc[qi * (Q + 1) + kj] = acc;
    }
    for (int hh = 0; hh < a.block_h; ++hh) {
      const int h = h0 + hh;
      float* hstate = hs + hh * DS * P;
      __syncthreads();  // scores done; the previous head's readers done
      for (int e = threadIdx.x; e < Q * P; e += kThreads) {
        const int t = e / P, pp = e % P;
        xs[e] = x[(c0 + t) * a.sx_s + h * a.sx_h + pp];
      }
      for (int t = threadIdx.x; t < Q; t += kThreads)
        dts[t] = dt[(c0 + t) * a.sdt_s + h];
      __syncthreads();
      if (threadIdx.x == 0) {
        const float rate = -expf(a_log[h]);
        float run = 0.f;
        for (int t = 0; t < Q; ++t) {
          run += dts[t] * rate;
          cum[t] = run;
        }
        for (int t = 0; t < Q; ++t) wk[t] = expf(run - cum[t]) * dts[t];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
        const int qi = e / Q, kj = e % Q;
        w[qi * (Q + 1) + kj] =
            kj <= qi ? sc[qi * (Q + 1) + kj] * expf(cum[qi] - cum[kj]) * dts[kj]
                     : 0.f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < Q * P; e += kThreads) {
        const int qi = e / P, pp = e % P;
        float intra = 0.f;
        for (int kj = 0; kj <= qi; ++kj)
          intra = fmaf(w[qi * (Q + 1) + kj], xs[kj * P + pp], intra);
        float inter = 0.f;
        for (int s = 0; s < DS; ++s)
          inter = fmaf(cs[qi * (DS + 1) + s], hstate[s * P + pp], inter);
        y[((c0 + qi) * a.n + h) * P + pp] = intra + inter * expf(cum[qi]);
      }
      __syncthreads();  // every read of the state before this chunk is done
      const float decay = expf(cum[Q - 1]);
      for (int e = threadIdx.x; e < DS * P; e += kThreads) {
        const int s = e / P, pp = e % P;
        float upd = 0.f;
        for (int kj = 0; kj < Q; ++kj)
          upd = fmaf(bs[kj * (DS + 1) + s], xs[kj * P + pp] * wk[kj], upd);
        hstate[e] = hstate[e] * decay + upd;
      }
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). x (B, S, n, p), dt (B, S, n), b and c
// (B, S, ds) f32 with a unit last stride; `strides` holds, in order, x's
// (row, step, head) strides, dt's (row, step), b's (row, step), c's (row,
// step) and a_log's slot stride. Row r uses a_log slot r / rows_per_slot.
// y is contiguous (B, S, n, p). S must be a multiple of chunk and n of
// block_h. Returns the CUDA error code of the launch (0 on success); the
// kernel runs asynchronously on `stream`.
extern "C" int ssd_scan_fwd(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, float* y, int batch, int seq,
                            int n, int p, int ds, int chunk, int block_h,
                            int rows_per_slot, const long long* strides,
                            cudaStream_t stream) {
  if (chunk <= 0 || seq % chunk || block_h <= 0 || n % block_h ||
      rows_per_slot <= 0)
    return cudaErrorInvalidValue;
  Args a{x, dt, a_log, b, c, y,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         seq, n, p, ds, chunk, block_h, rows_per_slot};
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
          ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    return err;
  }();
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * smem_floats(a);
  ssd_kernel<<<dim3(batch, n / block_h), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}
