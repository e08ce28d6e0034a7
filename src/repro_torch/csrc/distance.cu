// Tiled pairwise distance matrix for Hopper (sm_90a), SIMT fp32.
//
// Replaces the TPU kernel src/repro/kernels/distance.py::
// pairwise_dist_kernel_call (pallas_call at :46): [bq, d] x [n, d] ->
// [bq, n] fp32 squared L2 ((|q|^2 - 2 q.x) + |x|^2) or -q.x, from fp32 or
// bf16 inputs with fp32 accumulation.
//
// What bounds it on an H100: for the shapes it is called with, writing
// the [bq, n] fp32 result (4 bytes per output) and, at large d, the
// 2*bq*n*d fp32 operations; the kernel reads each input tile once per
// 64 x 64 output tile from shared memory.
//
// Design: one 256-thread block per 64 x 64 output tile; depth chunks of
// 32 are staged in shared memory (converted to fp32 on load, so bf16
// inputs cost half the bytes and accumulate exactly like the plain
// version), each thread keeps a 4 x 4 register micro-tile, and the norms
// are accumulated from the same staged chunks.  The final combination
// uses _rn intrinsics so it is not contracted into an FMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TQ = 64, TN = 64, DK = 32, NT = 256;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT) dist_kernel(const T* __restrict__ q,
                                                  const T* __restrict__ x,
                                                  float* __restrict__ out,
                                                  int bq, int n, int d,
                                                  int metric) {
  __shared__ float qs[DK][TQ + 1];
  __shared__ float xs[DK][TN + 1];
  __shared__ float qn[TQ], xn[TN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * TQ, c0 = blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;   // tid < 64: |q_tid|^2, 64 <= tid < 128: |x_tid-64|^2
  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int i = tid; i < TQ * DK; i += NT) {
      int r = i / DK, kk = i % DK, row = q0 + r, col = k0 + kk;
      qs[kk][r] = (row < bq && col < d) ? tof(q[(long long)row * d + col]) : 0.f;
    }
    for (int i = tid; i < TN * DK; i += NT) {
      int c = i / DK, kk = i % DK, cand = c0 + c, col = k0 + kk;
      xs[kk][c] = (cand < n && col < d) ? tof(x[(long long)cand * d + col]) : 0.f;
    }
    __syncthreads();
    if (tid < TQ) {
      for (int kk = 0; kk < DK; ++kk) nacc = fmaf(qs[kk][tid], qs[kk][tid], nacc);
    } else if (tid < TQ + TN) {
      int c = tid - TQ;
      for (int kk = 0; kk < DK; ++kk) nacc = fmaf(xs[kk][c], xs[kk][c], nacc);
    }
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < TQ) qn[tid] = nacc;
  else if (tid < TQ + TN) xn[tid - TQ] = nacc;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = ty * 4 + i, c = tx + 16 * j, row = q0 + r, col = c0 + c;
      if (row < bq && col < n) {
        float ip = acc[i][j];
        out[(long long)row * n + col] =
            metric == 0 ? __fadd_rn(__fsub_rn(qn[r], __fmul_rn(2.f, ip)), xn[c])
                        : -ip;
      }
    }
}

}  // namespace

extern "C" {

// q [bq, d], x [n, d] contiguous, both fp32 (dtype 0) or both bf16
// (dtype 1); out [bq, n] fp32.  Returns cudaGetLastError().
int repro_pairwise_dist(const void* q, const void* x, float* out, int bq,
                        int n, int d, int metric, int dtype, void* stream) {
  if (bq < 1 || n < 1 || d < 1 || (bq + TQ - 1) / TQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((n + TN - 1) / TN, (bq + TQ - 1) / TQ);
  if (dtype == 0)
    dist_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), out, bq, n,
        d, metric);
  else
    dist_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(x), out, bq, n, d, metric);
  return (int)cudaGetLastError();
}

}  // extern "C"
