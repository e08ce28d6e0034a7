// One hop of the stitched graph traversal for Hopper (sm_90a): gather the
// candidate rows straight from the bucket block, score them, evaluate the
// packed predicate.
//
// Replaces the TPU kernel src/repro/kernels/graph_topk.py::beam_step_scores
// (pallas_call at :86), which scores a candidate tile the caller has
// already gathered into a [b, c, d] array.  Here the gather is fused: the
// kernel takes flattened bucket positions pos [b, c] (row * cap + col) and
// reads each candidate row from the fp32 block x [rows * cap, d], or from
// the int8 block codes [rows * cap, d] dequantized on load with the row's
// scales [rows, d].
//
// Semantics (held against kernels/graph_topk.py::beam_step_plain):
//   L2 = (|x|^2 - 2 q.x) + |q|^2 with |x|^2 recomputed from the row read
//   (the dequantized row for int8 blocks), IP = -q.x; ok = the packed
//   predicate of topk_common.cuh on the row's metadata [rows * cap, m]
//   (PAD_META rows fail).  Distances are raw (routing ignores the
//   predicate); pos < 0 gives +inf / 0.
//
// What bounds it on an H100: bytes.  Each (query, candidate) pair reads
// one row (4d bytes fp32, d bytes int8) and does 4d operations, one
// operation per byte (fp32) — far below the fp32 ridge (about 20), so the
// gathered bytes over HBM bandwidth are the bound.  Fusing the gather
// saves writing and re-reading the [b, c, d] tile (1.57 GB per hop at
// b = 1000, c = 512, d = 768 fp32).
//
// Design: one block per (query, 64 candidates), grid b x c/64, with the
// query row and its squared norm in shared memory; one warp per candidate,
// each lane reading 4-element pieces of the row (one 16-byte / 4-byte load
// where d % 4 == 0) and keeping fmaf partial sums, then a fixed xor-shuffle
// reduction.  Every d runs the same loop in the same order.  The order of the
// sum depends only on d, never on the candidate's position, so a bucket
// grown incrementally and one built cold score identically.
#include "topk_common.cuh"

namespace {

constexpr int CPB = 64;     // candidates per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ELEM = float (fp32 block) or int8_t (codes, dequantized with scales).
template <typename ELEM>
__global__ void __launch_bounds__(NT) graph_step(
    const float* __restrict__ q, const int* __restrict__ pos,
    const ELEM* __restrict__ x, const float* __restrict__ scales,
    const float* __restrict__ meta, const float* __restrict__ params,
    float* __restrict__ out_d, int* __restrict__ out_ok, int c, int d,
    int cap, int m, int mp, int kind, int metric, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qv = reinterpret_cast<float*>(smem);    // [d]
  float* P = qv + d;                             // [4*mp]
  float* qn = P + 4 * mp;                        // [1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x;
  const float* qrow = q + (long long)qi * d;
  for (int k = tid; k < d; k += NT) qv[k] = qrow[k];
  for (int i = tid; i < 4 * mp; i += NT) P[i] = params[i];
  __syncthreads();
  if (warp == 0) {
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(qv[k], qv[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) qn[0] = acc;
  }
  __syncthreads();

  const int j_end = min(c, (int)(blockIdx.y + 1) * CPB);
  for (int j = blockIdx.y * CPB + warp; j < j_end; j += NW) {
    const long long o = (long long)qi * c + j;
    const int p = pos[o];
    if (p < 0) {                                 // warp-uniform
      if (lane == 0) { out_d[o] = INFINITY; out_ok[o] = 0; }
      continue;
    }
    const ELEM* xr = x + (long long)p * d;
    const float* sc = scales + (long long)(p / cap) * d;
    // Lane l owns the 4-element pieces at 4l, 4l + 128, ...  A whole piece
    // is one 16-byte (fp32) / 4-byte (int8) load when vec is set; without
    // it, and for the tail piece, the same values come from element loads.
    // The sums run in the same order either way.
    float ip = 0.f, xn = 0.f;
    for (int k = lane * 4; k < d; k += 128) {
      const int w = min(4, d - k);
      float v[4];
      if (vec && w == 4) {
        if constexpr (sizeof(ELEM) == 4) {
          float4 t = *reinterpret_cast<const float4*>(xr + k);
          v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
        } else {
          char4 t = *reinterpret_cast<const char4*>(xr + k);
          float4 s4 = *reinterpret_cast<const float4*>(sc + k);
          v[0] = __fmul_rn((float)t.x, s4.x);
          v[1] = __fmul_rn((float)t.y, s4.y);
          v[2] = __fmul_rn((float)t.z, s4.z);
          v[3] = __fmul_rn((float)t.w, s4.w);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= w) break;
          if constexpr (sizeof(ELEM) == 4) v[u] = xr[k + u];
          else v[u] = __fmul_rn((float)xr[k + u], sc[k + u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= w) break;
        ip = fmaf(v[u], qv[k + u], ip);
        xn = fmaf(v[u], v[u], xn);
      }
    }
    ip = warp_sum(ip);
    xn = warp_sum(xn);
    if (lane == 0) {
      float dv = metric == 0
                     ? __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, ip)), qn[0])
                     : -ip;
      float row[MAXM];
      for (int u = 0; u < m; ++u) row[u] = meta[(long long)p * m + u];
      out_d[o] = dv;
      out_ok[o] = predicate(row, P, m, mp, kind) ? 1 : 0;
    }
  }
}

template <typename ELEM>
cudaError_t launch(dim3 grid, size_t sm, cudaStream_t st, const float* q,
                   const int* pos, const void* x, const float* scales,
                   const float* meta, const float* params, float* od,
                   int* ook, int c, int d, int cap, int m, int mp, int kind,
                   int metric, int vec) {
  if (sm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        graph_step<ELEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm);
    if (e != cudaSuccess) return e;
  }
  graph_step<ELEM><<<grid, NT, sm, st>>>(
      q, pos, reinterpret_cast<const ELEM*>(x), scales, meta, params, od, ook,
      c, d, cap, m, mp, kind, metric, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, d] fp32, pos [b, c] int32 flattened bucket positions (-1 = none),
// x the bucket's [rows * cap, d] block: fp32 (quantized = 0) or int8 codes
// (quantized = 1, dequantized with scales [rows, d] fp32), meta
// [rows * cap, m] fp32, params [4, mp] fp32 -> out_d [b, c] fp32,
// out_ok [b, c] int32.  vec = 1 takes 16-byte loads (d % 4 == 0 and
// 16-byte aligned pointers, checked by the caller).  Returns
// cudaGetLastError().
int repro_graph_step(const float* q, const int* pos, const void* x,
                     const float* scales, const float* meta,
                     const float* params, float* out_d, int* out_ok, int b,
                     int c, int d, int cap, int m, int mp, int kind,
                     int metric, int quantized, int vec, void* stream) {
  if (m > MAXM || m < 1 || mp < m || b < 0 || c < 0 || d < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || c == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(b, (c + CPB - 1) / CPB);
  size_t sm = ((size_t)d + 4 * mp + 1) * 4;
  cudaError_t e =
      quantized ? launch<int8_t>(grid, sm, st, q, pos, x, scales, meta,
                                 params, out_d, out_ok, c, d, cap, m, mp,
                                 kind, metric, vec)
                : launch<float>(grid, sm, st, q, pos, x, scales, meta,
                                params, out_d, out_ok, c, d, cap, m, mp,
                                kind, metric, vec);
  return (int)e;
}

}  // extern "C"
