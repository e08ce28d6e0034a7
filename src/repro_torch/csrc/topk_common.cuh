// Shared pieces of the hand-written top-k kernels (B1 filtered_topk.cu,
// B3 quant_topk.cu, B4 graph_step.cu): the packed spatio-temporal
// predicate, the (distance, id) order, a warp-owned sorted top-kpad list in
// shared memory, and the pass that merges per-split lists.
//
// Everything sits in an anonymous namespace: each kernel source builds
// into its own shared library, so nothing here is linked twice.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int MAXM = 16;    // metadata columns the predicate reads
constexpr float POS = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { NONE = 0, BOX = 1, BALL = 2, BOX_NOT_BALL = 3, BOX_BALL = 4 };

__device__ __forceinline__ bool less_di(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// P is the packed [4, mp] parameter block in shared memory.
__device__ bool predicate(const float* srow, const float* P, int m, int mp,
                          int kind) {
  if (kind == NONE) return srow[0] < POS;
  bool in_box = true;
  for (int j = 0; j < m; ++j) {
    float v = srow[j];
    in_box = in_box && (v >= P[j]) && (v <= P[mp + j]);
  }
  int mc = (int)P[3 * mp + 1];
  mc = mc < m ? mc : m;
  float d2 = 0.f;
  for (int j = 0; j < mc; ++j) {
    float df = __fsub_rn(srow[j], P[2 * mp + j]);
    d2 = __fadd_rn(d2, __fmul_rn(df, df));
  }
  bool in_ball = d2 <= P[3 * mp];
  switch (kind) {
    case BOX: return in_box;
    case BALL: return in_ball;
    case BOX_BALL: return in_box && in_ball;
    default: return in_box && !in_ball;   // BOX_NOT_BALL
  }
}

// Insert (d, id) into the warp's ascending list; the caller checked that
// it beats the last entry.  Warp-uniform control flow throughout.
__device__ void warp_insert(float* Ld, int* Li, int kpad, float d, int id,
                            int lane) {
  int cnt = 0;
  for (int j = lane; j < kpad; j += 32) cnt += less_di(Ld[j], Li[j], d, id);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  const int p = cnt;
  for (int base = kpad - 1; base > p; base -= 32) {
    int j = base - lane;
    bool act = j > p;
    float dv = 0.f;
    int iv = 0;
    if (act) { dv = Ld[j - 1]; iv = Li[j - 1]; }
    __syncwarp();
    if (act) { Ld[j] = dv; Li[j] = iv; }
    __syncwarp();
  }
  if (lane == 0) { Ld[p] = d; Li[p] = id; }
  __syncwarp();
}

// Offer each lane's (dv, id) to the warp's list, survivors only.
__device__ void warp_offer(float* Ld, int* Li, int kpad, float dv, int id,
                           bool valid, int lane) {
  bool ok = valid && isfinite(dv) && less_di(dv, id, Ld[kpad - 1],
                                             Li[kpad - 1]);
  unsigned mask = __ballot_sync(FULL, ok);
  while (mask) {
    int src = __ffs(mask) - 1;
    mask &= mask - 1;
    float cd = __shfl_sync(FULL, dv, src);
    int ci = __shfl_sync(FULL, id, src);
    if (less_di(cd, ci, Ld[kpad - 1], Li[kpad - 1]))
      warp_insert(Ld, Li, kpad, cd, ci, lane);
  }
}

// Pass 2: one warp per (g, query) merges the splits' sorted lists.
__global__ void topk_merge(const float* __restrict__ part_d,
                           const int* __restrict__ part_i,
                           float* __restrict__ out_d, int* __restrict__ out_i,
                           int g, int splits, int bq, int kpad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  long long qi = (long long)blockIdx.x * wpb + warp;
  if (qi >= (long long)g * bq) return;           // whole warp leaves
  const int gi = (int)(qi / bq), row = (int)(qi % bq);
  float* Ld = reinterpret_cast<float*>(smem) + (size_t)warp * kpad;
  int* Li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) +
                                   (size_t)wpb * kpad) + (size_t)warp * kpad;
  long long base0 = (((long long)gi * splits) * bq + row) * kpad;
  for (int j = lane; j < kpad; j += 32) {
    Ld[j] = part_d[base0 + j];
    Li[j] = isfinite(Ld[j]) ? part_i[base0 + j] : INT_MAX;
  }
  __syncwarp();
  for (int sp = 1; sp < splits; ++sp) {
    long long base = (((long long)gi * splits + sp) * bq + row) * kpad;
    for (int j0 = 0; j0 < kpad; j0 += 32) {
      int j = j0 + lane;
      bool in = j < kpad;
      float dv = in ? part_d[base + j] : INFINITY;
      int iv = in ? part_i[base + j] : INT_MAX;
      // each split list is ascending: once no lane of a 32-run beats the
      // current k-th, nothing later in the list can
      bool beats = in && isfinite(dv) && less_di(dv, iv, Ld[kpad - 1],
                                                 Li[kpad - 1]);
      if (!__ballot_sync(FULL, beats)) break;
      warp_offer(Ld, Li, kpad, dv, iv, in, lane);
    }
  }
  long long o = ((long long)gi * bq + row) * kpad;
  for (int j = lane; j < kpad; j += 32) {
    float dv = Ld[j];
    out_d[o + j] = dv;
    out_i[o + j] = isfinite(dv) ? Li[j] : -1;
  }
}

// Launch the merge pass over [g, splits, bq, kpad] partial lists.
cudaError_t launch_merge(const float* part_d, const int* part_i, float* out_d,
                         int* out_i, int g, int splits, int bq, int kpad,
                         cudaStream_t st) {
  const int wpb = 4;
  size_t sm2 = (size_t)wpb * kpad * 8;
  if (sm2 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2);
    if (e != cudaSuccess) return e;
  }
  long long rows = (long long)g * bq;
  unsigned blocks = (unsigned)((rows + wpb - 1) / wpb);
  topk_merge<<<blocks, wpb * 32, sm2, st>>>(part_d, part_i, out_d, out_i, g,
                                            splits, bq, kpad);
  return cudaGetLastError();
}

}  // namespace
