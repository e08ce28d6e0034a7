// Shared pieces of the hand-written top-k kernels (B1 filtered_topk.cu,
// B3 quant_topk.cu, B4 graph_step.cu): the packed spatio-temporal
// predicate, the (distance, id) order, a warp-owned sorted top-kpad list in
// shared memory (one-by-one inserts, or a sorted batch of 32 merged in
// one pass, or a row of 128 whose survivors are compacted first), and the
// pass that merges per-split lists.
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

// Offer each lane's (dv, id) to the warp's list, like warp_offer.  When
// more than two lanes beat the list's last entry, their 32 values are
// sorted across the warp (bitonic, by (distance, id)) and merged into the
// list in one pass: every list entry moves up by the number of new values
// below it, every new value lands at its rank in the old list plus its
// own index.  The list that results is the one the inserts give.
__device__ void warp_offer_many(float* Ld, int* Li, int kpad, float dv,
                                int id, bool valid, int lane) {
  const bool ok = valid && isfinite(dv) &&
                  less_di(dv, id, Ld[kpad - 1], Li[kpad - 1]);
  const unsigned mask = __ballot_sync(FULL, ok);
  if (!mask) return;
  if (__popc(mask) <= 2) {
    warp_offer(Ld, Li, kpad, dv, id, ok, lane);
    return;
  }
  float d = ok ? dv : INFINITY;
  int i = ok ? id : INT_MAX;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      const float od = __shfl_xor_sync(FULL, d, st);
      const int oi = __shfl_xor_sync(FULL, i, st);
      const bool keep_min = ((lane & st) == 0) == ((lane & size) == 0);
      if (keep_min ? less_di(od, oi, d, i) : less_di(d, i, od, oi)) {
        d = od;
        i = oi;
      }
    }
  const int cnt = __popc(mask);     // lanes 0 .. cnt-1 hold the new values
  int rank = 0;                     // entries of the old list below mine
  if (lane < cnt) {
    int hi = kpad;
    while (rank < hi) {
      const int mid = (rank + hi) >> 1;
      if (less_di(Ld[mid], Li[mid], d, i)) rank = mid + 1;
      else hi = mid;
    }
  }
  const int first = __shfl_sync(FULL, rank, 0);  // entries below it stay
  const float d31 = __shfl_sync(FULL, d, 31);
  const int i31 = __shfl_sync(FULL, i, 31);
  for (int base = (kpad - 1) & ~31; base + 32 > first; base -= 32) {
    const int p = base + lane;
    float ld = INFINITY;
    int li = INT_MAX;
    if (p < kpad) { ld = Ld[p]; li = Li[p]; }
    int r = 0;                       // new values below entry p
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float bd = __shfl_sync(FULL, d, r + s - 1);
      const int bi = __shfl_sync(FULL, i, r + s - 1);
      if (less_di(bd, bi, ld, li)) r += s;
    }
    if (r == 31 && less_di(d31, i31, ld, li)) r = 32;
    __syncwarp();
    if (p < kpad && r > 0 && p + r < kpad) { Ld[p + r] = ld; Li[p + r] = li; }
    __syncwarp();
  }
  if (lane < cnt && rank + lane < kpad) {
    Ld[rank + lane] = d;
    Li[rank + lane] = i;
  }
  __syncwarp();
}

// Offer a row of 128 candidates (`row`, distances in shared memory; the
// candidate of column c has id id_of(c)) to the warp's list.  The
// candidates that beat the list's last entry are counted first; when at
// most 32 do, they are compacted into one batch (the row's storage is
// reused for it) and offered at once, else the four batches of 32 are
// offered in turn.
template <typename IdOf>
__device__ void warp_offer_row(float* Ld, int* Li, int kpad, float* row,
                               IdOf id_of, int lane) {
  const float td = Ld[kpad - 1];
  const int ti = Li[kpad - 1];
  float v[4];
  int id[4];
  unsigned bits[4];
  int total = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    v[h] = row[h * 32 + lane];
    id[h] = id_of(h * 32 + lane);
    const bool ok = isfinite(v[h]) && less_di(v[h], id[h], td, ti);
    bits[h] = __ballot_sync(FULL, ok);
    total += __popc(bits[h]);
  }
  if (total == 0) return;
  if (total > 32) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      warp_offer_many(Ld, Li, kpad, v[h], id[h], true, lane);
    return;
  }
  int* ids = reinterpret_cast<int*>(row + 32);
  __syncwarp();
  int base = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if ((bits[h] >> lane) & 1u) {
      const int pos = base + __popc(bits[h] & ((1u << lane) - 1u));
      row[pos] = v[h];
      ids[pos] = id[h];
    }
    base += __popc(bits[h]);
  }
  __syncwarp();
  const bool mine = lane < total;
  const float dv = mine ? row[lane] : INFINITY;
  const int mid = mine ? ids[lane] : INT_MAX;
  __syncwarp();
  warp_offer_many(Ld, Li, kpad, dv, mid, mine, lane);
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
