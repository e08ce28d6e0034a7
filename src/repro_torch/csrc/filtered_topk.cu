// Fused filtered exact top-k for Hopper (sm_90a), SIMT fp32.
//
// Replaces the TPU kernel src/repro/kernels/filtered_topk.py::
// filtered_topk_kernel_call (pallas_call at :147): distance + packed
// spatio-temporal predicate + exact top-kpad, with -1 / +inf for misses.
//
// Semantics (held against kernels/filtered_topk.py::filtered_topk_plain):
//   L2 = (|q|^2 - 2 q.x) + |x|^2 in fp32, IP = -q.x; the predicate kinds
//   none / box / ball / box_not_ball / box_ball read a packed [4, mp]
//   parameter block (box lo, box hi, ball centre, [r^2, ball ndim]); rows
//   whose metadata carries PAD_META (2e30) fail every kind, "none" too.
//   Outputs are ascending by (distance, candidate id), so they are
//   deterministic and equal the reference wherever distances are unique.
//
// What bounds it on an H100: the q.x products.  A batch of bq queries
// against n candidates of width d is 2*bq*n*d fp32 operations over
// n*d*4 bytes read once, i.e. bq/2 operations per byte — far above the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20) for the batches the
// main path sends (bq ~ 1000), so the kernel is bound by fp32 operations.
//
// Design (no TPU structure carried over):
//   * Pass 1 splits the candidate axis across blocks (grid = splits x
//     query tiles x batch g), so a long scan fills all 132 SMs even when
//     the query batch alone would make only a few tiles.
//   * Each block computes a TQ x 64 distance tile as a shared-memory-tiled
//     SIMT product (depth chunks of 32, a small register micro-tile per
//     thread), then evaluates the predicate once per candidate.
//   * Each query keeps its running top-kpad list in shared memory.  A warp
//     owns a query row: a ballot drops every candidate that is no better
//     than the current k-th (exact, because the k-th only falls), and the
//     few survivors are inserted by a warp-parallel shift.  kpad up to 1024
//     is supported; TQ shrinks as kpad grows so the lists stay within the
//     opt-in dynamic shared memory.
//   * Pass 2 merges the per-split sorted lists (one warp per query).
//   * The predicate, the list insertion and the merge pass live in
//     topk_common.cuh, shared with B3 (quant_topk.cu) and B4
//     (graph_step.cu).
//   * Metadata stays [n, m] fp32 (m <= 16), not 128 lanes, and every input
//     carries a leading batch axis g with its own stride (0 = shared), so
//     sharded and grouped callers reuse the kernel unchanged.
//   * No fast math: the PAD_META rows rely on (2e30)^2 overflowing to inf,
//     and the predicate arithmetic is spelled with _rn intrinsics so it is
//     never contracted into an FMA that would round differently from the
//     plain PyTorch version.
#include "topk_common.cuh"

namespace {

constexpr int TN = 64;      // candidates per tile
constexpr int DK = 32;      // depth chunk

size_t pass1_smem(int tq, int kpad, int mp) {
  size_t f = (size_t)DK * (tq + 1) + (size_t)DK * (TN + 1) +
             (size_t)tq * (TN + 1) + TN + tq + 4 * mp;
  return f * 4 + TN * 4 + (size_t)tq * kpad * 8;
}

template <int TQ>
__global__ void __launch_bounds__(NT) topk_pass1(
    const float* __restrict__ q, const float* __restrict__ x,
    const float* __restrict__ s, const float* __restrict__ params,
    float* __restrict__ out_d, int* __restrict__ out_i, int bq, int n, int d,
    int m, int mp, int kpad, int kind, int metric, int chunk,
    long long q_gs, long long x_gs, long long s_gs, long long p_gs) {
  constexpr int RQ = TQ / 16;           // query rows per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // [DK][TQ+1]
  float* xs = qs + DK * (TQ + 1);                // [DK][TN+1]
  float* dist = xs + DK * (TN + 1);              // [TQ][TN+1]
  float* xn = dist + TQ * (TN + 1);              // [TN]
  float* qn = xn + TN;                           // [TQ]
  float* P = qn + TQ;                            // [4*mp]
  int* okf = reinterpret_cast<int*>(P + 4 * mp); // [TN]
  float* Ld = reinterpret_cast<float*>(okf + TN);  // [TQ][kpad]
  int* Li = reinterpret_cast<int*>(Ld + TQ * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int gi = blockIdx.z;
  const int q0 = blockIdx.y * TQ;
  const int c_begin = blockIdx.x * chunk;
  const int c_end = min(n, c_begin + chunk);
  const float* qg = q + gi * q_gs;
  const float* xg = x + gi * x_gs;
  const float* sg = s + gi * s_gs;
  const float* pg = params + gi * p_gs;

  for (int i = tid; i < 4 * mp; i += NT) P[i] = pg[i];
  for (int i = tid; i < TQ * kpad; i += NT) { Ld[i] = INFINITY; Li[i] = INT_MAX; }
  for (int r = warp; r < TQ; r += NW) {
    float acc = 0.f;
    int row = q0 + r;
    if (row < bq)
      for (int k = lane; k < d; k += 32) {
        float v = qg[(long long)row * d + k];
        acc = fmaf(v, v, acc);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) qn[r] = acc;
  }
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    float acc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float xacc = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int i = tid; i < TQ * DK; i += NT) {
        int r = i / DK, kk = i % DK, row = q0 + r, col = k0 + kk;
        qs[kk * (TQ + 1) + r] =
            (row < bq && col < d) ? qg[(long long)row * d + col] : 0.f;
      }
      for (int i = tid; i < TN * DK; i += NT) {
        int c = i / DK, kk = i % DK, cand = c0 + c, col = k0 + kk;
        xs[kk * (TN + 1) + c] =
            (cand < c_end && col < d) ? xg[(long long)cand * d + col] : 0.f;
      }
      __syncthreads();
      if (tid < TN) {
#pragma unroll 8
        for (int kk = 0; kk < DK; ++kk) {
          float v = xs[kk * (TN + 1) + tid];
          xacc = fmaf(v, v, xacc);
        }
      }
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        float a[RQ], b[4];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[kk * (TQ + 1) + ty * RQ + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[kk * (TN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < TN) {
      int cand = c0 + tid;
      bool ok = false;
      if (cand < c_end) {
        float row[MAXM];
        for (int j = 0; j < m; ++j) row[j] = sg[(long long)cand * m + j];
        ok = predicate(row, P, m, mp, kind);
      }
      okf[tid] = ok;
      xn[tid] = xacc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = ty * RQ + i, c = tx + 16 * j;
        float ip = acc[i][j];
        float dv = metric == 0
                       ? __fadd_rn(__fsub_rn(qn[r], __fmul_rn(2.f, ip)), xn[c])
                       : -ip;
        dist[r * (TN + 1) + c] = okf[c] ? dv : INFINITY;
      }
    __syncthreads();
    for (int r = warp; r < TQ; r += NW) {
      if (q0 + r >= bq) continue;                // warp-uniform
      float* Lr = Ld + r * kpad;
      int* Ir = Li + r * kpad;
      for (int h = 0; h < TN; h += 32) {
        int c = h + lane;
        warp_offer(Lr, Ir, kpad, dist[r * (TN + 1) + c], c0 + c, true, lane);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < TQ * kpad; i += NT) {
    int r = i / kpad, j = i % kpad, row = q0 + r;
    if (row >= bq) continue;
    long long o = (((long long)gi * gridDim.x + blockIdx.x) * bq + row) * kpad + j;
    float dv = Ld[i];
    out_d[o] = dv;
    out_i[o] = isfinite(dv) ? Li[i] : -1;
  }
}

template <int TQ>
cudaError_t launch_pass1(dim3 grid, size_t sm, cudaStream_t st,
                         const float* q, const float* x, const float* s,
                         const float* p, float* od, int* oi, int bq, int n,
                         int d, int m, int mp, int kpad, int kind, int metric,
                         int chunk, long long qgs, long long xgs,
                         long long sgs, long long pgs) {
  cudaError_t e = cudaFuncSetAttribute(
      topk_pass1<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return e;
  topk_pass1<TQ><<<grid, NT, sm, st>>>(q, x, s, p, od, oi, bq, n, d, m, mp,
                                       kpad, kind, metric, chunk, qgs, xgs,
                                       sgs, pgs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Query-tile height the launcher uses for a given kpad (the wrapper sizes
// its split count with it).
int repro_filtered_topk_tile_q(int kpad) {
  return kpad <= 128 ? 64 : (kpad <= 256 ? 32 : 16);
}

// q [g?, bq, d], x [g, n, d], s [g, n, m], params [g?, 4, mp] (fp32,
// contiguous, batch strides in elements; 0 = shared across g).  With
// splits > 1, part_d / part_i are [g, splits, bq, kpad] scratch.
// out_d / out_i are [g, bq, kpad].  Returns cudaGetLastError().
int repro_filtered_topk(const float* q, const float* x, const float* s,
                        const float* params, float* out_d, int* out_i,
                        float* part_d, int* part_i, int g, int bq, int n,
                        int d, int m, int mp, int kpad, int kind, int metric,
                        int splits, int chunk, long long q_gs, long long x_gs,
                        long long s_gs, long long p_gs, void* stream) {
  if (m > MAXM || m < 1 || mp < m || kpad < 1 || kpad > 1024 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tq = repro_filtered_topk_tile_q(kpad);
  dim3 grid(splits, (bq + tq - 1) / tq, g);
  size_t sm = pass1_smem(tq, kpad, mp);
  float* p1d = splits == 1 ? out_d : part_d;
  int* p1i = splits == 1 ? out_i : part_i;
  cudaError_t e;
  if (tq == 64)
    e = launch_pass1<64>(grid, sm, st, q, x, s, params, p1d, p1i, bq, n, d, m,
                         mp, kpad, kind, metric, chunk, q_gs, x_gs, s_gs, p_gs);
  else if (tq == 32)
    e = launch_pass1<32>(grid, sm, st, q, x, s, params, p1d, p1i, bq, n, d, m,
                         mp, kpad, kind, metric, chunk, q_gs, x_gs, s_gs, p_gs);
  else
    e = launch_pass1<16>(grid, sm, st, q, x, s, params, p1d, p1i, bq, n, d, m,
                         mp, kpad, kind, metric, chunk, q_gs, x_gs, s_gs, p_gs);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1)
    e = launch_merge(part_d, part_i, out_d, out_i, g, splits, bq, kpad, st);
  return (int)e;
}

}  // extern "C"
