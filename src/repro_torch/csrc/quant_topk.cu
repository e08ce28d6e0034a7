// Fused asymmetric-distance filtered top-k over int8 codes for Hopper
// (sm_90a), SIMT fp32.
//
// Replaces the TPU kernel src/repro/kernels/quant_topk.py::
// quant_filtered_topk_kernel_call (pallas_call at :146): the scale-folded
// fp32 query against raw int8 segment codes, the packed predicate, and an
// exact top-kpad of the *partial* distance, with -1 / +inf for misses.
//
// Semantics (held against kernels/quant_topk.py::quant_topk_plain):
//   ip = qs . float(code), qs = q * scale (folded by the wrapper, per
//   shard row); L2 emits xsq - 2 ip (xsq = the dequantized squared norm,
//   precomputed at seal; the wrapper adds |q|^2 afterwards), IP emits -ip.
//   The predicate is B1's (topk_common.cuh) over row-major [n, m] metadata;
//   PAD_META rows (padding, dead points) fail every kind.  Outputs are
//   ascending by (distance, candidate id).
//
// What bounds it on an H100: the products again.  2*bq*n*d fp32 operations
// over n*(d + 4m + 4) bytes read once, so bq/2 operations per byte for the
// int8 block: at the batches the read path sends (bq ~ 1000) it sits far
// above the fp32 ridge (about 20), bound by fp32 operations.
//
// Design (no TPU structure carried over):
//   * Layout is Hopper's, not the TPU's transposed [dq, n] / [mq, n]
//     tiles: codes [g, n, d] int8 row-major (one point = d contiguous
//     bytes), metadata [g, n, m] fp32, xsq [g, n] fp32, queries
//     [g, bq, d] fp32 (each shard row has its own scales, so its own
//     folded queries).
//   * Same two-pass shape as B1: pass 1 splits the candidate axis across
//     blocks (grid = splits x query tiles x g), stages a 64-candidate int8
//     tile per depth chunk in shared memory converted to fp32, FMAs it
//     against the folded query tile, and keeps a per-query sorted
//     top-kpad list in shared memory; pass 2 merges the splits
//     (topk_common.cuh, shared with B1).
//   * kpad up to 2048 (the quantized path over-fetches rerank_multiple * k,
//     e.g. 4 * 300 -> kpad 2048): the query tile shrinks to 8 rows there
//     (8 * 2048 * 8 B = 128 KiB of lists) and the per-thread micro-tile
//     changes shape with it so all 256 threads stay busy.
//   * Per-candidate accumulation order (k = 0..d-1, one fmaf chain) does
//     not depend on the split, the tile or the row, so a shard stack, an
//     incrementally grown bucket and a cold build give bit-equal answers.
#include "topk_common.cuh"

namespace {

constexpr int TN = 64;      // candidates per tile
constexpr int DK = 32;      // depth chunk
constexpr int MAX_KPAD = 2048;

int tile_q(int kpad) {
  return kpad <= 128 ? 64 : kpad <= 256 ? 32 : kpad <= 1024 ? 16 : 8;
}

size_t pass1_smem(int tq, int kpad, int mp) {
  size_t f = (size_t)DK * (tq + 1) + (size_t)DK * (TN + 1) +
             (size_t)tq * (TN + 1) + TN + 4 * mp;
  return f * 4 + TN * 4 + (size_t)tq * kpad * 8;
}

// TQ query rows per block; each thread owns an RQ x RC micro-tile of the
// TQ x TN distance tile (TY x TX threads, TY * TX == NT).
template <int TQ, int RQ, int RC>
__global__ void __launch_bounds__(NT) quant_pass1(
    const float* __restrict__ q, const int8_t* __restrict__ codes,
    const float* __restrict__ s, const float* __restrict__ xsq,
    const float* __restrict__ params, float* __restrict__ out_d,
    int* __restrict__ out_i, int bq, int n, int d, int m, int mp, int kpad,
    int kind, int metric, int chunk, long long q_gs, long long c_gs,
    long long s_gs, long long xq_gs) {
  constexpr int TY = TQ / RQ, TX = TN / RC;
  static_assert(TY * TX == NT, "micro-tile must cover the block");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // [DK][TQ+1]
  float* xs = qs + DK * (TQ + 1);                // [DK][TN+1]
  float* dist = xs + DK * (TN + 1);              // [TQ][TN+1]
  float* xn = dist + TQ * (TN + 1);              // [TN]
  float* P = xn + TN;                            // [4*mp]
  int* okf = reinterpret_cast<int*>(P + 4 * mp); // [TN]
  float* Ld = reinterpret_cast<float*>(okf + TN);  // [TQ][kpad]
  int* Li = reinterpret_cast<int*>(Ld + TQ * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TX, ty = tid / TX;
  const int gi = blockIdx.z;
  const int q0 = blockIdx.y * TQ;
  const int c_begin = blockIdx.x * chunk;
  const int c_end = min(n, c_begin + chunk);
  const float* qg = q + gi * q_gs;
  const int8_t* cg = codes + gi * c_gs;
  const float* sg = s + gi * s_gs;
  const float* xqg = xsq + gi * xq_gs;

  for (int i = tid; i < 4 * mp; i += NT) P[i] = params[i];
  for (int i = tid; i < TQ * kpad; i += NT) { Ld[i] = INFINITY; Li[i] = INT_MAX; }
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int i = tid; i < TQ * DK; i += NT) {
        int r = i / DK, kk = i % DK, row = q0 + r, col = k0 + kk;
        qs[kk * (TQ + 1) + r] =
            (row < bq && col < d) ? qg[(long long)row * d + col] : 0.f;
      }
      for (int i = tid; i < TN * DK; i += NT) {
        int c = i / DK, kk = i % DK, cand = c0 + c, col = k0 + kk;
        xs[kk * (TN + 1) + c] =
            (cand < c_end && col < d)
                ? (float)cg[(long long)cand * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        float a[RQ], b[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[kk * (TQ + 1) + ty * RQ + i];
#pragma unroll
        for (int j = 0; j < RC; ++j) b[j] = xs[kk * (TN + 1) + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < TN) {
      int cand = c0 + tid;
      bool ok = false;
      float xv = 0.f;
      if (cand < c_end) {
        float row[MAXM];
        for (int j = 0; j < m; ++j) row[j] = sg[(long long)cand * m + j];
        ok = predicate(row, P, m, mp, kind);
        xv = xqg[cand];
      }
      okf[tid] = ok;
      xn[tid] = xv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        int r = ty * RQ + i, c = tx + TX * j;
        float ip = acc[i][j];
        float dv = metric == 0 ? __fsub_rn(xn[c], __fmul_rn(2.f, ip)) : -ip;
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

template <int TQ, int RQ, int RC>
cudaError_t launch_pass1(dim3 grid, size_t sm, cudaStream_t st,
                         const float* q, const int8_t* c, const float* s,
                         const float* xsq, const float* p, float* od, int* oi,
                         int bq, int n, int d, int m, int mp, int kpad,
                         int kind, int metric, int chunk, long long qgs,
                         long long cgs, long long sgs, long long xgs) {
  cudaError_t e = cudaFuncSetAttribute(
      quant_pass1<TQ, RQ, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return e;
  quant_pass1<TQ, RQ, RC><<<grid, NT, sm, st>>>(
      q, c, s, xsq, p, od, oi, bq, n, d, m, mp, kpad, kind, metric, chunk,
      qgs, cgs, sgs, xgs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Query-tile height for a given kpad (the wrapper sizes its splits with it).
int repro_quant_topk_tile_q(int kpad) { return tile_q(kpad); }

// q [g?, bq, d] fp32 scale-folded queries, codes [g, n, d] int8,
// s [g, n, m] fp32, xsq [g, n] fp32, params [4, mp] fp32 (all contiguous,
// batch strides in elements; q_gs = 0 shares the queries across g).
// With splits > 1, part_d / part_i are [g, splits, bq, kpad] scratch.
// out_d / out_i are [g, bq, kpad].  Returns cudaGetLastError().
int repro_quant_topk(const float* q, const int8_t* codes, const float* s,
                     const float* xsq, const float* params, float* out_d,
                     int* out_i, float* part_d, int* part_i, int g, int bq,
                     int n, int d, int m, int mp, int kpad, int kind,
                     int metric, int splits, int chunk, long long q_gs,
                     long long c_gs, long long s_gs, long long xq_gs,
                     void* stream) {
  if (m > MAXM || m < 1 || mp < m || kpad < 1 || kpad > MAX_KPAD ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tq = tile_q(kpad);
  dim3 grid(splits, (bq + tq - 1) / tq, g);
  size_t sm = pass1_smem(tq, kpad, mp);
  float* p1d = splits == 1 ? out_d : part_d;
  int* p1i = splits == 1 ? out_i : part_i;
  cudaError_t e;
  if (tq == 64)
    e = launch_pass1<64, 4, 4>(grid, sm, st, q, codes, s, xsq, params, p1d,
                               p1i, bq, n, d, m, mp, kpad, kind, metric, chunk,
                               q_gs, c_gs, s_gs, xq_gs);
  else if (tq == 32)
    e = launch_pass1<32, 2, 4>(grid, sm, st, q, codes, s, xsq, params, p1d,
                               p1i, bq, n, d, m, mp, kpad, kind, metric, chunk,
                               q_gs, c_gs, s_gs, xq_gs);
  else if (tq == 16)
    e = launch_pass1<16, 1, 4>(grid, sm, st, q, codes, s, xsq, params, p1d,
                               p1i, bq, n, d, m, mp, kpad, kind, metric, chunk,
                               q_gs, c_gs, s_gs, xq_gs);
  else
    e = launch_pass1<8, 1, 2>(grid, sm, st, q, codes, s, xsq, params, p1d,
                              p1i, bq, n, d, m, mp, kpad, kind, metric, chunk,
                              q_gs, c_gs, s_gs, xq_gs);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1)
    e = launch_merge(part_d, part_i, out_d, out_i, g, splits, bq, kpad, st);
  return (int)e;
}

}  // extern "C"
