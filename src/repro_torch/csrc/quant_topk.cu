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
// What bounds it on an H100: the products of the candidates that pass the
// predicate, 2*bq*d fp32 operations each; the bytes (all metadata and
// norms, the passing codes, the queries, the lists) are far fewer at the
// batches the read path sends (bq ~ 1000).
//
// Design (no TPU structure carried over):
//   * Layout is Hopper's, not the TPU's transposed [dq, n] / [mq, n]
//     tiles: codes [g, n, d] int8 row-major (one point = d contiguous
//     bytes), metadata [g, n, m] fp32, xsq [g, n] fp32, queries
//     [g, bq, d] fp32 (each shard row has its own scales).
//   * Pass 1: grid (query tiles, splits, g), query tiles fastest, so the
//     blocks that run together read the same candidate tiles (once from
//     HBM, then from L2).  Split s takes the 128-candidate tiles s,
//     s + splits, ... of its row, so a contiguous run of passing rows (a
//     time range of a time-ordered stream) is shared out evenly.
//   * Predicate first: a block evaluates the packed predicate over all its
//     candidates before it copies any code (one ok bit each in shared
//     memory) and lists its live tiles, those with at least one passing
//     candidate.  A tile where nothing passes is never copied or
//     multiplied; it could only offer +inf, so the answer is the same.
//     `PAD_META` rows (padding, free slots, dead points) fail every kind,
//     so an empty shard row costs one metadata pass.
//   * The live tiles stream back to back through the shared mainloop
//     (simt_gemm.cuh): int8 tiles land in the ring at one byte per element
//     and are widened once per stage, and the copies of the next live
//     tile are in flight during a tile's epilogue.
//   * Epilogue: the masked distance tile (every entry written, so nothing
//     of an earlier tile survives) goes to shared memory; each warp offers
//     its rows to per-query sorted top-kpad lists (warp_offer_row: the
//     survivors of a row of 128 are compacted into one batch when at most
//     32, and a batch with more than two survivors is sorted across the
//     warp and merged in one pass).  Pass 2 merges the splits
//     (topk_common.cuh, shared with B1).  The (distance, id) order makes
//     the result independent of splits and skips.
//   * kpad up to 2048 (the quantized path over-fetches rerank_multiple * k,
//     e.g. 4 * 300 -> kpad 2048): the wrapper
//     (kernels/quant_topk.py::launch_config) picks the query tile (64 rows
//     at kpad <= 64 down to 8 at kpad >= 1024: two blocks per SM wherever
//     the lists allow), the splits and the copy widths, and sizes the
//     shared memory; one template, four configurations.
//   * Per-candidate accumulation order (k = 0..d-1, one fmaf chain) does
//     not depend on the split, the tile or the row, so a shard stack, an
//     incrementally grown bucket and a cold build give bit-equal answers.
#include "topk_common.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int TN = 128;          // candidates per tile
constexpr int STAGES = 3;
constexpr int MAX_TILES = 64;    // candidate tiles per split
constexpr int MAX_KPAD = 2048;
static_assert(TN == 4 * 32, "warp_offer_row offers rows of 128");

template <int TQ>
struct QCfg {
  static constexpr int RC = TQ >= 16 ? 8 : 4, TX = TN / RC;
  static constexpr int TY = NT / TX, RQ = TQ / TY;
  using M = sg::Micro<TQ, TN, RQ, RC>;
  using R = sg::Ring<TQ, TN, STAGES, float, int8_t>;
  static constexpr int DIST = R::BYTES;                    // offsets
  static constexpr int XN = DIST + TQ * TN * 4;
  static constexpr int OKW = XN + 2 * TN * 4;
  static constexpr int LIVE = OKW + MAX_TILES * (TN / 32) * 4;
  static constexpr int LISTS = LIVE + (MAX_TILES + 1) * 4;
  static int smem(int kpad) { return LISTS + TQ * kpad * 8; }
};

template <int TQ>
__global__ void __launch_bounds__(NT, 2) quant_pass1(
    const float* __restrict__ q, const int8_t* __restrict__ codes,
    const float* __restrict__ s, const float* __restrict__ xsq,
    const float* __restrict__ params, float* __restrict__ out_d,
    int* __restrict__ out_i, int bq, int n, int d, int m, int mp, int kpad,
    int kind, int metric, long long q_gs, long long c_gs, long long s_gs,
    long long xq_gs, int vec_q, int vec_c) {
  using C = QCfg<TQ>;
  using M = typename C::M;
  constexpr int RQ = C::RQ, RC = C::RC, WORDS = TN / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const typename C::R ring{smem};
  float* dist = reinterpret_cast<float*>(smem + C::DIST);   // [TQ][TN]
  float* xnb = reinterpret_cast<float*>(smem + C::XN);      // [2][TN]
  unsigned* okw = reinterpret_cast<unsigned*>(smem + C::OKW);
  int* live = reinterpret_cast<int*>(smem + C::LIVE);       // [1 + tiles]
  float* Ld = reinterpret_cast<float*>(smem + C::LISTS);    // [TQ][kpad]
  int* Li = reinterpret_cast<int*>(Ld + TQ * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, splits = gridDim.y;
  const int gi = blockIdx.z;
  // this split's candidate tiles: split, split + splits, ... (strided, so
  // a contiguous run of passing rows, e.g. a time range, is shared out
  // evenly between the splits)
  const int ntiles = (n + TN - 1) / TN;
  const int nt = split < ntiles ? (ntiles - split + splits - 1) / splits : 0;
  const float* qg = q + gi * q_gs;
  const int8_t* cg = codes + gi * c_gs;
  const float* sgm = s + gi * s_gs;
  const float* xqg = xsq + gi * xq_gs;

  for (int i = tid; i < TQ * kpad; i += NT) { Ld[i] = INFINITY; Li[i] = INT_MAX; }

  // ---- predicate first: one ok bit per candidate of the split ----------
  for (int i0 = 0; i0 < nt * TN; i0 += NT) {
    const int i = i0 + tid;
    const int cand = (split + (i / TN) * splits) * TN + i % TN;
    bool ok = false;
    if (i < nt * TN && cand < n) {
      float row[MAXM];
      for (int j = 0; j < m; ++j) row[j] = sgm[(long long)cand * m + j];
      ok = predicate(row, params, m, mp, kind);
    }
    const unsigned bits = __ballot_sync(FULL, ok);
    if (lane == 0 && i < nt * TN) okw[i / 32] = bits;
  }
  __syncthreads();
  if (warp == 0) {   // the live tiles, in order
    int cnt = 0;
    for (int j0 = 0; j0 < nt; j0 += 32) {
      const int j = j0 + lane;
      bool any = false;
      if (j < nt)
        for (int w = 0; w < WORDS; ++w) any = any || okw[j * WORDS + w];
      const unsigned mask = __ballot_sync(FULL, any);
      if (any) live[1 + cnt + __popc(mask & ((1u << lane) - 1))] = j;
      cnt += __popc(mask);
    }
    if (lane == 0) live[0] = cnt;
  }
  __syncthreads();
  const int nlive = live[0];

  // ---- the live tiles through the pipelined mainloop -------------------
  // chunk `it` is depth chunk it % nk of live tile it / nk
  const int nk = (d + sg::BK - 1) / sg::BK;
  const int total = nlive * nk;
  auto tile0 = [&](int li) { return (split + live[1 + li] * splits) * TN; };
  auto issue = [&](int it) {
    if (it < total) {
      const int slot = it % STAGES, k0 = (it % nk) * sg::BK;
      sg::stage<float, TQ>(ring.a(slot), qg, d, q0, bq, k0, d, vec_q);
      sg::stage<int8_t, TN>(ring.b(slot), cg, d, tile0(it / nk), n, k0, d,
                            vec_c);
    }
    sg::cp_commit();
  };
  float unused = 0.f;   // row norms: B3 reads xsq instead (dead code)
#pragma unroll
  for (int c = 0; c < STAGES; ++c) issue(c);
  sg::cp_wait<STAGES - 1>();
  __syncthreads();
  if (total > 0) ring.transpose(0, unused);
  float acc[RQ][RC];
  for (int it = 0; it < total; ++it) {
    sg::cp_wait<STAGES - 2>();
    __syncthreads();
    issue(it + STAGES);
    if (it + 1 < total) ring.transpose(it + 1, unused);
    const int kt = it % nk, li = it / nk;
    const int j = live[1 + li], c0 = tile0(li);
    float* xn = xnb + (li & 1) * TN;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < RC; ++jj) acc[i][jj] = 0.f;
      if (tid < TN) xn[tid] = c0 + tid < n ? xqg[c0 + tid] : 0.f;
    }
    sg::mma_chunk<TQ, TN, RQ, RC>(acc, ring.ka(it), ring.kb(it), tx, ty);
    if (kt != nk - 1) continue;
    // epilogue of the tile: the masked distance tile (every entry, so
    // nothing of an earlier tile survives), then the offers
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = M::row(i, ty);
#pragma unroll
      for (int j0 = 0; j0 < RC; j0 += 4) {
        const int c = M::col(j0, tx);
        const unsigned bits = okw[j * WORDS + c / 32] >> (c % 32);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ip = acc[i][j0 + e];
          const float dv =
              metric == 0 ? __fsub_rn(xn[c + e], __fmul_rn(2.f, ip)) : -ip;
          v[e] = (bits >> e) & 1u ? dv : INFINITY;
        }
        *reinterpret_cast<float4*>(dist + r * TN + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    for (int r = warp; r < TQ; r += NW) {
      if (q0 + r >= bq) continue;                // warp-uniform
      warp_offer_row(Ld + r * kpad, Li + r * kpad, kpad, dist + r * TN, c0,
                     lane);
    }
  }
  sg::cp_wait<0>();
  __syncthreads();

  for (int i = tid; i < TQ * kpad; i += NT) {
    const int r = i / kpad, jj = i % kpad, row = q0 + r;
    if (row >= bq) continue;
    const long long o =
        (((long long)gi * splits + split) * bq + row) * kpad + jj;
    const float dv = Ld[i];
    out_d[o] = dv;
    out_i[o] = isfinite(dv) ? Li[i] : -1;
  }
}

template <int TQ>
cudaError_t launch_pass1(dim3 grid, int smem, cudaStream_t st,
                         const float* q, const int8_t* c, const float* s,
                         const float* xsq, const float* p, float* od, int* oi,
                         int bq, int n, int d, int m, int mp, int kpad,
                         int kind, int metric, long long qgs, long long cgs,
                         long long sgs, long long xgs, int vec_q,
                         int vec_c) {
  if (smem != QCfg<TQ>::smem(kpad)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      quant_pass1<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  quant_pass1<TQ><<<grid, NT, smem, st>>>(
      q, c, s, xsq, p, od, oi, bq, n, d, m, mp, kpad, kind, metric, qgs, cgs,
      sgs, xgs, vec_q, vec_c);
  return cudaGetLastError();
}

bool vec_ok(int v) { return v == 0 || v == 4 || v == 16; }

}  // namespace

extern "C" {

// q [g?, bq, d] fp32 scale-folded queries, codes [g, n, d] int8,
// s [g, n, m] fp32, xsq [g, n] fp32, params [4, mp] fp32 (all contiguous,
// batch strides in elements; q_gs = 0 shares the queries across g).
// With splits > 1, part_d / part_i are [g, splits, bq, kpad] scratch.
// out_d / out_i are [g, bq, kpad].  The launch configuration comes from
// the wrapper (kernels/quant_topk.py::launch_config): query tile tq, the
// splits (split s takes candidate tiles s, s + splits, ... of 128, at most
// 64 of them), the copy width in bytes of the queries and of the codes
// (16, 4 or 0 = element loads), and the dynamic shared memory, which must
// equal this file's layout.
// Returns cudaGetLastError().
int repro_quant_topk(const float* q, const int8_t* codes, const float* s,
                     const float* xsq, const float* params, float* out_d,
                     int* out_i, float* part_d, int* part_i, int g, int bq,
                     int n, int d, int m, int mp, int kpad, int kind,
                     int metric, int tq, int splits, int vec_q, int vec_c,
                     int smem, long long q_gs, long long c_gs,
                     long long s_gs, long long xq_gs, void* stream) {
  if (m > MAXM || m < 1 || mp < m || kpad < 1 || kpad > MAX_KPAD ||
      tq < 1 || splits < 1 || splits > 65535 || g < 1 || g > 65535 ||
      (long long)splits * MAX_TILES * TN < n || !vec_ok(vec_q) ||
      !vec_ok(vec_c))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((bq + tq - 1) / tq, splits, g);
  float* p1d = splits == 1 ? out_d : part_d;
  int* p1i = splits == 1 ? out_i : part_i;
  cudaError_t e;
#define REPRO_PASS1(T)                                                       \
  launch_pass1<T>(grid, smem, st, q, codes, s, xsq, params, p1d, p1i, bq, n, \
                  d, m, mp, kpad, kind, metric, q_gs, c_gs, s_gs, xq_gs,     \
                  vec_q, vec_c)
  switch (tq) {
    case 64: e = REPRO_PASS1(64); break;
    case 32: e = REPRO_PASS1(32); break;
    case 16: e = REPRO_PASS1(16); break;
    case 8: e = REPRO_PASS1(8); break;
    default: e = cudaErrorInvalidValue;
  }
#undef REPRO_PASS1
  if (e != cudaSuccess) return (int)e;
  if (splits > 1)
    e = launch_merge(part_d, part_i, out_d, out_i, g, splits, bq, kpad, st);
  return (int)e;
}

}  // extern "C"
