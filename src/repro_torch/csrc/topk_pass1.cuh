// Pass 1 of the fused filtered top-k kernels for Hopper (sm_90a), SIMT
// fp32: one template for B1 (filtered_topk.cu, fp32 candidates) and B3
// (quant_topk.cu, int8 codes).
//
// A block owns TQ queries of one shard row g and one split of the row's
// candidates, and leaves each query's sorted top-kpad (distance, id) list
// of that split in global memory; pass 2 (topk_common.cuh::topk_merge)
// merges the splits.
//
//   * Grid (query tiles, splits, g), query tiles fastest, so the blocks
//     that run together read the same candidates (once from HBM, then
//     from L2).  Split s takes the 128-candidate tiles s, s + splits, ...
//     of its row (strided), so a contiguous run of passing rows (a time
//     range of a time-ordered stream) is shared out evenly.
//   * Predicate first: the block evaluates the packed predicate over all
//     its candidates before it copies any vector (one ok bit each in
//     shared memory), counts the passing ones per 32-candidate word
//     (exclusive prefix sums) and multiplies only those: packed tiles of
//     128 passing candidates, in candidate order, whose vectors the ring
//     gathers row by row.  The filter is the same for every query of the
//     block, so a failing candidate could only offer +inf to each of them
//     and the answer is the same; `PAD_META` rows (padding, free slots,
//     dead points) fail every kind, so an empty shard row costs one
//     metadata pass.
//   * The packed tiles stream back to back through the shared mainloop
//     (simt_gemm.cuh): chunk `it` is depth chunk it % nk of packed tile
//     it / nk, so the copies of the next tile are in flight during a
//     tile's epilogue.  A tile's rows (candidate indices within the split,
//     found from the prefix sums) are listed at the start of the tile
//     before it, in one of two buffers; nk >= 3 (zero chunks past d), so
//     the ring never reaches further ahead than that next tile.
//   * Norms.  B3 reads the dequantized squared norms `xsq` precomputed at
//     seal and emits the partial distance xsq - 2 ip (its wrapper adds
//     |q|^2).  B1 takes both norms from the ring's transpose pass, which
//     squares every staged value once in k order: thread t < TQ gathers
//     query row t, thread TQ + j the candidate in row j of the tile.  The
//     transpose of chunk it + 1 runs during chunk it, so at the last chunk
//     of a tile it already starts on the next tile's first chunk: a thread
//     banks its finished norm in shared memory and restarts from 0 right
//     before that transpose, never in the epilogue.  A query's norm is
//     the same k-order chain in every tile and split.
//   * Epilogue: the distance tile (every entry written, +inf past the
//     split's passing candidates, so nothing of an earlier tile survives)
//     goes to shared memory; each warp offers its rows to per-query sorted
//     top-kpad lists (warp_offer_row: a row's survivors are compacted into
//     one batch when at most 32, and a batch with more than two survivors
//     is sorted across the warp and merged in one pass).  The (distance,
//     id) order makes the result independent of splits and packing.
//   * Numbers: each candidate's dot is one fmaf chain over k = 0..d-1 in
//     order whatever the tile, split or row (the zero chunks past d leave
//     it as it is), and the distance is combined with _rn intrinsics (B1:
//     (|q|^2 - 2 ip) + |x|^2; IP: -ip), never contracted: a shard stack
//     answers bit for bit like the monolithic scan and an incrementally
//     grown pack like a cold build.  No fast math: PAD_META rows rely on
//     (2e30)^2 overflowing to inf.
//   * The wrapper (kernels/_pass1.py) picks the query tile (64 rows down
//     to 8 as kpad grows: two blocks per SM wherever the lists allow),
//     the splits and the copy widths, and sizes the shared memory, which
//     the launcher refuses unless it equals Cfg::smem.
#pragma once
#include "topk_common.cuh"
#include "simt_gemm.cuh"

namespace {
namespace p1 {

constexpr int TN = 128;          // candidates per tile: the unit of the skip
constexpr int STAGES = 3;
constexpr int MAX_TILES = 64;    // candidate tiles per split
static_assert(TN == 4 * 32, "warp_offer_row offers rows of 128");

// Shared-memory layout of one block for candidates stored as SB (float:
// B1, norms from the ring; int8_t: B3, norms from xsq), in byte offsets.
template <typename SB, int TQ>
struct Cfg {
  static constexpr bool RING_NORMS = sizeof(SB) == 4;
  static constexpr int RC = TQ >= 16 ? 8 : 4, TX = TN / RC;
  static constexpr int TY = NT / TX, RQ = TQ / TY;
  static constexpr int WORDS = MAX_TILES * TN / 32;        // ok-bit words
  using M = sg::Micro<TQ, TN, RQ, RC>;
  using R = sg::Ring<TQ, TN, STAGES, float, SB>;
  static constexpr int DIST = R::BYTES;                    // [TQ][TN]
  static constexpr int XN = DIST + TQ * TN * 4;            // [TN]
  static constexpr int QN = XN + TN * 4;                   // [TQ] (B1)
  static constexpr int OKW = QN + (RING_NORMS ? TQ * 4 : 0);
  static constexpr int PRE = OKW + WORDS * 4;              // u16 [WORDS]
  static constexpr int ROWS = PRE + WORDS * 2;             // u16 [2][TN]
  static constexpr int COUNT = ROWS + 2 * TN * 2;          // int
  static constexpr int LISTS = COUNT + 16;
  static int smem(int kpad) { return LISTS + TQ * kpad * 8; }
};

constexpr unsigned short NO_ROW = 0xffff;   // a packed tile's empty row

template <typename SB, int TQ>
__global__ void __launch_bounds__(NT, 2) topk_pass1(
    const float* __restrict__ q, const SB* __restrict__ x,
    const float* __restrict__ s, const float* __restrict__ xsq,
    const float* __restrict__ params, float* __restrict__ out_d,
    int* __restrict__ out_i, int bq, int n, int d, int m, int mp, int kpad,
    int kind, int metric, long long q_gs, long long x_gs, long long s_gs,
    long long xq_gs, long long p_gs, int vec_q, int vec_x) {
  using C = Cfg<SB, TQ>;
  using M = typename C::M;
  constexpr int RQ = C::RQ, RC = C::RC;
  extern __shared__ __align__(16) unsigned char smem[];
  const typename C::R ring{smem};
  float* xn = reinterpret_cast<float*>(smem + C::XN);
  float* qn = reinterpret_cast<float*>(smem + C::QN);
  unsigned* okw = reinterpret_cast<unsigned*>(smem + C::OKW);
  unsigned short* pre = reinterpret_cast<unsigned short*>(smem + C::PRE);
  unsigned short* rows = reinterpret_cast<unsigned short*>(smem + C::ROWS);
  int* count = reinterpret_cast<int*>(smem + C::COUNT);
  float* dist = reinterpret_cast<float*>(smem + C::DIST);   // [TQ][TN]
  float* Ld = reinterpret_cast<float*>(smem + C::LISTS);    // [TQ][kpad]
  int* Li = reinterpret_cast<int*>(Ld + TQ * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, splits = gridDim.y;
  const int gi = blockIdx.z;
  const int ntiles = (n + TN - 1) / TN;
  const int nt = split < ntiles ? (ntiles - split + splits - 1) / splits : 0;
  const int nw = nt * (TN / 32);
  const float* qg = q + gi * q_gs;
  const SB* xg = x + gi * x_gs;
  const float* sgm = s + gi * s_gs;
  const float* pg = params + gi * p_gs;

  for (int i = tid; i < TQ * kpad; i += NT) { Ld[i] = INFINITY; Li[i] = INT_MAX; }

  // ---- predicate first: one ok bit per candidate of the split ----------
  for (int i0 = 0; i0 < nt * TN; i0 += NT) {
    const int i = i0 + tid;
    const int cand = (split + (i / TN) * splits) * TN + i % TN;
    bool ok = false;
    if (i < nt * TN && cand < n) {
      float row[MAXM];
      for (int j = 0; j < m; ++j) row[j] = sgm[(long long)cand * m + j];
      ok = predicate(row, pg, m, mp, kind);
    }
    const unsigned bits = __ballot_sync(FULL, ok);
    if (lane == 0 && i < nt * TN) okw[i / 32] = bits;
  }
  __syncthreads();
  if (warp == 0) {   // passing candidates before each word, and in all
    constexpr int PER = C::WORDS / 32;
    int own = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int w = lane * PER + e;
      own += w < nw ? __popc(okw[w]) : 0;
    }
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - own;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int w = lane * PER + e;
      if (w < nw) {
        pre[w] = (unsigned short)run;
        run += __popc(okw[w]);
      }
    }
    if (lane == 31) count[0] = incl;
  }
  __syncthreads();
  const int npass = count[0];
  const int npk = (npass + TN - 1) / TN;           // packed tiles

  // a candidate's index within the split -> its row in the shard row
  auto cand_of = [&](int local) {
    return (split + (local / TN) * splits) * TN + local % TN;
  };
  // threads tid < TN list row tid of packed tile c: the candidate of rank
  // c * TN + tid among the split's passing ones, or NO_ROW
  auto list_rows = [&](int c) {
    if (c < npk && tid < TN) {
      const int rank = c * TN + tid;
      unsigned short v = NO_ROW;
      if (rank < npass) {
        int lo = 0, hi = nw - 1;   // the last word with pre[w] <= rank
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (pre[mid] <= rank) lo = mid;
          else hi = mid - 1;
        }
        unsigned bits = okw[lo];
        for (int k = rank - pre[lo]; k > 0; --k) bits &= bits - 1;
        v = (unsigned short)(lo * 32 + __ffs(bits) - 1);
      }
      rows[(c & 1) * TN + tid] = v;
    }
  };

  // ---- the packed tiles through the pipelined mainloop -----------------
  const int nk = max(3, (d + sg::BK - 1) / sg::BK);
  const int total = npk * nk;
  auto issue = [&](int it) {
    if (it < total) {
      const int slot = it % STAGES, k0 = (it % nk) * sg::BK;
      const unsigned short* tr = rows + ((it / nk) & 1) * TN;
      sg::stage<float, TQ>(ring.a(slot), qg, d, q0, bq, k0, d, vec_q);
      sg::stage_rows<SB, TN>(
          ring.b(slot), xg, d,
          [&](int r) { return tr[r] == NO_ROW ? -1 : cand_of(tr[r]); }, k0,
          d, vec_x);
    }
    sg::cp_commit();
  };
  float norm = 0.f;   // B1: the row norm this thread's transposes gather
  list_rows(0);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < STAGES; ++c) issue(c);
  sg::cp_wait<STAGES - 1>();
  __syncthreads();
  if (total > 0) ring.transpose(0, norm);
  int it = 0;          // chunk it is depth chunk it % nk of packed tile it / nk
  for (int pk = 0; pk < npk; ++pk) {
    const unsigned short* tr = rows + (pk & 1) * TN;
    // the tile before is done with the buffer of the tile after this one
    __syncthreads();
    list_rows(pk + 1);
    if constexpr (!C::RING_NORMS) {
      const float* xqg = xsq + gi * xq_gs;
      if (tid < TN) xn[tid] = tr[tid] == NO_ROW ? 0.f : xqg[cand_of(tr[tid])];
    }
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) acc[i][jj] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      sg::cp_wait<STAGES - 2>();
      __syncthreads();
      issue(it + STAGES);
      if constexpr (C::RING_NORMS) {
        // the next transpose starts the next tile: bank this tile's
        // norms (row t < TQ: the query's, row TQ + c: candidate c's)
        if (kt == nk - 1) {
          if (tid < TQ) qn[tid] = norm;
          else if (tid < TQ + TN) xn[tid - TQ] = norm;
          norm = 0.f;
        }
      }
      if (it + 1 < total) ring.transpose(it + 1, norm);
      sg::mma_chunk<TQ, TN, RQ, RC>(acc, ring.ka(it), ring.kb(it), tx, ty);
    }
    // epilogue of the tile: the distances (every entry, +inf past the
    // passing candidates, so nothing of an earlier tile survives), then
    // each warp offers its query rows
    const int filled = min(TN, npass - pk * TN);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = M::row(i, ty);
#pragma unroll
      for (int j0 = 0; j0 < RC; j0 += 4) {
        const int c = M::col(j0, tx);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ip = acc[i][j0 + e];
          float dv;
          if constexpr (C::RING_NORMS)
            dv = metric == 0
                     ? __fadd_rn(__fsub_rn(qn[r], __fmul_rn(2.f, ip)),
                                 xn[c + e])
                     : -ip;
          else
            dv = metric == 0 ? __fsub_rn(xn[c + e], __fmul_rn(2.f, ip))
                             : -ip;
          v[e] = c + e < filled ? dv : INFINITY;
        }
        *reinterpret_cast<float4*>(dist + r * TN + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    for (int r = warp; r < TQ; r += NW) {
      if (q0 + r >= bq) continue;                // warp-uniform
      warp_offer_row(
          Ld + r * kpad, Li + r * kpad, kpad, dist + r * TN,
          [&](int c) { return tr[c] == NO_ROW ? INT_MAX : cand_of(tr[c]); },
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

// Everything a launch needs besides the candidates' type.
struct Args {
  const float *q, *s, *xsq, *params;
  float *out_d, *part_d;
  int *out_i, *part_i;
  int g, bq, n, d, m, mp, kpad, kind, metric, tq, splits, vec_q, vec_x,
      smem;
  long long q_gs, x_gs, s_gs, xq_gs, p_gs;
};

template <typename SB, int TQ>
cudaError_t launch_tq(const Args& a, const SB* x, dim3 grid, float* od,
                      int* oi, cudaStream_t st) {
  if (a.smem != Cfg<SB, TQ>::smem(a.kpad)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      topk_pass1<SB, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem);
  if (e != cudaSuccess) return e;
  topk_pass1<SB, TQ><<<grid, NT, a.smem, st>>>(
      a.q, x, a.s, a.xsq, a.params, od, oi, a.bq, a.n, a.d, a.m, a.mp,
      a.kpad, a.kind, a.metric, a.q_gs, a.x_gs, a.s_gs, a.xq_gs, a.p_gs,
      a.vec_q, a.vec_x);
  return cudaGetLastError();
}

inline bool vec_ok(int v) { return v == 0 || v == 4 || v == 16; }

// Pass 1 over `a.splits` splits (into the partial lists when there are
// several), then pass 2.  Returns the first CUDA error.
template <typename SB>
cudaError_t run(const Args& a, const SB* x, int max_kpad, cudaStream_t st) {
  if (a.m > MAXM || a.m < 1 || a.mp < a.m || a.kpad < 1 ||
      a.kpad > max_kpad || a.tq < 1 || a.splits < 1 || a.splits > 65535 ||
      a.g < 1 || a.g > 65535 ||
      (long long)a.splits * MAX_TILES * TN < a.n || !vec_ok(a.vec_q) ||
      !vec_ok(a.vec_x) || (a.splits > 1 && (!a.part_d || !a.part_i)))
    return cudaErrorInvalidValue;
  const dim3 grid((a.bq + a.tq - 1) / a.tq, a.splits, a.g);
  float* od = a.splits == 1 ? a.out_d : a.part_d;
  int* oi = a.splits == 1 ? a.out_i : a.part_i;
  cudaError_t e;
  switch (a.tq) {
    case 64: e = launch_tq<SB, 64>(a, x, grid, od, oi, st); break;
    case 32: e = launch_tq<SB, 32>(a, x, grid, od, oi, st); break;
    case 16: e = launch_tq<SB, 16>(a, x, grid, od, oi, st); break;
    case 8: e = launch_tq<SB, 8>(a, x, grid, od, oi, st); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || a.splits == 1) return e;
  return launch_merge(a.part_d, a.part_i, a.out_d, a.out_i, a.g, a.splits,
                      a.bq, a.kpad, st);
}

}  // namespace p1
}  // namespace
