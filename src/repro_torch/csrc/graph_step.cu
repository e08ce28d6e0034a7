// One hop of the stitched graph traversal for Hopper (sm_90a): gather the
// live candidate rows straight from the bucket block, score them, evaluate
// the packed predicate.
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
//   (the dequantized row for int8 blocks, each value code * scale rounded
//   once, as the twin's), IP = -q.x; ok = the packed predicate of
//   topk_common.cuh on the row's metadata [rows * cap, m] (PAD_META rows
//   fail).  Distances are raw (routing ignores the predicate); pos < 0
//   gives +inf / 0.
//
// What bounds it on an H100: bytes.  Each live (query, candidate) pair
// reads one row (4d bytes fp32, d bytes int8) and does 4d operations; the
// least the card could move is each distinct row once (rows repeat across
// the queries of a hop), but rows that do not fit in L2 come from HBM once
// per gather.  The traversal (kernels/graph_topk.py::_traverse) hands the
// kernel only the lanes it keeps (-1 elsewhere), about a quarter of them on
// a forced-graph read, so dead lanes must cost nothing but their store.
//
// Design:
//   * A block owns one query x all c lanes.  It stages the query row and
//     its |q|^2 once, and for an int8 block with `stage` set, the bucket's
//     [rows, d] scales, in shared memory.  Without the stage (scales too
//     large for it) the scales are read from global memory, one 16-byte
//     load per 4 elements.
//   * Compaction: the block reads its pos range with coalesced loads
//     (CHUNK lanes at a time, 4 a thread), writes +inf / 0 for the -1 lanes
//     straight away, and lists the live lanes in shared memory sorted by
//     coarse position (a counting sort into 256 bins of the bucket: shared
//     atomics give each lane its rank in its bin, a block scan the bins'
//     starts).  Only live lanes get work, and a block walks its rows in
//     position order, so the blocks resident together read nearby rows
//     and share them in L2 (on a phase-5b-shaped hop with every lane live
//     that took fp32 from 0.384 to 0.243 ms on an H100, tools/kernel_ab.py
//     b4_hop; no change on its sparse lanes).
//   * Scoring: a group of G = 8 lanes scores two live candidates at once,
//     so a warp has eight rows in flight.  Each lane owns the 16-byte
//     pieces lg, lg + 8, ... of a row (4 fp32 or 16 int8 elements) and
//     issues up to U pieces of both rows, and both rows' metadata, before
//     it uses any; the two rows share each read of the query from shared
//     memory.  The sums reduce with a fixed three-step xor-shuffle tree
//     over the group; lanes 0 and 1 evaluate the predicate and store.
//     (Groups of 16 and 32 lanes were slower for int8 and no faster for
//     fp32 on a phase-5b-shaped hop, tools/kernel_ab.py b4_hop.)
//   * int8: one 16-byte load of codes per piece; each code becomes a float
//     by a byte permute and one exact subtraction (2^23 + u - (2^23 + 128)),
//     not by the quarter-rate integer conversion; the staged queries and
//     scales are laid out quad-major (quad j of piece p at (j * P + p) * 4
//     floats), so the lanes of a group read them without bank conflicts.
//   * Numbers: a lane sums its pieces in order and the pieces' elements in
//     order, in one fmaf chain per sum, and the group's tree is fixed: the
//     order depends only on d (and the element type, which sets the piece
//     width), never on a candidate's position, its neighbours or whether
//     16-byte or element loads ran, so a bucket grown incrementally and one
//     built cold score identically.
#include "topk_common.cuh"

namespace {

constexpr int KPT = 4;                 // lanes a thread reads per chunk
constexpr int CHUNK = KPT * NT;        // lanes a block compacts at once
constexpr int G = 8;                   // lanes that score one candidate
constexpr int NG = NT / G;             // groups per block
constexpr int NB = NT;                 // bins of the position sort
static_assert(NB == NT && NW <= 16, "a thread per bin, a warp per 32");
static_assert(2 * G >= MAXM, "a group holds two metadata values a lane");

// Pieces a lane issues per row before it uses them, and the blocks per SM
// the registers are sized for.
template <typename ELEM>
struct Tune {
  static constexpr int U = 4, MINB = 4;
};
template <>
struct Tune<int8_t> {
  static constexpr int U = 2, MINB = 3;
};

struct Args {
  const float* q;
  const int* pos;
  const void* x;
  const float* scales;
  const float* meta;
  const float* params;
  float* out_d;
  int* out_ok;
  int b, c, d, cap, rows, m, mp, kind, metric, vec;
};

// Shared-memory layout in bytes: the staged scales [rows][dp] (int8 with
// stage), the query row [dp] and its norm, the live list (lane, position)
// [CHUNK] each, the sort's bins [NB], per-warp sums and starts [16 + 16]
// and total [16 ints], and two metadata rows per group.  The wrapper
// (kernels/graph_topk.py::smem_bytes) mirrors it.
struct Layout {
  int sc, qv, qn, le, lp, cnt, ms, bytes;
};

__host__ __device__ inline Layout layout(int dp, int rows_staged) {
  Layout L;
  L.sc = 0;
  L.qv = rows_staged * dp * 4;
  L.qn = L.qv + dp * 4;
  L.le = L.qn + 16;
  L.lp = L.le + CHUNK * 4;
  L.cnt = L.lp + CHUNK * 4;
  L.ms = L.cnt + (NB + 48) * 4;
  L.bytes = L.ms + NG * 2 * MAXM * 4;
  return L;
}

// Shared-memory float index of element k in the piece layout: linear for
// fp32 (pieces of 4), quad-major for int8 (pieces of 16, P of them).
template <int W>
__device__ __forceinline__ int sidx(int k, int P) {
  if constexpr (W == 4) return k;
  else return ((k & 15) >> 2) * P * 4 + (k >> 4) * 4 + (k & 3);
}

// Signed byte i of w as an exact float: 2^23 + (b + 128) - (2^23 + 128).
__device__ __forceinline__ float byte_f(unsigned biased, int i) {
  const unsigned sel = 0x7440u | (unsigned)i;
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, sel)),
                   8388736.f);
}

// Add piece pc of rows a and b to their (ip, xn).  fp32: ra / rb hold 4
// values each; int8: 16 codes, with each row's scales (sa / sb) quad-major
// in shared memory (stage) or linear in global memory.  The query row qv is
// in shared memory; each read of it serves both rows.
template <typename ELEM, bool STAGE>
__device__ __forceinline__ void piece2(const uint4 ra, const uint4 rb,
                                       int pc, int P,
                                       const float* __restrict__ qv,
                                       const float* __restrict__ sa,
                                       const float* __restrict__ sb,
                                       float& ipa, float& xna, float& ipb,
                                       float& xnb) {
  if constexpr (sizeof(ELEM) == 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(qv + pc * 4);
    const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
    const float va[4] = {__uint_as_float(ra.x), __uint_as_float(ra.y),
                         __uint_as_float(ra.z), __uint_as_float(ra.w)};
    const float vb[4] = {__uint_as_float(rb.x), __uint_as_float(rb.y),
                         __uint_as_float(rb.z), __uint_as_float(rb.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ipa = fmaf(va[e], qq[e], ipa);
      xna = fmaf(va[e], va[e], xna);
      ipb = fmaf(vb[e], qq[e], ipb);
      xnb = fmaf(vb[e], vb[e], xnb);
    }
  } else {
    const unsigned wa[4] = {ra.x ^ 0x80808080u, ra.y ^ 0x80808080u,
                            ra.z ^ 0x80808080u, ra.w ^ 0x80808080u};
    const unsigned wb[4] = {rb.x ^ 0x80808080u, rb.y ^ 0x80808080u,
                            rb.z ^ 0x80808080u, rb.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = (j * P + pc) * 4;
      const float4 q4 = *reinterpret_cast<const float4*>(qv + at);
      const float4 s4a =
          STAGE ? *reinterpret_cast<const float4*>(sa + at)
                : __ldg(reinterpret_cast<const float4*>(sa + pc * 16 + j * 4));
      const float4 s4b =
          STAGE ? *reinterpret_cast<const float4*>(sb + at)
                : __ldg(reinterpret_cast<const float4*>(sb + pc * 16 + j * 4));
      const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ssa[4] = {s4a.x, s4a.y, s4a.z, s4a.w};
      const float ssb[4] = {s4b.x, s4b.y, s4b.z, s4b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float va = __fmul_rn(byte_f(wa[j], e), ssa[e]);
        const float vb = __fmul_rn(byte_f(wb[j], e), ssb[e]);
        ipa = fmaf(va, qq[e], ipa);
        xna = fmaf(va, va, xna);
        ipb = fmaf(vb, qq[e], ipb);
        xnb = fmaf(vb, vb, xnb);
      }
    }
  }
}

template <typename ELEM, bool STAGE>
__global__ void __launch_bounds__(NT, Tune<ELEM>::MINB)
    graph_step(const Args a) {
  constexpr int W = 16 / (int)sizeof(ELEM);   // elements per 16-byte piece
  constexpr int U = Tune<ELEM>::U;
  const int c = a.c, d = a.d, m = a.m, cap = a.cap;
  const int P = (d + W - 1) / W, dp = P * W;
  const Layout L = layout(dp, STAGE ? a.rows : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* qv = reinterpret_cast<float*>(smem + L.qv);
  float* qn = reinterpret_cast<float*>(smem + L.qn);
  int* le = reinterpret_cast<int*>(smem + L.le);
  int* lp = reinterpret_cast<int*>(smem + L.lp);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* ms = reinterpret_cast<float*>(smem + L.ms);
  const ELEM* __restrict__ x = reinterpret_cast<const ELEM*>(a.x);
  const float* __restrict__ scales = a.scales;
  const float* __restrict__ meta = a.meta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long o0 = (long long)blockIdx.x * c;

  // ---- stage the query row (and the scales) in the piece layout --------
  const float* qg = a.q + (long long)blockIdx.x * d;
  const int d4 = d / 4;
  if (d % 4 == 0 && (reinterpret_cast<size_t>(qg) & 15) == 0) {
    for (int i = tid; i < d4; i += NT)
      *reinterpret_cast<float4*>(qv + sidx<W>(4 * i, P)) =
          __ldg(reinterpret_cast<const float4*>(qg) + i);
  } else {
    for (int k = tid; k < d; k += NT) qv[sidx<W>(k, P)] = qg[k];
  }
  if constexpr (STAGE) {
    if (d % 4 == 0 && (reinterpret_cast<size_t>(scales) & 15) == 0) {
      for (int i = tid; i < a.rows * d4; i += NT) {
        const int r = i / d4, k = (i - r * d4) * 4;
        *reinterpret_cast<float4*>(sc + r * dp + sidx<W>(k, P)) =
            __ldg(reinterpret_cast<const float4*>(scales) + i);
      }
    } else {
      for (int i = tid; i < a.rows * d; i += NT) {
        const int r = i / d, k = i - r * d;
        sc[r * dp + sidx<W>(k, P)] = scales[i];
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                     // |q|^2, k in order per lane
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = qv[sidx<W>(k, P)];
      acc = fmaf(v, v, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) qn[0] = acc;
  }

  const int gi = tid / G, lg = tid % G;
  const int npl = lg < P ? (P - lg + G - 1) / G : 0;   // pieces of this lane
  for (int base = 0; base < c; base += CHUNK) {
    // ---- compaction, sorted by coarse position (a counting sort) -------
    int pv[KPT], key[KPT], slot[KPT];
    __syncthreads();               // the previous chunk is done with cnt
    cnt[tid] = 0;
    __syncthreads();
    const long long npos = (long long)a.rows * cap;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int j = base + u * NT + tid;
      int p = -1;
      if (j < c) {
        p = a.pos[o0 + j];
        if (p < 0) {
          a.out_d[o0 + j] = INFINITY;
          a.out_ok[o0 + j] = 0;
        }
      }
      pv[u] = p;
      key[u] = 0;
      slot[u] = 0;
      if (p >= 0) {
        key[u] = (int)min((long long)p * NB / npos, (long long)NB - 1);
        slot[u] = atomicAdd(&cnt[key[u]], 1);
      }
    }
    __syncthreads();
    const int v = cnt[tid];        // bin tid: a warp scans 32 bins
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) cnt[NB + warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = lane < NW ? cnt[NB + lane] : 0;
      int s2 = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t2 = __shfl_up_sync(FULL, s2, o);
        if (lane >= o) s2 += t2;
      }
      if (lane < NW) cnt[NB + 16 + lane] = s2 - t;
      if (lane == NW - 1) cnt[NB + 32] = s2;
    }
    __syncthreads();
    const int start = incl - v + cnt[NB + 16 + warp];
    __syncthreads();
    cnt[tid] = start;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      if (pv[u] >= 0) {
        const int at = cnt[key[u]] + slot[u];
        le[at] = base + u * NT + tid;
        lp[at] = pv[u];
      }
    }
    __syncthreads();
    const int total = cnt[NB + 32];

    // ---- scoring: a group takes list entries gi and gi + NG together ---
    for (int i0 = warp * (32 / G); i0 < total; i0 += 2 * NG) {
      const int ia = i0 + lane / G, ib = ia + NG;
      const bool ha = ia < total, hb = ib < total;
      const int pa = ha ? lp[ia] : 0, pb = hb ? lp[ib] : 0;
      const ELEM* xa = x + (long long)pa * d;
      const ELEM* xb = x + (long long)pb * d;
      // metadata first, so it is in flight with the rows
      float ma0 = 0.f, ma1 = 0.f, mb0 = 0.f, mb1 = 0.f;
      if (ha && lg < m) ma0 = __ldg(meta + (long long)pa * m + lg);
      if (ha && lg + G < m) ma1 = __ldg(meta + (long long)pa * m + lg + G);
      if (hb && lg < m) mb0 = __ldg(meta + (long long)pb * m + lg);
      if (hb && lg + G < m) mb1 = __ldg(meta + (long long)pb * m + lg + G);
      const float* sa = STAGE ? sc + (pa / cap) * dp
                              : scales + (long long)(pa / cap) * d;
      const float* sb = STAGE ? sc + (pb / cap) * dp
                              : scales + (long long)(pb / cap) * d;
      float ipa = 0.f, xna = 0.f, ipb = 0.f, xnb = 0.f;
      if (a.vec) {
        for (int i = 0; i < npl; i += U) {
          uint4 ra[U], rb[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int pc = lg + G * (i + u);
            ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
            if (i + u < npl) {
              if (ha) ra[u] = __ldg(reinterpret_cast<const uint4*>(xa) + pc);
              if (hb) rb[u] = __ldg(reinterpret_cast<const uint4*>(xb) + pc);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (i + u < npl)
              piece2<ELEM, STAGE>(ra[u], rb[u], lg + G * (i + u), P, qv, sa,
                                  sb, ipa, xna, ipb, xnb);
        }
      } else {
        // element loads (d % W != 0 or an unaligned block): the same
        // pieces and the same order as the 16-byte loads
        for (int i = 0; i < npl; ++i) {
          const int pc = lg + G * i;
          for (int e = 0; e < W && pc * W + e < d; ++e) {
            const int k = pc * W + e;
            float va = 0.f, vb = 0.f;
            if constexpr (sizeof(ELEM) == 4) {
              if (ha) va = xa[k];
              if (hb) vb = xb[k];
            } else {
              const int ks = STAGE ? sidx<W>(k, P) : k;
              if (ha) va = __fmul_rn((float)xa[k], sa[ks]);
              if (hb) vb = __fmul_rn((float)xb[k], sb[ks]);
            }
            const float qk = qv[sidx<W>(k, P)];
            ipa = fmaf(va, qk, ipa);
            xna = fmaf(va, va, xna);
            ipb = fmaf(vb, qk, ipb);
            xnb = fmaf(vb, vb, xnb);
          }
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        ipa += __shfl_xor_sync(FULL, ipa, o);
        xna += __shfl_xor_sync(FULL, xna, o);
        ipb += __shfl_xor_sync(FULL, ipb, o);
        xnb += __shfl_xor_sync(FULL, xnb, o);
      }
      float* mrow = ms + gi * 2 * MAXM;
      if (lg < m) { mrow[lg] = ma0; mrow[MAXM + lg] = mb0; }
      if (lg + G < m) { mrow[lg + G] = ma1; mrow[MAXM + lg + G] = mb1; }
      __syncwarp();
      if (lg < 2 && (lg == 0 ? ha : hb)) {
        const float ip = lg == 0 ? ipa : ipb, xn = lg == 0 ? xna : xnb;
        const long long o = o0 + le[lg == 0 ? ia : ib];
        a.out_d[o] = a.metric == 0
                         ? __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, ip)), qn[0])
                         : -ip;
        a.out_ok[o] = predicate(mrow + lg * MAXM, a.params, m, a.mp, a.kind);
      }
      __syncwarp();
    }
  }
}

template <typename ELEM, bool STAGE>
cudaError_t launch(const Args& a, int smem, cudaStream_t st) {
  auto kernel = graph_step<ELEM, STAGE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.b, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, d] fp32, pos [b, c] int32 flattened bucket positions (-1 = none),
// x the bucket's [rows * cap, d] block: fp32 (quantized = 0) or int8 codes
// (quantized = 1, dequantized with scales [rows, d] fp32), meta
// [rows * cap, m] fp32, params [4, mp] fp32 -> out_d [b, c] fp32,
// out_ok [b, c] int32; one block per query.  The launch configuration comes
// from the wrapper (kernels/graph_topk.py::launch_config): stage = 1 stages
// an int8 block's scales in shared memory, vec = 1 takes 16-byte row loads
// (d a multiple of the piece, a 16-byte aligned block, and for unstaged
// int8 scales), and the dynamic shared memory, which must equal the layout
// above.  Returns cudaGetLastError().
int repro_graph_step(const float* q, const int* pos, const void* x,
                     const float* scales, const float* meta,
                     const float* params, float* out_d, int* out_ok, int b,
                     int c, int d, int cap, int rows, int m, int mp,
                     int kind, int metric, int quantized, int stage,
                     int vec, int smem, void* stream) {
  if (m > MAXM || m < 1 || mp < m || b < 0 || c < 0 || d < 1 || cap < 1 ||
      rows < 1 || (stage && !quantized))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || c == 0) return (int)cudaSuccess;
  const int w = quantized ? 16 : 4;
  const int dp = (d + w - 1) / w * w;
  if (smem != layout(dp, stage ? rows : 0).bytes)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    pos,  x,    scales, meta, params, out_d, out_ok, b,
               c,    d,    cap,  rows,   m,    mp,     kind,  metric, vec};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = !quantized ? launch<float, false>(a, smem, st)
                  : stage    ? launch<int8_t, true>(a, smem, st)
                             : launch<int8_t, false>(a, smem, st);
  return (int)e;
}

}  // extern "C"
