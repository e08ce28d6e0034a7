// Single-token GQA decode attention for Hopper (sm_90a), split over the
// sequence ("flash-decoding") with an online softmax in fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_kernel_call (pallas_call at :76).  For each row r (one
// (batch, kv-head) pair) and each of its g query heads:
//
//   o = softmax(q . K^T / sqrt(hd), masked to columns lo_r .. hi_r) . V
//
// with hi_r = lengths[r] and lo_r = max(0, hi_r - window) for a layer
// window >= 0 (the reference decode's sliding window,
// src/repro/models/layers.py::attention_decode), else 0.
// q [bkv, g, hd], k / v [bkv, smax, hd], lengths [bkv] int32 (inclusive),
// o [bkv, g, hd] in q's dtype (fp32 or bf16); products, softmax and sums in
// fp32 (held against kernels/ref.py::flash_decode_ref).  The TPU kernel's
// constraints (smax % ts == 0, hd % 128 == 0, g a multiple of 8) come from
// its tiling and are not inherited: any smax, g in 1..16, hd in
// {64, 80, 128, 256}.  lengths must lie in [0, smax); the kernel clamps
// them into that range so that it never reads outside a row.
//
// What bounds it on an H100: bytes.  Each cached key is read once (K and
// V, 2 * hd * sizeof(T) bytes) and used for 4 * g * hd operations, at
// most 16 operations per byte in bf16 with g = 16 — far below the ridge,
// so the filled prefix's K / V bytes over HBM bandwidth are the bound.
//
// Design:
// - Work follows the keys a row reads, shared out evenly.  Row r holds
//   the tiles of TS keys from the one holding lo_r to the one holding
//   hi_r (a windowed row costs the tiles of its window, and its first
//   tile masks the keys before lo_r); a fixed grid of blocks
//   (as many as the card holds at once, from the wrapper:
//   kernels/flash_decode.py::launch_config) splits the concatenation of
//   all rows' tiles into equal contiguous ranges, so every block streams
//   about the same number of filled tiles whatever the lengths, and no
//   block is launched for a tile past a row's prefix.  Each block reads
//   the lengths and builds the rows' tile prefix sums itself.
// - Copies in flight behind the compute.  K / V tiles (and the query row
//   of the tile's row) go through a STAGES-deep ring in shared memory by
//   16-byte cp.async copies, continuing across row boundaries inside a
//   block's range (keys past the prefix or before the window are
//   zero-filled, never read);
//   each tile waits on one barrier, and the next STAGES - 1 tiles are in
//   flight while it is scored.  K rows are padded by 16 bytes so that a
//   lane reading a whole key row meets no bank conflict.
// - Scores spread over the block.  Warp w scores keys [w KW, (w + 1) KW)
//   of every tile (KW = tile / 4), one (head, key) pair per lane, against
//   the segment's query row converted to fp32 once and scaled by
//   log2(e) / sqrt(hd), so a score is one dot product in four fmaf
//   chains and exp2f: no division and no expf.  Each warp leaves its
//   slice's maximum and sum per head; a second barrier hands them and
//   the probabilities to the PV pass.
// - PV: thread (column pair, head slot) keeps its heads' running (max,
//   sum), folds the four slice maxima in once per tile, and adds each
//   slice's probabilities times V at that slice's scale: 2 fp32
//   accumulators per head, the group rounded up to GC = 1, 2, 4, 8 or 16
//   at compile time (internvl2-2b: one head a thread), nothing to add up
//   across threads.  Where HD / 2 does not divide the block (hd 80: 40
//   column pairs, 3 head slots) the last NT % (HD / 2) threads stay idle
//   in PV; the cache is read at its own width, never padded.
// - The combine is folded in.  A row whose tiles fall in one block's
//   range is written directly.  Otherwise each block leaves its segment's
//   (max, sum, acc) in scratch (two slots a block: only a block's first
//   and last rows can be cut), and the last of the row's blocks to get
//   there (a ticket from a per-row counter) combines them and resets the
//   counter to 0, so the next launch, or a replay of a captured graph,
//   finds it zeroed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; zero-filled when !ok.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte piece of a key row as fp32: 4 (fp32) or 8 (bf16) values.
__device__ __forceinline__ void piece(const float* k, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(k);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void piece(const __nv_bfloat16* k, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Two adjacent values of a V row as fp32.
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared-memory layout and thread roles for dtype T, head width HD and
// the group rounded up to GC (mirrored by kernels/flash_decode.py).
template <typename T, int HD, int GC>
struct Geo {
  static constexpr int SZ = sizeof(T);
  static constexpr int TS = HD * SZ <= 256 ? 64 : 32;  // keys a tile
  static constexpr int KW = TS / NW;                   // keys a warp scores
  static constexpr int NPL = (GC * KW + 31) / 32;      // scores a lane
  static constexpr int EPV = 16 / SZ;                  // elements a piece
  static constexpr int VPR = HD / EPV;                 // pieces a row
  static constexpr int KRS = HD + EPV;                 // padded K row
  static constexpr int QLD = HD + 4;                   // fp32 query row
  static constexpr int K_BYTES = TS * KRS * SZ;
  static constexpr int V_BYTES = TS * HD * SZ;
  static constexpr int STAGE = K_BYTES + V_BYTES + GC * HD * SZ;  // + q
  // ring depth: 3 tiles, 2 where three fp32 tiles of hd 256 do not fit
  static constexpr int STAGES = SZ == 4 && HD == 256 ? 2 : 3;
  static constexpr int PS = STAGES * STAGE;            // [GC][TS] fp32
  static constexpr int QF = PS + GC * TS * 4;          // [GC][QLD] fp32
  static constexpr int WM = QF + GC * QLD * 4;         // [NW][GC] slice max
  static constexpr int WS = WM + NW * GC * 4;          // [NW][GC] slice sum
  static constexpr int TK = WS + NW * GC * 4;          // the ticket
  static constexpr int PRE = TK + 16;                  // [bkv + 1] tiles
  static constexpr int CPR = HD / 2;                   // column pairs
  static constexpr int HS = NT / CPR;                  // head slots (PV)
  static constexpr int HPT = (GC + HS - 1) / HS;       // heads a thread
  static constexpr bool ALL_PV = HS * CPR == NT;       // no idle PV thread
  static_assert(HS >= 1 && HS * CPR <= NT, "PV thread roles");
  static_assert(32 % KW == 0 && KW % 4 == 0, "score lanes, float4 slices");
  static_assert(PS % 16 == 0 && QF % 16 == 0, "float4 shared reads");
  static int smem(int bkv) { return PRE + ((bkv + 1) * 4 + 15) / 16 * 16; }
};

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(NT, 2) flash_decode(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, int bkv,
    int g, int smax, int window) {
  using G = Geo<T, HD, GC>;
  constexpr int TS = G::TS, KW = G::KW, NPL = G::NPL, EPV = G::EPV;
  constexpr int VPR = G::VPR, KRS = G::KRS, QLD = G::QLD, CPR = G::CPR;
  constexpr int HS = G::HS, HPT = G::HPT, STAGES = G::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem + G::PS);
  float* qf = reinterpret_cast<float*>(smem + G::QF);
  float* wm = reinterpret_cast<float*>(smem + G::WM);
  float* ws = reinterpret_cast<float*>(smem + G::WS);
  int* ticket = reinterpret_cast<int*>(smem + G::TK);
  int* pre = reinterpret_cast<int*>(smem + G::PRE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row r reads keys [first_key(nv), nv) with nv = nvalid(r)
  auto nvalid = [&](int r) {
    return min(max(__ldg(lengths + r), 0), smax - 1) + 1;
  };
  auto first_key = [&](int nv) {
    return window < 0 ? 0 : max(nv - 1 - window, 0);
  };
  // the rows' tile prefix sums (warp 0)
  if (warp == 0) {
    int carry = 0;
    for (int r0 = 0; r0 < bkv; r0 += 32) {
      const int r = r0 + lane;
      int x = 0;
      if (r < bkv) {
        const int nv = nvalid(r);
        x = (nv - 1) / TS - first_key(nv) / TS + 1;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      if (r < bkv) pre[r + 1] = carry + x;
      carry += __shfl_sync(FULL, x, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();

  // this block's tiles [t0, t1) of the rows' concatenation; with fewer
  // tiles than blocks the first `total` blocks take one each, so the
  // blocks holding a row's tiles are consecutive
  const int total = pre[bkv], b = blockIdx.x;
  const int nb = min((int)gridDim.x, total);
  const int t0 = (int)((long long)b * total / nb);
  const int t1 = (int)((long long)(b + 1) * total / nb);
  if (b >= nb || t0 >= t1) return;
  auto row_of = [&](int t) {            // the row holding tile t
    int lo = 0, hi = bkv - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  };
  auto block_of = [&](int t) {          // the block whose range holds t
    return (int)(((long long)(t + 1) * nb - 1) / total);
  };

  auto kslot = [&](int s) {
    return reinterpret_cast<T*>(smem + s * G::STAGE);
  };
  auto vslot = [&](int s) {
    return reinterpret_cast<T*>(smem + s * G::STAGE + G::K_BYTES);
  };
  auto qslot = [&](int s) {
    return reinterpret_cast<T*>(smem + s * G::STAGE + G::K_BYTES +
                                G::V_BYTES);
  };
  // the copy cursor: tile ii of row ir is the next to stage
  int ir = row_of(t0), ii = t0 - pre[ir], issued = 0;
  auto issue_next = [&]() {
    if (t0 + issued < t1) {
      const int nv = nvalid(ir), lo = first_key(nv);
      const int key0 = (lo / TS + ii) * TS, kv = min(TS, nv - key0);
      const int klo = lo - key0;            // > 0 in a window's first tile
      const int s = issued % STAGES;
      T* ks = kslot(s);
      T* vs = vslot(s);
      T* qs = qslot(s);
      const long long base = ((long long)ir * smax + key0) * HD;
      for (int idx = tid; idx < TS * VPR; idx += NT) {
        const int t = idx / VPR, e = (idx % VPR) * EPV;
        const bool ok = t >= klo && t < kv;
        const long long src = ok ? base + (long long)t * HD + e : 0;
        cp16(ks + t * KRS + e, k + src, ok);
        cp16(vs + t * HD + e, v + src, ok);
      }
      const T* qrow = q + (long long)ir * g * HD;
      for (int idx = tid; idx < g * VPR; idx += NT)
        cp16(qs + idx * EPV, qrow + idx * EPV, true);
      if (++ii == pre[ir + 1] - pre[ir]) { ++ir; ii = 0; }
    }
    ++issued;
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next();

  const float scale = 1.4426950408889634f / sqrtf((float)HD);  // log2(e)/sqrt
  // PV roles: columns 2 cp, 2 cp + 1 of heads hs, hs + HS, ...; each keeps
  // its heads' running (max, sum) of the segment.  A thread past the
  // roles (tid >= HS * CPR) takes head slot GC: every head it would hold
  // is >= GC, so it skips PV and writes nothing.
  const int cp = tid % CPR, hs = tid < HS * CPR ? tid / CPR : GC;
  float mrun[HPT], lrun[HPT], acc[HPT][2];
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    mrun[j] = -INFINITY;
    lrun[j] = 0.f;
    acc[j][0] = acc[j][1] = 0.f;
  }
  // score roles: warp w scores keys [w KW, (w + 1) KW) of every tile, lane
  // l the (head, key) pairs l, l + 32, ... (head = pair / KW)
  const int key = lane % KW, tk = warp * KW + key;
  // the compute cursor: tile ci of row cr; its segment began at tile ci0
  int cr = row_of(t0), ci = t0 - pre[cr], ci0 = ci;
  for (int it = 0; it < t1 - t0; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile it landed; tile it - 1's slot is free
    issue_next();
    const int s = it % STAGES, nt_row = pre[cr + 1] - pre[cr];
    const bool first = ci == ci0;
    const bool last = ci == nt_row - 1 || it == t1 - t0 - 1;
    const T* ks = kslot(s);
    const T* vs = vslot(s);
    const int nv = nvalid(cr), lo = first_key(nv);
    const int key0 = (lo / TS + ci) * TS;
    const int kv = min(TS, nv - key0), klo = lo - key0;
    if (first) {   // the segment's query row, scaled into the log2 domain
      const T* qs = qslot(s);
      for (int o = tid; o < g * HD; o += NT)
        qf[(o / HD) * QLD + o % HD] = tof(qs[o]) * scale;
      __syncthreads();
    }
    // scores of the warp's key slice, its max and sum for each head
    {
      float a[NPL][4];
#pragma unroll
      for (int i = 0; i < NPL; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
      const T* krow = ks + tk * KRS;
#pragma unroll 4
      for (int e = 0; e < HD; e += EPV) {
        float kf[EPV];
        piece(krow + e, kf);
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int h = (lane + 32 * i) / KW;
          if (GC * KW % 32 == 0 || h < GC) {
            const float* qv = qf + h * QLD + e;
#pragma unroll
            for (int u = 0; u < EPV; u += 4) {
              const float4 y = *reinterpret_cast<const float4*>(qv + u);
              a[i][0] = fmaf(kf[u], y.x, a[i][0]);
              a[i][1] = fmaf(kf[u + 1], y.y, a[i][1]);
              a[i][2] = fmaf(kf[u + 2], y.z, a[i][2]);
              a[i][3] = fmaf(kf[u + 3], y.w, a[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int h = (lane + 32 * i) / KW;
        const float sc = h < g && tk >= klo && tk < kv
                             ? (a[i][0] + a[i][1]) + (a[i][2] + a[i][3])
                             : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int o = KW / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float p = mx == -INFINITY ? 0.f : exp2f(sc - mx);
        float sum = p;
#pragma unroll
        for (int o = KW / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(FULL, sum, o);
        if (GC * KW % 32 == 0 || h < GC) {
          ps[h * TS + tk] = p;
          if (key == 0) {
            wm[warp * GC + h] = mx;
            ws[warp * GC + h] = sum;
          }
        }
      }
    }
    __syncthreads();   // probabilities and slice maxima / sums are in
    // PV: fold the slices' maxima into each head's running max, rescale,
    // then add each slice's probabilities times V at its own scale
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int h = hs + j * HS;
      if (h < g) {
        if (first) { mrun[j] = -INFINITY; lrun[j] = 0.f; }
        float mx = mrun[j];
#pragma unroll
        for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * GC + h]);
        const float alpha = exp2f(mrun[j] - mx);   // 0 at a segment start
        float l = lrun[j] * alpha;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          l = fmaf(ws[w * GC + h], exp2f(wm[w * GC + h] - mx), l);
        mrun[j] = mx;
        lrun[j] = l;
        acc[j][0] *= alpha;
        acc[j][1] *= alpha;
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float part[HPT][2];
#pragma unroll
      for (int j = 0; j < HPT; ++j) part[j][0] = part[j][1] = 0.f;
#pragma unroll
      for (int t = w * KW; t < (w + 1) * KW; t += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = pair(vs + (t + u) * HD + 2 * cp);
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const int h = hs + j * HS;
          if ((G::ALL_PV && GC >= HS) || h < GC) {
            const float4 p = *reinterpret_cast<const float4*>(ps + h * TS + t);
            const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              part[j][0] = fmaf(pp[u], vv[u].x, part[j][0]);
              part[j][1] = fmaf(pp[u], vv[u].y, part[j][1]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int h = hs + j * HS;
        if (h < g) {
          const float f = exp2f(wm[w * GC + h] - mrun[j]);  // 0: no key
          acc[j][0] = fmaf(f, part[j][0], acc[j][0]);
          acc[j][1] = fmaf(f, part[j][1], acc[j][1]);
        }
      }
    }
    if (!last) { ++ci; continue; }

    // ---- the end of a segment of row cr --------------------------------
    T* orow = out + (long long)cr * g * HD;
    if (ci0 == 0 && ci == nt_row - 1) {        // the whole row: o directly
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int h = hs + j * HS;
        if (h < g) {
          const float inv = 1.f / lrun[j];
          store2(orow + h * HD + 2 * cp, acc[j][0] * inv, acc[j][1] * inv);
        }
      }
    } else {
      const int blo = block_of(pre[cr]);
      const int nseg = block_of(pre[cr + 1] - 1) - blo + 1;
      // a block's partials: slot 2 b for its first row, 2 b + 1 for its
      // last (rows strictly inside its range are whole, written above);
      // row cr is b's first row exactly when b's range starts in it
      const long long mine = 2LL * b + (t0 >= pre[cr] ? 0 : 1);
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int h = hs + j * HS;
        if (h < g) {
          *reinterpret_cast<float2*>(part_acc + (mine * g + h) * HD +
                                     2 * cp) =
              make_float2(acc[j][0], acc[j][1]);
          if (cp == 0) {
            part_ml[(mine * g + h) * 2] = mrun[j];
            part_ml[(mine * g + h) * 2 + 1] = lrun[j];
          }
        }
      }
      __threadfence();     // the partials are visible before the ticket
      __syncthreads();
      if (tid == 0) *ticket = atomicAdd(counters + cr, 1);
      __syncthreads();
      if (*ticket == nseg - 1) {   // the row's last segment: combine
        __threadfence();
        if (tid == 0) counters[cr] = 0;   // every segment has counted
        // blocks blo + 1, ... start inside row cr (slot 0); block blo
        // holds it as its last row unless its range starts with it
        const long long s0 =
            2LL * blo + ((long long)blo * total / nb >= pre[cr] ? 0 : 1);
        auto slot = [&](int j) { return j == 0 ? s0 : 2LL * (blo + j); };
        for (int o = tid; o < g * HD; o += NT) {
          const int gi = o / HD;
          float mx = -INFINITY;
#pragma unroll 4
          for (int j = 0; j < nseg; ++j)
            mx = fmaxf(mx, __ldcg(part_ml + (slot(j) * g + gi) * 2));
          float num = 0.f, den = 0.f;
#pragma unroll 4
          for (int j = 0; j < nseg; ++j) {
            const long long sl = slot(j);
            const float w = exp2f(__ldcg(part_ml + (sl * g + gi) * 2) - mx);
            den = fmaf(__ldcg(part_ml + (sl * g + gi) * 2 + 1), w, den);
            num = fmaf(__ldcg(part_acc + sl * g * HD + o), w, num);
          }
          store(orow + o, num / den);
        }
      }
    }
    ++ci;
    if (ci == nt_row) { ++cr; ci = 0; }
    ci0 = ci;
  }
  cp_wait<0>();
}

template <typename T, int HD, int GC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int* counters, int bkv, int g, int smax,
                   int window, int nblocks, int smem, cudaStream_t st) {
  using G = Geo<T, HD, GC>;
  if (smem != G::smem(bkv)) return cudaErrorInvalidValue;
  // the shared-memory opt-in per device, renewed only when a launch asks
  // for more than the device's opt-in so far (a decode step launches the
  // kernel once per layer, and the host's time per launch is the tick's);
  // the lock keeps each device's opt-in growing and its record equal to it
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> opted[MAX_DEVICES];
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES ||
      opted[dev].load(std::memory_order_acquire) < smem) {
    std::lock_guard<std::mutex> hold(lock);
    if (dev >= MAX_DEVICES || opted[dev].load() < smem) {
      e = cudaFuncSetAttribute(flash_decode<T, HD, GC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      if (dev < MAX_DEVICES)
        opted[dev].store(smem, std::memory_order_release);
    }
  }
  flash_decode<T, HD, GC><<<nblocks, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, counters, bkv, g, smax, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_group(int gc, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* part_acc,
                     float* part_ml, int* counters, int bkv, int g, int smax,
                     int window, int nblocks, int smem, cudaStream_t st) {
#define REPRO_FD(GC)                                                        \
  launch<T, HD, GC>(q, k, v, lengths, out, part_acc, part_ml, counters, bkv, \
                    g, smax, window, nblocks, smem, st)
  switch (gc) {
    case 1: return REPRO_FD(1);
    case 2: return REPRO_FD(2);
    case 4: return REPRO_FD(4);
    case 8: return REPRO_FD(8);
    case 16: return REPRO_FD(16);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD
}

template <typename T>
cudaError_t by_width(int hd, int gc, const void* q, const void* k,
                     const void* v, const int* lengths, void* out,
                     float* part_acc, float* part_ml, int* counters, int bkv,
                     int g, int smax, int window, int nblocks, int smem,
                     cudaStream_t st) {
#define REPRO_FD(HD)                                                       \
  by_group<T, HD>(gc, q, k, v, lengths, out, part_acc, part_ml, counters, \
                  bkv, g, smax, window, nblocks, smem, st)
  switch (hd) {
    case 64: return REPRO_FD(64);
    case 80: return REPRO_FD(80);
    case 128: return REPRO_FD(128);
    case 256: return REPRO_FD(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD
}

}  // namespace

extern "C" {

// q [bkv, g, hd], k / v [bkv, smax, hd], all fp32 (dtype 0) or all bf16
// (dtype 1), contiguous and 16-byte aligned; lengths [bkv] int32 in
// [0, smax); window: -1 (global) or the keys a row reads before its last
// (columns max(0, lengths[r] - window) .. lengths[r]) -> out [bkv, g, hd]
// in the same dtype.  The launch
// configuration comes from the wrapper (kernels/flash_decode.py::
// launch_config): the group rounded up (gc in 1, 2, 4, 8, 16, >= g), the
// blocks (nblocks) and the dynamic shared memory, which must equal this
// file's layout for bkv rows.  Scratch: part_acc [nblocks, 2, g, hd] and
// part_ml [nblocks, 2, g, 2] fp32 (a block's first and last rows), and
// zeroed int32 counters [bkv], which the kernel leaves zeroed.  Returns
// cudaGetLastError().
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* part_acc,
                       float* part_ml, int* counters, int bkv, int g,
                       int smax, int hd, int window, int nblocks, int dtype,
                       int gc, int smem, void* stream) {
  if (g < 1 || g > gc || bkv < 0 || smax < 1 || nblocks < 1 || window < -1 ||
      (dtype != 0 && dtype != 1) || !part_acc || !part_ml || !counters)
    return (int)cudaErrorInvalidValue;
  if (bkv == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? by_width<float>(hd, gc, q, k, v, lengths, out, part_acc, part_ml,
                            counters, bkv, g, smax, window, nblocks, smem, st)
          : by_width<__nv_bfloat16>(hd, gc, q, k, v, lengths, out, part_acc,
                                    part_ml, counters, bkv, g, smax, window,
                                    nblocks, smem, st);
  return (int)e;
}

}  // extern "C"
