// One pipelined fp32 SIMT mainloop for Hopper (sm_90a), shared by the
// distance kernels (B2 distance.cu; B1 filtered_topk.cu and B3
// quant_topk.cu through topk_pass1.cuh).
//
// A block owns a TQ x TN output tile and computes
//   acc[i][j] = sum_k a[q0 + i, k] * b[c0 + j, k]
// for a row-major [rows, d] A and a row-major [cands, d] B, in fp32.
//
// Numbers: every output is ONE fmaf chain over k = 0..d-1 in order (the
// ragged tail is zero-filled, and fmaf(0, 0, acc) leaves acc's value).
// The order depends on neither the tile, the split, the grid position nor
// the row, so a shard stack answers bit for bit like the monolithic scan
// and an incrementally grown pack like a cold build.  No split-K, no TF32,
// no tensor cores: the bound is the fp32 SIMT rate (67 TFLOP/s on an
// H100 SXM).
//
// Design:
//   * 256 threads, each with an 8 x 8 register micro-tile at the 128 x 128
//     tile (struct Micro: two runs of four rows and two runs of four
//     columns), so one k costs four float4 shared-memory reads (LDS.128)
//     for 64 FMAs.  A warp reads two distinct A fragments (a broadcast)
//     and 16 consecutive B fragments, free of bank conflicts.
//   * Depth chunks of BK = 16 land in a STAGES-deep ring in dynamic shared
//     memory through cp.async: 16-byte copies where the row stride and the
//     base pointer allow it, else 4-byte copies, else element loads through
//     registers (odd widths; the caller picks the width, `vec`).  The
//     copies of the next chunks are in flight while chunk k is multiplied
//     (one barrier per chunk; the pipeline is spelled out at Ring).
//   * cp.async cannot transpose, so the ring keeps the rows' k order (fp32
//     rows padded to LDF = BK + 4 floats).  Once per staged chunk the block
//     turns it into a double-buffered k-major fp32 copy [BK][rows + 4],
//     widening int8 and bf16 on the way (int8 -> float is exact, bf16 is a
//     16-bit shift): narrow operands cost 4x / 2x less ring and L2 traffic,
//     and the conversion is paid once per staged element, not once per
//     fragment read.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sg {

constexpr int NTH = 256;        // threads per block
constexpr int BK = 16;          // depth chunk of one ring stage
constexpr int LDF = BK + 4;     // fp32 row stride in the ring (floats)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Ring row stride (elements) of a staged tile of storage type S: fp32 rows
// are padded to LDF floats, so the transpose's 16-byte reads of eight
// consecutive rows fall on distinct banks; int8 and bf16 rows are dense
// (16 and 32 bytes).
template <typename S>
__host__ __device__ constexpr int raw_ld() {
  return sizeof(S) == 4 ? LDF : BK;
}

template <typename S>
__host__ __device__ constexpr int raw_bytes(int rows) {
  return rows * raw_ld<S>() * (int)sizeof(S);
}

// Stage depth [k0, k0 + BK) of R rows of a row-major global [rows, d]
// array (row stride `ld` elements) into `dst`: tile row r is global row
// row_of(r), or zeros where that is < 0; depths >= d are zero.  `vec` is
// the copy width in bytes (16 or 4: the caller has checked that
// d * sizeof(S) and the base pointer are multiples of it, so a copy is
// either wholly inside the row or wholly past d), or 0 for element loads.
template <typename S, int R, typename RowOf>
__device__ __forceinline__ void stage_rows(S* dst, const S* __restrict__ src,
                                           long long ld, RowOf row_of,
                                           int k0, int d, int vec) {
  constexpr int LD = raw_ld<S>();
  const int tid = threadIdx.x;
  if (vec == 16) {
    constexpr int E = 16 / sizeof(S);
    constexpr int PER = BK / E;
    for (int i = tid; i < R * PER; i += NTH) {
      const int r = i / PER, c = (i % PER) * E, row = row_of(r), k = k0 + c;
      const bool ok = row >= 0 && k < d;
      cp16(dst + r * LD + c, src + (ok ? (long long)row * ld + k : 0), ok);
    }
  } else if (vec == 4) {
    constexpr int E = 4 / sizeof(S);
    constexpr int PER = BK / E;
    for (int i = tid; i < R * PER; i += NTH) {
      const int r = i / PER, c = (i % PER) * E, row = row_of(r), k = k0 + c;
      const bool ok = row >= 0 && k < d;
      cp4(dst + r * LD + c, src + (ok ? (long long)row * ld + k : 0), ok);
    }
  } else {
    for (int i = tid; i < R * BK; i += NTH) {
      const int r = i / BK, c = i % BK, row = row_of(r), k = k0 + c;
      dst[r * LD + c] =
          (row >= 0 && k < d) ? src[(long long)row * ld + k] : S(0);
    }
  }
}

// Stage rows [row0, row0 + R) (stage_rows; rows >= nrows are zero).
template <typename S, int R>
__device__ __forceinline__ void stage(S* dst, const S* __restrict__ src,
                                      long long ld, int row0, int nrows,
                                      int k0, int d, int vec) {
  stage_rows<S, R>(
      dst, src, ld,
      [=](int r) { return row0 + r < nrows ? row0 + r : -1; }, k0, d, vec);
}

// Sixteen staged bytes -> their E = 16 / sizeof(S) elements as fp32,
// exactly (int8 -> float, bf16 -> a 16-bit shift).
__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(const int8_t* p, float (&f)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    f[e] = (float)(signed char)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
}
__device__ __forceinline__ void unpack(const uint16_t* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
}

// Row stride (floats) of the k-major fp32 copy of an R-row tile.
__host__ __device__ constexpr int kld(int rows) { return rows + 4; }

// Row r of a staged [R][BK] tile (ring layout) -> column r of its k-major
// fp32 copy [BK][R + 4], k in order; `norm` accumulates the row's squared
// values in that order.  Lanes take consecutive rows, so the 16-byte reads
// of the ring and the 4-byte writes of the copy are free of bank
// conflicts.
template <typename S, int R>
__device__ __forceinline__ void row_to_kmajor(float* __restrict__ kt,
                                              const S* __restrict__ raw,
                                              int r, float& norm) {
  constexpr int LD = raw_ld<S>(), E = 16 / sizeof(S), PER = BK / E;
#pragma unroll
  for (int piece = 0; piece < PER; ++piece) {
    float f[E];
    unpack(raw + r * LD + piece * E, f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kt[(piece * E + e) * kld(R) + r] = f[e];
      norm = fmaf(f[e], f[e], norm);
    }
  }
}

// V consecutive floats of shared memory (V = 1, 2 or 4; aligned to V).
template <int V>
__device__ __forceinline__ void ld_frag(float* f, const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  } else {
    f[0] = p[0];
  }
}

// Which tile rows / columns a thread owns.  Thread (tx, ty) holds RQ rows
// in RQ / VA runs of VA = min(RQ, 4) consecutive rows, the runs TQ / GA
// apart (8 x 8 at 128 x 128: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}),
// and likewise RC columns: fragments are float4 reads of the k-major copy.
template <int T, int N, int V>
__host__ __device__ constexpr int owned(int idx, int t) {
  return (idx / V) * (T / (N / V)) + t * V + idx % V;
}

template <int TQ, int TN, int RQ, int RC>
struct Micro {
  static constexpr int TX = TN / RC, TY = NTH / TX;
  static constexpr int VA = RQ < 4 ? RQ : 4, VB = RC < 4 ? RC : 4;
  static_assert(TY * RQ == TQ && TX * RC == TN, "micro-tile must cover");
  static __device__ __forceinline__ int row(int i, int ty) {
    return owned<TQ, RQ, VA>(i, ty);
  }
  static __device__ __forceinline__ int col(int j, int tx) {
    return owned<TN, RC, VB>(j, tx);
  }
};

// acc += A_chunk . B_chunk^T for one depth chunk from the k-major copies
// ka [BK][TQ + 4] and kb [BK][TN + 4], k in order.
template <int TQ, int TN, int RQ, int RC>
__device__ __forceinline__ void mma_chunk(float (&acc)[RQ][RC],
                                          const float* __restrict__ ka,
                                          const float* __restrict__ kb,
                                          int tx, int ty) {
  using M = Micro<TQ, TN, RQ, RC>;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[RQ], b[RC];
#pragma unroll
    for (int i = 0; i < RQ; i += M::VA)
      ld_frag<M::VA>(a + i, ka + k * kld(TQ) + M::row(i, ty));
#pragma unroll
    for (int j = 0; j < RC; j += M::VB)
      ld_frag<M::VB>(b + j, kb + k * kld(TN) + M::col(j, tx));
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The ring and the double-buffered k-major copies for one (TQ, TN, A type,
// B type): byte offsets inside the block's dynamic shared memory, from 0.
//
// The pipeline a kernel runs over chunks it = 0, 1, ... (see distance.cu):
//   prologue: stage chunks 0 .. STAGES-1 (one commit group each),
//             cp_wait<STAGES-1>, barrier, transpose(0, 0)
//   chunk it: cp_wait<STAGES-2>, barrier  (chunk it+1 has landed, copy
//             it & 1 is complete, copy (it+1) & 1 is no longer read),
//             stage chunk it+STAGES into slot it % STAGES (its raw tile was
//             transposed one chunk ago), commit, transpose(it+1), then
//             multiply copy it & 1.
// So one barrier per chunk, two chunks of copies in flight behind the
// products, and the transpose of the next chunk interleaved with them.
template <int TQ, int TN, int STAGES, typename SA, typename SB>
struct Ring {
  static constexpr int A_BYTES = raw_bytes<SA>(TQ);
  static constexpr int B_BYTES = raw_bytes<SB>(TN);
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int KA = BK * kld(TQ) * 4, KB = BK * kld(TN) * 4;
  static constexpr int BYTES = STAGES * STAGE + 2 * (KA + KB);
  static_assert(TQ + TN <= NTH, "one thread per staged row");

  unsigned char* base;
  __device__ SA* a(int s) const {
    return reinterpret_cast<SA*>(base + s * STAGE);
  }
  __device__ SB* b(int s) const {
    return reinterpret_cast<SB*>(base + s * STAGE + A_BYTES);
  }
  __device__ float* ka(int it) const {
    return reinterpret_cast<float*>(base + STAGES * STAGE +
                                    (it & 1) * (KA + KB));
  }
  __device__ float* kb(int it) const { return ka(it) + KA / 4; }
  // Chunk `it` (staged in slot it % STAGES) -> copy it & 1.  Thread t < TQ
  // takes A row t, TQ <= t < TQ + TN takes B row t - TQ; `norm` gathers
  // the thread's row norm over the chunks in order.
  __device__ void transpose(int it, float& norm) const {
    const int t = threadIdx.x, s = it % STAGES;
    if (t < TQ) row_to_kmajor<SA, TQ>(ka(it), a(s), t, norm);
    else if (t < TQ + TN) row_to_kmajor<SB, TN>(kb(it), b(s), t - TQ, norm);
  }
};

}  // namespace sg
}  // namespace
