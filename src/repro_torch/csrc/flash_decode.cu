// Single-token GQA decode attention for Hopper (sm_90a), split over the
// sequence ("flash-decoding") with an online softmax in fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_kernel_call (pallas_call at :76).  For each row r (one
// (batch, kv-head) pair) and each of its g query heads:
//
//   o = softmax(q . K^T / sqrt(hd), masked to columns <= lengths[r]) . V
//
// q [bkv, g, hd], k / v [bkv, smax, hd], lengths [bkv] int32 (inclusive),
// o [bkv, g, hd] in q's dtype (fp32 or bf16); products, softmax and sums in
// fp32 (held against kernels/ref.py::flash_decode_ref).  The TPU kernel's
// constraints (smax % ts == 0, hd % 128 == 0, g a multiple of 8) come from
// its tiling and are not inherited: any smax, g in 1..16, hd in
// {64, 128, 256}.  lengths must lie in [0, smax); the kernel clamps them
// into that range so that it never reads outside a row.
//
// What bounds it on an H100: bytes.  Each cached key is read once (K and
// V, 2 * hd * sizeof(T) bytes) and used for 4 * g * hd operations, at
// most 16 operations per byte in bf16 with g = 16 — far below the ridge,
// so the filled prefix's K / V bytes over HBM bandwidth are the bound.
//
// Design:
// - Read only the filled prefix.  Unlike the TPU kernel, which streams
//   every tile up to smax and masks, a block stops at lengths[r]; a
//   batcher tick with ragged lengths reads only what is filled.
// - Fill the card.  A decode tick has few rows (8 slots x 8 kv-heads = 64
//   for internvl2-2b), fewer than the 132 SMs, so the sequence is split
//   across blocks: block (s, r) covers columns [s * chunk, (s + 1) * chunk)
//   of row r and keeps its own running (max, sum, acc[g, hd]) in fp32.
//   With one split it writes o directly; otherwise it writes the partial
//   triple to scratch that the wrapper allocates, and a second small
//   kernel combines the splits of each row.
// - Loads.  K / V tiles of TS keys are staged through shared memory with
//   16-byte loads, in the input dtype (bf16 is widened with
//   __bfloat162float when read); each K row is padded by 16 bytes so the
//   score pass's 16-byte row reads are free of bank conflicts.
// - Per tile: one thread per (query head, key) score, a warp per query
//   head for the running max / sum, then each thread accumulates its
//   (head, column) outputs over the tile's keys.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int NW = NT / 32;
constexpr int GMAX = 16;       // largest GQA group
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Dot product of one 16-byte piece (4 fp32 or 8 bf16 values) with q.
__device__ __forceinline__ float dot16(const float* k, const float* q,
                                       float acc) {
  float4 a = *reinterpret_cast<const float4*>(k);
  float4 b = *reinterpret_cast<const float4*>(q);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* k,
                                       const float* q, float acc) {
  uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float4 b0 = *reinterpret_cast<const float4*>(q);
  float4 b1 = *reinterpret_cast<const float4*>(q + 4);
  float2 f;
  f = __bfloat1622float2(h[0]);
  acc = fmaf(f.x, b0.x, acc); acc = fmaf(f.y, b0.y, acc);
  f = __bfloat1622float2(h[1]);
  acc = fmaf(f.x, b0.z, acc); acc = fmaf(f.y, b0.w, acc);
  f = __bfloat1622float2(h[2]);
  acc = fmaf(f.x, b1.x, acc); acc = fmaf(f.y, b1.y, acc);
  f = __bfloat1622float2(h[3]);
  acc = fmaf(f.x, b1.z, acc); acc = fmaf(f.y, b1.w, acc);
  return acc;
}

template <typename T, int HD>
struct Geo {
  static constexpr int TS = 16384 / (HD * (int)sizeof(T));  // keys a tile
  static constexpr int VPR = HD * (int)sizeof(T) / 16;      // 16-B pieces
  static constexpr int RS = HD + 16 / (int)sizeof(T);       // padded row
  static constexpr int EPV = 16 / (int)sizeof(T);           // elems a piece
  static constexpr int R = GMAX * HD / NT;                  // outputs/thread
  static size_t smem(int g) {
    return 2 * (size_t)TS * RS * sizeof(T) +
           ((size_t)g * HD + (size_t)g * TS + 3 * GMAX) * sizeof(float);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_decode(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int g, int smax, int chunk, int nsplit) {
  using G = Geo<T, HD>;
  constexpr int TS = G::TS, VPR = G::VPR, RS = G::RS, EPV = G::EPV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);                 // [TS][RS]
  T* Vs = Ks + TS * RS;                               // [TS][RS]
  float* qs = reinterpret_cast<float*>(Vs + TS * RS);  // [g][HD]
  float* ps = qs + g * HD;                            // [g][TS]
  float* mrow = ps + g * TS;                          // [GMAX]
  float* lrow = mrow + GMAX;                          // [GMAX]
  float* alpha = lrow + GMAX;                         // [GMAX]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, r = blockIdx.y;
  const int len = min(max(lengths[r], 0), smax - 1);
  const int n_valid = len + 1;
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, n_valid);
  const int nout = g * HD;
  const long long row_base = (long long)r * smax * HD;

  if (s0 >= s1) {   // this split lies past the filled prefix
    float* pa = part_acc + ((long long)r * nsplit + split) * nout;
    for (int o = tid; o < nout; o += NT) pa[o] = 0.f;
    if (tid < g) {
      float* pm = part_ml + (((long long)r * nsplit + split) * g + tid) * 2;
      pm[0] = -INFINITY;
      pm[1] = 0.f;
    }
    return;
  }

  const T* qr = q + (long long)r * nout;
  for (int o = tid; o < nout; o += NT) qs[o] = tof(qr[o]);
  if (tid < GMAX) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[G::R];
#pragma unroll
  for (int i = 0; i < G::R; ++i) acc[i] = 0.f;
  const float root_hd = sqrtf((float)HD);   // scores are dot / sqrt(hd)

  for (int c0 = s0; c0 < s1; c0 += TS) {
    const int nt = min(TS, s1 - c0);
    // stage the tile's K and V rows (16-byte pieces)
    const char* kg = reinterpret_cast<const char*>(k + row_base +
                                                   (long long)c0 * HD);
    const char* vg = reinterpret_cast<const char*>(v + row_base +
                                                   (long long)c0 * HD);
    for (int idx = tid; idx < nt * VPR; idx += NT) {
      const int t = idx / VPR, piece = idx - t * VPR;
      const long long src = ((long long)t * HD + piece * EPV) * sizeof(T);
      const int dst = t * RS + piece * EPV;
      *reinterpret_cast<uint4*>(Ks + dst) =
          *reinterpret_cast<const uint4*>(kg + src);
      *reinterpret_cast<uint4*>(Vs + dst) =
          *reinterpret_cast<const uint4*>(vg + src);
    }
    __syncthreads();
    // scores: one thread per (head, key)
    for (int p = tid; p < g * TS; p += NT) {
      const int gi = p / TS, t = p - gi * TS;
      float sc = -INFINITY;
      if (t < nt) {
        const T* kr = Ks + t * RS;
        const float* qv = qs + gi * HD;
        float d = 0.f;
#pragma unroll 4
        for (int e = 0; e < HD; e += EPV) d = dot16(kr + e, qv + e, d);
        sc = __fdiv_rn(d, root_hd);
      }
      ps[gi * TS + t] = sc;
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int gi = warp; gi < g; gi += NW) {
      float* pr = ps + gi * TS;
      float mx = -INFINITY;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = mrow[gi];
      const float m_new = fmaxf(m_old, mx);   // finite: nt >= 1
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float e = expf(pr[t] - m_new);   // 0 for masked keys
        pr[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        const float a = expf(m_old - m_new);   // 0 on the first tile
        alpha[gi] = a;
        lrow[gi] = lrow[gi] * a + sum;
        mrow[gi] = m_new;
      }
    }
    __syncthreads();
    // acc[head, col] = acc * alpha + sum_t p[head, t] * V[t, col]
#pragma unroll
    for (int i = 0; i < G::R; ++i) {
      const int o = tid + i * NT;
      if (o < nout) {
        const int gi = o / HD, j = o - gi * HD;
        const float* pr = ps + gi * TS;
        float a = acc[i] * alpha[gi];
        for (int t = 0; t < nt; ++t) a = fmaf(pr[t], tof(Vs[t * RS + j]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  if (nsplit == 1) {
    T* orow = out + (long long)r * nout;
#pragma unroll
    for (int i = 0; i < G::R; ++i) {
      const int o = tid + i * NT;
      if (o < nout) store(orow + o, acc[i] / lrow[o / HD]);
    }
    return;
  }
  float* pa = part_acc + ((long long)r * nsplit + split) * nout;
#pragma unroll
  for (int i = 0; i < G::R; ++i) {
    const int o = tid + i * NT;
    if (o < nout) pa[o] = acc[i];
  }
  if (tid < g) {
    float* pm = part_ml + (((long long)r * nsplit + split) * g + tid) * 2;
    pm[0] = mrow[tid];
    pm[1] = lrow[tid];
  }
}

// One block per row: o[head, col] = sum_s acc_s * e^(m_s - M) /
// sum_s l_s * e^(m_s - M), M the largest m_s (split 0 always holds
// column 0, so M is finite).
template <typename T>
__global__ void __launch_bounds__(NT) combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int g, int hd, int nsplit) {
  const int r = blockIdx.x;
  const int nout = g * hd;
  const float* ml = part_ml + (long long)r * nsplit * g * 2;
  const float* pa = part_acc + (long long)r * nsplit * nout;
  for (int o = threadIdx.x; o < nout; o += NT) {
    const int gi = o / hd;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[(s * g + gi) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[(s * g + gi) * 2] - mx);
      den = fmaf(ml[(s * g + gi) * 2 + 1], w, den);
      num = fmaf(pa[(long long)s * nout + o], w, num);
    }
    store(out + (long long)r * nout + o, num / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int bkv, int g, int smax, int chunk,
                   int nsplit, cudaStream_t st) {
  const size_t sm = Geo<T, HD>::smem(g);
  if (sm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(nsplit, bkv);
  flash_decode<T, HD><<<grid, NT, sm, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, g, smax, chunk, nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  combine<T><<<bkv, NT, 0, st>>>(part_acc, part_ml, static_cast<T*>(out), g,
                                 HD, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* part_acc,
                     float* part_ml, int bkv, int g, int smax, int chunk,
                     int nsplit, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, bkv, g,
                           smax, chunk, nsplit, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, bkv,
                            g, smax, chunk, nsplit, st);
    case 256:
      return launch<T, 256>(q, k, v, lengths, out, part_acc, part_ml, bkv,
                            g, smax, chunk, nsplit, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Keys per shared-memory tile for head width hd and dtype (0 = fp32,
// 1 = bf16); a split's chunk is a multiple of it.  0 for an unsupported hd.
int repro_flash_decode_tile(int hd, int dtype) {
  if (hd != 64 && hd != 128 && hd != 256) return 0;
  return 16384 / (hd * (dtype == 0 ? 4 : 2));
}

// q [bkv, g, hd], k / v [bkv, smax, hd], all fp32 (dtype 0) or all bf16
// (dtype 1), contiguous and 16-byte aligned; lengths [bkv] int32 in
// [0, smax) -> out [bkv, g, hd] in the same dtype.  nsplit > 1 needs
// scratch part_acc [bkv, nsplit, g, hd] and part_ml [bkv, nsplit, g, 2]
// fp32; chunk (keys per split, a multiple of the tile) * nsplit >= smax.
// Returns cudaGetLastError().
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* part_acc,
                       float* part_ml, int bkv, int g, int smax, int hd,
                       int chunk, int nsplit, int dtype, void* stream) {
  if (g < 1 || g > GMAX || bkv < 0 || smax < 1 || nsplit < 1 || chunk < 1 ||
      (long long)chunk * nsplit < smax || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bkv == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch<float>(hd, q, k, v, lengths, out, part_acc, part_ml,
                            bkv, g, smax, chunk, nsplit, st)
          : dispatch<__nv_bfloat16>(hd, q, k, v, lengths, out, part_acc,
                                    part_ml, bkv, g, smax, chunk, nsplit, st);
  return (int)e;
}

}  // extern "C"
