// Tiled pairwise distance matrix for Hopper (sm_90a), SIMT fp32.
//
// Replaces the TPU kernel src/repro/kernels/distance.py::
// pairwise_dist_kernel_call (pallas_call at :46): [bq, d] x [n, d] ->
// [bq, n] fp32 squared L2 ((|q|^2 - 2 q.x) + |x|^2) or -q.x, from fp32 or
// bf16 inputs with fp32 accumulation.
//
// What bounds it on an H100: the 2*bq*n*d fp32 operations at the shapes
// the scan path calls it with (bq ~ 1000, d = 768: about 190 operations
// per byte, far above the fp32 ridge of about 20).
//
// Design: the shared mainloop of simt_gemm.cuh (a 3-stage cp.async ring
// of depth-16 chunks turned into k-major fp32 copies, 8 x 8 register
// micro-tiles per thread, bf16 widened once per staged chunk) on a
// 128 x 128 output tile (64 x 128 for a small batch), two blocks per SM.
// Blocks are rasterised in groups of `group` query tiles: consecutive
// blocks share a candidate tile, which is read from HBM once and from L2
// by the rest of its group.  The norms are accumulated from the same
// staged chunks in the same fmaf order as the products; the final
// combination uses _rn intrinsics so it is not contracted into an FMA.
// Each thread stores runs of four consecutive columns as float4 streaming
// stores.
#include "simt_gemm.cuh"

namespace {

constexpr int TN = 128, STAGES = 3;

template <typename S, int TQ>
struct DistCfg {
  static constexpr int RC = 8, TX = TN / RC, TY = sg::NTH / TX, RQ = TQ / TY;
  using M = sg::Micro<TQ, TN, RQ, RC>;
  using R = sg::Ring<TQ, TN, STAGES, S, S>;
  static constexpr int SMEM = R::BYTES + (TQ + TN) * 4;
  // two blocks per SM (128 registers a thread) for fp32; bf16's widening
  // needs more registers than that without spilling
  static constexpr int MIN_BLOCKS = sizeof(S) == 4 ? 2 : 1;
};

template <typename S, int TQ>
__global__ void __launch_bounds__(sg::NTH, DistCfg<S, TQ>::MIN_BLOCKS) dist_kernel(
    const S* __restrict__ q, const S* __restrict__ x, float* __restrict__ out,
    int bq, int n, int d, int metric, int vec_q, int vec_x, int group) {
  using C = DistCfg<S, TQ>;
  using M = typename C::M;
  constexpr int RQ = C::RQ, RC = C::RC;
  extern __shared__ __align__(16) unsigned char smem[];
  const typename C::R ring{smem};
  float* qn = reinterpret_cast<float*>(smem + C::R::BYTES);   // [TQ]
  float* xn = qn + TQ;                                        // [TN]

  // grouped rasterisation: `group` query tiles per candidate tile
  const int tiles_q = (bq + TQ - 1) / TQ, tiles_n = (n + TN - 1) / TN;
  const long long id = blockIdx.x;
  const long long per = (long long)group * tiles_n;
  const int first = (int)(id / per) * group;
  const int gsz = min(tiles_q - first, group);
  const int qt = first + (int)((id % per) % gsz);
  const int ct = (int)((id % per) / gsz);
  if (qt >= tiles_q || ct >= tiles_n) return;
  const int q0 = qt * TQ, c0 = ct * TN;

  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  float acc[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;  // tid < TQ: |q_tid|^2; TQ <= tid < TQ + TN: |x|^2

  const int nk = (d + sg::BK - 1) / sg::BK;
  auto issue = [&](int c) {
    if (c < nk) {
      sg::stage<S, TQ>(ring.a(c % STAGES), q, d, q0, bq, c * sg::BK, d, vec_q);
      sg::stage<S, TN>(ring.b(c % STAGES), x, d, c0, n, c * sg::BK, d, vec_x);
    }
    sg::cp_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES; ++c) issue(c);
  sg::cp_wait<STAGES - 1>();
  __syncthreads();
  ring.transpose(0, nacc);
  for (int kt = 0; kt < nk; ++kt) {
    sg::cp_wait<STAGES - 2>();
    __syncthreads();
    issue(kt + STAGES);
    if (kt + 1 < nk) ring.transpose(kt + 1, nacc);
    sg::mma_chunk<TQ, TN, RQ, RC>(acc, ring.ka(kt), ring.kb(kt), tx, ty);
  }
  sg::cp_wait<0>();
  if (tid < TQ) qn[tid] = nacc;
  else if (tid < TQ + TN) xn[tid - TQ] = nacc;
  __syncthreads();
  // each thread writes runs of four consecutive columns (float4 where the
  // row stride allows it), streaming past L2
  const bool v4 = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = M::row(i, ty), row = q0 + r;
    if (row >= bq) continue;
    const float qr = qn[r];
    float* orow = out + (long long)row * n;
#pragma unroll
    for (int j0 = 0; j0 < RC; j0 += 4) {
      const int c = M::col(j0, tx), col = c0 + c;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ip = acc[i][j0 + e];
        v[e] = metric == 0
                   ? __fadd_rn(__fsub_rn(qr, __fmul_rn(2.f, ip)), xn[c + e])
                   : -ip;
      }
      if (v4 && col + 3 < n) {
        __stcs(reinterpret_cast<float4*>(orow + col),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n) __stcs(orow + col + e, v[e]);
      }
    }
  }
}

template <typename S, int TQ>
cudaError_t launch(const void* q, const void* x, float* out, int bq, int n,
                   int d, int metric, int vec_q, int vec_x, int group,
                   int smem, cudaStream_t st) {
  if (smem != DistCfg<S, TQ>::SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dist_kernel<S, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)((bq + TQ - 1) / TQ) * ((n + TN - 1) / TN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dist_kernel<S, TQ><<<(unsigned)blocks, sg::NTH, smem, st>>>(
      static_cast<const S*>(q), static_cast<const S*>(x), out, bq, n, d,
      metric, vec_q, vec_x, group);
  return cudaGetLastError();
}

bool vec_ok(int v) { return v == 0 || v == 4 || v == 16; }

}  // namespace

extern "C" {

// q [bq, d], x [n, d] contiguous, both fp32 (dtype 0) or both bf16
// (dtype 1); out [bq, n] fp32.  The launch configuration comes from the
// wrapper (kernels/distance.py::launch_config): the query tile tq (128 or
// 64), the copy width in bytes of each operand (16, 4 or 0 = element
// loads), the rasterisation group and the dynamic shared memory, which must
// equal this file's layout.  Returns cudaGetLastError().
int repro_pairwise_dist(const void* q, const void* x, float* out, int bq,
                        int n, int d, int metric, int dtype, int tq,
                        int vec_q, int vec_x, int group, int smem,
                        void* stream) {
  if (bq < 1 || n < 1 || d < 1 || group < 1 || !vec_ok(vec_q) ||
      !vec_ok(vec_x))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && tq == 128)
    e = launch<float, 128>(q, x, out, bq, n, d, metric, vec_q, vec_x, group,
                           smem, st);
  else if (dtype == 0 && tq == 64)
    e = launch<float, 64>(q, x, out, bq, n, d, metric, vec_q, vec_x, group,
                          smem, st);
  else if (dtype == 1 && tq == 128)
    e = launch<uint16_t, 128>(q, x, out, bq, n, d, metric, vec_q, vec_x,
                              group, smem, st);
  else if (dtype == 1 && tq == 64)
    e = launch<uint16_t, 64>(q, x, out, bq, n, d, metric, vec_q, vec_x,
                             group, smem, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
