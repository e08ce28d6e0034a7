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
//   * Pass 1 is the template of topk_pass1.cuh, shared with B1: strided
//     splits, the predicate evaluated before any code is copied (a
//     failing candidate is never copied or multiplied), the passing
//     candidates packed 128 to a tile and streamed back to back through
//     the pipelined mainloop of simt_gemm.cuh (int8 rows land in the ring
//     at one byte per element and are widened once per stage), batched
//     list offers.
//     B3 instantiates it with int8 codes and reads `xsq` for the norms.
//     Pass 2 merges the splits (topk_common.cuh, shared with B1).
//   * kpad up to 2048 (the quantized path over-fetches rerank_multiple * k,
//     e.g. 4 * 300 -> kpad 2048): the wrapper
//     (kernels/quant_topk.py::launch_config) picks the query tile (64 rows
//     at kpad <= 64 down to 8 at kpad >= 1024: two blocks per SM wherever
//     the lists allow), the splits and the copy widths, and sizes the
//     shared memory; one template, four configurations.
//   * Per-candidate accumulation order (k = 0..d-1, one fmaf chain) does
//     not depend on the split, the tile or the row, so a shard stack, an
//     incrementally grown bucket and a cold build give bit-equal answers.
#include "topk_pass1.cuh"

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
// equal topk_pass1.cuh's layout.
// Returns cudaGetLastError().
int repro_quant_topk(const float* q, const int8_t* codes, const float* s,
                     const float* xsq, const float* params, float* out_d,
                     int* out_i, float* part_d, int* part_i, int g, int bq,
                     int n, int d, int m, int mp, int kpad, int kind,
                     int metric, int tq, int splits, int vec_q, int vec_c,
                     int smem, long long q_gs, long long c_gs,
                     long long s_gs, long long xq_gs, void* stream) {
  const p1::Args a{q, s, xsq, params, out_d, part_d, out_i, part_i, g, bq,
                   n, d, m, mp, kpad, kind, metric, tq, splits, vec_q,
                   vec_c, smem, q_gs, c_gs, s_gs, xq_gs, 0};
  return (int)p1::run<int8_t>(a, codes, 2048,
                              reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
