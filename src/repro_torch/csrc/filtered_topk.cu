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
// main path sends (bq ~ 1000), so the kernel is bound by fp32 operations
// (of the candidates that pass: no other vector is copied or multiplied).
//
// Design (no TPU structure carried over): pass 1 is the template of
// topk_pass1.cuh, shared with B3 (quant_topk.cu), instantiated with fp32
// candidates:
//   * strided splits of 128-candidate tiles, the predicate evaluated over
//     a block's candidates before any vector is copied, and only the
//     passing candidates gathered, 128 to a tile, and multiplied;
//   * the pipelined mainloop of simt_gemm.cuh (3-stage cp.async ring of
//     depth-16 chunks with 16-byte / 4-byte / element copies, k-major fp32
//     copies, register micro-tiles (4 x 8 at 64 query rows) read as
//     float4, one barrier per chunk), with both norms gathered by the
//     ring's transpose pass in the same k order as the products;
//   * batched list offers (topk_common.cuh::warp_offer_row) and pass 2,
//     the merge of the splits.
// Metadata stays [n, m] fp32 (m <= 16), not 128 lanes, and every input
// carries a leading batch axis g with its own stride (0 = shared: the
// queries and the parameters), so sharded and grouped callers reuse the
// kernel unchanged.  The launch configuration (query tile, splits, copy
// widths, shared memory) comes from the wrapper
// (kernels/filtered_topk.py::launch_config); kpad up to 1024.
#include "topk_pass1.cuh"

extern "C" {

// q [g?, bq, d], x [g, n, d], s [g, n, m], params [g?, 4, mp] (fp32,
// contiguous, batch strides in elements; 0 = shared across g).  With
// splits > 1, part_d / part_i are [g, splits, bq, kpad] scratch.
// out_d / out_i are [g, bq, kpad].  tq, splits (split s takes candidate
// tiles s, s + splits, ... of 128, at most 64 of them), the copy widths in
// bytes of q and x (16, 4 or 0 = element loads) and the dynamic shared
// memory (which must equal topk_pass1.cuh's layout) come from the
// wrapper.  Returns cudaGetLastError().
int repro_filtered_topk(const float* q, const float* x, const float* s,
                        const float* params, float* out_d, int* out_i,
                        float* part_d, int* part_i, int g, int bq, int n,
                        int d, int m, int mp, int kpad, int kind, int metric,
                        int tq, int splits, int vec_q, int vec_x, int smem,
                        long long q_gs, long long x_gs, long long s_gs,
                        long long p_gs, void* stream) {
  const p1::Args a{q, s, nullptr, params, out_d, part_d, out_i, part_i, g,
                   bq, n, d, m, mp, kpad, kind, metric, tq, splits, vec_q,
                   vec_x, smem, q_gs, x_gs, s_gs, 0, p_gs};
  return (int)p1::run<float>(a, x, 1024,
                             reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
