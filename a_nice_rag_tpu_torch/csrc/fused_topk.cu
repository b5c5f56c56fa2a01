// Fused dense scoring + streaming top-k for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package (a_nice_rag_tpu.ops, file
// fused_topk.py under its TPU-kernel directory):
//   K1 fused_dense_top_k (fused_topk.py:1440)
//      (f32 or bf16 rows, f32 queries)
//   K2 fused_dense_top_k_int8 (fused_topk.py:1218)
//      (int8 rows with per-row scales, int8 queries with per-query scales)
//
// Contract (both): for every query, the k best documents by
// (score descending, doc id ascending), masked documents never being
// candidates; vals [B, k] f32, ids [B, k] i32, unfilled slots (-inf, -1).
// The [B, N] score matrix is never written to device memory.
//
// What bounds it on an H100. K1 at 2^21 x 256 bf16 with B = 256 does
// 2*B*N*D = 275 GFLOP over 1 GiB read: 4.1 ms at the 67 TFLOP/s FFMA peak
// against 0.32 ms at 3.35 TB/s, so it is compute-bound on FFMA. Scores
// are IEEE float32 (query times the upcast element, FFMA, no TF32, no bf16
// rounding of the queries); moving them onto tensor cores is a later
// change that has to be checked against recall. K2 at 10.5M x 1024 int8
// reads 10.7 GB (3.2 ms at 3.35 TB/s) for 5.5 T int8 operations (2.8 ms
// at 1,979 TOP/s): bound by bytes, with the tensor cores close behind.
// With B = 256 its four query blocks each read the matrix, so 43 GB cross
// L2 into shared memory for 10.7 GB from HBM; that traffic, the
// mma.sync rate (below wgmma's) and the fold decide its time. Whether
// scoring bounds it is what the anatomy (anatomy.cu, MODE_SCORE against
// MODE_STAGE) measures; a wgmma version is the step after that.
//
// Design.
// * Work split: doc splits x query blocks. Each CTA owns a block of
//   queries and one contiguous range of documents, and loops over that
//   range in tiles of TN documents. That loop takes the place of the
//   TPU's sequential grid axis. The wrappers size the splits to the CTAs
//   an SM holds (ops/kernels/int8_plan.py for K2).
// * Scoring, K1: each tile's [64, TN] scores are built in registers
//   (4 x 8 per thread, fmaf) from depth chunks staged in shared memory,
//   then written to shared memory.
// * Scoring, K2 (int8_mma.cuh): the query block (16 queries for B <= 16,
//   else 64) is staged once per CTA; doc tiles stream through a
//   three-chunk ring of 16-byte cp.async copies; the exact int32 sums
//   come from mma.sync m16n8k32 s8 on the
//   tensor cores, and selection is on float(acc) * doc_scale. The
//   query-block CTAs of a split are neighbours in the launch order, so
//   they stream the same tiles at about the same time. The query scale
//   is applied to the k outputs only, after
//   selection, in the merge kernel: the same order as the TPU kernel.
// * Selection: one warp per query row keeps a running top-k in shared
//   memory. A document is inserted only if it beats the current worst
//   entry under (score desc, id asc); the worst entry is evicted. Docs
//   are visited in ascending id order, so at an exact tie on the
//   boundary the lower id stays. In the steady state almost no document
//   beats the k-th best, so a tile costs one compare per score.
// * Merge: a second kernel merges the per-split lists of a query (one
//   warp per query) with the same insertion rule, then orders the k
//   survivors by rank and writes them sorted, with (-inf, -1) in
//   unfilled slots.
//
// No padding copy is made: ragged edges (B, N, D of any size, rows of
// any alignment) are handled inside the kernels. The scoring, selection
// and merge code is shared with the IVF kernels (topk_common.cuh,
// int8_mma.cuh); the split kernels and their launchers with the probes of
// anatomy.cu (split_topk.cuh). Plain C interface; each entry point
// returns the cudaError_t of its launches (0 on success).

#include "split_topk.cuh"

extern "C" {

int anr_topk_tile_docs() { return TN; }

// Shared memory of a K2 or K4 CTA (MODE_FULL) for a query block of bq.
long long anr_int8_smem_bytes(int bq, int D, int k) {
  return static_cast<long long>(smem_bytes_int8(bq, D, k));
}

int anr_fused_topk_f32(const float* q, const float* e, const uint8_t* mask,
                       int B, int N, int D, int k, int n_splits,
                       int docs_per_split, float* part_v, int* part_i,
                       float* out_v, int* out_i, void* stream) {
  return launch<float>(q, e, mask, B, N, D, k, n_splits, docs_per_split,
                       part_v, part_i, out_v, out_i,
                       static_cast<cudaStream_t>(stream));
}

int anr_fused_topk_bf16(const float* q, const void* e, const uint8_t* mask,
                        int B, int N, int D, int k, int n_splits,
                        int docs_per_split, float* part_v, int* part_i,
                        float* out_v, int* out_i, void* stream) {
  return launch<__nv_bfloat16>(q, static_cast<const __nv_bfloat16*>(e),
                               mask, B, N, D, k, n_splits, docs_per_split,
                               part_v, part_i, out_v, out_i,
                               static_cast<cudaStream_t>(stream));
}

int anr_fused_topk_int8(const int8_t* q_values, const float* q_scales,
                        const int8_t* values, const float* scales,
                        const uint8_t* mask, int B, int N, int D, int k,
                        int bq, int n_splits, int docs_per_split,
                        float* part_v, int* part_i, float* out_v, int* out_i,
                        void* stream) {
  return launch_int8(q_values, values, scales, mask, q_scales, B, N, D, k, bq,
                     n_splits, docs_per_split, part_v, part_i, out_v, out_i,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
