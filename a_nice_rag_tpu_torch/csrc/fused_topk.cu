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
// reads 10.7 GB (3.2 ms at 3.35 TB/s) for 5.5 T int8 operations: on the
// int8 tensor cores it would be bandwidth-bound; this version accumulates
// with __dp4a on the CUDA cores, which makes it compute-bound for now.
//
// Design.
// * Work split: grid = (doc split) x (query block). Each CTA owns BQ
//   queries and one contiguous range of documents, and loops over that
//   range in tiles of TN documents. That loop takes the place of the
//   TPU's sequential grid axis; enough splits are launched to keep more
//   than two CTAs on each SM.
// * Scoring: each tile's [BQ, TN] scores are built in registers (4 x 8
//   per thread) from depth chunks staged in shared memory, then written
//   to shared memory. K1 accumulates in f32 with fmaf; K2 accumulates
//   exactly in int32 with __dp4a, then selects on float(acc) * doc_scale.
//   The query scale is applied to the k outputs only, after selection,
//   in the merge kernel: the same order as the TPU kernel.
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
// No padding copy is made: ragged edges (B, N, D of any size) are
// masked inside the kernel. The scoring, selection and merge code is
// shared with the IVF kernels (topk_common.cuh); the split kernel and its
// launcher with the probes of anatomy.cu (split_topk.cuh). Plain C
// interface; each entry point returns the cudaError_t of its launches (0
// on success).

#include "split_topk.cuh"

extern "C" {

int anr_topk_tile_docs() { return TN; }

int anr_fused_topk_f32(const float* q, const float* e, const uint8_t* mask,
                       int B, int N, int D, int k, int n_splits,
                       int docs_per_split, float* part_v, int* part_i,
                       float* out_v, int* out_i, void* stream) {
  return launch<float, false>(q, e, nullptr, mask, nullptr, B, N, D, k,
                              n_splits, docs_per_split, part_v, part_i,
                              out_v, out_i,
                              static_cast<cudaStream_t>(stream));
}

int anr_fused_topk_bf16(const float* q, const void* e, const uint8_t* mask,
                        int B, int N, int D, int k, int n_splits,
                        int docs_per_split, float* part_v, int* part_i,
                        float* out_v, int* out_i, void* stream) {
  return launch<__nv_bfloat16, false>(
      q, static_cast<const __nv_bfloat16*>(e), nullptr, mask, nullptr, B, N,
      D, k, n_splits, docs_per_split, part_v, part_i, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}

int anr_fused_topk_int8(const int8_t* q_values, const float* q_scales,
                        const int8_t* values, const float* scales,
                        const uint8_t* mask, int B, int N, int D, int k,
                        int n_splits, int docs_per_split, float* part_v,
                        int* part_i, float* out_v, int* out_i, void* stream) {
  return launch<int8_t, true>(q_values, values, scales, mask, q_scales, B, N,
                              D, k, n_splits, docs_per_split, part_v, part_i,
                              out_v, out_i,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
