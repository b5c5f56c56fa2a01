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
// What bounds it on an H100. K1 at 2^21 x 256 bf16 with B = 256: 1.07 GB
// read once (0.32 ms at 3.35 TB/s) and 3 x 2*B*N*D = 825 GFLOP of bf16
// MMA (0.83 ms at 989 TFLOP/s): bound by its operations. Its four query
// blocks each stream the matrix, 4.3 GB through L2. (f32 rows score on
// FFMA, where the same product's bound is 4.1 ms at 67 TFLOP/s.) K2 at 10.5M x
// 1024 int8 reads 10.7 GB (3.2 ms at 3.35 TB/s) for 5.5 T int8 operations
// (2.8 ms at 1,979 TOP/s): bound by bytes, with the tensor cores close
// behind; its four query blocks pull 43 GB through L2 into shared memory.
//
// Design.
// * Work split (ops/kernels/topk_plan.py): doc splits x query blocks (16
//   queries for B <= 16, else 64), enough splits to give every SM the
//   CTAs its shared memory holds; the query-block CTAs of a split are
//   neighbours in the launch order, so they stream the same tiles at
//   about the same time. Each CTA loops over its split in tiles of TN
//   documents: that loop takes the place of the TPU's sequential grid
//   axis.
// * Scoring, K1 (float_mma.cuh): doc tiles stream through a three-chunk
//   ring of 16-byte cp.async copies; bf16 rows on the bf16 tensor cores
//   against the exact three-piece bf16 split of the f32 query (each
//   k-step's three MMAs promoted into an f32 sum by FADD), f32 rows on
//   FFMA in IEEE f32, never TF32. The query block is resident in shared
//   memory where it fits, else streamed by depth chunk beside the docs.
// * Scoring, K2 (int8_mma.cuh): the same ring; exact int32 sums from
//   mma.sync m16n8k32 s8, selection on float(acc) * doc_scale; the query
//   scale is applied to the k outputs only, after selection, in the merge:
//   the same order as the TPU kernel.
// * Selection (topk_common.cuh): one warp per query row keeps a running
//   top-k in shared memory; a document enters only if it beats the worst
//   entry under (score desc, id asc). Docs are visited in ascending id
//   order, so at an exact tie on the boundary the lower id stays.
// * tau warm start: a first pass of the same kernel over every 64th row
//   (the mask applied) and the merge in its tau mode give each query tau,
//   the k-th best subsample score lowered by TAU_SLACK (-inf with fewer
//   than k candidates); every running list of the main pass starts as k
//   copies of (tau, EMPTY_ID), so only documents at least tau are
//   inserted. Nothing syncs to the host.
// * Merge: one CTA per query selects the k best of the per-split lists
//   (seed entries dropped) by a radix select and writes them sorted, with
//   (-inf, -1) in unfilled slots.
//
// No padding copy is made: ragged edges (B, N, D of any size, rows of
// any alignment) are handled inside the kernels. Plain C interface; each
// entry point returns the cudaError_t of its launches (0 on success). The
// caller allocates the workspace (anr_topk_workspace_bytes).

#include "split_topk.cuh"

namespace {

template <typename T>
int fused_float(const float* q, const T* e, const uint8_t* mask, int B,
                int N, int D, int k, int bq, int qres, int splits, int per,
                int tau_splits, int tau_per, void* ws_base, float* out_v,
                int* out_i, float* tau_out, cudaStream_t stream) {
  if (!split_args_ok(B, N, D, k, bq, splits, per, tau_splits, tau_per) ||
      tau_splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Workspace ws = carve_workspace(ws_base, B, k, splits, tau_splits, D,
                                 FloatKind<T>::PLANES == 3);
  cudaError_t err;
  const T* planes = query_planes<T>(q, B, D, ws, stream, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FloatRows<T> rows{planes, e, mask, B, D, qres != 0};
  const SplitPlan sub{N, tau_per, TAU_STRIDE};
  if (tau_out != nullptr) {  // tau alone
    ws.tau = tau_out;
    return static_cast<int>(run_tau(rows, sub, tau_splits, bq, k, ws,
                                    stream));
  }
  return static_cast<int>(run_topk(rows, SplitPlan{N, per, 1}, splits, sub,
                                   tau_splits, bq, k, nullptr, ws, out_v,
                                   out_i, stream));
}

int fused_int8(const int8_t* q_values, const float* q_scales,
               const int8_t* values, const float* scales,
               const uint8_t* mask, int B, int N, int D, int k, int bq,
               int splits, int per, int tau_splits, int tau_per,
               void* ws_base, float* out_v, int* out_i, float* tau_out,
               cudaStream_t stream) {
  if (!split_args_ok(B, N, D, k, bq, splits, per, tau_splits, tau_per) ||
      tau_splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Workspace ws = carve_workspace(ws_base, B, k, splits, tau_splits, D, false);
  const Int8Rows rows{q_values, values, scales, mask, B, D};
  const SplitPlan sub{N, tau_per, TAU_STRIDE};
  if (tau_out != nullptr) {
    ws.tau = tau_out;
    return static_cast<int>(run_tau(rows, sub, tau_splits, bq, k, ws,
                                    stream));
  }
  return static_cast<int>(run_topk(rows, SplitPlan{N, per, 1}, splits, sub,
                                   tau_splits, bq, k, q_scales, ws, out_v,
                                   out_i, stream));
}

}  // namespace

extern "C" {

int anr_topk_tile_docs() { return TN; }

// Shared memory of a CTA (MODE_FULL): int8 rows, and f32 / bf16 rows
// with the query block resident (qres) or streamed.
long long anr_int8_smem_bytes(int bq, int D, int k) {
  return static_cast<long long>(smem_bytes_int8(bq, D, k));
}

long long anr_float_smem_bytes(int bq, int D, int bf16, int qres, int k) {
  return static_cast<long long>(smem_bytes_float(
      bq, D, bf16 ? 2 : 4, bf16 ? 3 : 1, qres != 0, k));
}

// Bytes of the workspace a call takes (pieces: bf16 rows' query planes).
long long anr_topk_workspace_bytes(int B, int k, int walkers,
                                   int tau_walkers, int D, int pieces) {
  size_t bytes = 0;
  carve_workspace(nullptr, B, k, walkers, tau_walkers, D, pieces != 0,
                  &bytes);
  return static_cast<long long>(bytes);
}

// K1. tau_out null: the top-k into out_v / out_i; else tau alone (the
// subsample pass), into tau_out [B].
int anr_fused_topk_f32(const float* q, const float* e, const uint8_t* mask,
                       int B, int N, int D, int k, int bq, int qres,
                       int splits, int per, int tau_splits, int tau_per,
                       void* ws, float* out_v, int* out_i, float* tau_out,
                       void* stream) {
  return fused_float<float>(q, e, mask, B, N, D, k, bq, qres, splits, per,
                            tau_splits, tau_per, ws, out_v, out_i, tau_out,
                            static_cast<cudaStream_t>(stream));
}

int anr_fused_topk_bf16(const float* q, const void* e, const uint8_t* mask,
                        int B, int N, int D, int k, int bq, int qres,
                        int splits, int per, int tau_splits, int tau_per,
                        void* ws, float* out_v, int* out_i, float* tau_out,
                        void* stream) {
  return fused_float<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(e), mask, B, N, D, k, bq, qres,
      splits, per, tau_splits, tau_per, ws, out_v, out_i, tau_out,
      static_cast<cudaStream_t>(stream));
}

// K2 (tau_out as K1's; tau on the selection scores, before the query
// scale).
int anr_fused_topk_int8(const int8_t* q_values, const float* q_scales,
                        const int8_t* values, const float* scales,
                        const uint8_t* mask, int B, int N, int D, int k,
                        int bq, int splits, int per, int tau_splits,
                        int tau_per, void* ws, float* out_v, int* out_i,
                        float* tau_out, void* stream) {
  return fused_int8(q_values, q_scales, values, scales, mask, B, N, D, k, bq,
                    splits, per, tau_splits, tau_per, ws, out_v, out_i,
                    tau_out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
