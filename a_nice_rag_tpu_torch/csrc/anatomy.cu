// Probes of the fused top-k kernels K1/K2 for Hopper (sm_90a): where
// their time goes, and how often their running lists take a document.
//
// Replaces these TPU kernels of the repository:
//   P4 scripts/profile_kernel_anatomy.py:138, the ablation of the fused
//      top-k kernel: four kernels on one launcher that differ only in the
//      work per tile (visit_dma_only :65, visit_mm_only :80,
//      visit_mm_trigger :100, visit_full :127);
//   P5 scripts/probe_iteration_count.py:160, the production fold with
//      counters (fold_counting :69, kernel :103) and an optional per-row
//      threshold taken from a subsample (:57-67).
//
// Contract. anr_anatomy_{f32,bf16,int8} run the split kernel of K1/K2
// (split_topk.cuh) in one of its probe modes, on K1/K2's grid, block and
// shared-memory layout for the given k and plan (query block bq, for
// float rows whether it is resident, splits), without K1/K2's tau pass:
//   MODE_STAGE    words [query blocks][n_splits] u32: per CTA, the XOR
//                 of the 32-bit words it staged (the query block's words,
//                 f32 or the three bf16 pieces or int8, zero-padded, once
//                 if resident and once per tile if streamed; every
//                 document word of the split once, zero past D; each read
//                 back from shared memory after its copy landed);
//   MODE_SCORE    row_max [B] f32: the best selection score of each row
//                 (float rows: q . e; int8 rows: float(q8 . e8) * doc
//                 scale);
//   MODE_COMPARE  counts [B] i32: the documents scoring at least thr[b];
//   MODE_COUNTED  K1/K2's (out_v, out_i) through the same merge, plus
//                 counts [B][n_splits][4] i32: insertions in the split's
//                 first 16 tiles, insertions after them, 32-column
//                 windows whose ballot fired, windows seen; with thr
//                 non-null, every slot of row b starts as (thr[b],
//                 EMPTY_ID), so only documents scoring at least thr[b]
//                 enter (exact when thr[b] is at most the k-th best
//                 score).
// The "full" time of the ablation is K1/K2 itself (fused_topk.cu), tau
// pass included.
//
// What bounds it on an H100: as K1/K2, bf16 tensor-core operations (K1,
// bf16 rows), FFMA (f32 rows) or int8 tensor-core operations (K2) for
// every mode that scores, and bytes; MODE_STAGE reads the same bytes as
// K1/K2 (the 2^21 x 256 bf16 matrix: 0.32 ms at 3.35 TB/s) through their
// own ring of copies. Each mode differs from the next by one part of the
// work, so the four times split K1/K2 into loads, scoring, the compare
// pass, and insertions plus merge (and, in K1/K2's time, the tau pass).
// The counters cost a few integer adds per window.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success).

#include <type_traits>

#include "split_topk.cuh"

namespace {

template <typename Launch>
int by_mode(int mode, Launch&& run) {
  switch (mode) {
    case MODE_STAGE:
      return run(std::integral_constant<int, MODE_STAGE>());
    case MODE_SCORE:
      return run(std::integral_constant<int, MODE_SCORE>());
    case MODE_COMPARE:
      return run(std::integral_constant<int, MODE_COMPARE>());
    case MODE_COUNTED:
      return run(std::integral_constant<int, MODE_COUNTED>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One probe mode over the split plan, and for MODE_COUNTED the merge.
template <class Rows>
int anatomy(int mode, const Rows& rows, int N, int k, int bq, int splits,
            int per, Probe probe, const float* qscale, const Workspace& ws,
            float* out_v, int* out_i, cudaStream_t stream) {
  return by_mode(mode, [&](auto tag) {
    constexpr int MODE = decltype(tag)::value;
    cudaError_t err = launch_pass<MODE>(rows, SplitPlan{N, per, 1}, bq,
                                        splits, k, nullptr, ws.part_v,
                                        ws.part_i, stream, probe);
    if (err == cudaSuccess && MODE == MODE_COUNTED) {
      err = launch_merge(ws.part_v, ws.part_i, rows.B, splits * k, k,
                         qscale, out_v, out_i, nullptr, stream);
    }
    return static_cast<int>(err);
  });
}

template <typename T>
int anatomy_float(int mode, const float* q, const T* e, int B, int N, int D,
                  int k, int bq, int qres, int splits, int per, Probe probe,
                  void* ws_base, float* out_v, int* out_i,
                  cudaStream_t stream) {
  if (!split_args_ok(B, N, D, k, bq, splits, per, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Workspace ws = carve_workspace(ws_base, B, k, splits, 0, D,
                                       FloatKind<T>::PLANES == 3);
  cudaError_t err;
  const T* planes = query_planes<T>(q, B, D, ws, stream, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return anatomy(mode, FloatRows<T>{planes, e, nullptr, B, D, qres != 0}, N,
                 k, bq, splits, per, probe, nullptr, ws, out_v, out_i,
                 stream);
}

}  // namespace

extern "C" {

int anr_anatomy_f32(int mode, const float* q, const float* e, int B, int N,
                    int D, int k, int bq, int qres, int n_splits,
                    int docs_per_split, const float* thr, int* counts,
                    unsigned* words, float* row_max, void* ws, float* out_v,
                    int* out_i, void* stream) {
  return anatomy_float<float>(mode, q, e, B, N, D, k, bq, qres, n_splits,
                              docs_per_split,
                              Probe{thr, counts, words, row_max}, ws, out_v,
                              out_i, static_cast<cudaStream_t>(stream));
}

int anr_anatomy_bf16(int mode, const float* q, const void* e, int B, int N,
                     int D, int k, int bq, int qres, int n_splits,
                     int docs_per_split, const float* thr, int* counts,
                     unsigned* words, float* row_max, void* ws,
                     float* out_v, int* out_i, void* stream) {
  return anatomy_float<__nv_bfloat16>(
      mode, q, static_cast<const __nv_bfloat16*>(e), B, N, D, k, bq, qres,
      n_splits, docs_per_split, Probe{thr, counts, words, row_max}, ws,
      out_v, out_i, static_cast<cudaStream_t>(stream));
}

int anr_anatomy_int8(int mode, const int8_t* q_values, const float* q_scales,
                     const int8_t* values, const float* scales, int B, int N,
                     int D, int k, int bq, int n_splits, int docs_per_split,
                     const float* thr, int* counts, unsigned* words,
                     float* row_max, void* ws_base, float* out_v, int* out_i,
                     void* stream) {
  if (!split_args_ok(B, N, D, k, bq, n_splits, docs_per_split, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Workspace ws = carve_workspace(ws_base, B, k, n_splits, 0, D, false);
  return anatomy(mode, Int8Rows{q_values, values, scales, nullptr, B, D}, N,
                 k, bq, n_splits, docs_per_split,
                 Probe{thr, counts, words, row_max}, q_scales, ws, out_v,
                 out_i, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
