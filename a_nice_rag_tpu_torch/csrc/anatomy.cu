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
// shared-memory layout for the given k:
//   MODE_STAGE    words [ceil(B / 64)][n_splits] u32: per CTA, the XOR
//                 of the 32-bit words its staging loops wrote (the query
//                 block's f32 words or packed int8 words once per tile,
//                 the range's document words once);
//   MODE_SCORE    row_max [B] f32: the best selection score of each row
//                 (f32 rows: q . e; int8 rows: float(q8 . e8) * doc
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
// The "full" time of the ablation is K1/K2 itself (fused_topk.cu).
//
// What bounds it on an H100: as K1/K2, FFMA (K1) or __dp4a (K2)
// operations for every mode that scores; MODE_STAGE reads the same bytes
// as K1/K2 (the 2^21 x 256 bf16 matrix: 0.32 ms at 3.35 TB/s) but stages
// them into shared memory through K1's own loops and barriers. Each mode
// differs from the next by one part of the work, so the four times
// split K1/K2 into loads, scoring, the compare pass, and insertions plus
// merge. The counters cost a few integer adds per window.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success).

#include <type_traits>

#include "split_topk.cuh"

namespace {

template <typename ET, bool INT8>
int anatomy(int mode, const void* q, const ET* e, const float* escale,
            const float* qscale, int B, int N, int D, int k, int n_splits,
            int docs_per_split, Probe probe, float* part_v, int* part_i,
            float* out_v, int* out_i, cudaStream_t stream) {
  auto run = [&](auto tag) {
    return launch<ET, INT8, decltype(tag)::value>(
        q, e, escale, nullptr, qscale, B, N, D, k, n_splits, docs_per_split,
        part_v, part_i, out_v, out_i, stream, probe);
  };
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

}  // namespace

extern "C" {

int anr_anatomy_f32(int mode, const float* q, const float* e, int B, int N,
                    int D, int k, int n_splits, int docs_per_split,
                    const float* thr, int* counts, unsigned* words,
                    float* row_max, float* part_v, int* part_i, float* out_v,
                    int* out_i, void* stream) {
  return anatomy<float, false>(mode, q, e, nullptr, nullptr, B, N, D, k,
                               n_splits, docs_per_split,
                               Probe{thr, counts, words, row_max}, part_v,
                               part_i, out_v, out_i,
                               static_cast<cudaStream_t>(stream));
}

int anr_anatomy_bf16(int mode, const float* q, const void* e, int B, int N,
                     int D, int k, int n_splits, int docs_per_split,
                     const float* thr, int* counts, unsigned* words,
                     float* row_max, float* part_v, int* part_i,
                     float* out_v, int* out_i, void* stream) {
  return anatomy<__nv_bfloat16, false>(
      mode, q, static_cast<const __nv_bfloat16*>(e), nullptr, nullptr, B, N,
      D, k, n_splits, docs_per_split, Probe{thr, counts, words, row_max},
      part_v, part_i, out_v, out_i, static_cast<cudaStream_t>(stream));
}

int anr_anatomy_int8(int mode, const int8_t* q_values, const float* q_scales,
                     const int8_t* values, const float* scales, int B, int N,
                     int D, int k, int n_splits, int docs_per_split,
                     const float* thr, int* counts, unsigned* words,
                     float* row_max, float* part_v, int* part_i,
                     float* out_v, int* out_i, void* stream) {
  return anatomy<int8_t, true>(mode, q_values, values, scales, q_scales, B,
                               N, D, k, n_splits, docs_per_split,
                               Probe{thr, counts, words, row_max}, part_v,
                               part_i, out_v, out_i,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
