// Probes of the cluster kernel for Hopper (sm_90a): where its time goes,
// and how often its running lists take a document, for every row kind it
// runs, K1's and K2's exact scores included.
//
// Replaces these TPU kernels of the repository on the cluster design
// (anatomy.cu keeps them on K1's and K2's split kernel):
//   P4 scripts/profile_kernel_anatomy.py:138, the ablation of the fused
//      top-k kernel: four kernels on one launcher that differ only in the
//      work per tile (visit_dma_only :65, visit_mm_only :80,
//      visit_mm_trigger :100, visit_full :127);
//   P5 scripts/probe_iteration_count.py:160, the production fold with
//      counters (fold_counting :69, kernel :103) and an optional per-row
//      threshold taken from a subsample (:57-67).
//
// Contract. anr_cluster_probe runs one pass of cluster_topk.cuh's kernel
// over every row, on the TMA route with the query planes resident, in
// one of its modes (cluster_topk.cuh states each mode's output): the
// query planes as the kind multiplies them (int8 q; the f32 query's three
// bf16 planes; bf16(q)); MODE_FULL and MODE_COUNTED seed the lists with
// (seed[b], EMPTY_ID), or from an earlier pass's top k (list_v / list_i,
// every list_every-th row: seed_lists), or at -inf, and merge the
// walkers' lists into out_v / out_i [B][k] (int8 kinds times q_scales,
// the rounded -0.0 written back). The exact kinds select on the unrounded
// score: int8 rows float(acc) * doc scale with the query scale applied
// after selection, (acc . s_d) . s_q as K2 does (a_nice_rag_tpu's
// fused_topk.py:1218); bf16 rows the f32 sums of the f32 query's three
// bf16 planes against the row, K1's function on bf16 rows
// (fused_topk.py:1440), its sums chained in the wgmma accumulator, so
// within f32 ulps of K1's; ±0.0 tie as floats and the lower id wins.
// anr_cluster_exact_topk is the whole call of an exact kind (the seed,
// tau and main passes and the merges, as cluster_topk.cu's folds run
// theirs): K1's or K2's lists on this design, P4's "full".
//
// What bounds it on an H100: as the folds, the rows' bytes (int8 rows at
// 10,485,760 x 1024: 10.7 GB, 3.22 ms at 3.35 TB/s) or the bf16 tensor
// cores (three planes at 2^21 x 256, B = 256: 825 GFLOP, 0.83 ms at 989
// TFLOP/s). MODE_STAGE reads the same bytes through the same ring and
// multiplies nothing; MODE_SCORE adds wgmma and a max a score;
// MODE_COMPARE the epilogue's test; MODE_FULL the offers and the merge.
// MODE_COUNTED's counters cost a compare a hit, a snapshot of two heap
// tops a tile and (QG = 1) a second barrier a tile.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success).

#include "cluster_topk.cuh"

namespace {

template <int R, int QG>
cudaError_t launch_probe(const Args& a, int mode, int groups, int smem,
                         cudaStream_t s) {
  switch (mode) {
    case MODE_FULL:
      return launch_kernel<R, QG, true, true, MODE_FULL>(a, groups, smem, s);
    case MODE_STAGE:
      return launch_kernel<R, QG, true, true, MODE_STAGE>(a, groups, smem, s);
    case MODE_SCORE:
      return launch_kernel<R, QG, true, true, MODE_SCORE>(a, groups, smem, s);
    case MODE_COMPARE:
      return launch_kernel<R, QG, true, true, MODE_COMPARE>(a, groups, smem,
                                                            s);
    case MODE_COUNTED:
      return launch_kernel<R, QG, true, true, MODE_COUNTED>(a, groups, smem,
                                                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t run_probe(const Shape& p, const Args& a, int mode,
                      cudaStream_t s) {
  if (a.per_group < 1 || !tma_ok(a, p.resident)) return cudaErrorInvalidValue;
  return p.qg == 1 ? launch_probe<R, 1>(a, mode, p.groups, p.smem, s)
                   : launch_probe<R, 2>(a, mode, p.groups, p.smem, s);
}

cudaError_t probe_pass(int kind, const Shape& p, const Args& a, int mode,
                       cudaStream_t s) {
  switch (kind) {
    case ROWS_INT8:
      return run_probe<ROWS_INT8>(p, a, mode, s);
    case ROWS_BF16_ROUNDED:
      return run_probe<ROWS_BF16_ROUNDED>(p, a, mode, s);
    case ROWS_BF16_COMPARE:
      return run_probe<ROWS_BF16_COMPARE>(p, a, mode, s);
    case ROWS_INT8_EXACT:
      return run_probe<ROWS_INT8_EXACT>(p, a, mode, s);
    case ROWS_BF16_EXACT:
      return run_probe<ROWS_BF16_EXACT>(p, a, mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The exact kinds' MODE_FULL passes of a whole call, on any route.
cudaError_t exact_pass(int kind, const Shape& p, const Args& a, int tma,
                       cudaStream_t s) {
  switch (kind) {
    case ROWS_INT8_EXACT:
      return run_full<ROWS_INT8_EXACT>(p, a, tma, s);
    case ROWS_BF16_EXACT:
      return run_full<ROWS_BF16_EXACT>(p, a, tma, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int MODE>
int active_of(int kind, int qg, int cl, int smem) {
  switch (kind) {
    case ROWS_INT8:
      return active_clusters_of<ROWS_INT8, MODE>(qg, cl, smem);
    case ROWS_BF16_ROUNDED:
      return active_clusters_of<ROWS_BF16_ROUNDED, MODE>(qg, cl, smem);
    case ROWS_BF16_COMPARE:
      return active_clusters_of<ROWS_BF16_COMPARE, MODE>(qg, cl, smem);
    case ROWS_INT8_EXACT:
      return active_clusters_of<ROWS_INT8_EXACT, MODE>(qg, cl, smem);
    case ROWS_BF16_EXACT:
      return active_clusters_of<ROWS_BF16_EXACT, MODE>(qg, cl, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Clusters of cl CTAs of rows ``kind`` in ``mode`` (qg query groups, smem
// bytes each) that the card holds at once (a negative cudaError_t on
// failure).
int anr_cluster_probe_active_clusters(int kind, int mode, int qg, int cl,
                                      int smem) {
  switch (mode) {
    case MODE_FULL:
      return active_of<MODE_FULL>(kind, qg, cl, smem);
    case MODE_STAGE:
      return active_of<MODE_STAGE>(kind, qg, cl, smem);
    case MODE_SCORE:
      return active_of<MODE_SCORE>(kind, qg, cl, smem);
    case MODE_COMPARE:
      return active_of<MODE_COMPARE>(kind, qg, cl, smem);
    case MODE_COUNTED:
      return active_of<MODE_COUNTED>(kind, qg, cl, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// One pass of rows ``kind`` in ``mode`` over all N rows (see the top of
// this file and of cluster_topk.cuh for the outputs); part_v / part_i
// [B][walkers][k] the walkers' lists of MODE_FULL and MODE_COUNTED.
int anr_cluster_probe(int kind, int mode, const void* q,
                      const float* q_scales, const void* e,
                      const float* scales, const uint8_t* mask,
                      const float* seed, const float* list_v,
                      const int* list_i, int list_every, int B, int N, int D,
                      int k, int qg, int cl, int groups, int stages,
                      int resident, int smem, int walkers, float* part_v,
                      int* part_i, unsigned* words, float* best, int* counts,
                      float* out_v, int* out_i, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  const bool fold = mode == MODE_FULL || mode == MODE_COUNTED;
  const bool lists = list_v != nullptr || list_i != nullptr;
  if (!kind_ok(kind) || mode < MODE_FULL || mode > MODE_COUNTED ||
      !shape_ok(kind, p, B, D, k, mode == MODE_COUNTED) || N < 1 ||
      walkers < 1 || (is_int8(kind) && scales == nullptr) ||
      (is_int8(kind) && fold && q_scales == nullptr) ||
      (mode == MODE_STAGE && words == nullptr) ||
      (mode == MODE_SCORE && best == nullptr) ||
      (mode == MODE_COMPARE && (counts == nullptr || seed == nullptr)) ||
      (mode == MODE_COUNTED && counts == nullptr) ||
      (fold && (part_v == nullptr || part_i == nullptr || out_v == nullptr ||
                out_i == nullptr)) ||
      (lists && (!fold || seed != nullptr || list_v == nullptr ||
                 list_i == nullptr || list_every < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  Args a = pass_args(p, static_cast<const int8_t*>(q),
                     static_cast<const int8_t*>(e), scales, mask, B, N,
                     D * elem_bytes(kind), k, 1, walkers);
  a.seed = seed;
  a.list_v = list_v;
  a.list_i = list_i;
  a.list_every = list_every;
  a.part_v = part_v;
  a.part_i = part_i;
  a.words = words;
  a.best = best;
  a.counts = counts;
  cudaError_t err = probe_pass(kind, p, a, mode, s);
  if (err != cudaSuccess || !fold) return static_cast<int>(err);
  return static_cast<int>(launch_merge(
      part_v, part_i, B, walkers * k, k, is_int8(kind) ? q_scales : nullptr,
      out_v, out_i, nullptr, s, unrounds(kind)));
}

// The whole call of an exact kind (ROWS_INT8_EXACT: q the int8 queries,
// q_scales and scales; ROWS_BF16_EXACT: q the f32 query [B][D], split into
// its three bf16 planes in the workspace first, scales and q_scales
// null): the seed, tau and main passes and the merges, as the folds'
// (anr_cluster_topk_bf16's list seeding for bf16 rows, anr_cluster_topk's
// tau for int8). The workspace: anr_cluster_workspace_bytes.
int anr_cluster_exact_topk(int kind, const void* q, const float* q_scales,
                           const void* e, const float* scales, int B, int N,
                           int D, int k, int qg, int cl, int groups,
                           int stages, int resident, int smem, int tma,
                           int walkers, int tau_tma, int tau_walkers,
                           int seed_tma, int seed_walkers, void* ws_base,
                           float* out_v, int* out_i, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if ((kind != ROWS_INT8_EXACT && kind != ROWS_BF16_EXACT) ||
      !shape_ok(kind, p, B, D, k) || N < 1 || walkers < 1 ||
      tau_walkers < 1 || seed_walkers < 1 ||
      (is_int8(kind) && (scales == nullptr || q_scales == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Workspace ws =
      carve(ws_base, B, k, walkers, tau_walkers, seed_walkers,
            piece_bytes(kind, B, D), !is_int8(kind));
  const int8_t* planes = static_cast<const int8_t*>(q);
  if (!is_int8(kind)) {
    const cudaError_t err = bf16_planes(kind, q, B, D, ws, s, &planes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(run_call(
      exact_pass, kind, p, planes, is_int8(kind) ? q_scales : nullptr,
      static_cast<const int8_t*>(e), scales, nullptr, B, N, D, k, tma,
      walkers, tau_tma, tau_walkers, seed_tma, seed_walkers, ws, out_v,
      out_i, s));
}

}  // extern "C"
