// The rounded folds and the bf16 compare fold for Hopper (sm_90a): K2r
// (int8 rows), K1r and K1c (bf16 rows), one kernel with the row type as a
// compile-time parameter: a cluster of query blocks on one TMA-multicast
// doc stream, wgmma scoring and a threshold epilogue in registers.
//
// Replaces the TPU kernels of the JAX package's packed and compare folds
// (a_nice_rag_tpu.ops, fused_topk.py under its TPU-kernel directory):
//   K2r _kernel_packed_int8 (fused_topk.py:377; selected at :1291-1295,
//       launched at :1398), fused_dense_top_k_int8(..., algo="packed");
//   K1r _kernel_packed (fused_topk.py:359; launched at :1649),
//       fused_dense_top_k(..., algo="packed") on bf16 rows;
//   K1c _kernel_iterate with compare_dtype="bfloat16" (fused_topk.py:921,
//       product at :945-951) on bf16 rows.
//
// Contract: for every query, the k best documents by (score desc, doc id
// asc) under the fold's selection score (topk_common.cuh's
// selection_score): K2r bf16(float(acc) * doc_scale), acc the exact int32
// dot of the int8 query and row, -0.0 carried below +0.0, values times
// the query scale after selection; K1r bf16(f32 product of the f32 query
// and the bf16 row), -0.0 carried below +0.0; K1c bf16(f32 product of
// bf16(q) and the row), -0.0 and +0.0 tied as floats; rounding to
// nearest, ties to even. values [B, k] f32 (the rounded scores), ids
// [B, k] i32, unfilled slots (-inf, -1); K1c takes an optional [N] bool
// mask (masked documents are never candidates). The callers
// (ops/kernels/fused_topk.py) route K2r's maskless calls over N % 1024
// == 0 rows past one 16-query block here, and K1r's and K1c's calls on
// bf16 rows past their measured batch whose plan keeps the query planes
// resident on the TMA route; the kernel itself takes any N, B, D, 1 <= k
// <= 128 and rows at any address (bf16 rows: with the query planes
// resident).
//
// What bounds it on an H100. K2r at 10,485,760 x 1024 int8, B = 256, k =
// 25 reads 10.7 GB of rows (3.22 ms at 3.35 TB/s) for 5.5 T int8
// operations (2.78 ms at 1,979 TOP/s): bound by its bytes. K1r at 2^21 x
// 256 bf16, B = 256, k = 32 does three bf16 products a score (825 GFLOP,
// 0.83 ms at 989 TFLOP/s) on 1.07 GB of rows (0.32 ms): bound by its
// operations; K1c one (275 GFLOP, 0.28 ms): bound by its bytes. K2's and
// K1's kernels, which these folds ran on before (int8_mma.cuh,
// float_mma.cuh), stream the whole matrix once per 64-query block,
// multiply on mma.sync with ldmatrix fragments and store every score in a
// [64][TN + 1] shared tile that one warp per row compares.
//
// Design: each doc byte leaves HBM once per group of query blocks, the
// multiply runs on wgmma straight from the TMA's tiles, and the selection
// touches only the rare scores that can enter a list.
// * Work split (ops/kernels/cluster_topk.py's cluster_plan). A CTA owns QG
//   x 64 queries, resident in shared memory ([chunk][plane][QG x 64][128
//   bytes], 128-byte swizzle): QG = 1, both consumer warpgroups multiply
//   the CTA's 64 queries against 128 docs each of a T = 256-doc tile; QG =
//   2, each warpgroup its own 64 queries against the T = 128-doc tile. The
//   query blocks of a call, up to MAX_CLUSTER of them, form one
//   thread-block cluster; B past MAX_CLUSTER blocks takes further groups
//   of clusters side by side. Persistent clusters, as many as
//   cudaOccupancyMaxActiveClusters reports, each walk one contiguous range
//   of tiles, so a planted cluster of similar rows falls to one walker,
//   whose threshold its first rows raise.
// * Stream. A 2-D tensor map over the rows' bytes (64-row x 128-byte
//   boxes: 128 int8 or 64 bf16 of depth, 128-byte swizzle); each CTA of
//   the cluster issues a share of a chunk's boxes with .multicast::cluster
//   into a ring of slots guarded by full / empty mbarriers; one producer
//   warp issues, and each consumer warpgroup of every CTA hands a slot
//   back with one relaxed remote arrival per CTA (tma_ring.cuh, shared
//   with int4.cu).
// * Multiply, with the queries as A and the docs as B, both read straight
//   from the swizzled tiles, waited on before any accumulator is read.
//   int8 rows: wgmma m64n128k32 s8, exact int32 sums. bf16 rows:
//   wgmma m64n128k16 bf16 on the query's planes: K1r the f32 query's three
//   bf16 planes hi, mid, lo (split_query_kernel, exact: a bf16 doc value
//   times a plane is exact in f32), K1c one plane bf16(q). Every 16-deep
//   k-step's planes (lo, mid, hi) chain onto the tile's f32 sums in the
//   wgmma accumulator, zeroed as the tile starts; a chunk's products stay
//   in flight while the next slot is waited on, and its slot goes back
//   once they are done (int8 rows wait on each chunk). K1's kernel
//   (float_mma.cuh) instead sums each k-step into a zeroed fragment and
//   adds it by FADD, keeping the tensor core's truncating accumulation
//   local to 16 x 3 products; that costs a wait a k-step, 0.4-0.5 ms of
//   this kernel at 2^21 x 256, B = 256 on an H100
//   (PERF.md, K1r / K1c), while the chained sums gave top-k lists equal to
//   the FADD ones and to K1's kernel's there, and stay within the one
//   bf16 ulp the checks allow on random rows (exact on integer grids,
//   whose partial sums are exact in any order).
// * Epilogue in registers, no scores tile. Each thread holds 64
//   accumulators (2 queries x 32 docs); the tile's doc multipliers are
//   loaded as it starts, one a thread, and read from shared memory once
//   its chunks are multiplied: int8 rows their scales, bf16 rows 1 for a
//   candidate and NaN for a masked doc or a row past N (NaN passes no
//   bound, and x * 1 is x). Each unrounded score x = acc * multiplier is
//   compared with a bound below its row's threshold by the most bf16
//   rounding can move it (prefilter_bound), kept as a 64-bit mask of the
//   thread's hits. Only hits are offered, one a lane a round (insert_hits):
//   the selection score of x, rows past N (zero-filled by the TMA: a 0
//   would beat every negative score) never candidates, against the row's
//   running top-k in shared memory, a binary heap with the worst entry
//   under (score desc, id asc) on top, rows an odd count of entries apart
//   (the eight rows a warp offers to at once in distinct banks): a doc
//   that beats the top takes its place and sifts down. The four lanes that
//   hold a row offer in turn, the warp's eight rows side by side; where
//   two warps share a row (QG = 1) under the row's lock. Offers compare
//   (score, id), so docs may arrive in any order: each heap is always the
//   top k of what it was offered. The thresholds are the tops, or (a row the
//   other warpgroup also fills) the top's score with the largest id: they
//   only rise, so nothing that could enter is skipped; when every doc is
//   a hit (tau = -inf, all-equal rows) the heaps take them one by one and
//   nothing is dropped.
// * tau warm start, in two steps: the same kernel over every SEED_STRIDE-th
//   row (4096th) and the merge in its tau mode give a first bound; then
//   over every TAU_STRIDE-th row (64th), lists seeded with that bound
//   (those rows are among its own, so its k-th best is the same as
//   unseeded), and the merge give tau[b], the k-th best subsample score
//   lowered by TAU_SLACK (bf16 rows: each merge gives its pass's top k
//   itself, and the next pass seeds each walker's lists with those of
//   them outside the walker's rows, lowered, and the k-th of them for the
//   rest: seed_lists). Each pass reads its rows (and K1c's mask)
//   through a tensor map whose row stride is its stride x the row's bytes
//   (no copy), and scores a row with the main pass's instructions, so its
//   scores are the main pass's. The main pass seeds every heap with (tau,
//   EMPTY_ID) (K2r) or as seed_lists says (K1r, K1c): with tau alone a
//   walker's threshold stays at tau until k docs have come in, and a
//   walker of the 2^21-row main path at B = 256, k = 32 meets only some
//   30-60 docs past tau. The merge of the walkers' lists then runs
//   unchanged, with
//   K2r's query scales and the rounded -0.0 written back.
//   Nothing syncs to the host.
// * Rows the TMA cannot take (a base not 16-byte aligned, such as
//   values[1:], row bytes not a multiple of 16 or under 128, or fewer than
//   64 rows) go through the producer warp's element loads into the same
//   layout, with no cluster; an int8 query block that does not fit beside
//   two ring slots streams through the ring with each doc chunk (element
//   loads). bf16 rows keep their query planes resident.
//
// The kernel, its launchers and a whole call's passes are in
// cluster_topk.cuh, shared with the probes of this design
// (cluster_probe.cu), which also run it on K1's and K2's exact scores.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success). The caller allocates the workspace
// (anr_cluster_workspace_bytes).

#include "cluster_topk.cuh"

namespace {

// The folds' MODE_FULL passes: the rounded and compare kinds.
cudaError_t fold_pass(int kind, const Shape& p, const Args& a, int tma,
                      cudaStream_t s) {
  switch (kind) {
    case ROWS_INT8:
      return run_full<ROWS_INT8>(p, a, tma, s);
    case ROWS_BF16_ROUNDED:
      return run_full<ROWS_BF16_ROUNDED>(p, a, tma, s);
    case ROWS_BF16_COMPARE:
      return run_full<ROWS_BF16_COMPARE>(p, a, tma, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool fold_kind(int kind) {
  return kind == ROWS_INT8 || kind == ROWS_BF16_ROUNDED ||
         kind == ROWS_BF16_COMPARE;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a CTA of rows ``kind`` (RowKind) at depth D;
// ``counted``: with MODE_COUNTED's counters.
long long anr_cluster_smem_bytes(int kind, int qg, int D, int k, int stages,
                                 int resident, int counted) {
  if (!kind_ok(kind)) return -1;
  return smem_bytes(qg, chunks(kind, D), planes_of(kind), k, stages,
                    resident != 0, counted != 0);
}

// Clusters of cl CTAs of a fold's rows ``kind`` (qg query groups, smem
// bytes each) that the card holds at once (a negative cudaError_t on
// failure).
int anr_cluster_active_clusters(int kind, int qg, int cl, int smem) {
  switch (kind) {
    case ROWS_INT8:
      return active_clusters_of<ROWS_INT8, MODE_FULL>(qg, cl, smem);
    case ROWS_BF16_ROUNDED:
      return active_clusters_of<ROWS_BF16_ROUNDED, MODE_FULL>(qg, cl, smem);
    case ROWS_BF16_COMPARE:
      return active_clusters_of<ROWS_BF16_COMPARE, MODE_FULL>(qg, cl, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

long long anr_cluster_workspace_bytes(int kind, int B, int D, int k,
                                      int walkers, int tau_walkers,
                                      int seed_walkers) {
  if (!kind_ok(kind)) return -1;
  return static_cast<long long>(workspace_bytes(
      kind, B, D, k, walkers, tau_walkers, seed_walkers));
}

// K2r over int8 rows with their scales, the query scales applied after
// selection.
int anr_cluster_topk(const int8_t* q, const float* q_scales,
                     const int8_t* e, const float* scales, int B, int N,
                     int D, int k, int qg, int cl, int groups, int stages,
                     int resident, int smem, int tma, int walkers,
                     int tau_tma, int tau_walkers, int seed_tma,
                     int seed_walkers, void* ws_base, float* out_v,
                     int* out_i, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if (!shape_ok(ROWS_INT8, p, B, D, k) || N < 1 || walkers < 1 ||
      tau_walkers < 1 || seed_walkers < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Workspace ws =
      carve(ws_base, B, k, walkers, tau_walkers, seed_walkers, 0, false);
  return static_cast<int>(run_call(
      fold_pass, ROWS_INT8, p, q, q_scales, e, scales, nullptr, B, N, D, k,
      tma, walkers, tau_tma, tau_walkers, seed_tma, seed_walkers, ws, out_v,
      out_i, static_cast<cudaStream_t>(stream)));
}

// K1r (kind ROWS_BF16_ROUNDED: q the f32 query [B][D], split into its
// three bf16 planes in the workspace first) or K1c (ROWS_BF16_COMPARE: q
// bf16(q) [B][D]) over bf16 rows e, with an optional [N] mask (bytes, 0:
// not a candidate).
int anr_cluster_topk_bf16(int kind, const void* q, const void* e,
                          const uint8_t* mask, int B, int N, int D, int k,
                          int qg, int cl, int groups, int stages,
                          int resident, int smem, int tma, int walkers,
                          int tau_tma, int tau_walkers, int seed_tma,
                          int seed_walkers, void* ws_base, float* out_v,
                          int* out_i, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if (!fold_kind(kind) || is_int8(kind) || !shape_ok(kind, p, B, D, k) ||
      N < 1 || walkers < 1 || tau_walkers < 1 || seed_walkers < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(ws_base, B, k, walkers, tau_walkers,
                             seed_walkers, piece_bytes(kind, B, D), true);
  const int8_t* planes;
  const cudaError_t err = bf16_planes(kind, q, B, D, ws, s, &planes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_call(
      fold_pass, kind, p, planes, nullptr, static_cast<const int8_t*>(e),
      nullptr, mask, B, N, D, k, tma, walkers, tau_tma, tau_walkers,
      seed_tma, seed_walkers, ws, out_v, out_i, s));
}

}  // extern "C"
