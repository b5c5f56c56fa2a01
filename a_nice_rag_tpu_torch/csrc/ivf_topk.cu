// IVF-probed dense scoring + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package (a_nice_rag_tpu.ops, file
// ivf_topk.py under its TPU-kernel directory):
//   K3 ivf_dense_top_k (ivf_topk.py:143)
//      (f32 or bf16 rows, f32 queries)
//   K4 ivf_dense_top_k_int8 (ivf_topk.py:174)
//      (int8 rows with per-row scales, int8 queries with per-query scales)
//
// Contract (both): rows are a cluster-major permuted matrix [Np, D], Np a
// multiple of tile_n. The tile table [max_tiles] int32 names the tiles to
// score: real entries first, then -1. Only rows [t * tile_n,
// min((t + 1) * tile_n, n_real)) of each named tile t are candidates, so
// the padded tail never surfaces. n_real > 0 is the real-row count; with
// n_real == 0 it is read from the table's trailing slot table[max_tiles],
// on the device (no host sync). For every query: the k best permuted rows
// by (score descending, row ascending); vals [B, k] f32, ids [B, k] i32,
// unfilled slots (-inf, -1). k <= 256.
//
// What bounds it on an H100. K3 on the 2M x 256 bf16 IVF at B = 8,
// nprobe = 16: about 298 scheduled tiles x 1024 rows x 256 x 2 B = 156
// MB, 0.047 ms at 3.35 TB/s; its 3 x 2*B*rows*D = 3.7 GFLOP of bf16 MMA
// take 0.004 ms at 989 TFLOP/s: bound by bytes. K4 on the 10.5M x 1024
// int8 IVF at B = 8, nprobe = 8: about 124 tiles x 2048 x 1024 B = 260
// MB, 0.078 ms, also bound by bytes, and by latency: a table of 124 real
// tiles is fewer than the 132 SMs.
//
// Design (shared with K1/K2: split_topk.cuh, topk_common.cuh).
// * The unit of work is a (table slot, TN-row sub-tile) item: item i is
//   sub-tile i % spt of slot i / spt, spt = ceil(tile_n / TN). Block b is
//   query block b % q_blocks of walker w = b / q_blocks, which takes items
//   w, w + walkers, w + 2 walkers, ... (ascending slots) and stops at the
//   first -1 slot, read on the device. So the items of a table spread
//   over every SM. The query block is 16 for B <= 16 and 64 above;
//   ops/kernels/topk_plan.py picks the block, the walkers, whether a
//   float query block stays resident, and mirrors the walk (ivf_items).
// * Scoring: K3 as K1 (float_mma.cuh: a cp.async ring, bf16 rows on the
//   bf16 tensor cores against the exact three-piece split of the f32
//   query, f32 rows on FFMA); K4 as K2 (int8_mma.cuh: exact int32 on the
//   int8 tensor cores, selection on float(acc) * row scale).
// * tau: a first pass walks every tabled tile's rows at a stride of
//   TAU_STRIDE (below the real-row count) and the merge's tau mode gives
//   each query the k-th best of them, lowered by TAU_SLACK (-inf with
//   fewer than k): the main pass's lists start at (tau, EMPTY_ID). tau is
//   taken only from candidates, so it never passes the true k-th best.
// * The doc id is the permuted row. Tie rule: a candidate enters a
//   running list only if it beats the worst entry under (score desc, row
//   asc), and the merge ranks by the same order, so the result is the
//   exact top-k under that order whatever the order of the slots.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success). The caller allocates the workspace
// (anr_topk_workspace_bytes of fused_topk.cu, the same layout).

#include "split_topk.cuh"

namespace {

constexpr int KMAX_IVF = 256;

bool ivf_args_ok(int B, int D, int k, int tile_n, int max_tiles, int n_real,
                 int bq, int walkers, int tau_walkers) {
  return k >= 1 && k <= KMAX_IVF && B >= 1 && D >= 1 && tile_n >= 1 &&
         max_tiles >= 1 && n_real >= 0 && (bq == 16 || bq == 64) &&
         walkers >= 1 && tau_walkers >= 1;
}

template <class Rows>
int ivf(const Rows& rows, const int* table, int max_tiles, int n_real,
        int k, int tile_n, int bq, int walkers, int tau_walkers,
        const float* qscale, const Workspace& ws, float* out_v, int* out_i,
        cudaStream_t stream) {
  const IvfPlan main{table, max_tiles, n_real, tile_n, 1};
  const IvfPlan sub{table, max_tiles, n_real, tile_n, TAU_STRIDE};
  return static_cast<int>(run_topk(rows, main, walkers, sub, tau_walkers, bq,
                                   k, qscale, ws, out_v, out_i, stream));
}

template <typename T>
int ivf_float(const float* q, const T* e, const int* table, int max_tiles,
              int n_real, int B, int D, int k, int tile_n, int bq, int qres,
              int walkers, int tau_walkers, void* ws_base, float* out_v,
              int* out_i, cudaStream_t stream) {
  if (!ivf_args_ok(B, D, k, tile_n, max_tiles, n_real, bq, walkers,
                   tau_walkers)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Workspace ws = carve_workspace(ws_base, B, k, walkers, tau_walkers,
                                       D, FloatKind<T>::PLANES == 3);
  cudaError_t err;
  const T* planes = query_planes<T>(q, B, D, ws, stream, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return ivf(FloatRows<T>{planes, e, nullptr, B, D, qres != 0}, table,
             max_tiles, n_real, k, tile_n, bq, walkers, tau_walkers, nullptr,
             ws, out_v, out_i, stream);
}

}  // namespace

extern "C" {

// K3; bq: 16 or 64; qres: the query block resident in shared memory;
// walkers and tau_walkers: CTAs per query block of the main and tau
// passes.
int anr_ivf_topk_f32(const float* q, const float* e, const int* table,
                     int max_tiles, int n_real, int B, int D, int k,
                     int tile_n, int bq, int qres, int walkers,
                     int tau_walkers, void* ws, float* out_v, int* out_i,
                     void* stream) {
  return ivf_float<float>(q, e, table, max_tiles, n_real, B, D, k, tile_n,
                          bq, qres, walkers, tau_walkers, ws, out_v, out_i,
                          static_cast<cudaStream_t>(stream));
}

int anr_ivf_topk_bf16(const float* q, const void* e, const int* table,
                      int max_tiles, int n_real, int B, int D, int k,
                      int tile_n, int bq, int qres, int walkers,
                      int tau_walkers, void* ws, float* out_v, int* out_i,
                      void* stream) {
  return ivf_float<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(e), table, max_tiles, n_real, B,
      D, k, tile_n, bq, qres, walkers, tau_walkers, ws, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}

// K4.
int anr_ivf_topk_int8(const int8_t* q_values, const float* q_scales,
                      const int8_t* values, const float* scales,
                      const int* table, int max_tiles, int n_real, int B,
                      int D, int k, int tile_n, int bq, int walkers,
                      int tau_walkers, void* ws_base, float* out_v,
                      int* out_i, void* stream) {
  if (!ivf_args_ok(B, D, k, tile_n, max_tiles, n_real, bq, walkers,
                   tau_walkers)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Workspace ws = carve_workspace(ws_base, B, k, walkers, tau_walkers,
                                       D, false);
  return ivf(Int8Rows{q_values, values, scales, nullptr, B, D}, table,
             max_tiles, n_real, k, tile_n, bq, walkers, tau_walkers, q_scales,
             ws, out_v, out_i, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
