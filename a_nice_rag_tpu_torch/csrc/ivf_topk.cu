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
// nprobe = 16: about 290 scheduled tiles x 1024 rows x 256 x 2 B = 150 MB,
// 0.05 ms at 3.35 TB/s; its 1.2 GFLOP take 0.02 ms at the 67 TFLOP/s FFMA
// peak, so it is bound by bytes. K4 on the 10.5M x 1024 int8 IVF at B = 8,
// nprobe = 8: about 144 tiles x 2048 x 1024 B = 300 MB, 0.09 ms, also
// bound by bytes. This first version computes a 64-query block whatever
// B is, so at B = 8 seven eighths of its products are wasted: a smaller
// query block (or tensor-core tiles at B = 8) is the first thing a faster
// version changes.
//
// Design. The scoring, the running top-k and the merge are K1/K2's
// (topk_common.cuh). What differs is where a CTA's rows come from:
// * grid = (slot splits) x (query blocks of BQ). Split s walks table
//   slots s, s + n_splits, s + 2 n_splits, ... in ascending order, so
//   real entries (which come first) spread over all splits. It stops at
//   the first -1: every later slot of the table is -1 too.
// * For each slot it scores the tile's real rows in sub-tiles of TN rows;
//   the doc id is the permuted row. The per-split lists are merged by the
//   merge kernel.
// * Tie rule: a candidate enters a running list only if it beats the
//   worst entry under (score desc, row asc), and the merge ranks by the
//   same order, so the result is the exact top-k under that order
//   whatever the order of the slots.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success).

#include "topk_common.cuh"

namespace {

constexpr int KMAX_IVF = 256;

template <typename ET, bool INT8>
__global__ void __launch_bounds__(THREADS)
    ivf_split_kernel(const void* q, const ET* e, const float* escale,
                     const int* table, int max_tiles, int n_real, int B,
                     int D, int k, int tile_n, float* part_v, int* part_i) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem sm = carve(smem_raw, k);
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const long long rows = n_real > 0 ? n_real : table[max_tiles];

  init_lists(sm, k);
  for (int slot = split; slot < max_tiles; slot += n_splits) {
    const int t = table[slot];
    if (t < 0) break;  // real entries come first: the rest are -1 too
    const long long row0 = static_cast<long long>(t) * tile_n;
    const int end = static_cast<int>(min(rows, row0 + tile_n));
    for (int tile0 = static_cast<int>(row0); tile0 < end; tile0 += TN) {
      score_tile<ET, INT8>(q, e, escale, B, D, q0, tile0, end, sm);
      if (tid < TN) sm.keep[tid] = tile0 + tid < end;
      __syncthreads();
      fold_tile(sm, tile0, q0, B, k);
      __syncthreads();
    }
  }
  write_parts(sm, q0, B, k, split, n_splits, part_v, part_i);
}

template <typename ET, bool INT8>
int launch_ivf(const void* q, const ET* e, const float* escale,
               const float* qscale, const int* table, int max_tiles,
               int n_real, int B, int D, int k, int tile_n, int n_splits,
               float* part_v, int* part_i, float* out_v, int* out_i,
               cudaStream_t stream) {
  if (k < 1 || k > KMAX_IVF || B < 1 || D < 1 || tile_n < 1 ||
      max_tiles < 1 || n_real < 0 || n_splits < 1 || n_splits > max_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_split_kernel<ET, INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_splits, (B + BQ - 1) / BQ);
  ivf_split_kernel<ET, INT8><<<grid, THREADS, smem, stream>>>(
      q, e, escale, table, max_tiles, n_real, B, D, k, tile_n, part_v,
      part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(part_v, part_i, B, n_splits, k,
                                       qscale, out_v, out_i, stream));
}

}  // namespace

extern "C" {

int anr_ivf_topk_f32(const float* q, const float* e, const int* table,
                     int max_tiles, int n_real, int B, int D, int k,
                     int tile_n, int n_splits, float* part_v, int* part_i,
                     float* out_v, int* out_i, void* stream) {
  return launch_ivf<float, false>(q, e, nullptr, nullptr, table, max_tiles,
                                  n_real, B, D, k, tile_n, n_splits, part_v,
                                  part_i, out_v, out_i,
                                  static_cast<cudaStream_t>(stream));
}

int anr_ivf_topk_bf16(const float* q, const void* e, const int* table,
                      int max_tiles, int n_real, int B, int D, int k,
                      int tile_n, int n_splits, float* part_v, int* part_i,
                      float* out_v, int* out_i, void* stream) {
  return launch_ivf<__nv_bfloat16, false>(
      q, static_cast<const __nv_bfloat16*>(e), nullptr, nullptr, table,
      max_tiles, n_real, B, D, k, tile_n, n_splits, part_v, part_i, out_v,
      out_i, static_cast<cudaStream_t>(stream));
}

int anr_ivf_topk_int8(const int8_t* q_values, const float* q_scales,
                      const int8_t* values, const float* scales,
                      const int* table, int max_tiles, int n_real, int B,
                      int D, int k, int tile_n, int n_splits, float* part_v,
                      int* part_i, float* out_v, int* out_i, void* stream) {
  return launch_ivf<int8_t, true>(q_values, values, scales, q_scales, table,
                                  max_tiles, n_real, B, D, k, tile_n,
                                  n_splits, part_v, part_i, out_v, out_i,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
