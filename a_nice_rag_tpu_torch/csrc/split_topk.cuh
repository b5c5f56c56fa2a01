// The doc-split streaming top-k kernels and their launchers, shared by
// K1/K2 (fused_topk.cu) and by their probes (anatomy.cu).
//
// Each CTA owns a block of queries and one contiguous range of
// docs_per_split documents, and loops over it in tiles of TN documents;
// a merge kernel combines the per-split lists. Float rows (K1):
// split_topk_kernel, grid = (doc split) x (query block of BQ = 64),
// score_tile and fold_tile of topk_common.cuh. Int8 rows (K2):
// split_topk_int8_kernel, a query block of BQN = 16 or 64 (the caller's
// choice), a 1-D grid whose block b is query block b % q_blocks of split
// b / q_blocks, so the query-block CTAs of one split are neighbours in
// the launch order and read each tile through L2 together; scoring by
// stream_int8 of int8_mma.cuh. MODE picks the work done per tile; every
// mode keeps the grid, the block and the shared-memory layout of
// MODE_FULL, and writes an output its plain version reproduces, so no
// mode's work can be compiled away:
//
//   MODE_FULL     K1/K2: score, fold into the running lists, merge.
//   MODE_STAGE    the staging alone (K1: the depth chunks of the queries
//                 and the tile into shared memory, with their barriers;
//                 K2: the query block once and the ring of doc chunks,
//                 each word read back from shared memory after its copy
//                 landed), no arithmetic: probe.words[query block *
//                 n_splits + split] = the XOR of every 32-bit word the
//                 CTA staged.
//   MODE_SCORE    + scoring into sm.scores; the fold is one running max
//                 per row: probe.row_max[b] = the best selection score
//                 of row b.
//   MODE_COMPARE  + fold_tile's ballot against the fixed per-row
//                 threshold probe.thr (lists seeded with (thr, EMPTY_ID),
//                 never inserted into): probe.counts[b] += the documents
//                 scoring at least thr[b].
//   MODE_COUNTED  MODE_FULL plus per-row, per-split counters (fold_tile's
//                 COUNT variant) in probe.counts [B][n_splits][COUNTERS];
//                 with probe.thr set, every slot starts as (thr,
//                 EMPTY_ID).
//
// The probe outputs that collect across CTAs (words, row_max, counts of
// MODE_COMPARE) are filled by atomics and start as the caller sets them:
// 0, -inf and 0.

#pragma once

#include <type_traits>

#include "int8_mma.cuh"

namespace {

constexpr int KMAX = 128;

enum Mode : int {
  MODE_FULL = 0,
  MODE_STAGE = 1,
  MODE_SCORE = 2,
  MODE_COMPARE = 3,
  MODE_COUNTED = 4
};

struct Probe {
  const float* thr;
  int* counts;
  unsigned* words;
  float* row_max;
};

// Exact float max through the integer atomics: floats with the sign bit
// clear order as signed ints, those with it set (-0.0 included) reversed
// as unsigned ints.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

struct XorTap {
  unsigned x = 0;
  __device__ __forceinline__ void operator()(unsigned w) { x ^= w; }
};

// Per-tile parts of the modes, shared by the float and int8 kernels.

// MODE_SCORE: fold the tile's kept scores into each row's running max
// (rows warp + WARPS * m).
template <int BQN>
__device__ __forceinline__ void tile_row_max(const SmemT<BQN>& sm,
                                             float (&best)[BQN / WARPS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < BQN / WARPS; ++m) {
    const int r = warp + WARPS * m;
    for (int c = lane; c < TN; c += 32) {
      if (sm.keep[c]) best[m] = fmaxf(best[m], sm.scores[r * (TN + 1) + c]);
    }
  }
}

template <int BQN>
__device__ __forceinline__ void publish_row_max(const float (&best)[BQN / WARPS],
                                                int q0, int B, Probe probe) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < BQN / WARPS; ++m) {
    float v = best[m];
    for (int off = 16; off > 0; off >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    }
    const int row = q0 + warp + WARPS * m;
    if (lane == 0 && row < B && v > -INFINITY) {
      atomic_max_f32(probe.row_max + row, v);
    }
  }
}

// MODE_FULL, MODE_COMPARE, MODE_COUNTED: fold tile j (first document
// tile0) of the CTA's range.
template <int MODE, int BQN>
__device__ __forceinline__ void fold_mode(const SmemT<BQN>& sm, int j,
                                          int tile0, int q0, int B, int k,
                                          int* counts) {
  if constexpr (MODE == MODE_FULL) {
    fold_tile(sm, tile0, q0, B, k);
  } else if constexpr (MODE == MODE_COMPARE) {
    fold_tile<false>(sm, tile0, q0, B, k, counts);
  } else {
    fold_tile<true, true>(sm, tile0, q0, B, k, counts, j < EARLY_TILES);
  }
}

// After the last tile: the probe counters out, the running lists to the
// split's partial outputs.
template <int MODE, int BQN>
__device__ __forceinline__ void finish(const SmemT<BQN>& sm, const int* counts,
                                       int q0, int B, int k, int split,
                                       int n_splits, float* part_v,
                                       int* part_i, Probe probe) {
  const int tid = threadIdx.x;
  if constexpr (MODE == MODE_COMPARE) {
    for (int r = tid; r < BQN && q0 + r < B; r += THREADS) {
      atomicAdd(probe.counts + q0 + r, counts[r * COUNTERS]);
    }
    return;
  }
  if constexpr (MODE == MODE_COUNTED) {
    for (int x = tid; x < BQN * COUNTERS; x += THREADS) {
      const int r = x / COUNTERS;
      if (q0 + r < B) {
        probe.counts[(static_cast<size_t>(q0 + r) * n_splits + split) *
                         COUNTERS + x % COUNTERS] = counts[x];
      }
    }
  }
  write_parts(sm, q0, B, k, split, n_splits, part_v, part_i);
}

__device__ __forceinline__ void publish_xor(unsigned x, unsigned* out) {
  for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(FULL, x, off);
  if (threadIdx.x % 32 == 0) atomicXor(out, x);
}

template <typename ET, int MODE>
__global__ void __launch_bounds__(THREADS)
    split_topk_kernel(const float* q, const ET* e, const uint8_t* mask,
                      int B, int N, int D, int k, int docs_per_split,
                      float* part_v, int* part_i, Probe probe) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem sm = carve(smem_raw, k);
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int begin = split * docs_per_split;
  const int end = min(N, begin + docs_per_split);
  const int tid = threadIdx.x;

  if constexpr (MODE == MODE_STAGE) {
    XorTap tap;
    for (int tile0 = begin; tile0 < end; tile0 += TN) {
      score_tile<ET, false>(q, e, B, D, q0, tile0, end, sm, tap);
    }
    publish_xor(tap.x, probe.words + blockIdx.y * n_splits + split);
    return;
  }

  if constexpr (MODE == MODE_SCORE) {
    float best[BQ / WARPS];
#pragma unroll
    for (int m = 0; m < BQ / WARPS; ++m) best[m] = -INFINITY;
    for (int tile0 = begin; tile0 < end; tile0 += TN) {
      score_tile<ET>(q, e, B, D, q0, tile0, end, sm);
      if (tid < TN) {
        int doc = tile0 + tid;
        sm.keep[tid] = doc < end && (mask == nullptr || mask[doc] != 0);
      }
      __syncthreads();
      tile_row_max(sm, best);
      __syncthreads();
    }
    publish_row_max<BQ>(best, q0, B, probe);
    return;
  }

  // MODE_FULL, MODE_COMPARE and MODE_COUNTED fold; the probes keep
  // counters in shared memory past the MODE_FULL layout.
  int* counts = reinterpret_cast<int*>(smem_raw + smem_bytes(k));
  if constexpr (MODE != MODE_FULL) {
    for (int x = tid; x < BQ * COUNTERS; x += THREADS) counts[x] = 0;
  }
  init_lists(sm, k, MODE == MODE_FULL ? nullptr : probe.thr, q0, B);
  for (int tile0 = begin; tile0 < end; tile0 += TN) {
    score_tile<ET>(q, e, B, D, q0, tile0, end, sm);
    if (tid < TN) {
      int doc = tile0 + tid;
      sm.keep[tid] = doc < end && (mask == nullptr || mask[doc] != 0);
    }
    __syncthreads();
    fold_mode<MODE>(sm, (tile0 - begin) / TN, tile0, q0, B, k, counts);
    __syncthreads();
  }
  finish<MODE>(sm, counts, q0, B, k, split, n_splits, part_v, part_i,
               probe);
}

// K2 and its probe modes. Block b: query block b % q_blocks of split
// b / q_blocks (n_splits splits). Up to 3 CTAs per SM at BQN = 16 and 2
// at 64, as shared memory allows.
template <int BQN, int MODE>
__global__ void __launch_bounds__(THREADS, BQN == 16 ? 3 : 2)
    split_topk_int8_kernel(const int8_t* q, const int8_t* e,
                           const float* escale, const uint8_t* mask, int B,
                           int N, int D, int k, int n_splits,
                           int docs_per_split, float* part_v, int* part_i,
                           Probe probe) {
  extern __shared__ __align__(128) char smem_raw[];
  const SmemT<BQN> sm = carve_int8<BQN>(smem_raw, D, k);
  const int q_blocks = (B + BQN - 1) / BQN;
  const int qb = blockIdx.x % q_blocks;
  const int split = blockIdx.x / q_blocks;
  const int q0 = qb * BQN;
  const int begin = split * docs_per_split;
  const SplitWalk walk{begin, min(N, begin + docs_per_split)};
  const int tid = threadIdx.x;

  if constexpr (MODE == MODE_STAGE) {
    const unsigned x = stream_int8<BQN, false>(
        q, e, escale, mask, B, D, q0, walk, sm, [](int, int, int) {});
    publish_xor(x, probe.words + qb * n_splits + split);
    return;
  }

  if constexpr (MODE == MODE_SCORE) {
    float best[BQN / WARPS];
#pragma unroll
    for (int m = 0; m < BQN / WARPS; ++m) best[m] = -INFINITY;
    stream_int8<BQN, true>(q, e, escale, mask, B, D, q0, walk, sm,
                           [&](int, int, int) { tile_row_max(sm, best); });
    publish_row_max<BQN>(best, q0, B, probe);
    return;
  }

  int* counts = reinterpret_cast<int*>(smem_raw + smem_bytes_int8(BQN, D, k));
  if constexpr (MODE != MODE_FULL) {
    for (int x = tid; x < BQN * COUNTERS; x += THREADS) counts[x] = 0;
  }
  init_lists(sm, k, MODE == MODE_FULL ? nullptr : probe.thr, q0, B);
  stream_int8<BQN, true>(q, e, escale, mask, B, D, q0, walk, sm,
                         [&](int j, int t0, int) {
                           fold_mode<MODE>(sm, j, t0, q0, B, k, counts);
                         });
  __syncthreads();
  finish<MODE>(sm, counts, q0, B, k, split, n_splits, part_v, part_i,
               probe);
}

// Launch the float split kernel (and, for MODE_FULL and MODE_COUNTED, the
// merge). The probe modes take k too: it sets the shared-memory layout,
// and with it the CTAs per SM, so a mode runs at MODE_FULL's occupancy.
template <typename ET, int MODE = MODE_FULL>
int launch(const float* q, const ET* e, const uint8_t* mask, int B, int N,
           int D, int k, int n_splits, int docs_per_split, float* part_v,
           int* part_i, float* out_v, int* out_i, cudaStream_t stream,
           Probe probe = Probe{nullptr, nullptr, nullptr, nullptr}) {
  if (k < 1 || k > KMAX || B < 1 || N < 1 || D < 1 || n_splits < 1 ||
      docs_per_split < 1 || docs_per_split % TN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      smem_bytes(k) + (MODE == MODE_FULL ? 0 : sizeof(int) * BQ * COUNTERS);
  cudaError_t err = cudaFuncSetAttribute(
      split_topk_kernel<ET, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_splits, (B + BQ - 1) / BQ);
  split_topk_kernel<ET, MODE><<<grid, THREADS, smem, stream>>>(
      q, e, mask, B, N, D, k, docs_per_split, part_v, part_i, probe);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (MODE != MODE_FULL && MODE != MODE_COUNTED) return 0;
  return static_cast<int>(launch_merge(part_v, part_i, B, n_splits, k,
                                       nullptr, out_v, out_i, stream));
}

template <int BQN, int MODE>
int launch_int8_bq(const int8_t* q, const int8_t* e, const float* escale,
                   const uint8_t* mask, const float* qscale, int B, int N,
                   int D, int k, int n_splits, int docs_per_split,
                   float* part_v, int* part_i, float* out_v, int* out_i,
                   cudaStream_t stream, Probe probe) {
  const size_t smem = smem_bytes_int8(BQN, D, k) +
                      (MODE == MODE_FULL ? 0 : sizeof(int) * BQN * COUNTERS);
  cudaError_t err = cudaFuncSetAttribute(
      split_topk_int8_kernel<BQN, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_splits * ((B + BQN - 1) / BQN);
  split_topk_int8_kernel<BQN, MODE><<<blocks, THREADS, smem, stream>>>(
      q, e, escale, mask, B, N, D, k, n_splits, docs_per_split, part_v,
      part_i, probe);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (MODE != MODE_FULL && MODE != MODE_COUNTED) return 0;
  return static_cast<int>(launch_merge(part_v, part_i, B, n_splits, k,
                                       qscale, out_v, out_i, stream));
}

// Launch the int8 split kernel for a query block of bq (16 or 64), and
// the merge as launch does.
template <int MODE = MODE_FULL>
int launch_int8(const int8_t* q, const int8_t* e, const float* escale,
                const uint8_t* mask, const float* qscale, int B, int N,
                int D, int k, int bq, int n_splits, int docs_per_split,
                float* part_v, int* part_i, float* out_v, int* out_i,
                cudaStream_t stream,
                Probe probe = Probe{nullptr, nullptr, nullptr, nullptr}) {
  if (k < 1 || k > KMAX || B < 1 || N < 1 || D < 1 || n_splits < 1 ||
      docs_per_split < 1 || docs_per_split % TN != 0 ||
      (bq != 16 && bq != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = [&](auto kernel_bq) {
    return launch_int8_bq<decltype(kernel_bq)::value, MODE>(
        q, e, escale, mask, qscale, B, N, D, k, n_splits, docs_per_split,
        part_v, part_i, out_v, out_i, stream, probe);
  };
  return bq == 16 ? run(std::integral_constant<int, 16>())
                  : run(std::integral_constant<int, 64>());
}

}  // namespace
