// The doc-split streaming top-k kernel and its launcher, shared by K1/K2
// (fused_topk.cu) and by their probes (anatomy.cu).
//
// grid = (doc split) x (query block): each CTA owns BQ queries and one
// contiguous range of docs_per_split documents, and loops over it in
// tiles of TN documents (score_tile, fold_tile of topk_common.cuh); a
// merge kernel combines the per-split lists. MODE picks the work done
// per tile; every mode keeps the grid, the block and the shared-memory
// layout of MODE_FULL, and writes an output its plain version
// reproduces, so no mode's work can be compiled away:
//
//   MODE_FULL     K1/K2: score, fold into the running lists, merge.
//   MODE_STAGE    the staging loops alone (depth chunks of the queries
//                 and the tile into shared memory, with their barriers),
//                 no arithmetic: probe.words[blockIdx.y * n_splits +
//                 split] = the XOR of every 32-bit word the CTA staged.
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

#include "topk_common.cuh"

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

template <typename ET, bool INT8, int MODE>
__global__ void __launch_bounds__(THREADS)
    split_topk_kernel(const void* q, const ET* e, const float* escale,
                      const uint8_t* mask, int B, int N, int D, int k,
                      int docs_per_split, float* part_v, int* part_i,
                      Probe probe) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem sm = carve(smem_raw, k);
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int begin = split * docs_per_split;
  const int end = min(N, begin + docs_per_split);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  if constexpr (MODE == MODE_STAGE) {
    XorTap tap;
    for (int tile0 = begin; tile0 < end; tile0 += TN) {
      score_tile<ET, INT8, false>(q, e, escale, B, D, q0, tile0, end, sm,
                                  tap);
    }
    unsigned x = tap.x;
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(FULL, x, off);
    if (lane == 0) atomicXor(probe.words + blockIdx.y * n_splits + split, x);
    return;
  }

  if constexpr (MODE == MODE_SCORE) {
    constexpr int ROWS = BQ / WARPS;  // rows r = warp + WARPS * m
    float best[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) best[m] = -INFINITY;
    for (int tile0 = begin; tile0 < end; tile0 += TN) {
      score_tile<ET, INT8>(q, e, escale, B, D, q0, tile0, end, sm);
      if (tid < TN) {
        int doc = tile0 + tid;
        sm.keep[tid] = doc < end && (mask == nullptr || mask[doc] != 0);
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int r = warp + WARPS * m;
        for (int c = lane; c < TN; c += 32) {
          if (sm.keep[c]) best[m] = fmaxf(best[m], sm.scores[r * (TN + 1) + c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      float v = best[m];
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
      }
      const int row = q0 + warp + WARPS * m;
      if (lane == 0 && row < B && v > -INFINITY) {
        atomic_max_f32(probe.row_max + row, v);
      }
    }
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
    score_tile<ET, INT8>(q, e, escale, B, D, q0, tile0, end, sm);
    if (tid < TN) {
      int doc = tile0 + tid;
      sm.keep[tid] = doc < end && (mask == nullptr || mask[doc] != 0);
    }
    __syncthreads();
    if constexpr (MODE == MODE_FULL) {
      fold_tile(sm, tile0, q0, B, k);
    } else if constexpr (MODE == MODE_COMPARE) {
      fold_tile<false>(sm, tile0, q0, B, k, counts);
    } else {
      fold_tile<true, true>(sm, tile0, q0, B, k, counts,
                            tile0 - begin < EARLY_TILES * TN);
    }
    __syncthreads();
  }
  if constexpr (MODE == MODE_COMPARE) {
    for (int r = tid; r < BQ && q0 + r < B; r += THREADS) {
      atomicAdd(probe.counts + q0 + r, counts[r * COUNTERS]);
    }
    return;
  }
  if constexpr (MODE == MODE_COUNTED) {
    for (int x = tid; x < BQ * COUNTERS; x += THREADS) {
      const int r = x / COUNTERS;
      if (q0 + r < B) {
        probe.counts[(static_cast<size_t>(q0 + r) * n_splits + split) *
                         COUNTERS + x % COUNTERS] = counts[x];
      }
    }
  }
  write_parts(sm, q0, B, k, split, n_splits, part_v, part_i);
}

// Launch the split kernel (and, for MODE_FULL and MODE_COUNTED, the
// merge). The probe modes take k too: it sets the shared-memory layout,
// and with it the CTAs per SM, so a mode runs at MODE_FULL's occupancy.
template <typename ET, bool INT8, int MODE = MODE_FULL>
int launch(const void* q, const ET* e, const float* escale,
           const uint8_t* mask, const float* qscale, int B, int N, int D,
           int k, int n_splits, int docs_per_split, float* part_v,
           int* part_i, float* out_v, int* out_i, cudaStream_t stream,
           Probe probe = Probe{nullptr, nullptr, nullptr, nullptr}) {
  if (k < 1 || k > KMAX || B < 1 || N < 1 || D < 1 || n_splits < 1 ||
      docs_per_split < 1 || docs_per_split % TN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      smem_bytes(k) + (MODE == MODE_FULL ? 0 : sizeof(int) * BQ * COUNTERS);
  cudaError_t err = cudaFuncSetAttribute(
      split_topk_kernel<ET, INT8, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_splits, (B + BQ - 1) / BQ);
  split_topk_kernel<ET, INT8, MODE><<<grid, THREADS, smem, stream>>>(
      q, e, escale, mask, B, N, D, k, docs_per_split, part_v, part_i, probe);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (MODE != MODE_FULL && MODE != MODE_COUNTED) return 0;
  return static_cast<int>(launch_merge(part_v, part_i, B, n_splits, k,
                                       qscale, out_v, out_i, stream));
}

}  // namespace
