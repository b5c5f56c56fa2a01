// The streaming top-k kernel and its launchers, shared by K1/K2
// (fused_topk.cu), K3/K4 (ivf_topk.cu) and the probes of K1/K2
// (anatomy.cu).
//
// topk_kernel<Rows, Plan, BQN, MODE>: Rows is the scoring path
// (FloatRows<T> of float_mma.cuh for f32 and bf16 rows, Int8Rows of
// int8_mma.cuh), Plan where each CTA's walk comes from (SplitPlan: K1/K2's
// contiguous doc splits; IvfPlan: K3/K4's walkers over the table's
// sub-tiles). Block b is query block b % q_blocks of walker b / q_blocks,
// so the query-block CTAs of one walker are neighbours in the launch order
// and read each tile through L2 together. MODE picks the work done per
// tile; every mode keeps the grid, the block and the shared-memory layout
// of MODE_FULL, and writes an output its plain version reproduces, so no
// mode's work can be compiled away:
//
//   MODE_FULL     K1-K4: score, fold into the running lists (seeded with
//                 tau when given), write the lists; the merge follows.
//   MODE_STAGE    the staging alone (the query block, resident once or
//                 streamed per tile, and the ring of doc chunks, each
//                 word read back from shared memory after its copy
//                 landed), no arithmetic: probe.words[query block *
//                 walkers + walker] = the XOR of every 32-bit word the CTA
//                 staged.
//   MODE_SCORE    + scoring into sm.scores; the fold is one running max
//                 per row: probe.row_max[b] = the best selection score
//                 of row b.
//   MODE_COMPARE  + fold_tile's ballot against the fixed per-row
//                 threshold probe.thr (lists seeded with (thr, EMPTY_ID),
//                 never inserted into): probe.counts[b] += the documents
//                 scoring at least thr[b].
//   MODE_COUNTED  MODE_FULL plus per-row, per-split counters (fold_tile's
//                 COUNT variant) in probe.counts [B][walkers][COUNTERS];
//                 with probe.thr set, every slot starts as (thr,
//                 EMPTY_ID).
//
// The probe outputs that collect across CTAs (words, row_max, counts of
// MODE_COMPARE) are filled by atomics and start as the caller sets them:
// 0, -inf and 0.
//
// run_topk is the whole of K1-K4: the tau pass (MODE_FULL over every
// TAU_STRIDE-th candidate row, the merge in its tau mode), the main pass
// seeded with tau, and the merge.

#pragma once

#include <type_traits>

#include "float_mma.cuh"
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

// CTAs per SM the kernel is compiled for (its registers): the float path
// at 64 queries runs one CTA per SM, as its shared memory allows.
template <class Rows, int BQN>
struct MinCtas {
  static constexpr int value = BQN == 16 ? 3 : 1;
};
template <bool ROUND, int BQN>
struct MinCtas<Int8RowsT<ROUND>, BQN> {
  static constexpr int value = BQN == 16 ? 3 : 2;
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

// MODE_FULL, MODE_COMPARE, MODE_COUNTED: fold tile j (documents tile0,
// tile0 + stride, ...) of the CTA's walk.
template <int MODE, int BQN>
__device__ __forceinline__ void fold_mode(const SmemT<BQN>& sm, int j,
                                          int tile0, int stride, int q0,
                                          int B, int k, int* counts) {
  if constexpr (MODE == MODE_FULL) {
    fold_tile(sm, tile0, stride, q0, B, k);
  } else if constexpr (MODE == MODE_COMPARE) {
    fold_tile<false>(sm, tile0, stride, q0, B, k, counts);
  } else {
    fold_tile<true, true>(sm, tile0, stride, q0, B, k, counts,
                          j < EARLY_TILES);
  }
}

// After the last tile: the probe counters out, the running lists to the
// walker's partial outputs.
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

template <class Rows, class Plan, int BQN, int MODE>
__global__ void __launch_bounds__(THREADS, (MinCtas<Rows, BQN>::value))
    topk_kernel(Rows rows, Plan plan, int k, int walkers, const float* seed,
                float* part_v, int* part_i, Probe probe) {
  extern __shared__ __align__(128) char smem_raw[];
  const SmemT<BQN> sm = rows.template carve<BQN>(smem_raw, k);
  const int B = rows.B;
  const int q_blocks = (B + BQN - 1) / BQN;
  const int qb = blockIdx.x % q_blocks;
  const int w = blockIdx.x / q_blocks;
  const int q0 = qb * BQN;
  const auto walk = plan.at(w, walkers);
  const int tid = threadIdx.x;

  if constexpr (MODE == MODE_STAGE) {
    const unsigned x = rows.template stream<BQN, false>(
        q0, walk, sm, [](int, int, int) {});
    publish_xor(x, probe.words + qb * walkers + w);
    return;
  }

  if constexpr (MODE == MODE_SCORE) {
    float best[BQN / WARPS];
#pragma unroll
    for (int m = 0; m < BQN / WARPS; ++m) best[m] = -INFINITY;
    rows.template stream<BQN, true>(
        q0, walk, sm, [&](int, int, int) { tile_row_max(sm, best); });
    publish_row_max<BQN>(best, q0, B, probe);
    return;
  }

  // MODE_FULL, MODE_COMPARE and MODE_COUNTED fold; the probes keep
  // counters in shared memory past the MODE_FULL layout.
  int* counts = reinterpret_cast<int*>(smem_raw + rows.smem_bytes(BQN, k));
  if constexpr (MODE != MODE_FULL) {
    for (int x = tid; x < BQN * COUNTERS; x += THREADS) counts[x] = 0;
  }
  init_lists(sm, k, MODE == MODE_FULL ? seed : probe.thr, q0, B);
  rows.template stream<BQN, true>(q0, walk, sm, [&](int j, int t0, int) {
    fold_mode<MODE>(sm, j, t0, walk.stride, q0, B, k, counts);
  });
  __syncthreads();
  finish<MODE>(sm, counts, q0, B, k, w, walkers, part_v, part_i, probe);
}

// One launch of topk_kernel for a query block of bq (16 or 64) and
// ``walkers`` walkers.
template <int MODE, class Rows, class Plan>
cudaError_t launch_pass(const Rows& rows, const Plan& plan, int bq,
                        int walkers, int k, const float* seed, float* part_v,
                        int* part_i, cudaStream_t stream,
                        Probe probe = Probe{nullptr, nullptr, nullptr,
                                            nullptr}) {
  auto run = [&](auto tag) -> cudaError_t {
    constexpr int BQN = decltype(tag)::value;
    const size_t smem = rows.smem_bytes(BQN, k) +
                        (MODE == MODE_FULL ? 0 : sizeof(int) * BQN * COUNTERS);
    auto kernel = topk_kernel<Rows, Plan, BQN, MODE>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int blocks = walkers * ((rows.B + BQN - 1) / BQN);
    kernel<<<blocks, THREADS, smem, stream>>>(rows, plan, k, walkers, seed,
                                              part_v, part_i, probe);
    return cudaGetLastError();
  };
  if (bq == 16) return run(std::integral_constant<int, 16>());
  if (bq == 64) return run(std::integral_constant<int, 64>());
  return cudaErrorInvalidValue;
}

// The scratch of one call: the partial lists of the main pass [B][walkers]
// [k] and of the tau pass [B][tau_walkers][k], tau [B], and the query's
// three bf16 planes [3][B][D] (bf16 rows). Each piece starts on a
// 256-byte boundary. With base null, only *bytes is filled.
struct Workspace {
  float* part_v;
  int* part_i;
  float* tau_v;
  int* tau_i;
  float* tau;
  uint16_t* pieces;
};

inline Workspace carve_workspace(void* base, int B, int k, int walkers,
                                 int tau_walkers, int D, bool pieces,
                                 size_t* bytes = nullptr) {
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t n) {
    char* at = p == nullptr ? nullptr : p + off;
    off += (n + 255) / 256 * 256;
    return at;
  };
  const size_t main = static_cast<size_t>(B) * walkers * k;
  const size_t sub = static_cast<size_t>(B) * tau_walkers * k;
  Workspace ws;
  ws.part_v = reinterpret_cast<float*>(take(4 * main));
  ws.part_i = reinterpret_cast<int*>(take(4 * main));
  ws.tau_v = reinterpret_cast<float*>(take(4 * sub));
  ws.tau_i = reinterpret_cast<int*>(take(4 * sub));
  ws.tau = reinterpret_cast<float*>(take(4 * static_cast<size_t>(B)));
  ws.pieces = reinterpret_cast<uint16_t*>(
      take(pieces ? 6 * static_cast<size_t>(B) * D : 0));
  if (bytes != nullptr) *bytes = off;
  return ws;
}

// The query planes the float rows take: the f32 query itself, or (bf16
// rows) its three bf16 pieces, split into the workspace.
template <typename T>
const T* query_planes(const float* q, int B, int D, const Workspace& ws,
                      cudaStream_t stream, cudaError_t& err) {
  if constexpr (std::is_same<T, float>::value) {
    err = cudaSuccess;
    return q;
  } else {
    err = launch_split_query(q, static_cast<long long>(B) * D, ws.pieces,
                             stream);
    return reinterpret_cast<const T*>(ws.pieces);
  }
}

// tau into ws.tau: the pass over the subsample plan ``sub`` and the merge
// in its tau mode.
template <class Rows, class Plan>
cudaError_t run_tau(const Rows& rows, const Plan& sub, int tau_walkers,
                    int bq, int k, const Workspace& ws, cudaStream_t stream) {
  cudaError_t err = launch_pass<MODE_FULL>(rows, sub, bq, tau_walkers, k,
                                           nullptr, ws.tau_v, ws.tau_i,
                                           stream);
  if (err != cudaSuccess) return err;
  return launch_merge(ws.tau_v, ws.tau_i, rows.B, tau_walkers * k, k,
                      nullptr, nullptr, nullptr, ws.tau, stream);
}

// K1-K4 (and K1r / K2r / K1c, whose rows round): tau, the main pass
// seeded with it, the merge (qscale: int8's query scales, applied to the
// k outputs only).
template <class Rows, class Plan>
cudaError_t run_topk(const Rows& rows, const Plan& main, int walkers,
                     const Plan& sub, int tau_walkers, int bq, int k,
                     const float* qscale, const Workspace& ws, float* out_v,
                     int* out_i, cudaStream_t stream) {
  cudaError_t err = run_tau(rows, sub, tau_walkers, bq, k, ws, stream);
  if (err != cudaSuccess) return err;
  err = launch_pass<MODE_FULL>(rows, main, bq, walkers, k, ws.tau,
                               ws.part_v, ws.part_i, stream);
  if (err != cudaSuccess) return err;
  return launch_merge(ws.part_v, ws.part_i, rows.B, walkers * k, k, qscale,
                      out_v, out_i, nullptr, stream, Rows::ROUNDED);
}

bool split_args_ok(int B, int N, int D, int k, int bq, int splits, int per,
                   int tau_splits, int tau_per) {
  return k >= 1 && k <= KMAX && B >= 1 && N >= 1 && D >= 1 &&
         (bq == 16 || bq == 64) && splits >= 1 && per >= TN &&
         per % TN == 0 && tau_splits >= 0 &&
         (tau_splits == 0 || (tau_per >= TN * TAU_STRIDE &&
                              tau_per % (TN * TAU_STRIDE) == 0));
}

}  // namespace
