// Device code shared by the streaming top-k kernels (fused_topk.cu: K1,
// K2; ivf_topk.cu: K3, K4) and their probes (anatomy.cu; int4.cu takes
// the tile constants and dp4a_chunk).
//
// A CTA owns a block of queries and scores tiles of TN documents into
// shared memory: score_tile here for float rows (K1, K3: IEEE float32,
// FFMA, 64 queries), int8_mma.cuh for int8 rows (K2, K4: exact int32 on
// the int8 tensor cores, 16 or 64 queries, selected on float(acc) *
// doc_scale). One warp per query row keeps a running top-k in shared
// memory: a document enters only if it beats the current worst entry
// under (score desc, id asc), and evicts it (fold_tile). Every CTA writes
// its k survivors per query; merge_kernel merges the per-split lists of
// each query and writes them sorted, with (-inf, -1) in unfilled slots.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per CTA of the float kernels
constexpr int TN = 128;       // documents per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 8 score block
constexpr int WARPS = THREADS / 32;
constexpr int DK = 32;        // depth chunk (elements; int8: 32-bit words)
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Warp-wide search for the worst entry (lowest under the tie rule) of
// one running list of k entries; every lane ends with the same answer.
__device__ __forceinline__ void find_worst(const float* rv, const int* ri,
                                           int k, int lane, float& wv,
                                           int& wi, int& ws) {
  float bv = 0.f;
  int bi = 0, bs = -1;
  for (int s = lane; s < k; s += 32) {
    float v = rv[s];
    int i = ri[s];
    if (bs < 0 || better(bv, bi, v, i)) {
      bv = v; bi = i; bs = s;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, bv, off);
    int oi = __shfl_xor_sync(FULL, bi, off);
    int os = __shfl_xor_sync(FULL, bs, off);
    bool take;
    if (os < 0) {
      take = false;
    } else if (bs < 0) {
      take = true;
    } else if (better(bv, bi, ov, oi)) {
      take = true;  // the other one is worse
    } else if (better(ov, oi, bv, bi)) {
      take = false;
    } else {
      take = os < bs;  // identical entries (unfilled slots): lower slot
    }
    if (take) {
      bv = ov; bi = oi; bs = os;
    }
  }
  wv = bv; wi = bi; ws = bs;
}

// Offer one warp-uniform candidate to a running list; refreshes the
// cached worst entry after an insertion. Returns whether it entered.
__device__ __forceinline__ bool offer(float cv, int ci, float* rv, int* ri,
                                      int k, int lane, float& wv, int& wi,
                                      int& ws) {
  if (!better(cv, ci, wv, wi)) return false;
  if (lane == 0) {
    rv[ws] = cv;
    ri[ws] = ci;
  }
  __syncwarp();
  find_worst(rv, ri, k, lane, wv, wi, ws);
  return true;
}

// A CTA's shared memory for a query block of BQN rows. The float
// kernels stage depth chunks in qs / es (carve); the int8 path holds its
// whole query block in qs and a ring of doc chunks in es (carve_int8).
template <int BQN>
struct SmemT {
  static constexpr int ROWS = BQN;
  float* run_v;   // [BQN][k]
  int* run_i;     // [BQN][k]
  float* worst_v; // [BQN]
  int* worst_i;   // [BQN]
  int* worst_s;   // [BQN]
  float* scores;  // [BQN][TN + 1]
  uint8_t* keep;  // [TN]
  void* qs;       // float: [DK][BQ + 1] f32
  void* es;       // float: [DK][TN + 1] f32
};
using Smem = SmemT<BQ>;

__host__ __device__ inline size_t smem_bytes(int k) {
  return sizeof(float) * BQ * k + sizeof(int) * BQ * k +
         (sizeof(float) + 2 * sizeof(int)) * BQ +
         sizeof(float) * BQ * (TN + 1) + sizeof(float) * DK * (BQ + 1) +
         sizeof(float) * DK * (TN + 1) + TN;
}

__device__ inline Smem carve(char* base, int k) {
  Smem s;
  s.run_v = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQ * k;
  s.run_i = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQ * k;
  s.worst_v = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQ;
  s.worst_i = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQ;
  s.worst_s = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQ;
  s.scores = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQ * (TN + 1);
  s.qs = base;
  base += sizeof(float) * DK * (BQ + 1);
  s.es = base;
  base += sizeof(float) * DK * (TN + 1);
  s.keep = reinterpret_cast<uint8_t*>(base);
  return s;
}

// One staged depth chunk into a thread's 4 x 8 block of exact sums:
// qs [DK][BQ + 1] and es [DK][TN + 1] hold 32-bit words of four int8
// each; the thread owns queries ty * 4 + i and documents tx + 16 * j.
// The stripped folds of int4.cu use it.
__device__ __forceinline__ void dp4a_chunk(const int* qs, const int* es,
                                           int ty, int tx,
                                           int (&acc)[4][8]) {
#pragma unroll 4
  for (int w = 0; w < DK; ++w) {
    int a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[w * (BQ + 1) + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = es[w * (TN + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// Sees every 32-bit word the staging loops write to shared memory; the
// top-k kernels pass this one, which does nothing.
struct NoTap {
  __device__ __forceinline__ void operator()(unsigned) const {}
};

// Score one tile [BQ, TN] of float rows into sm.scores: q is f32 [B, D],
// e is ET [N, D]. Rows at or past ``end`` score as zero rows. With DOT
// false only the staging loops run (depth chunks into sm.qs / sm.es and
// their barriers) and sm.scores is left alone; ``tap`` is handed each
// staged word.
template <typename ET, bool DOT = true, typename Tap = NoTap>
__device__ void score_tile(const float* qf, const ET* e, int B, int D,
                           int q0, int tile0, int end, const Smem& sm,
                           Tap&& tap = Tap()) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // docs tx + 16 * j
  const int ty = tid / 16;  // queries ty * 4 + i
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float* qs = static_cast<float*>(sm.qs);
  float* es = static_cast<float*>(sm.es);
  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int x = tid; x < BQ * DK; x += THREADS) {
      int r = x / DK, dd = x % DK, row = q0 + r, d = d0 + dd;
      const float v =
          (row < B && d < D) ? qf[static_cast<size_t>(row) * D + d] : 0.f;
      qs[dd * (BQ + 1) + r] = v;
      tap(__float_as_uint(v));
    }
    for (int x = tid; x < TN * DK; x += THREADS) {
      int r = x / DK, dd = x % DK, doc = tile0 + r, d = d0 + dd;
      const float v = (doc < end && d < D)
                          ? to_f32(e[static_cast<size_t>(doc) * D + d])
                          : 0.f;
      es[dd * (TN + 1) + r] = v;
      tap(__float_as_uint(v));
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < (DOT ? DK : 0); ++dd) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[dd * (BQ + 1) + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = es[dd * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if constexpr (!DOT) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sm.scores[(ty * 4 + i) * (TN + 1) + tx + 16 * j] = acc[i][j];
}

// Empty running lists, and their cached worst entries. With ``seed``
// [B], every slot of query q0 + r starts as (seed[q0 + r], EMPTY_ID):
// only a document scoring at least the seed can enter.
template <int BQN>
__device__ inline void init_lists(const SmemT<BQN>& sm, int k,
                                  const float* seed = nullptr, int q0 = 0,
                                  int B = 0) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int x = tid; x < BQN * k; x += THREADS) {
    const int row = q0 + x / k;
    sm.run_v[x] = seed != nullptr && row < B ? seed[row] : -INFINITY;
    sm.run_i[x] = EMPTY_ID;
  }
  __syncthreads();
  for (int r = warp; r < BQN; r += WARPS) {
    float wv; int wi, ws;
    find_worst(sm.run_v + r * k, sm.run_i + r * k, k, lane, wv, wi, ws);
    if (lane == 0) {
      sm.worst_v[r] = wv; sm.worst_i[r] = wi; sm.worst_s[r] = ws;
    }
  }
}

// Per-row counters of the probe variants of fold_tile: [BQN][COUNTERS].
// INSERT and COUNT: insertions in the first EARLY_TILES tiles of the
// CTA's range, insertions after them, windows of 32 columns whose ballot
// fired, windows seen. !INSERT: documents that beat the row's worst
// entry (counter 0).
constexpr int COUNTERS = 4;
constexpr int EARLY_TILES = 16;

// Fold the scored tile (sm.scores, documents tile0 + col where
// sm.keep[col]) into the running lists of the CTA's real queries. The
// caller has synchronised after filling sm.scores and sm.keep. The
// probes' variants: COUNT adds to ``counts`` ([BQN][COUNTERS] in shared
// memory, ``early`` picks the insertion counter); !INSERT only takes
// the ballot against each row's cached worst entry and counts its bits,
// so nothing is ever inserted.
template <bool INSERT = true, bool COUNT = false, int BQN>
__device__ inline void fold_tile(const SmemT<BQN>& sm, int tile0, int q0,
                                 int B, int k, int* counts = nullptr,
                                 bool early = false) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < BQN && q0 + r < B; r += WARPS) {
    float* rv = sm.run_v + r * k;
    int* ri = sm.run_i + r * k;
    float wv = sm.worst_v[r];
    int wi = sm.worst_i[r], ws = sm.worst_s[r];
    int inserted = 0, fired = 0, beat = 0;
    for (int c = 0; c < TN; c += 32) {
      int col = c + lane;
      float s = sm.scores[r * (TN + 1) + col];
      bool cand = sm.keep[col] && better(s, tile0 + col, wv, wi);
      unsigned m = __ballot_sync(FULL, cand);
      if constexpr (!INSERT) {
        beat += __popc(m);
        continue;
      }
      fired += m != 0u;
      while (m) {
        int src = __ffs(m) - 1;
        m &= m - 1;
        float cv = __shfl_sync(FULL, s, src);
        inserted += offer(cv, tile0 + c + src, rv, ri, k, lane, wv, wi, ws);
      }
    }
    if (lane == 0) {
      if constexpr (INSERT) {
        sm.worst_v[r] = wv; sm.worst_i[r] = wi; sm.worst_s[r] = ws;
      } else {
        counts[r * COUNTERS] += beat;
      }
      if constexpr (COUNT) {
        counts[r * COUNTERS + (early ? 0 : 1)] += inserted;
        counts[r * COUNTERS + 2] += fired;
        counts[r * COUNTERS + 3] += TN / 32;
      }
    }
  }
}

// Write the CTA's running lists to its split's slot of the partial
// outputs part_v / part_i [B][n_splits][k].
template <int BQN>
__device__ inline void write_parts(const SmemT<BQN>& sm, int q0, int B,
                                   int k, int split, int n_splits,
                                   float* part_v, int* part_i) {
  for (int x = threadIdx.x; x < BQN * k; x += THREADS) {
    int r = x / k, slot = x % k;
    if (q0 + r < B) {
      size_t o = (static_cast<size_t>(q0 + r) * n_splits + split) * k + slot;
      part_v[o] = sm.run_v[x];
      part_i[o] = sm.run_i[x];
    }
  }
}

constexpr int MERGE_WARPS = 4;

// Merge the per-split lists of each query (one warp per query) and write
// them sorted by (score desc, id asc). qscale (int8) multiplies the
// emitted values only.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    merge_kernel(const float* part_v, const int* part_i, int B, int n_splits,
                 int k, const float* qscale, float* out_v, int* out_i) {
  extern __shared__ __align__(16) char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * MERGE_WARPS + warp;
  float* rv = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* ri = reinterpret_cast<int*>(smem_raw + sizeof(float) * MERGE_WARPS * k) +
            warp * k;
  if (row >= B) return;  // warp-uniform; no block-wide barrier below

  for (int s = lane; s < k; s += 32) {
    rv[s] = -INFINITY;
    ri[s] = EMPTY_ID;
  }
  __syncwarp();
  float wv; int wi, ws;
  find_worst(rv, ri, k, lane, wv, wi, ws);
  const size_t base = static_cast<size_t>(row) * n_splits * k;
  const int total = n_splits * k;
  for (int c = 0; c < total; c += 32) {
    int x = c + lane;
    float v = -INFINITY;
    int id = EMPTY_ID;
    if (x < total) {
      v = part_v[base + x];
      id = part_i[base + x];
    }
    bool cand = x < total && better(v, id, wv, wi);
    unsigned m = __ballot_sync(FULL, cand);
    while (m) {
      int src = __ffs(m) - 1;
      m &= m - 1;
      float cv = __shfl_sync(FULL, v, src);
      int ci = __shfl_sync(FULL, id, src);
      offer(cv, ci, rv, ri, k, lane, wv, wi, ws);
    }
  }
  __syncwarp();
  const float qs = qscale ? qscale[row] : 1.f;
  for (int s = lane; s < k; s += 32) {
    float v = rv[s];
    int id = ri[s];
    int rank = 0;
    for (int t = 0; t < k; ++t) {
      float tv = rv[t];
      int ti = ri[t];
      if (better(tv, ti, v, id) || (tv == v && ti == id && t < s)) ++rank;
    }
    bool empty = id == EMPTY_ID;
    out_v[static_cast<size_t>(row) * k + rank] =
        empty ? -INFINITY : (qscale ? v * qs : v);
    out_i[static_cast<size_t>(row) * k + rank] = empty ? -1 : id;
  }
}

inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                int B, int n_splits, int k,
                                const float* qscale, float* out_v,
                                int* out_i, cudaStream_t stream) {
  const size_t msmem = (sizeof(float) + sizeof(int)) * MERGE_WARPS * k;
  merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, msmem,
                 stream>>>(part_v, part_i, B, n_splits, k, qscale, out_v,
                           out_i);
  return cudaGetLastError();
}

}  // namespace
