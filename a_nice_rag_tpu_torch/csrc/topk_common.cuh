// Device code shared by the streaming top-k kernels (fused_topk.cu: K1,
// K2; ivf_topk.cu: K3, K4) and their probes (anatomy.cu; int4.cu takes
// the chunk constant and the swizzle).
//
// A CTA owns a block of queries and scores tiles of TN documents into
// shared memory: int8_mma.cuh for int8 rows (K2, K4: exact int32 on the
// int8 tensor cores, selected on float(acc) * doc_scale), float_mma.cuh
// for f32 and bf16 rows (K1, K3). Both stream the doc tiles through a
// ring of 16-byte cp.async copies (the staging helpers below) and walk a
// sequence of tiles (SplitWalk: a contiguous doc range; IvfWalk: a share
// of the IVF table's sub-tiles), either every row or every stride-th.
// One warp per query row keeps a running top-k in shared memory: a
// document enters only if it beats the current worst entry under (score
// desc, id asc), and evicts it (fold_tile). Every CTA writes its k
// survivors per query; merge_kernel, one CTA per query, selects the k
// best of them and writes them sorted, with (-inf, -1) in unfilled slots.
//
// The exact tau warm start (every kernel): a first pass runs the same
// kernel over every TAU_STRIDE-th candidate row and the merge, in its
// tau mode, writes tau[b] = the k-th best score of that subsample,
// lowered by TAU_SLACK (-inf with fewer than k candidates). The main pass
// seeds every slot with (tau[b], EMPTY_ID): only documents scoring at
// least tau enter, and tau is at most the k-th best candidate, so the
// result is unchanged.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;       // documents per tile
constexpr int THREADS = 256;  // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int CH = 128;       // bytes of depth per staged chunk
constexpr int STAGES = 3;     // chunks in the ring
constexpr int SEGS = CH / 16; // 16-byte segments per chunk row
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TAU_STRIDE = 64;
constexpr float TAU_SLACK = 1e-5f;

__host__ __device__ constexpr int depth_pad(int bytes) {
  return (bytes + CH - 1) / CH * CH;
}

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// -- staging ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p))
      : "memory");
}

// Byte offset of 16-byte segment ``seg`` of row ``row`` in a layout of
// 128-byte row chunks (row_bytes a multiple of 128): segment s of a row
// sits at position s ^ (row & 7), so the eight rows an ldmatrix (or a
// quarter-warp's 16-byte loads) reads at one segment fall on distinct
// banks.
__device__ __forceinline__ int swizzle(int row, int row_bytes, int chunk,
                                       int seg) {
  return row * row_bytes + chunk * CH + ((seg ^ (row & 7)) << 4);
}

// Stage the 16 bytes of elements src[0, 16 / sizeof(U)) to dst, zero
// from element ``valid`` on (valid <= 0: all zero, src is not read). U is
// the elements' bit type (int8_t, uint16_t for bf16, uint32_t for f32).
// vec: a cp.async copy (src 16-byte aligned; ``base`` stands in for src
// when nothing is read); else element loads.
template <typename U>
__device__ __forceinline__ void stage16(char* dst, const U* src, int valid,
                                        bool vec, const void* base) {
  constexpr int E = 16 / static_cast<int>(sizeof(U));
  valid = max(0, min(E, valid));
  if (vec) {
    cp_async16(dst, valid > 0 ? static_cast<const void*>(src) : base,
               valid * static_cast<int>(sizeof(U)));
    return;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (i < valid) {
      constexpr int BITS = 8 * sizeof(U);
      const unsigned v =
          static_cast<unsigned>(src[i]) &
          (BITS == 32 ? 0xffffffffu : (1u << (BITS % 32)) - 1u);
      w[(i * sizeof(U)) / 4] |= v << (8 * ((i * sizeof(U)) % 4));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// -- walks -------------------------------------------------------------------

// K1/K2's walk: the split's documents begin, begin + stride, ... < end in
// tiles of TN of them, in order.
struct SplitWalk {
  int begin, end, stride;
  __device__ __forceinline__ bool tile(int j, int& t0, int& t1) const {
    const long long s =
        begin + static_cast<long long>(j) * TN * static_cast<long long>(stride);
    if (s >= end) return false;
    t0 = static_cast<int>(s);
    t1 = static_cast<int>(min(static_cast<long long>(end),
                              s + static_cast<long long>(TN) * stride));
    return true;
  }
};

// K3/K4's walk: items first, first + step, ... of the table's sub-tiles.
// Item i is sub-tile i % spt of slot i / spt (spt = ceil(tile_n / (TN *
// stride))): rows r0, r0 + stride, ... below the tile's end and ``rows``.
// It stops at the first -1 slot (real entries come first), read on the
// device.
struct IvfWalk {
  const int* table;
  int max_tiles, tile_n, spt, first, step, stride;
  long long rows;
  __device__ __forceinline__ bool tile(int j, int& t0, int& t1) const {
    const long long item = first + static_cast<long long>(j) * step;
    const long long slot = item / spt;
    if (slot >= max_tiles) return false;
    const int t = table[slot];
    if (t < 0) return false;
    const long long span = static_cast<long long>(TN) * stride;
    const long long base = static_cast<long long>(t) * tile_n;
    const long long r0 = base + (item % spt) * span;
    const long long r1 = min(min(base + tile_n, r0 + span), rows);
    t0 = static_cast<int>(r0);
    t1 = static_cast<int>(max(r0, r1));
    return true;
  }
};

// Where each CTA's walk comes from: K1/K2 split s covers documents [s *
// per, (s + 1) * per); K3/K4 walker w takes items w, w + walkers, ...
struct SplitPlan {
  int n, per, stride;
  __device__ __forceinline__ SplitWalk at(int split, int) const {
    const long long b = static_cast<long long>(split) * per;
    return SplitWalk{static_cast<int>(min(b, static_cast<long long>(n))),
                     static_cast<int>(min(b + per, static_cast<long long>(n))),
                     stride};
  }
};

struct IvfPlan {
  const int* table;
  int max_tiles, n_real, tile_n, stride;
  __device__ __forceinline__ IvfWalk at(int walker, int walkers) const {
    const int span = TN * stride;
    return IvfWalk{table, max_tiles, tile_n, (tile_n + span - 1) / span,
                   walker, walkers, stride,
                   n_real > 0 ? n_real : table[max_tiles]};
  }
};

// -- running lists -------------------------------------------------------

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

// A CTA's shared memory for a query block of BQN rows: the ring of doc
// chunks (and, where the query block is streamed, its chunks) in es, a
// resident query block in qs, the scores tile, the running lists. hit
// (the float path; nullptr for int8 rows): hit[r] != 0 where some score
// of the tile's row r is at least the row's worst entry, set by the
// scoring epilogue, so the fold visits only those rows.
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
  uint8_t* hit;   // [BQN] or nullptr
  void* qs;       // resident query block (nullptr when streamed)
  void* es;       // the ring
};

// The tail every layout shares, after its ring and query block: scores,
// running lists, worst entries, keep.
__host__ __device__ inline size_t smem_tail_bytes(int bq, int k) {
  return sizeof(float) * bq * (TN + 1) +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(bq) * k +
         (sizeof(float) + 2 * sizeof(int)) * bq + TN;
}

template <int BQN>
__device__ inline void carve_tail(SmemT<BQN>& s, char* base, int k) {
  s.scores = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQN * (TN + 1);
  s.run_v = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQN * k;
  s.run_i = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQN * k;
  s.worst_v = reinterpret_cast<float*>(base);
  base += sizeof(float) * BQN;
  s.worst_i = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQN;
  s.worst_s = reinterpret_cast<int*>(base);
  base += sizeof(int) * BQN;
  s.keep = reinterpret_cast<uint8_t*>(base);
  s.hit = nullptr;
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
  if (sm.hit != nullptr && tid < BQN) sm.hit[tid] = 0;
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

// Fold the scored tile (sm.scores; column col is document tile0 + col *
// stride, a candidate where sm.keep[col]) into the running lists of the
// CTA's real queries. The caller has synchronised after filling sm.scores
// and sm.keep (and sm.hit, where the path keeps it: a row without a hit
// has no candidate, and is skipped; the flags are cleared for the next
// tile). The probes' variants: COUNT adds to ``counts`` ([BQN]
// [COUNTERS] in shared memory, ``early`` picks the insertion counter);
// !INSERT only takes the ballot against each row's cached worst entry and
// counts its bits, so nothing is ever inserted.
template <bool INSERT = true, bool COUNT = false, int BQN>
__device__ inline void fold_tile(const SmemT<BQN>& sm, int tile0, int stride,
                                 int q0, int B, int k, int* counts = nullptr,
                                 bool early = false) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < BQN && q0 + r < B; r += WARPS) {
    if (sm.hit != nullptr && !sm.hit[r]) {
      if constexpr (COUNT) {
        if (lane == 0) counts[r * COUNTERS + 3] += TN / 32;
      }
      continue;
    }
    float* rv = sm.run_v + r * k;
    int* ri = sm.run_i + r * k;
    float wv = sm.worst_v[r];
    int wi = sm.worst_i[r], ws = sm.worst_s[r];
    int inserted = 0, fired = 0, beat = 0;
    for (int c = 0; c < TN; c += 32) {
      int col = c + lane;
      float s = sm.scores[r * (TN + 1) + col];
      bool cand = sm.keep[col] && better(s, tile0 + col * stride, wv, wi);
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
        inserted += offer(cv, tile0 + (c + src) * stride, rv, ri, k, lane,
                          wv, wi, ws);
      }
    }
    if (lane == 0) {
      if (sm.hit != nullptr) sm.hit[r] = 0;
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

// -- the merge -------------------------------------------------------------

constexpr int MERGE_THREADS = 256;
constexpr int MERGE_KMAX = 256;

// The order (score desc, id asc) as one unsigned 64-bit key, larger is
// better: the score's order-preserving bits (-0.0 as +0.0, so they tie as
// floats do), then the complement of the id.
__device__ __forceinline__ unsigned long long merge_key(float v, int id) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(~id);
}

// tau from the k-th best subsample score, as the plain version lowers it
// (two roundings: no fused multiply-add); an infinite score stays.
__device__ __forceinline__ float lowered(float kth) {
  if (!isfinite(kth)) return kth;
  return __fsub_rn(__fsub_rn(kth, __fmul_rn(fabsf(kth), TAU_SLACK)), 1e-30f);
}

// One CTA per query row: from the row's m partial entries (part_v /
// part_i [B][m]; EMPTY_ID entries, the seeds and unfilled slots, are not
// candidates) select the k best under (score desc, id asc) by a radix
// select over merge_key, 8 bits a pass, stopping once the chosen bin
// holds exactly the entries still needed. Ids are distinct, so the keys
// are, and the selection is exact. Then the selected entries are ranked
// among themselves and written sorted: out_v [B][k] (times qscale[row]
// where qscale is given: int8's query scale, after selection), out_i,
// (-inf, -1) past the candidates. With ``tau`` set, writes only tau[row]
// = lowered(k-th best), or -inf with fewer than k candidates.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* part_v, const int* part_i, int m, int k,
                 const float* qscale, float* out_v, int* out_i, float* tau) {
  __shared__ int hist[256];
  __shared__ int bin_s, need_s, done_s, count_s;
  __shared__ unsigned long long keys_s[MERGE_KMAX];
  __shared__ float vals_s[MERGE_KMAX];
  __shared__ int ids_s[MERGE_KMAX];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const float* pv = part_v + static_cast<size_t>(row) * m;
  const int* pi = part_i + static_cast<size_t>(row) * m;

  unsigned long long prefix = 0ull;  // the chosen high bits so far
  int need = k;
  int shift = 56;
  for (;; shift -= 8) {
    for (int x = tid; x < 256; x += MERGE_THREADS) hist[x] = 0;
    __syncthreads();
    const unsigned long long hi_mask =
        shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int x = tid; x < m; x += MERGE_THREADS) {
      const int id = pi[x];
      if (id == EMPTY_ID) continue;
      const unsigned long long key = merge_key(pv[x], id);
      if ((key & hi_mask) == prefix) {
        atomicAdd(&hist[(key >> shift) & 255], 1);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // Suffix sums over the 256 bins, eight per lane, highest first.
      int local[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        local[i] = hist[255 - (tid * 8 + i)];
        sum += local[i];
      }
      int incl = sum;  // inclusive prefix over lanes (bins from the top)
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += o;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      int above = incl - sum;  // entries in higher bins than this lane's
      if (tid == 0 && total < need) {
        bin_s = -1;  // every remaining candidate is taken
      }
      if (total >= need) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (above < need && above + local[i] >= need) {
            bin_s = 255 - (tid * 8 + i);
            need_s = need - above;
            done_s = local[i] == need - above;
          }
          above += local[i];
        }
      }
    }
    __syncthreads();
    const int bin = bin_s;
    if (bin < 0) break;
    prefix |= static_cast<unsigned long long>(bin) << shift;
    need = need_s;
    if (done_s || shift == 0) break;
    __syncthreads();  // bin_s / need_s / done_s are rewritten next pass
  }
  // Selected: every candidate whose key is at least the threshold (the
  // chosen prefix, its lower bits zero); with fewer than k candidates,
  // all of them (bin < 0 leaves the prefix chosen so far, which all the
  // remaining candidates share or exceed).
  if (tid == 0) count_s = 0;
  __syncthreads();
  for (int x = tid; x < m; x += MERGE_THREADS) {
    const int id = pi[x];
    if (id == EMPTY_ID) continue;
    const float v = pv[x];
    const unsigned long long key = merge_key(v, id);
    if (key >= prefix) {
      const int slot = atomicAdd(&count_s, 1);
      if (slot < k) {
        keys_s[slot] = key;
        vals_s[slot] = v;
        ids_s[slot] = id;
      }
    }
  }
  __syncthreads();
  const int count = min(count_s, k);
  if (tau != nullptr) {
    for (int s = tid; s < count; s += MERGE_THREADS) {
      int rank = 0;
      for (int t = 0; t < count; ++t) rank += keys_s[t] > keys_s[s];
      if (rank == k - 1) tau[row] = lowered(vals_s[s]);
    }
    if (tid == 0 && count < k) tau[row] = -INFINITY;
    return;
  }
  const float qs = qscale ? qscale[row] : 1.f;
  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  for (int s = tid; s < k; s += MERGE_THREADS) {
    if (s < count) {
      int rank = 0;
      for (int t = 0; t < count; ++t) rank += keys_s[t] > keys_s[s];
      ov[rank] = qscale ? vals_s[s] * qs : vals_s[s];
      oi[rank] = ids_s[s];
    } else {
      ov[s] = -INFINITY;
      oi[s] = -1;
    }
  }
}

// The merge of B rows of m partial entries each: sorted lists into
// out_v / out_i, or (tau non-null) tau alone.
inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                int B, int m, int k, const float* qscale,
                                float* out_v, int* out_i, float* tau,
                                cudaStream_t stream) {
  if (k > MERGE_KMAX) return cudaErrorInvalidValue;
  merge_kernel<<<B, MERGE_THREADS, 0, stream>>>(part_v, part_i, m, k, qscale,
                                                out_v, out_i, tau);
  return cudaGetLastError();
}

// The query split of bf16 rows: q [n] f32 into three bf16 planes out
// [3][n], hi + mid + lo == q. hi keeps q's top 16 bits, mid the top 16
// bits of the rest, lo the rest rounded to bf16 (exact unless |q| <
// 2^-110); as ops/kernels/fused_topk.py's split_query.
__global__ void split_query_kernel(const float* q, long long n,
                                   uint16_t* out) {
  for (long long x = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       x < n; x += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = q[x];
    const unsigned u = __float_as_uint(v);
    const float hi = __uint_as_float(u & 0xffff0000u);
    const float r1 = isfinite(v) ? __fsub_rn(v, hi) : 0.f;
    const unsigned w = __float_as_uint(r1);
    const float mid = __uint_as_float(w & 0xffff0000u);
    const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(r1, mid));
    out[x] = static_cast<uint16_t>(u >> 16);
    out[n + x] = static_cast<uint16_t>(w >> 16);
    out[2 * n + x] = *reinterpret_cast<const uint16_t*>(&lo);
  }
}

inline cudaError_t launch_split_query(const float* q, long long n,
                                      uint16_t* out, cudaStream_t stream) {
  const int blocks = static_cast<int>(min((n + 255) / 256, 1024ll));
  split_query_kernel<<<max(blocks, 1), 256, 0, stream>>>(q, n, out);
  return cudaGetLastError();
}

}  // namespace
