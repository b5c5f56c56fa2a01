// The cluster kernel for Hopper (sm_90a), shared by the folds that run on
// it (cluster_topk.cu: K2r, K1r, K1c) and its probes (cluster_probe.cu:
// P4's anatomy and P5's counted fold on this design, and K1's and K2's
// exact functions as its EXACT row kinds). cluster_topk.cu states the
// design; this header holds the kernel, its launchers and the passes of a
// whole call.
//
// The kernel's compile-time parameters: the rows (RowKind: int8 or bf16,
// and the selection score), the query groups a CTA (QG), TMA or element
// loads, the query planes resident or streamed, and the work (Mode). Every
// mode keeps MODE_FULL's grid, block and walk, and every probe mode writes
// an output its plain version reproduces (ops/kernels/cluster_probe.py):
//
//   MODE_FULL     the fold's pass: the walkers' lists [B][walkers][k].
//   MODE_STAGE    the ring alone: words[query block][walker] ^= every
//                 32-bit word that landed in the CTA's ring slots (with
//                 multicast, each doc word of the walker's tiles once,
//                 zero past the rows and past the row) and its resident
//                 query planes' words (zero past B and past the row),
//                 read back from shared memory; nothing multiplied.
//   MODE_SCORE    + wgmma: best[b] = the row's best selection score over
//                 every doc (rows past N and masked docs never count; a
//                 best of zero may come out as -0.0 or +0.0).
//   MODE_COMPARE  + the epilogue's test against the pinned thresholds
//                 (a.seed [B], nothing offered): counts[b] += the docs
//                 whose selection score is at least it.
//   MODE_COUNTED  MODE_FULL with counters [B][walkers][5] (see
//                 CLUSTER_COUNTERS) in shared memory past the lists.
//
// words, best and counts of MODE_COMPARE collect across CTAs by atomics
// and start as the caller sets them: 0, -inf and 0.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int QB = 64;        // queries a warpgroup multiplies (wgmma M)
constexpr int WG_DOCS = 128;  // docs a warpgroup multiplies (wgmma N)
constexpr int CWARPS = 8;     // consumer warps: two warpgroups
constexpr int CTHREADS = CWARPS * 32;
constexpr int KTHREADS = CTHREADS + 32;  // + one producer warp
constexpr int BOX_ROWS = 64;
constexpr int MAX_CLUSTER = 4;
constexpr int MAX_STAGES = 6;
constexpr int MAX_K = 128;
constexpr int ALIGN = 1024;  // the 128-byte swizzle's period
constexpr int SMEM_LIMIT = 232448;
constexpr int CONSUMERS_BAR = 1;  // named barrier of the consumer warps

enum Mode : int {
  MODE_FULL = 0,
  MODE_STAGE = 1,
  MODE_SCORE = 2,
  MODE_COMPARE = 3,
  MODE_COUNTED = 4
};

// MODE_COUNTED's counters of a row and walker, against the walker's list
// as it stood when a tile began (the top k, under (score desc, id asc), of
// its seed and of every doc of its earlier tiles: what the heap holds,
// since the bound is safe). A doc enters iff it beats that list's worst
// entry. Entries in the walker's first EARLY_TILES tiles, entries after
// them, tiles with an entry, tiles seen, and the heap's own insertions
// (a doc that beat the heap's top when offered: between the tile's docs
// that survive it and its entries, in an order that depends on the
// lanes and, with QG = 1, on the two warpgroups that share the row).
// While the walk runs, slot CNT_SEEN holds the last tile counted in
// CNT_TILES.
constexpr int CLUSTER_COUNTERS = 5;
constexpr int CNT_EARLY = 0, CNT_LATE = 1, CNT_TILES = 2, CNT_SEEN = 3,
              CNT_INSERTED = 4;

// The rows a call multiplies and the score it selects on: int8 with
// per-row scales (K2r rounded, K2 exact), or bf16 against the f32 query's
// three planes (K1r rounded, K1 exact) or against bf16(q) (K1c).
enum RowKind : int {
  ROWS_INT8 = 0,
  ROWS_BF16_ROUNDED = 1,
  ROWS_BF16_COMPARE = 2,
  ROWS_INT8_EXACT = 3,
  ROWS_BF16_EXACT = 4
};
constexpr int ROW_KINDS = 5;

template <int R>
struct RowT {
  using Acc = int;
  static constexpr int PLANES = 1;
  static constexpr int SCORE = SCORE_ROUNDED;
};
template <>
struct RowT<ROWS_BF16_ROUNDED> {
  using Acc = float;
  static constexpr int PLANES = 3;
  static constexpr int SCORE = SCORE_ROUNDED;
};
template <>
struct RowT<ROWS_BF16_COMPARE> {
  using Acc = float;
  static constexpr int PLANES = 1;
  static constexpr int SCORE = SCORE_COMPARE;
};
template <>
struct RowT<ROWS_INT8_EXACT> {
  using Acc = int;
  static constexpr int PLANES = 1;
  static constexpr int SCORE = SCORE_EXACT;
};
template <>
struct RowT<ROWS_BF16_EXACT> {
  using Acc = float;
  static constexpr int PLANES = 3;
  static constexpr int SCORE = SCORE_EXACT;
};

__host__ __device__ constexpr bool is_int8(int kind) {
  return kind == ROWS_INT8 || kind == ROWS_INT8_EXACT;
}
__host__ __device__ constexpr int planes_of(int kind) {
  return kind == ROWS_BF16_ROUNDED || kind == ROWS_BF16_EXACT ? 3 : 1;
}
__host__ __device__ constexpr int elem_bytes(int kind) {
  return is_int8(kind) ? 1 : 2;
}
// The rounded folds carry -0.0 as 0x80000001 until the merge writes it
// back.
__host__ __device__ constexpr bool unrounds(int kind) {
  return kind == ROWS_INT8 || kind == ROWS_BF16_ROUNDED;
}

__host__ __device__ constexpr int cta_queries(int qg) { return QB * qg; }
// Entries from one row's list to the next: k rounded up to an odd count,
// so the eight rows a warp's lanes offer to at once sit in distinct
// shared-memory banks (k = 32 would put all eight in one).
__host__ __device__ constexpr int list_stride(int k) { return k | 1; }
__host__ __device__ constexpr int tile_docs(int qg) {
  return 2 * WG_DOCS / qg;
}

// Bytes of one ring slot and of the whole dynamic shared memory: alignment
// slack, ring, resident query planes, barriers, two tiles' doc
// multipliers, each row's published worst score and lock, the running
// lists, and (MODE_COUNTED) each row's counters. ops/kernels/
// cluster_topk.py's cluster_smem_bytes computes the same number.
__host__ __device__ inline int slot_bytes(int qg, int planes,
                                          bool resident) {
  return tile_docs(qg) * CH + (resident ? 0 : planes * cta_queries(qg) * CH);
}
__host__ __device__ inline long long smem_bytes(int qg, int nck, int planes,
                                                int k, int stages,
                                                bool resident,
                                                bool counted = false) {
  const long long q = cta_queries(qg);
  return ALIGN +
         static_cast<long long>(stages) * slot_bytes(qg, planes, resident) +
         (resident ? static_cast<long long>(nck) * planes * q * CH : 0) +
         16LL * stages + 8LL * tile_docs(qg) + q * (8 + 8LL * list_stride(k)) +
         (counted ? 4LL * CLUSTER_COUNTERS * q : 0);
}

struct Args {
  const int8_t* q;       // [PLANES][B] query rows of rowb bytes
  const int8_t* e;       // the pass's row r at e + r * stride
  const float* escale;   // int8 rows: row r's scale at escale[r * sstride]
  const uint8_t* mask;   // bf16 rows: row r kept iff mask[r * sstride]
                         // (null: every row)
  const float* seed;     // [B] tau, or null: lists start at -inf;
                         // MODE_COMPARE: the pinned thresholds
  // Or (the main pass of bf16 rows, or a counted probe) an earlier pass's
  // top k [B][k], ids in its rows, every list_every-th of these: see
  // seed_lists.
  const float* list_v;
  const int* list_i;
  int list_every;
  long long stride;      // bytes from one row to the next
  int sstride;
  int B, rows, rowb, k;  // rows: the pass's row count (ids 0..rows - 1);
                         // rowb: bytes of a row and of a query row
  int nck, stages, cl, tiles, per_group;
  float* part_v;         // [B][per_group][k] (MODE_FULL, MODE_COUNTED)
  int* part_i;
  unsigned* words;       // MODE_STAGE: [groups * cl][per_group]
  float* best;           // MODE_SCORE: [B]
  int* counts;           // MODE_COMPARE: [B]; MODE_COUNTED:
                         // [B][per_group][CLUSTER_COUNTERS]
};

// The running lists of a CTA's rows, in shared memory: each row's k
// entries as a binary heap with the worst entry under (score desc, id
// asc) on top, so the threshold is entry 0; its score published for the
// other warpgroup's threshold.
struct Lists {
  float* run_v;    // [rows][stride]: entries 0..k-1 of each
  int* run_i;      // [rows][stride]
  float* worst_v;  // [rows]: entry 0's score
  int* lock;       // [rows]: 0 free, 1 held (rows two warps share)
  int* cnt;        // MODE_COUNTED: [rows][CLUSTER_COUNTERS]
  int k, stride;
};

// Put (cv, ci), which beats the top of the heap hv / hi of k entries, in
// place of it and sift it down: at each level the worse child moves up
// while the candidate beats it. By one thread.
__device__ __forceinline__ void heap_replace_top(float* hv, int* hi, int k,
                                                 float cv, int ci) {
  int x = 0;
  for (;;) {
    int c = 2 * x + 1;
    if (c >= k) break;
    float v = hv[c];
    int id = hi[c];
    if (c + 1 < k) {
      const float v2 = hv[c + 1];
      const int id2 = hi[c + 1];
      if (better(v, id, v2, id2)) {
        c += 1;
        v = v2;
        id = id2;
      }
    }
    if (!better(cv, ci, v, id)) break;
    hv[x] = v;
    hi[x] = id;
    x = c;
  }
  hv[x] = cv;
  hi[x] = ci;
}

// A bound below which an unrounded score x cannot give a selection score
// at least t: the exact kinds select on x itself, so t; the rounded and
// compare kinds' bf16 rounding moves x by at most half an ulp, 2^-8 |x|
// (2^-134 among the denormals). (t = -inf: -inf; t = +inf, a row past B:
// +inf or NaN, which no finite x reaches.)
template <int SCORE>
__device__ __forceinline__ float prefilter_bound(float t) {
  if constexpr (SCORE == SCORE_EXACT) {
    return t;
  } else {
    return t - fabsf(t) * 0.0078125f - 1.0e-40f;
  }
}

// Float max through the integer atomics: floats with the sign bit clear
// order as signed ints, those with it set (-0.0 included) reversed as
// unsigned ints.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

// Offer the selection score v of doc to row r's heap, by one thread:
// under the row's lock where two warps share it (LOCKED); the top read
// afresh, as another lane or warp may have raised it. COUNT: an insertion
// adds to the row's CNT_INSERTED.
template <bool LOCKED, bool COUNT>
__device__ __forceinline__ void offer(const Lists& L, int r, float v,
                                      int doc) {
  float* hv = L.run_v + r * L.stride;
  int* hid = L.run_i + r * L.stride;
  if constexpr (LOCKED) {
    while (atomicCAS(L.lock + r, 0, 1) != 0) {
    }
    __threadfence_block();
  }
  // The top read afresh; the sift below reads the heap with plain loads,
  // which the compiler may schedule together: the row is this thread's alone
  // until it lets go (the lock, or its turn among the lanes of the row).
  if (better(v, doc, *reinterpret_cast<volatile float*>(hv),
             *reinterpret_cast<volatile int*>(hid))) {
    heap_replace_top(hv, hid, L.k, v, doc);
    *reinterpret_cast<volatile float*>(L.worst_v + r) = hv[0];
    if constexpr (COUNT) {
      atomicAdd(L.cnt + r * CLUSTER_COUNTERS + CNT_INSERTED, 1);
    }
  }
  if constexpr (LOCKED) {
    __threadfence_block();
    atomicExch(L.lock + r, 0);
  }
}

// The warp's hits of a tile into the rows' heaps. hm has bit i set where
// the thread's accumulator acc[i] (i = 4 j + 2 h + e: row r0 + 8 h, doc d0
// + 8 j + e, multiplier sc[8 j + e]) passed its row's bound as the tile's
// test ran. Each round every lane takes its lowest hit (its accumulator
// picked out by an unrolled select, so the array stays in registers);
// the four lanes that hold a row offer in turn, the warp's eight rows
// side by side; then every lane takes its rows' tops as thresholds (a
// shared row's top score alone, with the largest id: a read without the
// lock may be torn). Rounds run while any lane has a hit left: one or two
// a tile on the main pass, where the old loop stepped through all 16
// column pairs of every tile with a hit. COUNT: every hit that beats its
// row's list as the tile began (sv, si) adds to ent, whether or not it is
// still offered.
template <int SCORE, bool LOCKED, bool COUNT, typename Acc>
__device__ __forceinline__ void insert_hits(
    const Acc (&acc)[64], unsigned long long hm, const float* sc, int d0,
    int r0, const Args& a, const Lists& L, int lane, float (&tv)[2],
    int (&ti)[2], const float (&sv)[2], const int (&si)[2], int (&ent)[2]) {
  while (__any_sync(FULL, hm != 0ull)) {
    const int i = hm != 0ull ? __ffsll(static_cast<long long>(hm)) - 1 : -1;
    hm &= hm - 1ull;
    float x = 0.f;
#pragma unroll
    for (int c = 0; c < 64; ++c) {
      if (c == i) x = static_cast<float>(acc[c]);
    }
    const int j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    const int doc = d0 + 8 * j + e;
    if (i >= 0) x *= sc[8 * j + e];
    if constexpr (COUNT) {
      if (i >= 0 && doc < a.rows) {
        const float v = selection_score<SCORE>(x);
        const bool in = h ? better(v, doc, sv[1], si[1])
                          : better(v, doc, sv[0], si[0]);
        ent[0] += h == 0 && in;
        ent[1] += h == 1 && in;
      }
    }
    for (int g = 0; g < 4; ++g) {
      if (lane % 4 == g && i >= 0 && doc < a.rows &&
          x >= prefilter_bound<SCORE>(tv[h])) {
        offer<LOCKED, COUNT>(L, r0 + 8 * h, selection_score<SCORE>(x), doc);
      }
      __syncwarp();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if constexpr (LOCKED) {
        const float w = *reinterpret_cast<volatile float*>(L.worst_v + r);
        if (w > tv[hh]) {
          tv[hh] = w;
          ti[hh] = EMPTY_ID;
        }
      } else {
        tv[hh] = *reinterpret_cast<volatile float*>(L.run_v + r * L.stride);
        ti[hh] = *reinterpret_cast<volatile int*>(L.run_i + r * L.stride);
      }
    }
  }
}

// The main pass's lists seeded from an earlier pass's top k of its rows:
// the listed docs outside this walker's docs [d_lo, d_hi), each as (its
// score lowered, EMPTY_ID), the other slots (tau, EMPTY_ID) with tau the
// k-th score lowered, in ascending order: a heap with the worst on top.
// Its k entries stand for k distinct docs, each scoring at least its
// entry (the walker meets its own listed docs itself and counts them
// then), so the top stays at most the k-th best of all docs while rising
// with every doc the walker takes in, where k copies of tau stay put
// until k docs have come in. Rows past B hold (inf, EMPTY_ID).
__device__ void seed_lists(const Args& a, const Lists& L, int Q, int q0,
                           long long d_lo, long long d_hi, int tid,
                           int threads) {
  for (int r = tid; r < Q; r += threads) {
    const int row = q0 + r;
    float* hv = L.run_v + r * L.stride;
    int* hid = L.run_i + r * L.stride;
    L.lock[r] = 0;
    if (row >= a.B) {
      for (int x = 0; x < a.k; ++x) {
        hv[x] = INFINITY;
        hid[x] = EMPTY_ID;
      }
      L.worst_v[r] = INFINITY;
      continue;
    }
    const float* lv = a.list_v + static_cast<size_t>(row) * a.k;
    const int* li = a.list_i + static_cast<size_t>(row) * a.k;
    auto outside = [&](int j) {
      const long long doc = static_cast<long long>(li[j]) * a.list_every;
      return li[j] >= 0 && (doc < d_lo || doc >= d_hi);
    };
    int kept = 0;
    for (int j = 0; j < a.k; ++j) kept += outside(j);
    const float tau = lowered(lv[a.k - 1]);
    int x = 0;
    for (; x < a.k - kept; ++x) {
      hv[x] = tau;
      hid[x] = EMPTY_ID;
    }
    for (int j = a.k - 1; j >= 0; --j) {
      if (outside(j)) {
        hv[x] = lowered(lv[j]);
        hid[x] = EMPTY_ID;
        ++x;
      }
    }
    L.worst_v[r] = hv[0];
  }
}

// Bytes [off, off + 4) of a row of len bytes at p (zero past len), at any
// alignment.
__device__ __forceinline__ unsigned load_word(const int8_t* p, int off,
                                              int len) {
  const int8_t* at = p + off;
  if (off + 4 <= len && (reinterpret_cast<uintptr_t>(at) & 3u) == 0u) {
    return *reinterpret_cast<const unsigned*>(at);
  }
  unsigned v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (off + b < len) {
      v |= static_cast<unsigned>(static_cast<uint8_t>(at[b])) << (8 * b);
    }
  }
  return v;
}

// Rows [row0, row0 + rows) x depth chunk c of src (rows ``stride`` bytes
// apart, ``valid`` rows, ``len`` bytes each) into a swizzled [rows][CH]
// chunk at dst, zero past them; by the 32 lanes of one warp. Generic
// stores: the caller fences them into the async proxy that wgmma reads.
__device__ __forceinline__ void load_rows(char* dst, const int8_t* src,
                                          long long stride, int row0,
                                          int rows, int valid, int len, int c,
                                          int lane) {
  for (int x = lane; x < rows * (CH / 4); x += 32) {
    const int r = x / (CH / 4), w = x % (CH / 4), row = row0 + r;
    const int off = c * CH + 4 * w;
    unsigned v = 0u;
    if (row < valid && off < len) v = load_word(src + row * stride, off, len);
    *reinterpret_cast<unsigned*>(dst + word_at(r, w)) = v;
  }
}

// MODE_SCORE's running maxima of a thread's two rows over a tile's scores
// acc[4 j + 2 h + e] * sc[8 j + e] (doc d0 + 8 j + e, below rows).
template <int SCORE, typename Acc>
__device__ __forceinline__ void row_best(const Acc (&acc)[64],
                                         const float* sc, float (&best)[2],
                                         int d0, int rows) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = static_cast<float>(acc[4 * j + 2 * h + e]) *
                        sc[8 * j + e];
        if (d0 + 8 * j + e < rows) {
          best[h] = fmaxf(best[h], selection_score<SCORE>(x));
        }
      }
    }
  }
}

// grid = (clusters per group x cl, groups); block = KTHREADS. CTA rank r
// of cluster i in group g owns queries Q (g cl + r).. and walks the i-th
// of per_group contiguous ranges of tiles. R: the rows (RowKind). TMA:
// the doc chunks through the tensor map, shared by the cluster; else the
// producer warp's element loads, per CTA. QRES: the query planes
// resident; else each slot carries its query chunk. MODE: the work (see
// the top of this file).
template <int R, int QG, bool TMA, bool QRES, int MODE>
__global__ void __launch_bounds__(KTHREADS, 1)
    cluster_topk_kernel(const __grid_constant__ CUtensorMap map,
                        const Args a) {
  using Acc = typename RowT<R>::Acc;
  constexpr int P = RowT<R>::PLANES, SCORE = RowT<R>::SCORE;
  constexpr bool INT8 = is_int8(R);
  constexpr bool COUNT = MODE == MODE_COUNTED;
  constexpr bool FOLD = MODE == MODE_FULL || COUNT;  // offers to the lists
  constexpr bool STAGE = MODE == MODE_STAGE;
  static_assert(!TMA || QRES, "TMA runs with the query block resident");
  static_assert(INT8 || QRES, "bf16 rows keep their query planes resident");
  constexpr int Q = cta_queries(QG), T = tile_docs(QG);
  // One query group: both warpgroups hold every row (each for half the
  // tile's docs), so a row's heap is taken under its lock.
  constexpr bool LOCKED = QG == 1;
  extern __shared__ char smem_raw[];
  char* base = smem_raw + (ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN;
  const int slot_b = slot_bytes(QG, P, QRES);
  char* ring = base;
  char* qblk = ring + a.stages * slot_b;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(qblk + (QRES ? a.nck * P * Q * CH : 0));
  uint64_t* empty = full + a.stages;
  // The doc multipliers of a tile, by tile parity: [2][T].
  float* tile_sc = reinterpret_cast<float*>(empty + a.stages);
  Lists L;
  L.worst_v = tile_sc + 2 * T;
  L.lock = reinterpret_cast<int*>(L.worst_v + Q);
  L.run_v = reinterpret_cast<float*>(L.lock + Q);
  L.k = a.k;
  L.stride = list_stride(a.k);
  L.run_i = reinterpret_cast<int*>(L.run_v + Q * L.stride);
  L.cnt = L.run_i + Q * L.stride;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x % a.cl, cid = blockIdx.x / a.cl;
  const int q0 = (blockIdx.y * a.cl + rank) * Q;
  // The cluster's walk: a contiguous range of tiles.
  const int per = (a.tiles + a.per_group - 1) / a.per_group;
  const int t_begin = cid * per, t_end = min(a.tiles, t_begin + per);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, TMA ? 1 : 32);
      mbar_init(empty + s, 2 * (TMA ? a.cl : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (a.list_v != nullptr) {
    seed_lists(a, L, Q, q0, static_cast<long long>(t_begin) * T,
               static_cast<long long>(t_end) * T, tid, KTHREADS);
  } else {
    // Every slot (seed, EMPTY_ID): only a doc scoring at least the seed
    // enters. Rows past B hold (inf, EMPTY_ID), which nothing beats.
    for (int x = tid; x < Q * L.stride; x += KTHREADS) {
      const int row = q0 + x / L.stride;
      L.run_v[x] = row >= a.B            ? INFINITY
                   : a.seed != nullptr ? a.seed[row]
                                       : -INFINITY;
      L.run_i[x] = EMPTY_ID;
    }
    for (int r = tid; r < Q; r += KTHREADS) {
      const int row = q0 + r;
      L.worst_v[r] = row >= a.B ? INFINITY
                     : a.seed != nullptr ? a.seed[row]
                                         : -INFINITY;
      L.lock[r] = 0;
    }
  }
  if constexpr (COUNT) {
    for (int x = tid; x < Q * CLUSTER_COUNTERS; x += KTHREADS) {
      L.cnt[x] = x % CLUSTER_COUNTERS == CNT_SEEN ? -1 : 0;
    }
  }
  unsigned xw = 0u;  // MODE_STAGE: the XOR of the words this thread read
  if constexpr (QRES) {
    // [chunk][plane][Q][CH], zero past B and past the row.
    const int words = a.nck * (CH / 4);
    for (int x = tid; x < P * Q * words; x += KTHREADS) {
      const int pr = x / words, w = x % words;
      const int p = pr / Q, r = pr % Q, row = q0 + r;
      unsigned v = 0u;
      if (row < a.B && 4 * w < a.rowb) {
        v = load_word(a.q + (static_cast<long long>(p) * a.B + row) * a.rowb,
                      4 * w, a.rowb);
      }
      unsigned* at = reinterpret_cast<unsigned*>(
          qblk + ((w / (CH / 4)) * P + p) * Q * CH + word_at(r, w % (CH / 4)));
      *at = v;
      if constexpr (STAGE) xw ^= *reinterpret_cast<volatile unsigned*>(at);
    }
    fence_async_smem();
  }
  __syncthreads();
  if constexpr (TMA) cluster_sync();

  if (warp == CWARPS) {
    // The producer: chunk f of this CTA's walk into slot f % stages once
    // every consumer of the slot (cluster-wide with TMA) let it go.
    int f = 0;
    for (int t = t_begin; t < t_end; ++t) {
      for (int c = 0; c < a.nck; ++c, ++f) {
        const int s = f % a.stages;
        const unsigned parity = ((f / a.stages) & 1) ^ 1;
        char* slot = ring + s * slot_b;
        if constexpr (TMA) {
          if (lane == 0) {
            mbar_wait(empty + s, parity);
            mbar_expect_tx(full + s, T * CH);
            const uint16_t mask = static_cast<uint16_t>((1u << a.cl) - 1u);
            for (int box = rank; box < T / BOX_ROWS; box += a.cl) {
              tma_box(slot + box * BOX_ROWS * CH, &map, c * CH,
                      t * T + box * BOX_ROWS, full + s, mask);
            }
          }
        } else {
          mbar_wait(empty + s, parity);
          load_rows(slot, a.e, a.stride, t * T, T, a.rows, a.rowb, c, lane);
          if constexpr (!QRES) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              load_rows(slot + (T + p * Q) * CH,
                        a.q + static_cast<long long>(p) * a.B * a.rowb,
                        a.rowb, q0, Q, a.B, a.rowb, c, lane);
            }
          }
          fence_async_smem();
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    const int wg = warp / 4, wt = tid % 128;
    // This thread's accumulator rows r0, r0 + 8 (of the CTA's Q) and
    // columns dcol + 8 j + {0, 1} (of the tile's T docs).
    const int rbase = (QG == 2 ? QB * wg : 0) + 16 * (warp % 4);
    const int r0 = rbase + lane / 4;
    const int wdocs = QG == 1 ? WG_DOCS * wg : 0;
    const int dcol = wdocs + 2 * (lane % 4);
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    // Running thresholds, at most the row's worst entry; rows past B take
    // nothing ((inf, -1) is beaten by no finite score). MODE_COMPARE: the
    // pinned thresholds.
    float tv[2];
    int ti[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tv[h] = L.worst_v[r0 + 8 * h];
      ti[h] = q0 + r0 + 8 * h < a.B ? EMPTY_ID : -1;
    }
    float best[2] = {-INFINITY, -INFINITY};  // MODE_SCORE
    int n_at[2] = {0, 0};                    // MODE_COMPARE
    // MODE_COUNTED: the rows' lists as the tile began, and the entries of
    // this thread's hits against them.
    float sv[2] = {0.f, 0.f};
    int si[2] = {0, 0}, ent[2] = {0, 0};

    // The warpgroup hands slot s back: thread r releases it in CTA r,
    // once every warp of the warpgroup is done with it.
    auto release = [&](int s) {
      wg_sync(wg);
      if constexpr (TMA) {
        if (wt < a.cl) mbar_arrive_cluster(empty + s, wt);
      } else {
        if (wt == 0) mbar_arrive(empty + s);
      }
    };
    int f = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int d0 = t * T + dcol;
      // The tile's doc multipliers, one a consumer thread, loaded as the
      // tile starts and stored to shared memory once its chunks are
      // multiplied: int8 rows their scales (0 past the rows, which the
      // row test drops), bf16 rows 1 for a kept row, NaN for a masked one
      // or one past the rows.
      float my_sc = INT8 ? 0.f : __int_as_float(0x7fc00000);
      const int sdoc = t * T + tid;
      if constexpr (!STAGE) {
        if (tid < T && sdoc < a.rows) {
          const long long at = static_cast<long long>(sdoc) * a.sstride;
          if constexpr (INT8) {
            my_sc = __ldg(a.escale + at);
          } else if (a.mask == nullptr || __ldg(a.mask + at) != 0) {
            my_sc = 1.f;
          }
        }
      }
      if constexpr (!INT8) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      int prev = 0;  // bf16 rows: the slot whose products are in flight
      for (int c = 0; c < a.nck; ++c, ++f) {
        const int s = f % a.stages;
        mbar_wait(full + s, (f / a.stages) & 1);
        if constexpr (STAGE) {
          // Every word of the slot's doc chunk, read back, once by one
          // consumer thread of the CTA.
          const unsigned* w =
              reinterpret_cast<const unsigned*>(ring + s * slot_b);
          for (int x = tid; x < T * CH / 4; x += CTHREADS) xw ^= w[x];
        } else {
          const char* slot = ring + s * slot_b;
          // This chunk's query planes [P][Q][CH]: the resident block's
          // chunk c, or the slot's own; this warpgroup's 64 rows of them.
          const char* qc =
              (QRES ? qblk + c * P * Q * CH : slot + T * CH) +
              (QG == 2 ? wg * QB * CH : 0);
          const uint64_t db = sw128_desc(slot + wdocs * CH);
          if constexpr (INT8) {
            const uint64_t da = sw128_desc(qc);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < CH / 32; ++ks) {
              wgmma_s8(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin(acc);
          } else {
            // Onto the tile's running sums (zeroed as it starts): each
            // k-step's planes lo, mid, hi (or bf16(q)) in turn.
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < CH / 32; ++ks) {
#pragma unroll
              for (int p = P - 1; p >= 0; --p) {
                wgmma_bf16(acc, sw128_desc(qc + p * Q * CH) + 2 * ks,
                           db + 2 * ks, 1);
              }
            }
            wgmma_commit();
            // This chunk's products stay in flight while the next slot is
            // waited on; the previous chunk's are done, and its slot goes
            // back.
            wgmma_wait<1>();
          }
        }
        if constexpr (INT8 || STAGE) {
          release(s);
        } else {
          if (c > 0) release(prev);
          prev = s;
        }
      }
      if constexpr (!INT8 && !STAGE) {
        wgmma_wait<0>();
        pin(acc);
        release(prev);
      }
      if constexpr (!STAGE) {
        // The multipliers to shared memory, by tile parity: a warp that
        // runs a tile ahead writes the other half, and none runs two ahead
        // past this barrier.
        float* sc_all = tile_sc + (t & 1) * T;
        if (tid < T) sc_all[tid] = my_sc;
        asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMERS_BAR), "n"(CTHREADS)
                     : "memory");
        const float* sc = sc_all + dcol;
        if constexpr (MODE == MODE_SCORE) {
          // Each row's best selection score: fmaxf drops a masked doc's
          // NaN; the TMA's zero rows past N, in the last tile alone, are
          // left out by row index.
          if ((t + 1) * T <= a.rows) {
            row_best<SCORE>(acc, sc, best, d0, INT_MAX);
          } else {
            row_best<SCORE>(acc, sc, best, d0, a.rows);
          }
        } else {
          if constexpr (FOLD && LOCKED) {
            // The other warpgroup may have raised a shared row's worst
            // score: (that score, the largest id) is still at most its
            // worst entry.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float w =
                  *reinterpret_cast<volatile float*>(L.worst_v + r0 + 8 * h);
              if (w > tv[h]) {
                tv[h] = w;
                ti[h] = EMPTY_ID;
              }
            }
          }
          if constexpr (COUNT) {
            // The lists as the tile begins: every insertion of the last
            // tile is done (the barrier above), and none of this one
            // starts before every snapshot is taken (QG = 1: the barrier
            // below; QG = 2: a warp's rows are its own).
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              sv[h] =
                  *reinterpret_cast<volatile float*>(L.run_v + r * L.stride);
              si[h] = *reinterpret_cast<volatile int*>(L.run_i + r * L.stride);
            }
            if constexpr (LOCKED) {
              asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMERS_BAR),
                           "n"(CTHREADS)
                           : "memory");
            }
          }
          // Every score against its row's bound, unrounded; the rounded
          // test only where one passes.
          const float lo[2] = {prefilter_bound<SCORE>(tv[0]),
                               prefilter_bound<SCORE>(tv[1])};
          unsigned long long hm = 0ull;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = 4 * j + 2 * h + i;
                const float x = static_cast<float>(acc[c]) * sc[8 * j + i];
                if (x >= lo[h]) {
                  hm |= 1ull << c;
                  if constexpr (MODE == MODE_COMPARE) {
                    n_at[h] += d0 + 8 * j + i < a.rows &&
                               selection_score<SCORE>(x) >= tv[h];
                  }
                }
              }
            }
          }
          if constexpr (FOLD) {
            insert_hits<SCORE, LOCKED, COUNT>(acc, hm, sc, d0, r0, a, L,
                                              lane, tv, ti, sv, si, ent);
          }
          if constexpr (COUNT) {
            // The tile's entries of each row, over the four lanes that
            // hold it (and, QG = 1, both warpgroups, through the atomics).
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int e = ent[h];
              e += __shfl_xor_sync(FULL, e, 1);
              e += __shfl_xor_sync(FULL, e, 2);
              int* cnt = L.cnt + (r0 + 8 * h) * CLUSTER_COUNTERS;
              if (lane % 4 == 0 && e > 0) {
                atomicAdd(cnt + (t - t_begin < EARLY_TILES ? CNT_EARLY
                                                           : CNT_LATE),
                          e);
                if (atomicMax(cnt + CNT_SEEN, t) < t) {
                  atomicAdd(cnt + CNT_TILES, 1);
                }
              }
              ent[h] = 0;
            }
          }
        }
      }
    }
    if constexpr (MODE == MODE_SCORE || MODE == MODE_COMPARE) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if constexpr (MODE == MODE_SCORE) {
          float v = best[h];
          v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
          v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
          if (lane % 4 == 0 && row < a.B && v > -INFINITY) {
            atomic_max_f32(a.best + row, v);
          }
        } else {
          int n = n_at[h];
          n += __shfl_xor_sync(FULL, n, 1);
          n += __shfl_xor_sync(FULL, n, 2);
          if (lane % 4 == 0 && row < a.B && n != 0) {
            atomicAdd(a.counts + row, n);
          }
        }
      }
    }
    if constexpr (FOLD) {
      // Every insertion of the CTA done: the lists to the walker's slot.
      asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMERS_BAR), "n"(CTHREADS)
                   : "memory");
      for (int x = tid; x < Q * a.k; x += CTHREADS) {
        const int r = x / a.k, row = q0 + r;
        if (row < a.B) {
          const size_t o =
              (static_cast<size_t>(row) * a.per_group + cid) * a.k + x % a.k;
          a.part_v[o] = L.run_v[r * L.stride + x % a.k];
          a.part_i[o] = L.run_i[r * L.stride + x % a.k];
        }
      }
      if constexpr (COUNT) {
        for (int x = tid; x < Q * CLUSTER_COUNTERS; x += CTHREADS) {
          const int r = x / CLUSTER_COUNTERS, c = x % CLUSTER_COUNTERS;
          const int row = q0 + r;
          if (row < a.B) {
            a.counts[(static_cast<size_t>(row) * a.per_group + cid) *
                         CLUSTER_COUNTERS +
                     c] = c == CNT_SEEN ? max(0, t_end - t_begin) : L.cnt[x];
          }
        }
      }
    }
  }
  if constexpr (STAGE) {
    // The CTA's XOR: the producer warp's share of the query planes and
    // every consumer's words.
    for (int off = 16; off > 0; off >>= 1) {
      xw ^= __shfl_xor_sync(FULL, xw, off);
    }
    if (lane == 0 && xw != 0u) {
      atomicXor(a.words + static_cast<size_t>(blockIdx.y * a.cl + rank) *
                              a.per_group +
                    cid,
                xw);
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers.
  if constexpr (TMA) cluster_sync();
}

// -- host side ------------------------------------------------------------------

template <int R, int QG, bool TMA, bool QRES, int MODE>
cudaError_t launch_kernel(const Args& a, int groups, int smem,
                          cudaStream_t stream) {
  CUtensorMap map{};
  if (TMA) {
    const cudaError_t err =
        encode_rows(&map, a.e, a.rowb, a.rows, a.stride, BOX_ROWS);
    if (err != cudaSuccess) return err;
  }
  return launch_clustered(cluster_topk_kernel<R, QG, TMA, QRES, MODE>,
                          dim3(a.per_group * a.cl, groups, 1), KTHREADS, smem,
                          TMA ? a.cl : 0, stream, map, a);
}

// The launch shape of one call (cluster_plan's).
struct Shape {
  int qg, cl, groups, stages, resident, smem;
};

bool kind_ok(int kind) { return kind >= 0 && kind < ROW_KINDS; }

int chunks(int kind, int D) {
  return static_cast<int>(
      (static_cast<long long>(D) * elem_bytes(kind) + CH - 1) / CH);
}

bool shape_ok(int kind, const Shape& p, int B, int D, int k,
              bool counted = false) {
  return kind_ok(kind) && B >= 1 && D >= 1 && k >= 1 && k <= MAX_K &&
         (p.qg == 1 || p.qg == 2) && p.cl >= 1 && p.cl <= MAX_CLUSTER &&
         p.groups >= 1 &&
         static_cast<long long>(p.groups) * p.cl * cta_queries(p.qg) >= B &&
         p.stages >= 1 && p.stages <= MAX_STAGES &&
         (is_int8(kind) || p.resident) &&
         p.smem >= smem_bytes(p.qg, chunks(kind, D), planes_of(kind), k,
                              p.stages, p.resident != 0, counted) &&
         p.smem <= SMEM_LIMIT;
}

// TMA takes rows of a 16-byte aligned base and stride, a whole chunk deep,
// at least one box of them, the query block resident.
bool tma_ok(const Args& a, int resident) {
  return resident && a.rowb % 16 == 0 && a.rowb >= CH && a.stride % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.e) % 16 == 0 && a.rows >= BOX_ROWS;
}

// One MODE_FULL pass of rows R on any route the rows allow (bf16 rows:
// query planes resident).
template <int R, int QG>
cudaError_t launch_full(const Args& a, int tma, int resident, int groups,
                        int smem, cudaStream_t s) {
  if (tma) {
    return launch_kernel<R, QG, true, true, MODE_FULL>(a, groups, smem, s);
  }
  if (resident) {
    return launch_kernel<R, QG, false, true, MODE_FULL>(a, groups, smem, s);
  }
  if constexpr (is_int8(R)) {
    return launch_kernel<R, QG, false, false, MODE_FULL>(a, groups, smem, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t run_full(const Shape& p, const Args& a, int tma,
                     cudaStream_t s) {
  if (a.per_group < 1 || (tma && !tma_ok(a, p.resident))) {
    return cudaErrorInvalidValue;
  }
  return p.qg == 1
             ? launch_full<R, 1>(a, tma, p.resident, p.groups, p.smem, s)
             : launch_full<R, 2>(a, tma, p.resident, p.groups, p.smem, s);
}

// Rows every ``every``-th of them: 1 (the main pass), TAU_STRIDE (the tau
// pass) or SEED_STRIDE (the seed pass).
constexpr int SEED_STRIDE = TAU_STRIDE * TAU_STRIDE;

// The pass over every ``every``-th row of e (rows rowb bytes apart).
Args pass_args(const Shape& p, const int8_t* q, const int8_t* e,
               const float* scales, const uint8_t* mask, int B, int N,
               int rowb, int k, int every, int per_group) {
  Args a{};
  a.q = q;
  a.e = e;
  a.escale = scales;
  a.mask = mask;
  a.stride = static_cast<long long>(rowb) * every;
  a.sstride = every;
  a.B = B;
  a.rows = (N + every - 1) / every;
  a.rowb = rowb;
  a.k = k;
  a.nck = (rowb + CH - 1) / CH;
  a.stages = p.stages;
  a.cl = p.cl;
  a.tiles = (a.rows + tile_docs(p.qg) - 1) / tile_docs(p.qg);
  a.per_group = per_group;
  return a;
}

// The workspace of one call: the main pass's lists [B][walkers][k], the
// tau pass's [B][tau_walkers][k], the seed pass's [B][seed_walkers][k],
// tau [B], the seed pass's tau [B], (three-plane bf16 rows) the query's
// bf16 planes [3][B][D] and (bf16 rows) the tau and seed passes' top k
// [B][k] (values and ids); each piece on a 256-byte boundary. With base
// null only *bytes is filled.
struct Workspace {
  float* part_v;
  int* part_i;
  float* tau_v;
  int* tau_i;
  float* seed_v;
  int* seed_i;
  float* tau;
  float* seed;
  uint16_t* pieces;
  float* top_v;  // bf16 rows: the tau pass's top k [B][k]
  int* top_i;
  float* seed_top_v;  // bf16 rows: the seed pass's top k [B][k]
  int* seed_top_i;
};

Workspace carve(void* base, int B, int k, int walkers, int tau_walkers,
                int seed_walkers, size_t piece_bytes, bool top,
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
  const size_t seed = static_cast<size_t>(B) * seed_walkers * k;
  Workspace ws;
  ws.part_v = reinterpret_cast<float*>(take(4 * main));
  ws.part_i = reinterpret_cast<int*>(take(4 * main));
  ws.tau_v = reinterpret_cast<float*>(take(4 * sub));
  ws.tau_i = reinterpret_cast<int*>(take(4 * sub));
  ws.seed_v = reinterpret_cast<float*>(take(4 * seed));
  ws.seed_i = reinterpret_cast<int*>(take(4 * seed));
  ws.tau = reinterpret_cast<float*>(take(4 * static_cast<size_t>(B)));
  ws.seed = reinterpret_cast<float*>(take(4 * static_cast<size_t>(B)));
  ws.pieces = reinterpret_cast<uint16_t*>(take(piece_bytes));
  const size_t list = top ? static_cast<size_t>(B) * k : 0;
  ws.top_v = reinterpret_cast<float*>(take(4 * list));
  ws.top_i = reinterpret_cast<int*>(take(4 * list));
  ws.seed_top_v = reinterpret_cast<float*>(take(4 * list));
  ws.seed_top_i = reinterpret_cast<int*>(take(4 * list));
  if (bytes != nullptr) *bytes = off;
  return ws;
}

size_t piece_bytes(int kind, int B, int D) {
  return planes_of(kind) == 3 ? 6 * static_cast<size_t>(B) * D : 0;
}

size_t workspace_bytes(int kind, int B, int D, int k, int walkers,
                       int tau_walkers, int seed_walkers) {
  size_t bytes = 0;
  carve(nullptr, B, k, walkers, tau_walkers, seed_walkers,
        piece_bytes(kind, B, D), !is_int8(kind), &bytes);
  return bytes;
}

// A MODE_FULL pass of rows ``kind``: pass(kind, shape, args, tma, stream)
// of the including source, which instantiates the kinds it runs.
using FullPass = cudaError_t (*)(int, const Shape&, const Args&, int,
                                 cudaStream_t);

// One pass (MODE_FULL) and the merge of its walkers' lists in the merge's
// tau mode: tau_out[b] = the k-th best of the pass's rows, lowered (-inf
// with fewer than k candidates).
cudaError_t tau_of(FullPass pass, int kind, const Shape& p, Args a, int tma,
                   float* part_v, int* part_i, float* tau_out,
                   cudaStream_t s) {
  a.part_v = part_v;
  a.part_i = part_i;
  const cudaError_t err = pass(kind, p, a, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(part_v, part_i, a.B, a.per_group * a.k, a.k, nullptr,
                      nullptr, nullptr, tau_out, s);
}

// One pass (MODE_FULL) and the merge of its walkers' lists into its top k
// (top_v / top_i [B][k], the pass's row ids; no rounding undone).
cudaError_t top_of(FullPass pass, int kind, const Shape& p, Args a, int tma,
                   float* part_v, int* part_i, float* top_v, int* top_i,
                   cudaStream_t s) {
  a.part_v = part_v;
  a.part_i = part_i;
  const cudaError_t err = pass(kind, p, a, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(part_v, part_i, a.B, a.per_group * a.k, a.k, nullptr,
                      top_v, top_i, nullptr, s);
}

// The seed pass over every SEED_STRIDE-th row and the merge in its tau
// mode; the tau pass over every TAU_STRIDE-th row, its lists seeded with
// the seed pass's tau (those rows are among its own, so its k-th best is
// the same), and the merge in its tau mode; the main pass seeded with
// tau; the merge of the walkers' lists (times q_scales where given; the
// rounded -0.0 written back). bf16 rows hand each pass's top k on
// instead of its tau (seed_lists). Each pass takes TMA or element loads
// (*tma) and walkers of its own.
cudaError_t run_call(FullPass pass, int kind, const Shape& p,
                     const int8_t* q, const float* q_scales, const int8_t* e,
                     const float* scales, const uint8_t* mask, int B, int N,
                     int D, int k, int tma, int walkers, int tau_tma,
                     int tau_walkers, int seed_tma, int seed_walkers,
                     const Workspace& ws, float* out_v, int* out_i,
                     cudaStream_t s) {
  const int rowb = D * elem_bytes(kind);
  Args seed = pass_args(p, q, e, scales, mask, B, N, rowb, k, SEED_STRIDE,
                        seed_walkers);
  Args sub = pass_args(p, q, e, scales, mask, B, N, rowb, k, TAU_STRIDE,
                       tau_walkers);
  Args main = pass_args(p, q, e, scales, mask, B, N, rowb, k, 1, walkers);
  cudaError_t err;
  if (is_int8(kind)) {
    err = tau_of(pass, kind, p, seed, seed_tma, ws.seed_v, ws.seed_i,
                 ws.seed, s);
    if (err != cudaSuccess) return err;
    sub.seed = ws.seed;
    err = tau_of(pass, kind, p, sub, tau_tma, ws.tau_v, ws.tau_i, ws.tau, s);
    main.seed = ws.tau;
  } else {
    // bf16 rows: each pass's top k itself (the merge in list mode) seeds
    // the next pass's lists (seed_lists); a seed pass row is every
    // (SEED_STRIDE / TAU_STRIDE)-th tau pass row.
    err = top_of(pass, kind, p, seed, seed_tma, ws.seed_v, ws.seed_i,
                 ws.seed_top_v, ws.seed_top_i, s);
    if (err != cudaSuccess) return err;
    sub.list_v = ws.seed_top_v;
    sub.list_i = ws.seed_top_i;
    sub.list_every = SEED_STRIDE / TAU_STRIDE;
    err = top_of(pass, kind, p, sub, tau_tma, ws.tau_v, ws.tau_i, ws.top_v,
                 ws.top_i, s);
    main.list_v = ws.top_v;
    main.list_i = ws.top_i;
    main.list_every = TAU_STRIDE;
  }
  if (err != cudaSuccess) return err;
  main.part_v = ws.part_v;
  main.part_i = ws.part_i;
  err = pass(kind, p, main, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(ws.part_v, ws.part_i, B, walkers * k, k, q_scales,
                      out_v, out_i, nullptr, s, unrounds(kind));
}

// The query planes of a whole call over bf16 rows: three-plane kinds split
// the f32 query into the workspace first; K1c takes bf16(q) as it is.
cudaError_t bf16_planes(int kind, const void* q, int B, int D,
                        const Workspace& ws, cudaStream_t s,
                        const int8_t** planes) {
  *planes = static_cast<const int8_t*>(q);
  if (planes_of(kind) != 3) return cudaSuccess;
  const cudaError_t err = launch_split_query(
      static_cast<const float*>(q), static_cast<long long>(B) * D, ws.pieces,
      s);
  *planes = reinterpret_cast<const int8_t*>(ws.pieces);
  return err;
}

template <int R, int MODE>
int active_clusters_of(int qg, int cl, int smem) {
  return qg == 1 ? max_active_clusters(
                       cluster_topk_kernel<R, 1, true, true, MODE>, KTHREADS,
                       cl, smem)
                 : max_active_clusters(
                       cluster_topk_kernel<R, 2, true, true, MODE>, KTHREADS,
                       cl, smem);
}

}  // namespace
