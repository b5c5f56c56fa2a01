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
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success). The caller allocates the workspace
// (anr_cluster_workspace_bytes).

#include <cuda.h>
#include <cuda_runtime.h>
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

// MODE_FULL: the fold's pass. The probe's anatomy runs the same launch
// with less work: MODE_STREAM the ring alone (each chunk handed back
// unread), MODE_MMA + the multiply, MODE_EPILOGUE + the epilogue's
// threshold test, counting into probe the tiles where a thread's scores
// passed a bound instead of offering them.
enum Mode : int {
  MODE_FULL = 0,
  MODE_STREAM = 1,
  MODE_MMA = 2,
  MODE_EPILOGUE = 3
};

// The rows a call multiplies: int8 with per-row scales (K2r), or bf16
// against the f32 query's three planes (K1r) or against bf16(q) (K1c).
enum RowKind : int {
  ROWS_INT8 = 0,
  ROWS_BF16_ROUNDED = 1,
  ROWS_BF16_COMPARE = 2
};

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

__host__ __device__ constexpr int planes_of(int kind) {
  return kind == ROWS_BF16_ROUNDED ? 3 : 1;
}
__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == ROWS_INT8 ? 1 : 2;
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
// lists. ops/kernels/cluster_topk.py's cluster_smem_bytes computes the
// same number.
__host__ __device__ inline int slot_bytes(int qg, int planes,
                                          bool resident) {
  return tile_docs(qg) * CH + (resident ? 0 : planes * cta_queries(qg) * CH);
}
__host__ __device__ inline long long smem_bytes(int qg, int nck, int planes,
                                                int k, int stages,
                                                bool resident) {
  const long long q = cta_queries(qg);
  return ALIGN +
         static_cast<long long>(stages) * slot_bytes(qg, planes, resident) +
         (resident ? static_cast<long long>(nck) * planes * q * CH : 0) +
         16LL * stages + 8LL * tile_docs(qg) + q * (8 + 8LL * list_stride(k));
}

struct Args {
  const int8_t* q;       // [PLANES][B] query rows of rowb bytes
  const int8_t* e;       // the pass's row r at e + r * stride
  const float* escale;   // int8 rows: row r's scale at escale[r * sstride]
  const uint8_t* mask;   // bf16 rows: row r kept iff mask[r * sstride]
                         // (null: every row)
  const float* seed;     // [B] tau, or null: lists start at -inf
  // Or (bf16 rows' main pass) the tau pass's top k [B][k], ids in its
  // rows, every list_every-th of these: see seed_lists.
  const float* list_v;
  const int* list_i;
  int list_every;
  long long stride;      // bytes from one row to the next
  int sstride;
  int B, rows, rowb, k;  // rows: the pass's row count (ids 0..rows - 1);
                         // rowb: bytes of a row and of a query row
  int nck, stages, cl, tiles, per_group;
  float* part_v;         // [B][per_group][k] (MODE_FULL)
  int* part_i;
  int* probe;            // MODE_EPILOGUE: tests passed, added
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

// A bound below which an unrounded score x cannot round to a selection
// score at least t: bf16 rounding moves x by at most half an ulp, 2^-8 |x|
// (2^-134 among the denormals). (t = -inf: -inf; t = +inf, a row past B:
// NaN, which no x reaches.)
__device__ __forceinline__ float prefilter_bound(float t) {
  return t - fabsf(t) * 0.0078125f - 1.0e-40f;
}

// Offer the selection score v of doc to row r's heap, by one thread:
// under the row's lock where two warps share it (LOCKED); the top read
// afresh, as another lane or warp may have raised it.
template <bool LOCKED>
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
  // which the compiler may issue together: the row is this thread's alone
  // until it lets go (the lock, or its turn among the lanes of the row).
  if (better(v, doc, *reinterpret_cast<volatile float*>(hv),
             *reinterpret_cast<volatile int*>(hid))) {
    heap_replace_top(hv, hid, L.k, v, doc);
    *reinterpret_cast<volatile float*>(L.worst_v + r) = hv[0];
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
// column pairs of every tile with a hit.
template <int SCORE, bool LOCKED, typename Acc>
__device__ __forceinline__ void insert_hits(const Acc (&acc)[64],
                                            unsigned long long hm,
                                            const float* sc, int d0, int r0,
                                            const Args& a, const Lists& L,
                                            int lane, float (&tv)[2],
                                            int (&ti)[2]) {
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
    for (int g = 0; g < 4; ++g) {
      if (lane % 4 == g && i >= 0 && doc < a.rows &&
          x >= prefilter_bound(tv[h])) {
        offer<LOCKED>(L, r0 + 8 * h, selection_score<SCORE>(x), doc);
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

// The main pass's lists seeded from the tau pass's top k of its rows
// (bf16 rows): the listed docs outside this walker's docs [d_lo, d_hi),
// each as (its score lowered, EMPTY_ID), the other slots (tau, EMPTY_ID)
// with tau the k-th score lowered, in ascending order: a heap with the
// worst on top. Its k entries stand for k distinct docs, each scoring at
// least its entry (the walker meets its own listed docs itself and counts
// them then), so the top stays at most the k-th best of all docs while
// rising with every doc the walker takes in, where k copies of tau stay
// put until k docs have come in. Rows past B hold (inf, EMPTY_ID).
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

// grid = (clusters per group x cl, groups); block = KTHREADS. CTA rank r
// of cluster i in group g owns queries Q (g cl + r).. and walks the i-th
// of per_group contiguous ranges of tiles. R: the rows (RowKind). TMA:
// the doc chunks through the tensor map, shared by the cluster; else the
// producer warp's element loads, per CTA. QRES: the query planes
// resident; else each slot carries its query chunk.
template <int R, int QG, bool TMA, bool QRES, int MODE>
__global__ void __launch_bounds__(KTHREADS, 1)
    cluster_topk_kernel(const __grid_constant__ CUtensorMap map,
                        const Args a) {
  using Acc = typename RowT<R>::Acc;
  constexpr int P = RowT<R>::PLANES, SCORE = RowT<R>::SCORE;
  constexpr bool INT8 = R == ROWS_INT8;
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
      *reinterpret_cast<unsigned*>(qblk + ((w / (CH / 4)) * P + p) * Q * CH +
                                   word_at(r, w % (CH / 4))) = v;
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
    // nothing ((inf, -1) is beaten by no finite score).
    float tv[2];
    int ti[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tv[h] = L.worst_v[r0 + 8 * h];
      ti[h] = q0 + r0 + 8 * h < a.B ? EMPTY_ID : -1;
    }
    int hits = 0;

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
      if constexpr (MODE != MODE_STREAM && MODE != MODE_MMA) {
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
        if constexpr (MODE != MODE_STREAM) {
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
        if constexpr (INT8 || MODE == MODE_STREAM) {
          release(s);
        } else {
          if (c > 0) release(prev);
          prev = s;
        }
      }
      if constexpr (!INT8 && MODE != MODE_STREAM) {
        wgmma_wait<0>();
        pin(acc);
        release(prev);
      }
      if constexpr (MODE != MODE_STREAM && MODE != MODE_MMA) {
        // The multipliers to shared memory, by tile parity: a warp that
        // runs a tile ahead writes the other half, and none runs two ahead
        // past this barrier.
        float* sc_all = tile_sc + (t & 1) * T;
        if (tid < T) sc_all[tid] = my_sc;
        asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMERS_BAR), "n"(CTHREADS)
                     : "memory");
        const float* sc = sc_all + dcol;
        // The other warpgroup may have raised a shared row's worst score:
        // (that score, the largest id) is still at most its worst entry.
        if constexpr (LOCKED) {
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
        // Every score against its row's bound, unrounded; the rounded
        // test only where one passes.
        const float lo[2] = {prefilter_bound(tv[0]), prefilter_bound(tv[1])};
        unsigned long long hm = 0ull;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 4 * j + 2 * h + i;
              if (static_cast<float>(acc[c]) * sc[8 * j + i] >= lo[h]) {
                hm |= 1ull << c;
              }
            }
          }
        }
        if constexpr (MODE == MODE_EPILOGUE) hits += hm != 0ull;
        if constexpr (MODE == MODE_FULL) {
          insert_hits<SCORE, LOCKED>(acc, hm, sc, d0, r0, a, L, lane, tv,
                                     ti);
        }
      }
    }
    if constexpr (MODE == MODE_MMA && !INT8) {
      // The sums reach a register the compiler cannot drop.
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) x += acc[i];
      if (x == 1.2345e-38f && a.probe != nullptr) atomicAdd(a.probe, 1);
    }
    if constexpr (MODE == MODE_EPILOGUE) {
      const int n = __reduce_add_sync(FULL, hits);
      if (lane == 0 && n != 0) atomicAdd(a.probe, n);
    }
    if constexpr (MODE == MODE_FULL) {
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

// One pass: MODE_FULL on any route (bf16 rows: query planes resident); the
// probe's modes on TMA only.
template <int R, int QG>
cudaError_t launch_qg(const Args& a, int mode, int tma, int resident,
                      int groups, int smem, cudaStream_t s) {
  if (mode == MODE_FULL) {
    if (tma) {
      return launch_kernel<R, QG, true, true, MODE_FULL>(a, groups, smem, s);
    }
    if (resident) {
      return launch_kernel<R, QG, false, true, MODE_FULL>(a, groups, smem, s);
    }
    if constexpr (R == ROWS_INT8) {
      return launch_kernel<R, QG, false, false, MODE_FULL>(a, groups, smem,
                                                           s);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (!tma) return cudaErrorInvalidValue;
  switch (mode) {
    case MODE_STREAM:
      return launch_kernel<R, QG, true, true, MODE_STREAM>(a, groups, smem, s);
    case MODE_MMA:
      return launch_kernel<R, QG, true, true, MODE_MMA>(a, groups, smem, s);
    case MODE_EPILOGUE:
      return launch_kernel<R, QG, true, true, MODE_EPILOGUE>(a, groups, smem,
                                                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch shape of one call (cluster_plan's).
struct Shape {
  int qg, cl, groups, stages, resident, smem;
};

bool kind_ok(int kind) {
  return kind == ROWS_INT8 || kind == ROWS_BF16_ROUNDED ||
         kind == ROWS_BF16_COMPARE;
}

int chunks(int kind, int D) {
  return static_cast<int>(
      (static_cast<long long>(D) * elem_bytes(kind) + CH - 1) / CH);
}

bool shape_ok(int kind, const Shape& p, int B, int D, int k) {
  return kind_ok(kind) && B >= 1 && D >= 1 && k >= 1 && k <= MAX_K &&
         (p.qg == 1 || p.qg == 2) && p.cl >= 1 && p.cl <= MAX_CLUSTER &&
         p.groups >= 1 &&
         static_cast<long long>(p.groups) * p.cl * cta_queries(p.qg) >= B &&
         p.stages >= 1 && p.stages <= MAX_STAGES &&
         (kind == ROWS_INT8 || p.resident) &&
         p.smem >= smem_bytes(p.qg, chunks(kind, D), planes_of(kind), k,
                              p.stages, p.resident != 0) &&
         p.smem <= SMEM_LIMIT;
}

// TMA takes rows of a 16-byte aligned base and stride, a whole chunk deep,
// at least one box of them, the query block resident.
bool tma_ok(const Args& a, int resident) {
  return resident && a.rowb % 16 == 0 && a.rowb >= CH && a.stride % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.e) % 16 == 0 && a.rows >= BOX_ROWS;
}

template <int R>
cudaError_t run_pass(const Shape& p, const Args& a, int mode, int tma,
                     cudaStream_t s) {
  if (a.per_group < 1 || (tma && !tma_ok(a, p.resident))) {
    return cudaErrorInvalidValue;
  }
  return p.qg == 1
             ? launch_qg<R, 1>(a, mode, tma, p.resident, p.groups, p.smem, s)
             : launch_qg<R, 2>(a, mode, tma, p.resident, p.groups, p.smem, s);
}

cudaError_t run_pass_kind(int kind, const Shape& p, const Args& a, int mode,
                          int tma, cudaStream_t s) {
  switch (kind) {
    case ROWS_INT8:
      return run_pass<ROWS_INT8>(p, a, mode, tma, s);
    case ROWS_BF16_ROUNDED:
      return run_pass<ROWS_BF16_ROUNDED>(p, a, mode, tma, s);
    case ROWS_BF16_COMPARE:
      return run_pass<ROWS_BF16_COMPARE>(p, a, mode, tma, s);
    default:
      return cudaErrorInvalidValue;
  }
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
// tau [B], the seed pass's tau [B], (K1r) the query's three bf16 planes
// [3][B][D] and (bf16 rows) the tau and seed passes' top k [B][k]
// (values and ids); each piece on a 256-byte boundary. With base null
// only *bytes is filled.
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
  return kind == ROWS_BF16_ROUNDED ? 6 * static_cast<size_t>(B) * D : 0;
}

// One pass (MODE_FULL) and the merge of its walkers' lists in the merge's
// tau mode: tau_out[b] = the k-th best of the pass's rows, lowered (-inf
// with fewer than k candidates).
cudaError_t tau_of(int kind, const Shape& p, Args a, int tma, float* part_v,
                   int* part_i, float* tau_out, cudaStream_t s) {
  a.part_v = part_v;
  a.part_i = part_i;
  const cudaError_t err = run_pass_kind(kind, p, a, MODE_FULL, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(part_v, part_i, a.B, a.per_group * a.k, a.k, nullptr,
                      nullptr, nullptr, tau_out, s);
}

// One pass (MODE_FULL) and the merge of its walkers' lists into its top k
// (top_v / top_i [B][k], the pass's row ids; no rounding undone).
cudaError_t top_of(int kind, const Shape& p, Args a, int tma, float* part_v,
                   int* part_i, float* top_v, int* top_i, cudaStream_t s) {
  a.part_v = part_v;
  a.part_i = part_i;
  const cudaError_t err = run_pass_kind(kind, p, a, MODE_FULL, tma, s);
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
cudaError_t run_call(int kind, const Shape& p, const int8_t* q,
                     const float* q_scales, const int8_t* e,
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
  if (kind == ROWS_INT8) {
    err = tau_of(kind, p, seed, seed_tma, ws.seed_v, ws.seed_i, ws.seed, s);
    if (err != cudaSuccess) return err;
    sub.seed = ws.seed;
    err = tau_of(kind, p, sub, tau_tma, ws.tau_v, ws.tau_i, ws.tau, s);
    main.seed = ws.tau;
  } else {
    // bf16 rows: each pass's top k itself (the merge in list mode) seeds
    // the next pass's lists (seed_lists); a seed pass row is every
    // (SEED_STRIDE / TAU_STRIDE)-th tau pass row.
    err = top_of(kind, p, seed, seed_tma, ws.seed_v, ws.seed_i,
                 ws.seed_top_v, ws.seed_top_i, s);
    if (err != cudaSuccess) return err;
    sub.list_v = ws.seed_top_v;
    sub.list_i = ws.seed_top_i;
    sub.list_every = SEED_STRIDE / TAU_STRIDE;
    err = top_of(kind, p, sub, tau_tma, ws.tau_v, ws.tau_i, ws.top_v,
                 ws.top_i, s);
    main.list_v = ws.top_v;
    main.list_i = ws.top_i;
    main.list_every = TAU_STRIDE;
  }
  if (err != cudaSuccess) return err;
  main.part_v = ws.part_v;
  main.part_i = ws.part_i;
  err = run_pass_kind(kind, p, main, MODE_FULL, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(ws.part_v, ws.part_i, B, walkers * k, k, q_scales,
                      out_v, out_i, nullptr, s,
                      kind != ROWS_BF16_COMPARE);
}

template <int R>
int active_clusters_of(int qg, int cl, int smem) {
  return qg == 1 ? max_active_clusters(
                       cluster_topk_kernel<R, 1, true, true, MODE_FULL>,
                       KTHREADS, cl, smem)
                 : max_active_clusters(
                       cluster_topk_kernel<R, 2, true, true, MODE_FULL>,
                       KTHREADS, cl, smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a CTA of rows ``kind`` (RowKind) at depth D.
long long anr_cluster_smem_bytes(int kind, int qg, int D, int k, int stages,
                                 int resident) {
  if (!kind_ok(kind)) return -1;
  return smem_bytes(qg, chunks(kind, D), planes_of(kind), k, stages,
                    resident != 0);
}

// Clusters of cl CTAs of rows ``kind`` (qg query groups, smem bytes each)
// that the card holds at once (a negative cudaError_t on failure).
int anr_cluster_active_clusters(int kind, int qg, int cl, int smem) {
  switch (kind) {
    case ROWS_INT8:
      return active_clusters_of<ROWS_INT8>(qg, cl, smem);
    case ROWS_BF16_ROUNDED:
      return active_clusters_of<ROWS_BF16_ROUNDED>(qg, cl, smem);
    case ROWS_BF16_COMPARE:
      return active_clusters_of<ROWS_BF16_COMPARE>(qg, cl, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

long long anr_cluster_workspace_bytes(int kind, int B, int D, int k,
                                      int walkers, int tau_walkers,
                                      int seed_walkers) {
  size_t bytes = 0;
  carve(nullptr, B, k, walkers, tau_walkers, seed_walkers,
        piece_bytes(kind, B, D), kind != ROWS_INT8, &bytes);
  return static_cast<long long>(bytes);
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
      ROWS_INT8, p, q, q_scales, e, scales, nullptr, B, N, D, k, tma,
      walkers, tau_tma, tau_walkers, seed_tma, seed_walkers, ws, out_v,
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
  if (kind == ROWS_INT8 || !shape_ok(kind, p, B, D, k) || N < 1 ||
      walkers < 1 || tau_walkers < 1 || seed_walkers < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(ws_base, B, k, walkers, tau_walkers,
                             seed_walkers, piece_bytes(kind, B, D), true);
  const int8_t* planes = static_cast<const int8_t*>(q);
  if (kind == ROWS_BF16_ROUNDED) {
    const cudaError_t err = launch_split_query(
        static_cast<const float*>(q), static_cast<long long>(B) * D,
        ws.pieces, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    planes = reinterpret_cast<const int8_t*>(ws.pieces);
  }
  return static_cast<int>(run_call(
      kind, p, planes, nullptr, static_cast<const int8_t*>(e), nullptr,
      mask, B, N, D, k, tma, walkers, tau_tma, tau_walkers, seed_tma,
      seed_walkers, ws, out_v, out_i, s));
}

// One pass alone, for the probe's anatomy: over every row, or (tau) the
// tau pass's every TAU_STRIDE-th; rows ``kind`` (q: int8 queries, or the
// bf16 planes [PLANES][B][D]; scales: int8 rows' scales; mask: bf16 rows'
// optional mask); mode MODE_FULL (lists seeded with seed, or -inf, into
// part [B][walkers][k]), MODE_STREAM, MODE_MMA or MODE_EPILOGUE (the
// threshold test against seed; the tiles where a thread passed it added
// to probe).
int anr_cluster_pass(int kind, int mode, const void* q, const void* e,
                     const float* scales, const uint8_t* mask,
                     const float* seed, int B, int N, int D, int k, int qg,
                     int cl, int groups, int stages, int resident, int smem,
                     int tma, int walkers, int tau, float* part_v,
                     int* part_i, int* probe, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if (!shape_ok(kind, p, B, D, k) || N < 1 || mode < MODE_FULL ||
      mode > MODE_EPILOGUE || (mode == MODE_EPILOGUE && probe == nullptr) ||
      (kind == ROWS_INT8 && scales == nullptr) ||
      (mode == MODE_FULL && (part_v == nullptr || part_i == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = pass_args(p, static_cast<const int8_t*>(q),
                     static_cast<const int8_t*>(e), scales, mask, B, N,
                     D * elem_bytes(kind), k, tau ? TAU_STRIDE : 1, walkers);
  a.seed = seed;
  a.part_v = part_v;
  a.part_i = part_i;
  a.probe = probe;
  return static_cast<int>(run_pass_kind(kind, p, a, mode, tma,
                                        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
