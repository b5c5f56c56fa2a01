// K2r for Hopper (sm_90a): the rounded int8 top-k, a cluster of query
// blocks on one TMA-multicast doc stream, wgmma s8 scoring and a threshold
// epilogue in registers.
//
// Replaces the TPU kernel of the JAX package's packed int8 fold
// (a_nice_rag_tpu.ops, fused_topk.py under its TPU-kernel directory):
//   K2r _kernel_packed_int8 (fused_topk.py:377; selected at :1291-1295,
//       launched at :1398), fused_dense_top_k_int8(..., algo="packed").
//
// Contract: for every query, the k best documents by (score desc, doc id
// asc), score = bf16(float(acc) * doc_scale) (to nearest, ties to even;
// topk_common.cuh's selection_score, -0.0 carried below +0.0), acc the
// exact int32 dot of the int8 query and row; values [B, k] f32 = those
// rounded scores times the query scale, applied after selection, ids [B,
// k] i32, unfilled slots (-inf, -1). The callers take it for maskless
// calls over N % 1024 == 0 rows (ops/kernels/fused_topk.py's
// rounded_route); the kernel itself takes any N, B, D, 1 <= k <= 128 and
// rows at any address.
//
// What bounds it on an H100. At 10,485,760 x 1024 int8, B = 256, k = 25 it
// reads 10.7 GB of rows (3.22 ms at 3.35 TB/s) for 5.5 T int8 operations
// (2.78 ms at 1,979 TOP/s): bound by its bytes, the tensor cores close
// behind. K2's kernel, which K2r ran before (int8_mma.cuh), streamed the
// whole matrix once per 64-query block (43 GB through L2 at B = 256),
// multiplied on mma.sync with ldmatrix fragments, and stored every score
// in a [64][TN + 1] shared tile that one warp per row compared: 28 ms.
//
// Design: each doc byte leaves HBM once per group of query blocks, the
// multiply runs on wgmma straight from the TMA's tiles, and the selection
// touches only the rare scores that can enter a list.
// * Work split (ops/kernels/cluster_topk.py's cluster_plan). A CTA owns QG
//   x 64 queries, resident in shared memory ([chunk][QG x 64][128 bytes],
//   128-byte swizzle): QG = 1 (B <= 64), both consumer warpgroups multiply
//   the CTA's 64 queries against 128 docs each of a T = 256-doc tile; QG =
//   2, each warpgroup its own 64 queries against the T = 128-doc tile. The
//   query blocks of a call, up to MAX_CLUSTER of them, form one
//   thread-block cluster; B past MAX_CLUSTER blocks takes further groups
//   of clusters side by side. Persistent clusters, as many as
//   cudaOccupancyMaxActiveClusters reports, each walk one contiguous range
//   of tiles, so a planted cluster of similar rows falls to one walker,
//   whose threshold its first rows raise.
// * Stream. A 2-D tensor map over the rows (64-row x 128-byte boxes,
//   128-byte swizzle); each CTA of the cluster issues a share of a chunk's
//   boxes with .multicast::cluster into a ring of slots guarded by full /
//   empty mbarriers; one producer warp issues, and each consumer warpgroup
//   of every CTA hands a slot back with one relaxed remote arrival per CTA
//   (tma_ring.cuh, shared with int4.cu).
// * Multiply. wgmma.mma_async.m64n128k32.s32.s8.s8 with the queries as A
//   and the docs as B, both read straight from the swizzled tiles; exact
//   int32 sums, waited on before any accumulator is read.
// * Epilogue in registers, no scores tile. Each thread holds 64
//   accumulators (2 queries x 32 docs); the tile's doc scales are loaded
//   as it starts, one a thread, and read from shared memory once its
//   chunks are multiplied. Each unrounded score float(acc) * doc_scale is
//   compared with a bound below its row's threshold by the most bf16
//   rounding can move it (prefilter_bound); one warp vote a tile. Only a
//   warp with a score past a bound offers its docs, a step of 8 columns
//   at a time: the score by K2's expression,
//   selection_score<SCORE_ROUNDED>(float(acc) * doc_scale), rows past N
//   (zero-filled by the TMA: a 0 would beat every negative score) never
//   candidates, against the row's running top-k in shared memory, a
//   binary heap with the worst entry under (score desc, id asc) on top:
//   a doc that beats the top takes its place and sifts down. The four
//   lanes that hold a row offer in turn, the warp's eight rows side by
//   side; where two warps share a row (QG = 1) under the row's lock.
//   Offers compare (score, id), so docs may arrive in any order: each heap
//   is always the top k of what it was offered. The thresholds are the
//   tops, or (a row the other warpgroup also fills) the top's score with
//   the largest id: they only rise, so nothing that could enter is
//   skipped; when every doc is a hit (tau = -inf, all-equal rows) the
//   heaps take them one by one and nothing is dropped.
// * tau warm start, in two steps: the same kernel over every SEED_STRIDE-th
//   row (4096th) and the merge in its tau mode give a first bound; then
//   over every TAU_STRIDE-th row (64th), lists seeded with that bound
//   (those rows are among its own, so its k-th best is the same as
//   unseeded), and the merge give tau[b], the k-th best subsample score
//   lowered. Each pass reads its rows through a tensor map whose row
//   stride is its stride x D bytes (no copy). The main pass seeds every
//   heap with (tau, EMPTY_ID). The merge of the walkers' lists then runs
//   unchanged, with the query scales and the rounded -0.0 written back.
//   Nothing syncs to the host.
// * Rows the TMA cannot take (a base not 16-byte aligned, such as
//   values[1:], D % 16 != 0, D < 128, or fewer than 64 rows) go through
//   the producer warp's element loads into the same layout, with no
//   cluster; a query block that does not fit beside two ring slots
//   streams through the ring with each doc chunk (element loads).
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

// MODE_FULL: K2r's pass. The probe's anatomy runs the same launch with
// less work: MODE_STREAM the ring alone (each chunk handed back unread),
// MODE_MMA + the multiply, MODE_EPILOGUE + the epilogue's threshold test,
// counting into probe the tiles where a thread's scores passed a bound
// instead of offering them.
enum Mode : int {
  MODE_FULL = 0,
  MODE_STREAM = 1,
  MODE_MMA = 2,
  MODE_EPILOGUE = 3
};

__host__ __device__ constexpr int cta_queries(int qg) { return QB * qg; }
__host__ __device__ constexpr int tile_docs(int qg) {
  return 2 * WG_DOCS / qg;
}

// Bytes of one ring slot and of the whole dynamic shared memory: alignment
// slack, ring, resident query block, barriers, two tiles' doc scales, each
// row's published worst score and lock, the running lists.
// ops/kernels/cluster_topk.py's cluster_smem_bytes computes the same
// number.
__host__ __device__ inline int slot_bytes(int qg, bool resident) {
  return tile_docs(qg) * CH + (resident ? 0 : cta_queries(qg) * CH);
}
__host__ __device__ inline long long smem_bytes(int qg, int nck, int k,
                                                int stages, bool resident) {
  const long long q = cta_queries(qg);
  return ALIGN + static_cast<long long>(stages) * slot_bytes(qg, resident) +
         (resident ? nck * q * CH : 0) + 16LL * stages + 8LL * tile_docs(qg) +
         q * (8 + 8LL * k);
}

struct Args {
  const int8_t* q;       // [B, D] queries
  const int8_t* e;       // the pass's row r at e + r * stride
  const float* escale;   // row r's scale at escale[r * sstride]
  const float* seed;     // [B] tau, or null: lists start at -inf
  long long stride;      // bytes from one row to the next
  int sstride;
  int B, rows, D, k;     // rows: the pass's row count (ids 0..rows - 1)
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
  float* run_v;    // [rows][k]
  int* run_i;      // [rows][k]
  float* worst_v;  // [rows]: entry 0's score
  int* lock;       // [rows]: 0 free, 1 held (rows two warps share)
  int k;
};

// Put (cv, ci), which beats the top of the heap hv / hi of k entries, in
// place of it and sift it down: at each level the worse child moves up
// while the candidate beats it. By one thread.
__device__ __forceinline__ void heap_replace_top(volatile float* hv,
                                                 volatile int* hi, int k,
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

// A bound below which an unrounded score x = float(acc) * sc cannot round
// to a selection score at least t: bf16 rounding moves x by at most half
// an ulp, 2^-8 |x| (2^-134 among the denormals). (t = -inf: -inf; t =
// +inf, a row past B: NaN, which no x reaches.)
__device__ __forceinline__ float prefilter_bound(float t) {
  return t - fabsf(t) * 0.0078125f - 1.0e-40f;
}

// Offer the selection score v of doc to row r's heap, by one thread:
// under the row's lock where two warps share it (LOCKED); the top read
// afresh, as another lane or warp may have raised it.
template <bool LOCKED>
__device__ __forceinline__ void offer(const Lists& L, int r, float v,
                                      int doc) {
  volatile float* hv = L.run_v + r * L.k;
  volatile int* hid = L.run_i + r * L.k;
  if constexpr (LOCKED) {
    while (atomicCAS(L.lock + r, 0, 1) != 0) {
    }
    __threadfence_block();
  }
  if (better(v, doc, hv[0], hid[0])) {
    heap_replace_top(hv, hid, L.k, v, doc);
    *reinterpret_cast<volatile float*>(L.worst_v + r) = hv[0];
  }
  if constexpr (LOCKED) {
    __threadfence_block();
    atomicExch(L.lock + r, 0);
  }
}

// The warp's hits of a tile into the rows' heaps: the thread's
// accumulators acc[4 j + 2 h + i] (row r0 + 8 h, doc d0 + 8 j + i, scale
// sc[8 j + i]) a step j at a time, rolled (the accumulators shifted down
// a step after each, keeping the code to four offers); in a
// step the four lanes that hold a row offer in turn, each its doc of
// rows r0 and r0 + 8 whose unrounded score passes the row's bound; then
// every lane takes its rows' tops as thresholds (a shared row's top score
// alone, with the largest id: a read without the lock may be torn).
template <bool LOCKED>
__device__ __forceinline__ void insert_hits(int (&acc)[64], const float* sc,
                                            int d0, int r0, const Args& a,
                                            const Lists& L, int lane,
                                            float (&tv)[2], int (&ti)[2]) {
#pragma unroll 1
  for (int j = 0; j < 16; ++j, d0 += 8, sc += 8) {
    unsigned f = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = static_cast<float>(acc[e]) * sc[e & 1];
      if (x >= prefilter_bound(tv[e >> 1]) && d0 + (e & 1) < a.rows) {
        f |= 1u << e;
      }
    }
    if (__any_sync(FULL, f != 0u)) {
      for (int g = 0; g < 4; ++g) {
        if (lane % 4 == g && f != 0u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (f & (1u << e)) {
              offer<LOCKED>(L, r0 + 8 * (e >> 1),
                            selection_score<SCORE_ROUNDED>(
                                static_cast<float>(acc[e]) * sc[e & 1]),
                            d0 + (e & 1));
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if constexpr (LOCKED) {
          const float w =
              *reinterpret_cast<volatile float*>(L.worst_v + r);
          if (w > tv[h]) {
            tv[h] = w;
            ti[h] = EMPTY_ID;
          }
        } else {
          tv[h] = *reinterpret_cast<volatile float*>(L.run_v + r * L.k);
          ti[h] = *reinterpret_cast<volatile int*>(L.run_i + r * L.k);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 60; ++x) acc[x] = acc[x + 4];
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
// of per_group contiguous ranges of tiles. TMA: the doc chunks through the tensor map, shared by
// the cluster; else the producer warp's element loads, per CTA. QRES: the
// query block resident; else each slot carries its query chunk.
template <int QG, bool TMA, bool QRES, int MODE>
__global__ void __launch_bounds__(KTHREADS, 1)
    cluster_topk_kernel(const __grid_constant__ CUtensorMap map,
                        const Args a) {
  static_assert(!TMA || QRES, "TMA runs with the query block resident");
  constexpr int Q = cta_queries(QG), T = tile_docs(QG);
  // One query group: both warpgroups hold every row (each for half the
  // tile's docs), so a row's heap is taken under its lock.
  constexpr bool LOCKED = QG == 1;
  extern __shared__ char smem_raw[];
  char* base = smem_raw + (ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN;
  const int slot_b = slot_bytes(QG, QRES);
  char* ring = base;
  char* qblk = ring + a.stages * slot_b;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(qblk + (QRES ? a.nck * Q * CH : 0));
  uint64_t* empty = full + a.stages;
  // The doc scales of a tile, by tile parity: [2][T].
  float* tile_sc = reinterpret_cast<float*>(empty + a.stages);
  Lists L;
  L.worst_v = tile_sc + 2 * T;
  L.lock = reinterpret_cast<int*>(L.worst_v + Q);
  L.run_v = reinterpret_cast<float*>(L.lock + Q);
  L.run_i = reinterpret_cast<int*>(L.run_v + Q * a.k);
  L.k = a.k;

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
  // Every slot (seed, EMPTY_ID): only a doc scoring at least the seed
  // enters. Rows past B hold (inf, EMPTY_ID), which nothing beats.
  for (int x = tid; x < Q * a.k; x += KTHREADS) {
    const int row = q0 + x / a.k;
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
  if constexpr (QRES) {
    // [chunk][Q][CH], zero past B and past D.
    const int words = a.nck * (CH / 4);
    for (int x = tid; x < Q * words; x += KTHREADS) {
      const int r = x / words, w = x % words, row = q0 + r;
      unsigned v = 0u;
      if (row < a.B && 4 * w < a.D) {
        v = load_word(a.q + static_cast<long long>(row) * a.D, 4 * w, a.D);
      }
      *reinterpret_cast<unsigned*>(qblk + (w / (CH / 4)) * Q * CH +
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
          load_rows(slot, a.e, a.stride, t * T, T, a.rows, a.D, c, lane);
          if constexpr (!QRES) {
            load_rows(slot + T * CH, a.q, a.D, q0, Q, a.B, a.D, c, lane);
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
    int acc[64];
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
      // The tile's doc scales, one a consumer thread, loaded as the tile
      // starts and stored to shared memory once its chunks are multiplied.
      float my_sc = 0.f;
      const int sdoc = t * T + tid;
      if constexpr (MODE != MODE_STREAM && MODE != MODE_MMA) {
        if (tid < T && sdoc < a.rows) {
          my_sc = __ldg(a.escale + static_cast<long long>(sdoc) * a.sstride);
        }
      }
      for (int c = 0; c < a.nck; ++c, ++f) {
        const int s = f % a.stages;
        mbar_wait(full + s, (f / a.stages) & 1);
        if constexpr (MODE != MODE_STREAM) {
          const char* slot = ring + s * slot_b;
          const char* qc = QRES ? qblk + c * Q * CH : slot + T * CH;
          const uint64_t da = sw128_desc(qc + (QG == 2 ? wg * QB * CH : 0));
          const uint64_t db = sw128_desc(slot + wdocs * CH);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < CH / 32; ++ks) {
            wgmma_s8(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc);
        }
        release(s);
      }
      if constexpr (MODE != MODE_STREAM && MODE != MODE_MMA) {
        // The scales to shared memory, by tile parity: a warp that runs a
        // tile ahead writes the other half, and none runs two ahead past
        // this barrier.
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
        bool any = false;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              any |= static_cast<float>(acc[4 * j + 2 * h + i]) *
                         sc[8 * j + i] >=
                     lo[h];
            }
          }
        }
        if constexpr (MODE == MODE_EPILOGUE) hits += any;
        if constexpr (MODE == MODE_FULL) {
          if (__any_sync(FULL, any)) {
            insert_hits<LOCKED>(acc, sc, d0, r0, a, L, lane, tv, ti);
          }
        }
      }
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
        const int row = q0 + x / a.k;
        if (row < a.B) {
          const size_t o =
              (static_cast<size_t>(row) * a.per_group + cid) * a.k + x % a.k;
          a.part_v[o] = L.run_v[x];
          a.part_i[o] = L.run_i[x];
        }
      }
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers.
  if constexpr (TMA) cluster_sync();
}

// -- host side ------------------------------------------------------------------

template <int QG, bool TMA, bool QRES, int MODE>
cudaError_t launch_kernel(const Args& a, int groups, int smem,
                          cudaStream_t stream) {
  CUtensorMap map{};
  if (TMA) {
    const cudaError_t err =
        encode_rows(&map, a.e, a.D, a.rows, a.stride, BOX_ROWS);
    if (err != cudaSuccess) return err;
  }
  return launch_clustered(cluster_topk_kernel<QG, TMA, QRES, MODE>,
                          dim3(a.per_group * a.cl, groups, 1), KTHREADS, smem,
                          TMA ? a.cl : 0, stream, map, a);
}

// One pass: MODE_FULL on any route; the probe's modes on TMA only.
template <int QG>
cudaError_t launch_qg(const Args& a, int mode, int tma, int resident,
                      int groups, int smem, cudaStream_t s) {
  if (mode == MODE_FULL) {
    if (tma) return launch_kernel<QG, true, true, MODE_FULL>(a, groups, smem, s);
    if (resident) {
      return launch_kernel<QG, false, true, MODE_FULL>(a, groups, smem, s);
    }
    return launch_kernel<QG, false, false, MODE_FULL>(a, groups, smem, s);
  }
  if (!tma) return cudaErrorInvalidValue;
  switch (mode) {
    case MODE_STREAM:
      return launch_kernel<QG, true, true, MODE_STREAM>(a, groups, smem, s);
    case MODE_MMA:
      return launch_kernel<QG, true, true, MODE_MMA>(a, groups, smem, s);
    case MODE_EPILOGUE:
      return launch_kernel<QG, true, true, MODE_EPILOGUE>(a, groups, smem,
                                                          s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch shape of one call (cluster_plan's).
struct Shape {
  int qg, cl, groups, stages, resident, smem;
};

bool shape_ok(const Shape& p, int B, int D, int k) {
  const int nck = (D + CH - 1) / CH;
  return B >= 1 && D >= 1 && k >= 1 && k <= MAX_K &&
         (p.qg == 1 || p.qg == 2) && p.cl >= 1 && p.cl <= MAX_CLUSTER &&
         p.groups >= 1 &&
         static_cast<long long>(p.groups) * p.cl * cta_queries(p.qg) >= B &&
         p.stages >= 1 && p.stages <= MAX_STAGES &&
         p.smem >= smem_bytes(p.qg, nck, k, p.stages, p.resident != 0) &&
         p.smem <= SMEM_LIMIT;
}

// TMA takes rows of a 16-byte aligned base and stride, a whole chunk deep,
// at least one box of them, the query block resident.
bool tma_ok(const Args& a, int resident) {
  return resident && a.D % 16 == 0 && a.D >= CH && a.stride % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.e) % 16 == 0 && a.rows >= BOX_ROWS;
}

cudaError_t run_pass(const Shape& p, const Args& a, int mode, int tma,
                     cudaStream_t s) {
  if (a.per_group < 1 || (tma && !tma_ok(a, p.resident))) {
    return cudaErrorInvalidValue;
  }
  return p.qg == 1 ? launch_qg<1>(a, mode, tma, p.resident, p.groups, p.smem, s)
                   : launch_qg<2>(a, mode, tma, p.resident, p.groups, p.smem,
                                  s);
}

// Rows every ``every``-th of them: 1 (the main pass), TAU_STRIDE (the tau
// pass) or SEED_STRIDE (the seed pass).
constexpr int SEED_STRIDE = TAU_STRIDE * TAU_STRIDE;

// The pass over every ``every``-th row of e (rows D bytes apart).
Args pass_args(const Shape& p, const int8_t* q, const int8_t* e,
               const float* scales, int B, int N, int D, int k, int every,
               int per_group) {
  Args a{};
  a.q = q;
  a.e = e;
  a.escale = scales;
  a.stride = static_cast<long long>(D) * every;
  a.sstride = every;
  a.B = B;
  a.rows = (N + every - 1) / every;
  a.D = D;
  a.k = k;
  a.nck = (D + CH - 1) / CH;
  a.stages = p.stages;
  a.cl = p.cl;
  a.tiles = (a.rows + tile_docs(p.qg) - 1) / tile_docs(p.qg);
  a.per_group = per_group;
  return a;
}

// The workspace of one call: the main pass's lists [B][walkers][k], the
// tau pass's [B][tau_walkers][k], the seed pass's [B][seed_walkers][k],
// tau [B] and the seed pass's tau [B]; each piece on a 256-byte boundary.
// With base null only *bytes is filled.
struct Workspace {
  float* part_v;
  int* part_i;
  float* tau_v;
  int* tau_i;
  float* seed_v;
  int* seed_i;
  float* tau;
  float* seed;
};

Workspace carve(void* base, int B, int k, int walkers, int tau_walkers,
                int seed_walkers, size_t* bytes = nullptr) {
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
  if (bytes != nullptr) *bytes = off;
  return ws;
}

// One pass (MODE_FULL) and the merge of its walkers' lists in the merge's
// tau mode: tau_out[b] = the k-th best of the pass's rows, lowered (-inf
// with fewer than k candidates).
cudaError_t tau_of(const Shape& p, Args a, int tma, float* part_v,
                   int* part_i, float* tau_out, cudaStream_t s) {
  a.part_v = part_v;
  a.part_i = part_i;
  const cudaError_t err = run_pass(p, a, MODE_FULL, tma, s);
  if (err != cudaSuccess) return err;
  return launch_merge(part_v, part_i, a.B, a.per_group * a.k, a.k, nullptr,
                      nullptr, nullptr, tau_out, s);
}

}  // namespace

extern "C" {

long long anr_cluster_smem_bytes(int qg, int D, int k, int stages,
                                 int resident) {
  return smem_bytes(qg, (D + CH - 1) / CH, k, stages, resident != 0);
}

// Clusters of cl K2r CTAs (qg query groups, smem bytes each) that the card
// holds at once (a negative cudaError_t on failure).
int anr_cluster_active_clusters(int qg, int cl, int smem) {
  return qg == 1 ? max_active_clusters(
                       cluster_topk_kernel<1, true, true, MODE_FULL>,
                       KTHREADS, cl, smem)
                 : max_active_clusters(
                       cluster_topk_kernel<2, true, true, MODE_FULL>,
                       KTHREADS, cl, smem);
}

long long anr_cluster_workspace_bytes(int B, int k, int walkers,
                                      int tau_walkers, int seed_walkers) {
  size_t bytes = 0;
  carve(nullptr, B, k, walkers, tau_walkers, seed_walkers, &bytes);
  return static_cast<long long>(bytes);
}

// K2r: the seed pass over every SEED_STRIDE-th row and the merge in its
// tau mode; the tau pass over every TAU_STRIDE-th row, its lists seeded
// with the seed pass's tau (those rows are among its own, so its k-th best
// is the same), and the merge in its tau mode; the main pass seeded with
// tau; the merge of the walkers' lists (times q_scales, the rounded -0.0
// written back). Each pass takes TMA or element loads (*tma) and walkers
// of its own.
int anr_cluster_topk(const int8_t* q, const float* q_scales,
                     const int8_t* e, const float* scales, int B, int N,
                     int D, int k, int qg, int cl, int groups, int stages,
                     int resident, int smem, int tma, int walkers,
                     int tau_tma, int tau_walkers, int seed_tma,
                     int seed_walkers, void* ws_base, float* out_v,
                     int* out_i, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if (!shape_ok(p, B, D, k) || N < 1 || walkers < 1 || tau_walkers < 1 ||
      seed_walkers < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Workspace ws =
      carve(ws_base, B, k, walkers, tau_walkers, seed_walkers);
  cudaError_t err = tau_of(
      p, pass_args(p, q, e, scales, B, N, D, k, SEED_STRIDE, seed_walkers),
      seed_tma, ws.seed_v, ws.seed_i, ws.seed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args sub = pass_args(p, q, e, scales, B, N, D, k, TAU_STRIDE, tau_walkers);
  sub.seed = ws.seed;
  err = tau_of(p, sub, tau_tma, ws.tau_v, ws.tau_i, ws.tau, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args main = pass_args(p, q, e, scales, B, N, D, k, 1, walkers);
  main.seed = ws.tau;
  main.part_v = ws.part_v;
  main.part_i = ws.part_i;
  err = run_pass(p, main, MODE_FULL, tma, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(ws.part_v, ws.part_i, B, walkers * k,
                                       k, q_scales, out_v, out_i, nullptr, s,
                                       true));
}

// One pass alone, for the probe's anatomy: over every row, or (tau) the
// tau pass's every TAU_STRIDE-th; mode MODE_FULL (lists seeded with seed,
// or -inf, into part [B][walkers][k]), MODE_STREAM, MODE_MMA or
// MODE_EPILOGUE (the threshold test against seed; the tiles where a
// thread passed it added to probe).
int anr_cluster_pass(int mode, const int8_t* q, const int8_t* e,
                     const float* scales, const float* seed, int B, int N,
                     int D, int k, int qg, int cl, int groups, int stages,
                     int resident, int smem, int tma, int walkers, int tau,
                     float* part_v, int* part_i, int* probe, void* stream) {
  const Shape p{qg, cl, groups, stages, resident, smem};
  if (!shape_ok(p, B, D, k) || N < 1 || mode < MODE_FULL ||
      mode > MODE_EPILOGUE || (mode == MODE_EPILOGUE && probe == nullptr) ||
      (mode == MODE_FULL && (part_v == nullptr || part_i == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = pass_args(p, q, e, scales, B, N, D, k, tau ? TAU_STRIDE : 1,
                     walkers);
  a.seed = seed;
  a.part_v = part_v;
  a.part_i = part_i;
  a.probe = probe;
  return static_cast<int>(
      run_pass(p, a, mode, tma, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
