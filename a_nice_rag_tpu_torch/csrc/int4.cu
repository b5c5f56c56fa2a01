// int8 and int4-packed dense folds for Hopper (sm_90a): does halving the
// bytes of the int8 stream help a kernel that may be bound by its
// arithmetic?
//
// Replaces the TPU kernels of scripts/probe_int4.py:
//   stage 1 (:83) _score_kernel :60, with either unpack (:47, :53), and
//   stage 3 (:243 native int4, :261 int4 load + int8 upcast): the exact
//     [B, N] int32 product q8 . e4^T, all one function -> int4 scores;
//   stage 2 (:188 _fold_kernel_int4 :97, :167 _fold_kernel_int8 :121):
//     stream + unpack + dot + a per-row running max -> int4 / int8 fold.
// All three are one kernel template, fold_kernel, behind anr_fold.
//
// Layout (pack_int4, probe_int4.py:36): a row of D int4 values is D/2
// bytes; byte j holds column j in its low nibble and column j + D/2 in its
// high nibble. So a packed word (bytes p..p+3) unpacks to two int8 words:
// its low nibbles are columns p..p+3, its high nibbles D/2 + p... Each
// nibble is sign-extended within its own byte, never across the 32-bit
// word (a borrow or a shift across bytes would corrupt the neighbour):
//   UNPACK_MASK  (probe :53) per byte (n ^ 8) - 8, the subtraction by
//                __vsub4, which keeps each borrow inside its byte;
//   UNPACK_SHIFT (probe :47) per byte the nibble moved to the byte's top
//                and shifted right by 4 with its sign bit copied.
//
// Contract: q8 [B, D] int8, e8 [N, D] int8 or packed [N, D/2] int8 with
// D % 8 == 0 (int8 rows: D % 4 == 0), rows 4-byte aligned.
//   scores: out [B, N] i32 = q8 . unpack(packed)^T, exact;
//   folds:  out [B] i32 = max over the N documents of the exact product,
//     folded by atomicMax into out, which the caller sets to INT_MIN.
// |sum| <= D * 128 * 128 < 2^31 up to D = 131,071: every sum is exact.
//
// What bounds it on an H100. Stage 2 at 10,485,760 x 1024 and B = 256 is
// 2.75 T multiply-adds (5.5 T operations): 2.78 ms at the int8
// tensor-core peak (1,979 TOP/s), against 3.21 ms (int8) or 1.61 ms
// (int4) for the bytes at 3.35 TB/s. The earlier design of this file read
// every 4 bytes with its own load into a transposed tile, two barriers a
// 32-word chunk, dp4a on the CUDA cores, and every 64-query block of a
// doc split read the tile again: 68 ms on an H100.
//
// Design: route (a), a cluster of CTAs that share one doc stream, with
// the multiply on wgmma.
// * A CTA owns a block of FQ = 64 queries, resident in shared memory for
//   the whole call ([halves][depth chunk][64][128 bytes], zero past B and
//   past the row). The query blocks of a call (up to MAX_CLUSTER of them;
//   B = 256: four) form one thread-block cluster, launched by
//   cudaLaunchKernelEx with a cluster dimension. Every cluster walks the
//   doc tiles t = cluster, cluster + clusters, ... (FT = 256 rows), as
//   many clusters as the card holds at once
//   (cudaOccupancyMaxActiveClusters: 30 of four CTAs on an H100).
// * Each doc byte leaves HBM once per call: the tile's depth chunk
//   [256 rows][128 bytes] arrives through TMA (a 2-D tensor map over the
//   rows, boxes of 64 rows x 128 bytes, 128-byte swizzle), and each CTA of
//   the cluster issues a share of the boxes with .multicast::cluster, so
//   one read from L2 fills the same slot in every CTA. The slots form a
//   ring of up to MAX_STAGES chunks guarded by mbarriers: a full barrier
//   per slot (the local producer's expect_tx, the boxes' complete_tx) and
//   an empty barrier per slot on which each warpgroup of every CTA of the
//   cluster arrives once (mapa + a relaxed remote arrive), since a CTA's
//   boxes land in all of them. One producer warp issues. (A release
//   arrival from every warp, eight per CTA and chunk, each waiting on its
//   cluster-scope fence, held the stream far below the HBM rate.)
// * The multiply: two consumer warpgroups, each
//   wgmma.mma_async.m64n128k32.s32.s8.s8 with the 64 queries as A and its
//   128 of the tile's docs as B, both read by the tensor cores straight
//   from the swizzled shared tiles (K-major, 128-byte swizzle: the TMA's
//   layout). mma.sync with ldmatrix fragments (K2's path) was bound by the
//   ldmatrix reads of shared memory: each fragment passes through
//   registers, where wgmma reads each operand tile once per warpgroup.
// * int4: the ring carries packed bytes, half the bytes of int8 across
//   HBM. Each warpgroup reads its 128 packed rows of a chunk and unpacks
//   them into two int8 tiles in shared memory (lo: depth c, hi: D/2 + c),
//   which meet the query block's matching halves (each query row kept as
//   two halves, each padded to the chunk): the unpack is paid once per
//   doc byte, not once per query.
// * Epilogue: each thread keeps a running max over its accumulators (no
//   scores tile); rows past N (zero-filled by the TMA, so a 0 that would
//   beat an all-negative row) are masked out; two shuffles and one
//   atomicMax per (warp, query) at the end. Scores write every exact sum
//   to out [B, N] instead.
// * Rows whose base is not 16-byte aligned, or whose row bytes are not a
//   multiple of 16 (D = 40 packed, D = 1000 int8, a copy 4 bytes past a
//   16-byte boundary), take the producer warp's 4-byte loads into the
//   same layout, each CTA loading its own (no cluster). Depths whose query
//   block does not fit beside two ring slots stream each query chunk with
//   its doc chunk through the ring instead (the same element loads).
//
// Plain C interface; each entry point returns the cudaError_t of its
// launch (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int FQ = 64;           // queries per CTA
constexpr int FT = 256;          // documents per tile
constexpr int FBOX = 64;         // rows per TMA box
constexpr int FWARPS = 8;        // consumer warps: two warpgroups
constexpr int FGROUPS = FWARPS / 4;
constexpr int FTHREADS = (FWARPS + 1) * 32;  // + one producer warp
// PACKED: each warpgroup's 128 docs unpacked, lo and hi [128][CH].
constexpr int UNPACK_BYTES = FGROUPS * 2 * (FT / FGROUPS) * CH;
constexpr int MAX_STAGES = 6;
constexpr int MAX_CLUSTER = 4;
constexpr int ALIGN = 1024;      // the 128-byte swizzle's period
constexpr int SMEM_LIMIT = 232448;

enum Kind : int {
  INT8_FOLD = 0, INT4_FOLD_MASK, INT4_FOLD_SHIFT, INT4_SCORES_MASK,
  INT4_SCORES_SHIFT
};
enum Unpack : int { UNPACK_MASK = 0, UNPACK_SHIFT = 1, NONE = 2 };
// MODE_STAGE: the ring runs as in MODE_FULL, but the consumers hand each
// chunk back unread (no ldmatrix, no MMA; out keeps its INT_MIN): the
// time of the stream alone.
enum Mode : int { MODE_FULL = 0, MODE_STAGE = 1 };

// Bytes of one ring slot, of the resident query block, and of the whole
// dynamic shared memory (alignment slack, ring, query block, barriers).
// ops/kernels/int4.py's fold_plan computes the same numbers.
__host__ __device__ inline int slot_bytes(int halves, bool resident) {
  return FT * CH + (resident ? 0 : halves * FQ * CH);
}
__host__ __device__ inline int qblock_bytes(int halves, int nck) {
  return halves * nck * FQ * CH;
}
__host__ __device__ inline int fold_smem_bytes(int halves, int nck,
                                               int stages, bool resident) {
  return ALIGN + stages * slot_bytes(halves, resident) +
         (resident ? qblock_bytes(halves, nck) : 0) +
         (halves == 2 ? UNPACK_BYTES : 0) + 2 * stages * 8;
}

struct FoldArgs {
  const int8_t* q;
  const int8_t* e;
  int B, N, D;
  int erow;    // stored bytes of a doc row: D, or D / 2 packed
  int halves;  // 1, or 2 packed: query halves [0, D/2) and [D/2, D)
  int nck;     // depth chunks of CH bytes per stored row
  int stages, cl, tiles, per_group;
  int mode;  // MODE_FULL, or MODE_STAGE: the stream alone
  int* out;
};

// -- mbarriers, TMA, clusters -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on the barrier at the same offset in CTA ``rank`` of the cluster.
// The arrival orders nothing but the caller's reads of a ring slot, whose
// values the caller has already used: relaxed, without the cluster-scope
// release (PTX 8.6 on), which measured about 0.5 us an arrival on an H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 8)
  asm volatile(
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
#else
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
#endif
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Box (x bytes, y rows) of the tensor map into dst, completing on bar; with
// mask, into the same offset of every CTA of the mask.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar,
                                        uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask > 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
            smem_addr(dst)),
        "l"(m), "r"(x), "r"(y), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(m), "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
  }
}

// -- unpack ----------------------------------------------------------------------

// A packed word to its two int8 words: lo (columns p..p+3 of the row's
// first half) and hi (D/2 + p..). Each nibble stays inside its own byte.
//   UNPACK_MASK:  the nibble masked out and sign-extended over its byte,
//                 (n ^ 8) - 8, as ((n ^ 8) + 0x78) ^ 0x80: the sum stays
//                 below 0x100, so no carry crosses into the next byte;
//   UNPACK_SHIFT: the nibble shifted to its byte's top, 16 n, exact as
//                 int8 (-128..112); the arithmetic shift right by 4 that
//                 ends the probe's shift unpack is applied once to each
//                 int32 sum instead (every sum is 16 times the true one).
template <int UNPACK>
__device__ __forceinline__ void unpack(unsigned w, unsigned& lo,
                                       unsigned& hi) {
  if constexpr (UNPACK == UNPACK_MASK) {
    lo = (((w & 0x0f0f0f0fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
    hi = ((((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u) + 0x78787878u) ^
         0x80808080u;
  } else {
    lo = (w << 4) & 0xf0f0f0f0u;
    hi = w & 0xf0f0f0f0u;
  }
}

// The int32 sum of an unpacked product: SHIFT's sums carry a factor 16.
template <int UNPACK>
__device__ __forceinline__ int true_sum(int v) {
  return UNPACK == UNPACK_SHIFT ? v >> 4 : v;
}

// Byte offset of 4-byte word w (of 32) of row r in a [rows][CH] swizzled
// chunk.
__device__ __forceinline__ int word_at(int r, int w) {
  return swizzle(r, CH, 0, w / 4) + (w % 4) * 4;
}

// Rows [row0, row0 + rows) x depth chunk c of src (rows of ``stride``
// bytes, ``valid`` rows, ``len`` bytes each) into a swizzled [rows][CH]
// chunk at dst, zero past them; by the 32 lanes of one warp. Generic
// stores: the writer fences them into the async proxy that wgmma reads.
__device__ __forceinline__ void load_words(char* dst, const int8_t* src,
                                           long long stride, int row0,
                                           int rows, int valid, int len,
                                           int c, int lane) {
  for (int x = lane; x < rows * (CH / 4); x += 32) {
    const int r = x / (CH / 4), w = x % (CH / 4), row = row0 + r;
    const int off = c * CH + 4 * w;
    unsigned v = 0u;
    if (row < valid && off < len) {
      v = *reinterpret_cast<const unsigned*>(src + row * stride + off);
    }
    *reinterpret_cast<unsigned*>(dst + word_at(r, w)) = v;
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -------------------------------------------------------------------------

// Descriptor of a K-major operand tile of 128-byte rows, 128-byte swizzle
// (the TMA's layout; the tile 1024-byte aligned): 8-row groups 1024 bytes
// apart. Adding 2 (32 bytes) moves to the next k-step of 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory. Thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4)
// (+ 1) as d[4 j + {0, 1}] (row) and d[4 j + {2, 3}] (row + 8).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from touching the accumulators across wgmma.
__device__ __forceinline__ void pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// -- the kernel ----------------------------------------------------------------

// grid = (clusters per group x cl, groups); block = FTHREADS. CTA rank r
// of cluster i in group g owns queries 64 (g cl + r).. and walks tiles i,
// i + per_group, ... TMA: the doc chunks through the tensor map, shared by
// the cluster; else the producer warp's loads, per CTA. QRES: the query
// block resident; else each slot carries its query chunks (element loads
// only). Warpgroup wg (warps 4 wg..4 wg + 3) multiplies the tile's docs
// 128 wg..128 wg + 127 against the CTA's 64 queries.
template <int UNPACK, bool SCORES, bool TMA, bool QRES>
__global__ void __launch_bounds__(FTHREADS, 1)
    fold_kernel(const __grid_constant__ CUtensorMap map, const FoldArgs a) {
  static_assert(!TMA || QRES, "TMA runs with the query block resident");
  constexpr bool PACKED = UNPACK != NONE;
  constexpr int H = PACKED ? 2 : 1;
  extern __shared__ char smem_raw[];
  char* base = smem_raw + (ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN;
  const int slot_b = slot_bytes(H, QRES);
  char* ring = base;
  char* qblk = ring + a.stages * slot_b;
  // PACKED: each warpgroup's docs unpacked, [lo, hi][128][CH].
  char* unp = qblk + (QRES ? qblock_bytes(H, a.nck) : 0);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(unp + (PACKED ? UNPACK_BYTES : 0));
  uint64_t* empty = full + a.stages;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x % a.cl, cid = blockIdx.x / a.cl;
  const int q0 = (blockIdx.y * a.cl + rank) * FQ;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, TMA ? 1 : 32);
      mbar_init(empty + s, FGROUPS * (TMA ? a.cl : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (QRES) {
    // [h][chunk][64][CH], 4-byte words, zero past B and past the half row.
    const int words = a.nck * (CH / 4);
    for (int x = tid; x < FQ * H * words; x += FTHREADS) {
      const int r = x / (H * words), h = (x / words) % H, w = x % words;
      const int row = q0 + r, off = 4 * w;
      unsigned v = 0u;
      if (row < a.B && off < a.erow) {
        v = *reinterpret_cast<const unsigned*>(
            a.q + static_cast<long long>(row) * a.D + h * a.erow + off);
      }
      *reinterpret_cast<unsigned*>(
          qblk + (h * a.nck + w / (CH / 4)) * FQ * CH +
          word_at(r, w % (CH / 4))) = v;
    }
    fence_async_smem();
  }
  __syncthreads();
  if constexpr (TMA) cluster_sync();

  if (warp == FWARPS) {
    // The producer: fill chunk f of this CTA's walk into slot f % stages
    // once every consumer of the slot (cluster-wide with TMA) let it go.
    int f = 0;
    for (int t = cid; t < a.tiles; t += a.per_group) {
      for (int c = 0; c < a.nck; ++c, ++f) {
        const int s = f % a.stages;
        const unsigned parity = ((f / a.stages) & 1) ^ 1;
        char* slot = ring + s * slot_b;
        if constexpr (TMA) {
          if (lane == 0) {
            mbar_wait(empty + s, parity);
            mbar_expect_tx(full + s, FT * CH);
            const uint16_t mask = static_cast<uint16_t>((1u << a.cl) - 1u);
            for (int box = rank; box < FT / FBOX; box += a.cl) {
              tma_box(slot + box * FBOX * CH, &map, c * CH,
                      t * FT + box * FBOX, full + s, mask);
            }
          }
        } else {
          mbar_wait(empty + s, parity);
          load_words(slot, a.e, a.erow, t * FT, FT, a.N, a.erow, c, lane);
          if constexpr (!QRES) {
            for (int h = 0; h < H; ++h) {
              load_words(slot + FT * CH + h * FQ * CH, a.q + h * a.erow, a.D,
                         q0, FQ, a.B, a.erow, c, lane);
            }
          }
          fence_async_smem();
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    const int wg = warp / 4, wt = tid % 128;
    char* my_unp = unp + wg * 2 * (FT / FGROUPS) * CH;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int best[2] = {INT_MIN, INT_MIN};
    // This thread's accumulator rows: queries q0 + qr, + 8.
    const int qr = 16 * (warp % 4) + lane / 4;

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
    for (int t = cid; t < a.tiles; t += a.per_group) {
      for (int c = 0; c < a.nck; ++c, ++f) {
        const int s = f % a.stages;
        mbar_wait(full + s, (f / a.stages) & 1);
        char* slot = ring + s * slot_b;
        if constexpr (PACKED) {
          char* docs[2] = {my_unp, my_unp + (FT / FGROUPS) * CH};
          if (a.mode == MODE_FULL) {
            // Row wt of this warpgroup's 128 packed rows, unpacked into
            // lo and hi at the same swizzled place, once every warp of the
            // warpgroup is past the previous chunk's MMAs (wait_group 0).
            // (Unpacking one half while the other multiplies measured
            // slower on an H100: one more barrier a chunk.)
            wg_sync(wg);
            const int r = wg * (FT / FGROUPS) + wt;
#pragma unroll
            for (int seg = 0; seg < CH / 16; ++seg) {
              const int off = swizzle(wt, CH, 0, seg);
              const uint4 v = *reinterpret_cast<const uint4*>(
                  slot + swizzle(r, CH, 0, seg));
              uint4 lo, hi;
              unpack<UNPACK>(v.x, lo.x, hi.x);
              unpack<UNPACK>(v.y, lo.y, hi.y);
              unpack<UNPACK>(v.z, lo.z, hi.z);
              unpack<UNPACK>(v.w, lo.w, hi.w);
              *reinterpret_cast<uint4*>(docs[0] + off) = lo;
              *reinterpret_cast<uint4*>(docs[1] + off) = hi;
            }
            fence_async_smem();
          }
          // Every row unpacked; with the query block resident the packed
          // slot is free already.
          if constexpr (QRES) {
            release(s);
          } else {
            wg_sync(wg);
          }
          if (a.mode == MODE_FULL) {
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const char* qc = QRES ? qblk + (h * a.nck + c) * FQ * CH
                                    : slot + FT * CH + h * FQ * CH;
              const uint64_t da = sw128_desc(qc), db = sw128_desc(docs[h]);
#pragma unroll
              for (int ks = 0; ks < CH / 32; ++ks) {
                wgmma_s8(acc, da + 2 * ks, db + 2 * ks,
                         c > 0 || h > 0 || ks > 0);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin(acc);
          }
          if constexpr (!QRES) release(s);
        } else {
          // int8: the slot's docs straight to the tensor cores. (Waiting
          // for one chunk's MMAs only at the next, wait_group 1, measured
          // slower on an H100: the slot goes back a chunk later.)
          if (a.mode == MODE_FULL) {
            const char* qc = QRES ? qblk + c * FQ * CH : slot + FT * CH;
            const uint64_t da = sw128_desc(qc);
            const uint64_t db = sw128_desc(slot + wg * (FT / FGROUPS) * CH);
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
      }
      if (a.mode != MODE_FULL) continue;
      // Columns: the warpgroup's docs; rows past N were zero-filled:
      // never folded.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int doc = t * FT + wg * (FT / FGROUPS) + 8 * j + 2 * (lane % 4) + i;
          if (doc >= a.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = true_sum<UNPACK>(acc[4 * j + 2 * h + i]);
            if constexpr (SCORES) {
              const int query = q0 + qr + 8 * h;
              if (query < a.B) {
                a.out[static_cast<long long>(query) * a.N + doc] = v;
              }
            } else {
              best[h] = max(best[h], v);
            }
          }
        }
      }
    }
    if constexpr (!SCORES) {
      // The four lanes of one lane / 4 hold the same queries.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = best[h];
        v = max(v, __shfl_xor_sync(FULL, v, 1));
        v = max(v, __shfl_xor_sync(FULL, v, 2));
        const int query = q0 + qr + 8 * h;
        if (lane % 4 == 0 && query < a.B && v != INT_MIN) {
          atomicMax(a.out + query, v);
        }
      }
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers.
  if constexpr (TMA) cluster_sync();
}

// -- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The rows of e as boxes of FBOX rows x CH bytes, 128-byte swizzle, zero
// fill past N and past the row.
cudaError_t doc_map(CUtensorMap* map, const FoldArgs& a) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.erow),
                              static_cast<cuuint64_t>(a.N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.erow)};
  const cuuint32_t box[2] = {CH, FBOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(static_cast<const void*>(a.e)), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int UNPACK, bool SCORES, bool TMA, bool QRES>
cudaError_t launch(const FoldArgs& a, int groups, int smem,
                   cudaStream_t stream) {
  auto kern = fold_kernel<UNPACK, SCORES, TMA, QRES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map{};
  if (TMA) {
    err = doc_map(&map, a);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.per_group * a.cl, groups, 1);
  cfg.blockDim = dim3(FTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = TMA ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, map, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int UNPACK, bool SCORES>
cudaError_t launch_route(const FoldArgs& a, int tma, int resident,
                         int groups, int smem, cudaStream_t s) {
  if (tma) return launch<UNPACK, SCORES, true, true>(a, groups, smem, s);
  if (resident) return launch<UNPACK, SCORES, false, true>(a, groups, smem, s);
  return launch<UNPACK, SCORES, false, false>(a, groups, smem, s);
}

}  // namespace

extern "C" {

int anr_fold_tile_docs() { return FT; }

int anr_fold_smem_bytes(int D, int packed, int stages, int resident) {
  const int erow = packed ? D / 2 : D;
  return fold_smem_bytes(packed ? 2 : 1, (erow + CH - 1) / CH, stages,
                         resident != 0);
}

// Clusters of cl CTAs with smem bytes each that the card holds at once
// (a negative cudaError_t on failure).
int anr_fold_active_clusters(int cl, int smem) {
  auto kern = fold_kernel<NONE, false, true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * 64, 1, 1);
  cfg.blockDim = dim3(FTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

// kind: 0 int8 fold, 1 / 2 int4 fold (mask / shift unpack), 3 / 4 int4
// scores. The launch shape is fold_plan's: stages ring slots, the query
// block resident or streamed, TMA (and clusters of cl CTAs) or element
// loads, groups of cl query blocks, per_group CTAs' clusters per group,
// smem bytes of dynamic shared memory; mode MODE_FULL, or MODE_STAGE (the
// stream alone, for the probe's anatomy).
int anr_fold(int kind, const int8_t* q, const int8_t* e, int B, int N, int D,
             int stages, int resident, int tma, int cl, int groups,
             int per_group, int smem, int mode, int* out, void* stream) {
  const bool packed = kind != INT8_FOLD;
  const int align = packed ? 8 : 4;
  FoldArgs a{};
  a.q = q;
  a.e = e;
  a.B = B;
  a.N = N;
  a.D = D;
  a.erow = packed ? D / 2 : D;
  a.halves = packed ? 2 : 1;
  a.nck = (a.erow + CH - 1) / CH;
  a.stages = stages;
  a.cl = cl;
  a.tiles = N > 0 ? (N + FT - 1) / FT : 0;
  a.per_group = per_group;
  a.mode = mode;
  a.out = out;
  if (kind < INT8_FOLD || kind > INT4_SCORES_SHIFT || B < 1 || N < 1 ||
      D < align || D % align != 0 || stages < 1 || stages > MAX_STAGES ||
      cl < 1 || cl > MAX_CLUSTER || groups < 1 || per_group < 1 ||
      (mode != MODE_FULL && mode != MODE_STAGE) ||
      static_cast<long long>(groups) * cl * FQ < B ||
      smem < fold_smem_bytes(a.halves, a.nck, stages, resident != 0) ||
      smem > SMEM_LIMIT || reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(e) % 4 != 0 ||
      (tma && (!resident || a.erow % 16 != 0 ||
               reinterpret_cast<uintptr_t>(e) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case INT8_FOLD:
      err = launch_route<NONE, false>(a, tma, resident, groups, smem, s);
      break;
    case INT4_FOLD_MASK:
      err = launch_route<UNPACK_MASK, false>(a, tma, resident, groups, smem,
                                             s);
      break;
    case INT4_FOLD_SHIFT:
      err = launch_route<UNPACK_SHIFT, false>(a, tma, resident, groups, smem,
                                              s);
      break;
    case INT4_SCORES_MASK:
      err = launch_route<UNPACK_MASK, true>(a, tma, resident, groups, smem,
                                            s);
      break;
    default:
      err = launch_route<UNPACK_SHIFT, true>(a, tma, resident, groups, smem,
                                             s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
