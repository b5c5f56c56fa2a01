// int4-packed dense scoring for Hopper (sm_90a): does halving the bytes
// of the int8 stream help a kernel that may be bound by its arithmetic?
//
// Replaces the TPU kernels of scripts/probe_int4.py:
//   stage 1 (:83) _score_kernel :60, with either unpack (:47, :53), and
//   stage 3 (:243 native int4, :261 int4 load + int8 upcast): the exact
//     [B, N] int32 product q8 . e4^T, all one function -> anr_int4_scores;
//   stage 2 (:188 _fold_kernel_int4 :97, :167 _fold_kernel_int8 :121):
//     stream + unpack + dot + a per-row running max -> anr_int4_fold_max,
//     anr_int8_fold_max.
//
// Layout (pack_int4, probe_int4.py:36): a row of D int4 values is D/2
// bytes; byte j holds column j in its low nibble and column j + D/2 in its
// high nibble. So packed word w (bytes 4w..4w+3) unpacks to two int8
// words: its low nibbles are columns 4w..4w+3 (query word w), its high
// nibbles columns D/2 + 4w.. (query word D/8 + w). Each nibble is
// sign-extended within its own byte, never across the 32-bit word (a
// borrow or a shift across bytes would corrupt the neighbour):
//   UNPACK_MASK  (probe :53) per byte (n ^ 8) - 8, the subtraction by
//                __vsub4, which keeps each borrow inside its byte;
//   UNPACK_SHIFT (probe :47) per byte the nibble moved to the byte's top
//                and shifted right by 4 with its sign bit copied.
//
// Contract: q8 [B, D] int8, e8 [N, D] int8 or packed [N, D/2] int8 with
// D % 8 == 0 (int8 rows: D % 4 == 0), rows 4-byte aligned.
//   anr_int4_scores:   out [B, N] i32 = q8 . unpack(packed)^T, exact;
//   anr_int{4,8}_fold_max: out [B] i32 = max over the N documents of the
//     exact product, folded by atomicMax into out, which the caller sets
//     to INT_MIN.
//
// What bounds it on an H100: operations, on this design. Stage 2 at
// 10,485,760 x 1024 and B = 256 is 5.5 T int8 multiply-adds: 2.8 ms at
// the int8 tensor-core peak against 3.2 ms (int8) or 1.6 ms (int4) for
// the bytes, but these kernels multiply on the CUDA cores with __dp4a, as
// K2 does, through K2's own tiles and inner loop (topk_common.cuh: 64
// queries x 128 documents per CTA, 4 x 8 sums per thread, dp4a_chunk over
// depth staged through shared memory). They are the TPU probe's stripped
// kernels: no scores tile, no running lists, only the staging (with the
// unpack) and a running max, so their shared memory and occupancy are
// their own, not K2's. int4 halves the bytes and adds the unpack (a few
// integer operations per packed word) to the same number of __dp4a; if
// the stream were the limit it would run up to 2x faster, if the __dp4a
// are, no faster.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

// BQ, TN, THREADS, DK (int8 words of depth staged per chunk) and FULL
// are topk_common.cuh's.
constexpr int PK = DK / 2;    // packed words per chunk (two int8 words each)

enum Unpack : int { UNPACK_MASK = 0, UNPACK_SHIFT = 1, NONE = 2 };

__device__ __forceinline__ unsigned sar4_bytes(unsigned t) {
  // Each byte's top nibble to its bottom, the byte's sign bit copied
  // into the top four bits (x 0xf0 stays inside each byte).
  return ((t >> 4) & 0x0f0f0f0fu) | (((t >> 7) & 0x01010101u) * 0xf0u);
}

template <int UNPACK>
__device__ __forceinline__ void unpack(unsigned w, int& lo, int& hi) {
  if constexpr (UNPACK == UNPACK_MASK) {
    lo = static_cast<int>(__vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u,
                                  0x08080808u));
    hi = static_cast<int>(__vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u,
                                  0x08080808u));
  } else {
    lo = static_cast<int>(sar4_bytes((w << 4) & 0xf0f0f0f0u));
    hi = static_cast<int>(sar4_bytes(w & 0xf0f0f0f0u));
  }
}

// grid = (doc split) x (query block). UNPACK == NONE: e holds int8 rows
// of D bytes; else packed rows of D/2 bytes. SCORES: write every exact
// sum to out [B, N]; else fold each row's max into out [B].
template <int UNPACK, bool SCORES>
__global__ void __launch_bounds__(THREADS)
    dot_kernel(const int* q, const int* e, int B, int N, int D,
               int docs_per_split, int* out) {
  __shared__ int qs[DK][BQ + 1];
  __shared__ int es[DK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // docs tx + 16 * j
  const int ty = tid / 16;  // queries ty * 4 + i
  const int q0 = blockIdx.y * BQ;
  const int begin = blockIdx.x * docs_per_split;
  const int end = min(N, begin + docs_per_split);
  const int qwords = D / 4;  // int8 words of a query row
  constexpr bool PACKED = UNPACK != NONE;
  const int ewords = PACKED ? D / 8 : D / 4;  // stored words per doc row
  int best[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};

  for (int tile0 = begin; tile0 < end; tile0 += TN) {
    int acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    // Per chunk: DK int8 words of depth, i.e. PK packed words.
    const int step = PACKED ? PK : DK;
    for (int w0 = 0; w0 < ewords; w0 += step) {
      for (int x = tid; x < BQ * step; x += THREADS) {
        const int r = x / step, w = x % step, row = q0 + r, word = w0 + w;
        const bool ok = row < B && word < ewords;
        const int* qrow = q + static_cast<size_t>(row) * qwords;
        if constexpr (PACKED) {
          qs[w][r] = ok ? qrow[word] : 0;
          qs[PK + w][r] = ok ? qrow[D / 8 + word] : 0;
        } else {
          qs[w][r] = ok ? qrow[word] : 0;
        }
      }
      for (int x = tid; x < TN * step; x += THREADS) {
        const int r = x / step, w = x % step, doc = tile0 + r,
                  word = w0 + w;
        const unsigned v =
            doc < end && word < ewords
                ? static_cast<unsigned>(
                      e[static_cast<size_t>(doc) * ewords + word])
                : 0u;
        if constexpr (PACKED) {
          int lo, hi;
          unpack<UNPACK>(v, lo, hi);
          es[w][r] = lo;
          es[PK + w][r] = hi;
        } else {
          es[w][r] = static_cast<int>(v);
        }
      }
      __syncthreads();
      dp4a_chunk(&qs[0][0], &es[0][0], ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int doc = tile0 + tx + 16 * j;
      if (doc >= end) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if constexpr (SCORES) {
          if (row < B) out[static_cast<size_t>(row) * N + doc] = acc[i][j];
        } else {
          best[i] = max(best[i], acc[i][j]);
        }
      }
    }
  }
  if constexpr (!SCORES) {
    // The 16 threads of one query group are 16 neighbouring lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int v = best[i];
      for (int off = 8; off > 0; off >>= 1) {
        v = max(v, __shfl_xor_sync(FULL, v, off));
      }
      const int row = q0 + ty * 4 + i;
      if (tx == 0 && row < B && v != INT_MIN) atomicMax(out + row, v);
    }
  }
}

template <int UNPACK, bool SCORES>
int launch(const void* q, const void* e, int B, int N, int D, int n_splits,
           int docs_per_split, int* out, cudaStream_t stream) {
  const int align = UNPACK == NONE ? 4 : 8;
  if (B < 1 || N < 1 || D < align || D % align != 0 || n_splits < 1 ||
      docs_per_split < 1 || docs_per_split % TN != 0 ||
      reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(e) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_splits, (B + BQ - 1) / BQ);
  dot_kernel<UNPACK, SCORES><<<grid, THREADS, 0, stream>>>(
      static_cast<const int*>(q), static_cast<const int*>(e), B, N, D,
      docs_per_split, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int anr_int4_tile_docs() { return TN; }

int anr_int4_scores(const int8_t* q, const int8_t* packed, int B, int N,
                    int D, int unpack_shift, int n_splits,
                    int docs_per_split, int* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return unpack_shift
             ? launch<UNPACK_SHIFT, true>(q, packed, B, N, D, n_splits,
                                          docs_per_split, out, s)
             : launch<UNPACK_MASK, true>(q, packed, B, N, D, n_splits,
                                         docs_per_split, out, s);
}

int anr_int4_fold_max(const int8_t* q, const int8_t* packed, int B, int N,
                      int D, int unpack_shift, int n_splits,
                      int docs_per_split, int* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return unpack_shift
             ? launch<UNPACK_SHIFT, false>(q, packed, B, N, D, n_splits,
                                           docs_per_split, out, s)
             : launch<UNPACK_MASK, false>(q, packed, B, N, D, n_splits,
                                          docs_per_split, out, s);
}

int anr_int8_fold_max(const int8_t* q, const int8_t* e, int B, int N, int D,
                      int n_splits, int docs_per_split, int* out,
                      void* stream) {
  return launch<NONE, false>(q, e, B, N, D, n_splits, docs_per_split, out,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
