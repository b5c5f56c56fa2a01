// The int8 scoring path of K2 (fused_topk.cu, through split_topk.cuh)
// and K4 (ivf_topk.cu), and of K2's probe variants (anatomy.cu).
//
// A CTA owns BQN queries (16 or 64) and walks a sequence of tiles of up
// to TN documents (a Walk of topk_common.cuh: K2 a contiguous doc range,
// K4 its share of the IVF table's sub-tiles; every row, or every
// TAU_STRIDE-th for the tau pass). stream_int8 scores every tile into
// sm.scores as float(acc) * doc_scale, acc the exact int32 dot, and hands
// it to the caller's fold.
//
// * Staging. The query block [BQN][Dpad] (Dpad = D rounded up to CH
//   bytes, zero past D and past B) is staged once per CTA. Doc tiles
//   stream through a ring of STAGES chunks of [TN][CH] bytes: while
//   chunk f is scored, the copies of chunks f + 1 and f + 2 are in
//   flight, and the walk runs on across tile boundaries, so the next
//   tile's first chunks load during the fold. (Rings of 5 and 7 chunks
//   measured no faster on an H100.) Rows of
//   16-byte aligned base and D % 16 == 0 move by
//   cp.async.cg 16-byte copies, zero-filled through the copy's source
//   size past D and past the tile's last row; any other rows (D = 37, a
//   view such as values[1:]) are loaded byte by byte into the same layout
//   by the same threads, zero-filled the same way.
// * Layout. Each 128-byte row of a chunk holds eight 16-byte segments,
//   XOR-swizzled by row (topk_common.cuh's swizzle).
// * Scoring. mma.sync.m16n8k32.row.col.s32.s8.s8.s32: documents are the
//   M side (row-major, depth-contiguous as stored), queries the N side
//   (each query row depth-contiguous: the col layout); neither operand is
//   transposed. ldmatrix.x4 loads a 16 x 32-byte A fragment or two 8 x
//   32-byte B fragments. Eight warps: BQN = 64 as 4 x 2 warps of 32 docs
//   x 32 queries (8 MMAs per 32 bytes of depth), BQN = 16 as 8 x 1 warps
//   of 16 x 16 (2 MMAs). The int32 sums are exact, so the scores equal
//   the plain versions' bit for bit.

#pragma once

#include "topk_common.cuh"

namespace {

// Dynamic shared memory of the int8 path for a block of bq queries:
// ring, query block, then the shared tail (scores, running lists, worst
// entries, keep). The probe modes add their counters after it.
// ops/kernels/topk_plan.py computes the same number.
__host__ __device__ inline size_t smem_bytes_int8(int bq, int D, int k) {
  return static_cast<size_t>(STAGES) * TN * CH +
         static_cast<size_t>(bq) * depth_pad(D) + smem_tail_bytes(bq, k);
}

template <int BQN>
__device__ inline SmemT<BQN> carve_int8(char* base, int D, int k) {
  SmemT<BQN> s;
  s.es = base;  // ring [STAGES][TN][CH]
  base += STAGES * TN * CH;
  s.qs = base;  // query block [BQN][Dpad]
  base += static_cast<size_t>(BQN) * depth_pad(D);
  carve_tail(s, base, k);
  return s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Score the tiles of ``walk`` for queries q0.. of q [B, D] against e
// [*, D] (int8, row scales escale). After tile j (documents t0, t0 +
// stride, ... < t1, stride = walk.stride; t1 == t0 for a tile with no
// real row) has landed in sm.scores and sm.keep (column col: document
// t0 + col * stride < t1 and, with ``mask``, mask of it),
// and after a barrier, every thread calls on_tile(j, t0, t1); the next
// tile's scores are written only after the next barrier. With DOT false
// nothing is scored or folded: each thread reads back the words its
// share of the staged chunks and of the query block hold once they have
// landed, and the XOR of them is returned (the CTA's XOR is the XOR of
// the query block's words and of every word of its documents, zero past
// D).
template <int BQN, bool DOT, typename Walk, typename OnTile>
__device__ unsigned stream_int8(const int8_t* q, const int8_t* e,
                                const float* escale, const uint8_t* mask,
                                int B, int D, int q0, const Walk& walk,
                                const SmemT<BQN>& sm, OnTile&& on_tile) {
  constexpr int WARPS_N = BQN >= 64 ? 2 : 1;
  constexpr int WARPS_M = WARPS / WARPS_N;
  constexpr int WM = TN / WARPS_M;   // documents per warp
  constexpr int WN = BQN / WARPS_N;  // queries per warp
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int dpad = depth_pad(D);
  const int nck = dpad / CH;
  char* ring = static_cast<char*>(sm.es);
  char* qblk = static_cast<char*>(sm.qs);
  const bool qvec = D % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool evec = D % 16 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0;

  // The query block, once; its copies join the first chunk's group.
  const int qsegs = dpad / 16;
  for (int x = tid; x < BQN * qsegs; x += THREADS) {
    const int r = x / qsegs, s = x % qsegs, row = q0 + r;
    stage16(qblk + swizzle(r, dpad, s / SEGS, s % SEGS),
            q + static_cast<size_t>(min(row, B - 1)) * D + 16 * s,
            row < B ? D - 16 * s : 0, qvec, q);
  }

  // Chunk f of the walk is depth chunk f % nck of tile f / nck.
  int pj = -1, pt0 = 0, pt1 = 0;
  bool pok = false;
  auto fetch = [&](int f) {
    const int j = f / nck, c = f % nck;
    if (j != pj) {
      pj = j;
      pok = walk.tile(j, pt0, pt1);
    }
    if (pok) {
      char* slot = ring + (f % STAGES) * (TN * CH);
      for (int x = tid; x < TN * SEGS; x += THREADS) {
        const int r = x / SEGS, s = x % SEGS, doc = pt0 + r * walk.stride;
        const int d0 = c * CH + 16 * s;
        stage16(slot + swizzle(r, CH, 0, s),
                e + static_cast<size_t>(doc < pt1 ? doc : 0) * D + d0,
                doc < pt1 ? D - d0 : 0, evec, e);
      }
    }
    cp_async_commit();
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  unsigned xr = 0u;

#pragma unroll
  for (int f = 0; f < STAGES - 1; ++f) fetch(f);
  int t0 = 0, t1 = 0;
  for (int f = 0;; ++f) {
    const int j = f / nck, c = f % nck;
    if (c == 0 && !walk.tile(j, t0, t1)) break;
    cp_async_wait<STAGES - 2>();  // chunk f (and the query block) landed
    __syncthreads();              // ... for every thread; slot f - 1 free
    fetch(f + STAGES - 1);
    const char* slot = ring + (f % STAGES) * (TN * CH);
    if constexpr (DOT) {
#pragma unroll
      for (int ks = 0; ks < CH / 32; ++ks) {
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = wm * WM + mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
          ldsm_x4(slot + swizzle(row, CH, 0, 2 * ks + lane / 16), a[mt][0],
                  a[mt][1], a[mt][2], a[mt][3]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int row = wn * WN + np * 16 + (lane % 8) + (lane / 16) * 8;
          ldsm_x4(qblk + swizzle(row, dpad, c, 2 * ks + (lane / 8) % 2),
                  b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                  b[2 * np + 1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
      if (f == 0) {
        const unsigned* w = reinterpret_cast<const unsigned*>(qblk);
        for (int x = tid; x < BQN * dpad / 4; x += THREADS) xr ^= w[x];
      }
      const unsigned* w = reinterpret_cast<const unsigned*>(slot);
      for (int x = tid; x < TN * CH / 4; x += THREADS) xr ^= w[x];
    }
    if (DOT && c == nck - 1) {
      // C fragment: rows (documents) lane / 4 and + 8, columns (queries)
      // 2 (lane % 4) and + 1.
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = wm * WM + mt * 16 + g + 8 * h;
          const int doc = t0 + col * walk.stride;
          const float sc = doc < t1 ? escale[doc] : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = wn * WN + nt * 8 + 2 * t + i;
              sm.scores[r * (TN + 1) + col] =
                  static_cast<float>(acc[mt][nt][2 * h + i]) * sc;
              acc[mt][nt][2 * h + i] = 0;
            }
          }
        }
      }
      if (tid < TN) {
        const int doc = t0 + tid * walk.stride;
        sm.keep[tid] = doc < t1 && (mask == nullptr || mask[doc] != 0);
      }
      __syncthreads();
      on_tile(j, t0, t1);
    }
  }
  cp_async_wait<0>();
  return xr;
}

// The int8 rows of K2 / K4 as the split kernels of split_topk.cuh take
// them: q [B, D] int8 queries, e [*, D] int8 rows with scales escale, an
// optional [N] mask.
struct Int8Rows {
  const int8_t* q;
  const int8_t* e;
  const float* escale;
  const uint8_t* mask;
  int B, D;
  __host__ __device__ size_t smem_bytes(int bq, int k) const {
    return smem_bytes_int8(bq, D, k);
  }
  template <int BQN>
  __device__ SmemT<BQN> carve(char* base, int k) const {
    return carve_int8<BQN>(base, D, k);
  }
  template <int BQN, bool DOT, typename Walk, typename OnTile>
  __device__ unsigned stream(int q0, const Walk& walk, const SmemT<BQN>& sm,
                             OnTile&& on_tile) const {
    return stream_int8<BQN, DOT>(q, e, escale, mask, B, D, q0, walk, sm,
                                 on_tile);
  }
};

}  // namespace
