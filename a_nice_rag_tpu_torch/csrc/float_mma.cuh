// The float scoring path of K1 (fused_topk.cu, through split_topk.cuh)
// and K3 (ivf_topk.cu), and of K1's probe variants (anatomy.cu): the
// counterpart of int8_mma.cuh, on the same staging helpers and walks
// (topk_common.cuh).
//
// A CTA owns BQN queries (16 for B <= 16, else 64) and walks a sequence
// of tiles of up to TN documents. stream_float scores every tile into
// sm.scores (f32) and hands it to the caller's fold.
//
// * Staging. Doc tiles stream through a ring of STAGES chunks of [TN]
//   [CH] bytes (64 bf16 or 32 f32 of depth per row), 16-byte cp.async.cg
//   copies zero-filled past D and past the tile's last row, segments
//   XOR-swizzled by row; the walk runs on across tile boundaries. Rows
//   whose base or D * element size is not 16-byte aligned (D = 37, a view
//   emb[1:]) take element loads into the same layout. The query block
//   (every plane, [PLANES][BQN][Dpad]) is held whole in shared memory
//   where it fits (qres, chosen by ops/kernels/topk_plan.py); otherwise
//   each ring stage also carries the query block's matching depth chunk,
//   so any D works.
// * bf16 rows on the bf16 tensor cores. The f32 query arrives as three
//   bf16 planes hi + mid + lo == q (split_query_kernel): a bf16 document
//   value times a bf16 piece is exact in f32, so three MMAs compute the
//   f32-accumulated product of the f32 query and the bf16 rows, in
//   another summation order; no TF32 anywhere.
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: documents are the M side
//   (row-major as stored), queries the N side (depth-contiguous rows: the
//   col layout), the same fragments and ldmatrix addressing as the int8
//   path's m16n8k32 (16 rows x 32 bytes). Eight warps: BQN = 64 as 4 x 2
//   warps of 32 docs x 32 queries, BQN = 16 as 8 x 1 of 16 x 16. Each doc
//   fragment serves the three pieces. The tensor cores' f32 accumulation
//   truncates inside the MMA, so each 16-deep k-step's three MMAs (lo,
//   mid, hi) sum into a zeroed fragment that is then added to the running
//   f32 sum with an ordinary FADD: the truncation stays local to 16 * 3
//   products.
// * f32 rows on FFMA, in IEEE f32: each thread owns QT queries x DT docs
//   and reads 16-byte shared vectors (4 depths) of both from the same
//   ring, accumulating depth by depth in order.
//
// Every document is scored by the same instruction sequence wherever it
// sits, so duplicated rows tie bit for bit, and the tau pass's subsample
// scores equal the main pass's.
//
// The epilogue that writes a tile's scores also flags (sm.hit) each query
// row with a score at least the row's worst entry: with lists seeded by
// tau, most rows of most tiles have none, and the fold skips them.

#pragma once

#include "topk_common.cuh"

namespace {

// The bit type of a float row's elements and the planes of its query: bf16
// rows take the three bf16 pieces of the f32 query, f32 rows the query.
template <typename T>
struct FloatKind;
template <>
struct FloatKind<float> {
  using U = uint32_t;
  static constexpr int PLANES = 1;
};
template <>
struct FloatKind<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr int PLANES = 3;
};

// Dynamic shared memory of the float path for a block of bq queries: the
// ring (doc chunks, and the query chunks when the block is streamed), the
// resident query block (qres), the shared tail, then the rows' hit flags.
// The probe modes add their counters after it. ops/kernels/topk_plan.py
// computes the same number.
__host__ __device__ inline size_t smem_bytes_float(int bq, int D, int esize,
                                                   int planes, bool qres,
                                                   int k) {
  const size_t stage = static_cast<size_t>(TN) * CH +
                       (qres ? 0 : static_cast<size_t>(planes) * bq * CH);
  const size_t qblock =
      qres ? static_cast<size_t>(planes) * bq * depth_pad(D * esize) : 0;
  return STAGES * stage + qblock + smem_tail_bytes(bq, k) + bq;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Score the tiles of ``walk`` for queries q0.. of q [PLANES][B][D]
// against e [*, D] (T: f32 or bf16). After tile j (documents t0, t0 +
// stride, ... < t1) has landed in sm.scores and sm.keep (column col:
// document t0 + col * stride < t1 and, with ``mask``, mask of it), and
// after a barrier, every thread calls on_tile(j, t0, t1); the next tile's
// scores are written only after the next barrier. With DOT false nothing
// is scored or folded: each thread reads back the words its share of the
// staged chunks (and of a resident query block, once) hold once they have
// landed, and the XOR of them is returned.
template <typename T, int BQN, bool DOT, typename Walk, typename OnTile>
__device__ unsigned stream_float(const T* q, const T* e, const uint8_t* mask,
                                 int B, int D, int q0, bool qres,
                                 const Walk& walk, const SmemT<BQN>& sm,
                                 OnTile&& on_tile) {
  using U = typename FloatKind<T>::U;
  constexpr int P = FloatKind<T>::PLANES;
  constexpr int ES = static_cast<int>(sizeof(T));
  constexpr bool MMA = P == 3;
  // bf16 MMA: warp tiles of WM docs x WN queries.
  constexpr int WARPS_N = BQN >= 64 ? 2 : 1;
  constexpr int WARPS_M = WARPS / WARPS_N;
  constexpr int WM = TN / WARPS_M, WN = BQN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  // f32 FFMA: QT queries x DT docs per thread, TXN threads along docs.
  constexpr int QT = BQN >= 64 ? 4 : 2, DT = BQN >= 64 ? 8 : 4;
  constexpr int TXN = TN / DT;
  static_assert((THREADS / TXN) * QT == BQN, "thread tile");
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int tx = tid % TXN, ty = tid / TXN;
  const int dpad = depth_pad(D * ES);
  const int nck = dpad / CH;
  char* ring = static_cast<char*>(sm.es);
  char* qblk = static_cast<char*>(sm.qs);
  const int stage_bytes = TN * CH + (qres ? 0 : P * BQN * CH);
  const U* qu = reinterpret_cast<const U*>(q);
  const U* eu = reinterpret_cast<const U*>(e);
  const bool qvec =
      (D * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool evec =
      (D * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0;

  // Query rows q0.. of every plane (shared-memory row p * BQN + r), depth
  // chunks c0 .. c0 + n - 1, into rows of row_bytes at dst.
  auto stage_query = [&](char* dst, int row_bytes, int c0, int n) {
    const int segs = n * SEGS;
    for (int x = tid; x < P * BQN * segs; x += THREADS) {
      const int pr = x / segs, s = x % segs;
      const int p = pr / BQN, row = q0 + pr % BQN;
      const int d0 = (c0 * CH + 16 * s) / ES;
      stage16(dst + swizzle(pr, row_bytes, s / SEGS, s % SEGS),
              qu + (static_cast<size_t>(p) * B + min(row, B - 1)) * D + d0,
              row < B ? D - d0 : 0, qvec, q);
    }
  };
  // A resident block joins the first chunk's group.
  if (qres) stage_query(qblk, dpad, 0, nck);

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
      char* slot = ring + (f % STAGES) * stage_bytes;
      for (int x = tid; x < TN * SEGS; x += THREADS) {
        const int r = x / SEGS, s = x % SEGS, doc = pt0 + r * walk.stride;
        const int d0 = (c * CH + 16 * s) / ES;
        stage16(slot + swizzle(r, CH, 0, s),
                eu + static_cast<size_t>(doc < pt1 ? doc : 0) * D + d0,
                doc < pt1 ? D - d0 : 0, evec, e);
      }
      if (!qres) stage_query(slot + TN * CH, CH, c, 1);
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float facc[QT][DT];
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) facc[i][jj] = 0.f;
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
    const char* slot = ring + (f % STAGES) * stage_bytes;
    // This chunk's query depth: the resident block's chunk c, or the
    // slot's own.
    const char* qc = qres ? qblk : slot + TN * CH;
    const int qrb = qres ? dpad : CH, qch = qres ? c : 0;
    if constexpr (DOT && MMA) {
#pragma unroll
      for (int ks = 0; ks < CH / 32; ++ks) {
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = wm * WM + mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
          ldsm_x4(slot + swizzle(row, CH, 0, 2 * ks + lane / 16), a[mt][0],
                  a[mt][1], a[mt][2], a[mt][3]);
        }
        float part[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {  // lo, mid, hi
          unsigned b[NT][2];
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int row = p * BQN + wn * WN + np * 16 + (lane % 8) +
                            (lane / 16) * 8;
            ldsm_x4(qc + swizzle(row, qrb, qch, 2 * ks + (lane / 8) % 2),
                    b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                    b[2 * np + 1][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(part[mt][nt], a[mt], b[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);
      }
    } else if constexpr (DOT) {
#pragma unroll 2
      for (int s = 0; s < SEGS; ++s) {
        float4 qa[QT], eb[DT];
#pragma unroll
        for (int i = 0; i < QT; ++i)
          qa[i] = *reinterpret_cast<const float4*>(
              qc + swizzle(ty * QT + i, qrb, qch, s));
#pragma unroll
        for (int jj = 0; jj < DT; ++jj)
          eb[jj] = *reinterpret_cast<const float4*>(
              slot + swizzle(tx + TXN * jj, CH, 0, s));
#pragma unroll
        for (int i = 0; i < QT; ++i)
#pragma unroll
          for (int jj = 0; jj < DT; ++jj) {
            float v = facc[i][jj];
            v = fmaf(qa[i].x, eb[jj].x, v);
            v = fmaf(qa[i].y, eb[jj].y, v);
            v = fmaf(qa[i].z, eb[jj].z, v);
            v = fmaf(qa[i].w, eb[jj].w, v);
            facc[i][jj] = v;
          }
      }
    } else {
      if (f == 0 && qres) {
        const unsigned* w = reinterpret_cast<const unsigned*>(qblk);
        for (int x = tid; x < P * BQN * dpad / 4; x += THREADS) xr ^= w[x];
      }
      const unsigned* w = reinterpret_cast<const unsigned*>(slot);
      for (int x = tid; x < stage_bytes / 4; x += THREADS) xr ^= w[x];
    }
    if (DOT && c == nck - 1) {
      if constexpr (MMA) {
        // C fragment: rows (documents) lane / 4 and + 8, columns
        // (queries) 2 (lane % 4) and + 1.
        const int g = lane / 4, t = lane % 4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wn * WN + nt * 8 + 2 * t + i;
            const float wv = sm.worst_v[r];
            bool hit = false;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = wm * WM + mt * 16 + g + 8 * h;
                const float v = acc[mt][nt][2 * h + i];
                sm.scores[r * (TN + 1) + col] = v;
                hit |= v >= wv;
                acc[mt][nt][2 * h + i] = 0.f;
              }
            if (hit) sm.hit[r] = 1;
          }
      } else {
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const int r = ty * QT + i;
          const float wv = sm.worst_v[r];
          bool hit = false;
#pragma unroll
          for (int jj = 0; jj < DT; ++jj) {
            sm.scores[r * (TN + 1) + tx + TXN * jj] = facc[i][jj];
            hit |= facc[i][jj] >= wv;
            facc[i][jj] = 0.f;
          }
          if (hit) sm.hit[r] = 1;
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

// The float rows of K1 / K3 as the split kernels of split_topk.cuh take
// them: q [PLANES][B, D] (bf16 rows: the three pieces; f32 rows: the f32
// query), e [*, D], an optional [N] mask, and whether the query block is
// resident (qres) or streamed by depth chunk.
template <typename T>
struct FloatRows {
  const T* q;
  const T* e;
  const uint8_t* mask;
  int B, D;
  bool qres;
  __host__ __device__ size_t smem_bytes(int bq, int k) const {
    return smem_bytes_float(bq, D, static_cast<int>(sizeof(T)),
                            FloatKind<T>::PLANES, qres, k);
  }
  template <int BQN>
  __device__ SmemT<BQN> carve(char* base, int k) const {
    constexpr int P = FloatKind<T>::PLANES;
    SmemT<BQN> s;
    s.es = base;
    base += STAGES * (TN * CH + (qres ? 0 : P * BQN * CH));
    s.qs = qres ? base : nullptr;
    if (qres) {
      base += static_cast<size_t>(P) * BQN *
              depth_pad(D * static_cast<int>(sizeof(T)));
    }
    carve_tail(s, base, k);
    s.hit = reinterpret_cast<uint8_t*>(base + smem_tail_bytes(BQN, k));
    return s;
  }
  template <int BQN, bool DOT, typename Walk, typename OnTile>
  __device__ unsigned stream(int q0, const Walk& walk, const SmemT<BQN>& sm,
                             OnTile&& on_tile) const {
    return stream_float<T, BQN, DOT>(q, e, mask, B, D, q0, qres, walk, sm,
                                     on_tile);
  }
};

}  // namespace
