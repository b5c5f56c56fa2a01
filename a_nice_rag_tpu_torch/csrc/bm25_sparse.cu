// BM25's sparse top-k for Hopper (sm_90a): per-document totals of each
// query's fetched postings in shared-memory doc slabs, and a k-list
// selection, with no sort.
//
// Replaces no TPU kernel: the JAX package's sparse BM25 route
// (ops/bm25.py, bm25_top_k_sparse) is plain jnp, a sort of the fetched
// postings by document id, a prefix sum and a sort of the totals. The
// port keeps that route in plain torch (ops/bm25.py), which the CPU tests
// hold against the JAX package; on the card it sorted a 2^19-posting
// budget twice a query, about 90% of it padding. This kernel computes the
// same lists from the postings alone (ops/kernels/bm25_sparse.py).
//
// Contract (row b of B, term slot j < T in query order, term t =
// q_terms[b][j]; the term's postings are indptr[t] .. indptr[t + 1] of
// doc_ids / impact, int32 offsets and ids, f32 impacts, the ids of a term
// strictly ascending and >= 0):
//   * slot j counts the term's first n_bj postings: 0 for t < 0 or
//     t >= V; min(df, df_cap) with df_cap > 0 (the window fetch); else
//     min(df, budget - the postings of the slots before j) clamped at 0
//     (the flat fetch). A repeated term counts once per occurrence.
//   * a counted posting of document d adds its impact to d's total unless
//     d >= N (the dump row) or mask[min(d, mask_len - 1)] == 0. A total is
//     the float32 sum of its impacts in slot order (the first impact
//     taken as it is, then each added): at most T - 1 roundings.
//   * out_v / out_i [B][k]: the k best documents with a counted posting,
//     by (total desc, id asc), sorted; (-inf, -1) past the row's last.
//
// What bounds it on an H100: bytes and latency. The postings read are 8
// bytes each (int32 id, f32 impact): a 256-row batch of BEIR-NQ queries
// fetches about 51k postings a row, 0.1 GB, 0.03 ms at 3.35 TB/s. Each
// document's total passes through shared memory once: 256 rows x 2.68M
// documents x 4 bytes, 2.7 GB of shared-memory traffic a batch. On an
// H100 SXM at 700 W that batch takes 1.16 ms (37x the byte bound; the
// sort route 51 ms), nearly all of it in the slab launch, paced by each
// CTA's chain of dependent loads and atomics (slabs of 2^13 beat 2^12
// and 2^14).
//
// Design. Three launches, in order on the stream:
//   bm25_span_kernel (grid [G][B]): each CTA computes its row's counted
//     spans (slot j: its first posting and n_bj, their prefix over the
//     slots), and from the postings' ids the slab boundaries: bound[b][s]
//     [j] = the count of slot j's postings whose id lies below s * S, for
//     s = 0 .. n_slabs (a posting writes the boundaries between its
//     slab and its predecessor's; the G CTAs of a row split its postings).
//     It zeroes the row's list counter and floor.
//   bm25_slab_kernel (grid [B][n_slabs]; row fastest, so the CTAs of one
//     slab column of every row run together and a row's later slabs find
//     its floor raised): a CTA owns the S documents of one slab of one
//     row. It reads each slot's range from the boundary table, loads up
//     to ROUND postings a thread at once, and adds them into the slab's
//     f32 totals in shared memory slot by slot, a barrier between slots:
//     a document occurs once in a term's postings, so a slot's adds never
//     meet and need no atomics, and the sum order is the slot order. A
//     byte a document marks it counted; its first posting writes the
//     total and appends the document to the slab's candidate list.
//     Selection: the row's floor F (a key that the row's k-th best is
//     known to reach) prunes the candidates; if more than k keys reach F,
//     a radix select over the 64-bit key (score's order bits, then the
//     complement of the id: distinct, larger is better) finds the k best
//     and raises the floor to their threshold (atomicMax). The survivors
//     are appended to the row's list (warp-aggregated atomics).
//   bm25_final_kernel (grid [B]): the same selection over the row's list
//     under its final floor, then the k survivors ranked and written.
//
// The names avoid topk_common.cuh's merge_kernel, split_query_kernel and
// topk_kernel: the benchmark's readers of K1's time match those names.
//
// Plain C interface; the entry point returns the cudaError_t of its
// launches (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;      // threads of every CTA
constexpr int ROUND = 4;     // postings in flight a thread
constexpr int SPAN_UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SHIFT_MIN = 12, SHIFT_MAX = 15;  // S = 4096 .. 32768

typedef unsigned long long u64;

// The order (score desc, id asc) as one unsigned 64-bit key, larger is
// better; never 0 (the id's complement of a non-negative id has its top
// bit set).
__device__ __forceinline__ u64 order_key(float v, int id) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(~id);
}

struct Fetch {
  const int* q_terms;   // [B][T]
  const int* indptr;    // [V + 1]
  int V;
  int T;
  long long budget;     // flat fetch
  long long df_cap;     // > 0: the window fetch
};

// The largest j < T with off[j] <= q, for 0 <= q < off[T] (off
// nondecreasing): the slot whose range holds flat position q.
__device__ __forceinline__ int slot_of(const int* off, int T, int q) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= q) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Warp 0: off[0 .. T] = the exclusive prefix of len[0 .. T), in chunks
// of 32 slots. The caller synchronises before and after.
__device__ __forceinline__ void warp_prefix(const int* len, int* off, int T) {
  const int lane = threadIdx.x;
  int carry = 0;
  for (int j0 = 0; j0 < T; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < T ? len[j] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int w = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += w;
    }
    if (j < T) off[j] = carry + inc - v;
    carry += __shfl_sync(FULL, inc, 31);
  }
  if (lane == 0) off[T] = carry;
}

// Row b's counted spans into shared memory: st[j] its first posting,
// n[j] its counted postings, off[0 .. T] their exclusive prefix (df: [T]
// scratch).
__device__ void row_spans(const Fetch& f, int b, long long* st,
                          long long* df, int* n, int* off) {
  const int T = f.T;
  for (int j = threadIdx.x; j < T; j += BT) {
    const int t = f.q_terms[static_cast<size_t>(b) * T + j];
    long long s = 0, d = 0;
    if (t >= 0 && t < f.V) {
      s = f.indptr[t];
      d = f.indptr[t + 1] - s;
    }
    st[j] = s;
    df[j] = d;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long before = 0;  // df of the slots before this chunk
    for (int j0 = 0; j0 < T; j0 += 32) {
      const int j = j0 + lane;
      const long long d = j < T ? df[j] : 0;
      long long inc = d;
      for (int o = 1; o < 32; o <<= 1) {
        const long long w = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += w;
      }
      if (j < T) {
        const long long c = f.df_cap > 0
            ? min(d, f.df_cap)
            : max(0ll, min(d, f.budget - (before + inc - d)));
        n[j] = static_cast<int>(c);
      }
      before += __shfl_sync(FULL, inc, 31);
    }
    __syncwarp();
    warp_prefix(n, off, T);
  }
  __syncthreads();
}

// -- launch 1: spans and slab boundaries ---------------------------------

__global__ void __launch_bounds__(BT)
    bm25_span_kernel(Fetch f, const int* doc_ids, int shift, int n_slabs,
                     long long* span_start, int* bound, int* row_cnt,
                     u64* row_floor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = f.T;
  long long* st = reinterpret_cast<long long*>(smem);  // [T]
  long long* df = st + T;                              // [T]
  int* n = reinterpret_cast<int*>(df + T);             // [T]
  int* off = n + T;                                    // [T + 1]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  row_spans(f, b, st, df, n, off);
  if (blockIdx.x == 0) {
    for (int j = tid; j < T; j += BT) {
      span_start[static_cast<size_t>(b) * T + j] = st[j];
    }
    if (tid == 0) {
      row_cnt[b] = 0;
      row_floor[b] = 0ull;
    }
  }
  int* rb = bound + static_cast<size_t>(b) * (n_slabs + 1) * T;  // [s][j]
  const int stride = gridDim.x * BT;
  for (int e = blockIdx.x * BT + tid; e < (n_slabs + 1) * T; e += stride) {
    if (n[e % T] == 0) rb[e] = 0;
  }
  const int total = off[T];
  for (int base = blockIdx.x * BT * SPAN_UNROLL; base < total;
       base += stride * SPAN_UNROLL) {
    int d[SPAN_UNROLL], dp[SPAN_UNROLL], p[SPAN_UNROLL], js[SPAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SPAN_UNROLL; ++u) {
      const int q = base + u * BT + tid;
      js[u] = -1;
      if (q < total) {
        const int j = slot_of(off, T, q);
        const long long g = st[j] + (q - off[j]);
        js[u] = j;
        p[u] = q - off[j];
        d[u] = doc_ids[g];
        dp[u] = p[u] > 0 ? doc_ids[g - 1] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < SPAN_UNROLL; ++u) {
      if (js[u] < 0) continue;
      const int j = js[u];
      const int cur = min(d[u] >> shift, n_slabs);
      const int prev = dp[u] < 0 ? -1 : min(dp[u] >> shift, n_slabs);
      for (int s = prev + 1; s <= cur; ++s) rb[s * T + j] = p[u];
      if (p[u] == n[j] - 1) {
        for (int s = cur + 1; s <= n_slabs; ++s) rb[s * T + j] = n[j];
      }
    }
  }
}

// -- selection -------------------------------------------------------------

// Shared state of one CTA's selection.
struct Pick {
  int hist[256];
  int bin, need, done, count;
};

// How many of the n keys key(x) reach floor (every thread gets it).
template <class Key>
__device__ int count_from(Key key, int n, u64 floor, Pick& pk) {
  if (threadIdx.x == 0) pk.count = 0;
  __syncthreads();
  int c = 0;
  for (int x = threadIdx.x; x < n; x += BT) c += key(x) >= floor;
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&pk.count, c);
  __syncthreads();
  return pk.count;
}

// The threshold of the k best of the keys that reach floor, more than k
// of them: a radix select over the 64-bit key, 8 bits a pass, stopping
// once the chosen bin holds exactly the keys still needed. The keys at
// or above both the result and floor are exactly the k best (keys are
// distinct). Every thread of the CTA calls it and gets the result.
template <class Key>
__device__ u64 radix_threshold(Key key, int n, int k, u64 floor, Pick& pk) {
  const int tid = threadIdx.x;
  u64 prefix = 0ull;
  int need = k;
  for (int shift = 56;; shift -= 8) {
    for (int x = tid; x < 256; x += BT) pk.hist[x] = 0;
    __syncthreads();
    const u64 hi_mask = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int x = tid; x < n; x += BT) {
      const u64 kx = key(x);
      if (kx >= floor && (kx & hi_mask) == prefix) {
        atomicAdd(&pk.hist[(kx >> shift) & 255], 1);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // Suffix sums over the 256 bins, eight per lane, highest first.
      int local[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        local[i] = pk.hist[255 - (tid * 8 + i)];
        sum += local[i];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int w = __shfl_up_sync(FULL, incl, o);
        if (tid >= o) incl += w;
      }
      int above = incl - sum;  // keys in higher bins than this lane's
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (above < need && above + local[i] >= need) {
          pk.bin = 255 - (tid * 8 + i);
          pk.need = need - above;
          pk.done = local[i] == need - above;
        }
        above += local[i];
      }
    }
    __syncthreads();
    // pk.bin / need / done are rewritten only after the next pass's
    // second barrier, which every thread reaches after reading them.
    prefix |= static_cast<u64>(pk.bin) << shift;
    need = pk.need;
    if (pk.done || shift == 0) return prefix;
  }
}

// The threshold a CTA keeps its keys from: floor where at most k keys
// reach it, else the k best's (and, with row_floor, the row's floor
// raised to it).
template <class Key>
__device__ u64 keep_from(Key key, int n, int k, u64 floor, Pick& pk,
                         u64* row_floor) {
  if (count_from(key, n, floor, pk) <= k) return floor;
  const u64 p = radix_threshold(key, n, k, floor, pk);
  if (row_floor != nullptr && threadIdx.x == 0) atomicMax(row_floor, p);
  return max(p, floor);
}

// -- launch 2: the slabs -----------------------------------------------------

__global__ void __launch_bounds__(BT)
    bm25_slab_kernel(const int* doc_ids, const float* impact,
                     const uint8_t* mask, long long mask_len, int N, int T,
                     int k, int shift, int n_slabs,
                     const long long* span_start, const int* bound,
                     int* row_cnt, u64* row_floor, int cap, float* list_v,
                     int* list_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Pick pk;
  __shared__ int n_cand;
  __shared__ u64 floor_s;
  const int S = 1 << shift;
  float* acc = reinterpret_cast<float*>(smem);             // [S]
  uint16_t* cand = reinterpret_cast<uint16_t*>(acc + S);  // [S]
  uint8_t* counted = reinterpret_cast<uint8_t*>(cand + S); // [S]
  long long* tst = reinterpret_cast<long long*>(counted + S);  // [T]
  int* tlen = reinterpret_cast<int*>(tst + T);             // [T]
  int* toff = tlen + T;                                    // [T + 1]
  const int b = blockIdx.x, slab = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int s0 = slab << shift;

  const int* lo_row =
      bound + (static_cast<size_t>(b) * (n_slabs + 1) + slab) * T;
  for (int j = tid; j < T; j += BT) {
    const int lo = lo_row[j];
    tst[j] = span_start[static_cast<size_t>(b) * T + j] + lo;
    tlen[j] = lo_row[T + j] - lo;
  }
  if (tid == 0) n_cand = 0;
  __syncthreads();
  if (tid < 32) {
    warp_prefix(tlen, toff, T);
  } else {
    for (int i = (tid - 32) * 16; i < S; i += (BT - 32) * 16) {
      *reinterpret_cast<uint4*>(counted + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  const int L = toff[T];
  if (L == 0) return;

  // Totals, slot by slot.
  for (int base = 0; base < L; base += BT * ROUND) {
    int id[ROUND], js[ROUND];
    float v[ROUND];
#pragma unroll
    for (int r = 0; r < ROUND; ++r) {
      const int q = base + r * BT + tid;
      js[r] = -1;
      if (q < L) {
        const int j = slot_of(toff, T, q);
        const long long g = tst[j] + (q - toff[j]);
        id[r] = doc_ids[g];
        v[r] = impact[g];
        js[r] = j;
      }
    }
#pragma unroll
    for (int r = 0; r < ROUND; ++r) {
      if (js[r] >= 0 &&
          (id[r] >= N ||
           (mask != nullptr &&
            !mask[min(static_cast<long long>(id[r]), mask_len - 1)]))) {
        js[r] = -1;
      }
    }
    const int j_first = slot_of(toff, T, base);
    const int j_last = slot_of(toff, T, min(base + BT * ROUND, L) - 1);
    for (int j = j_first; j <= j_last; ++j) {
      if (tlen[j] == 0) continue;  // no posting of slot j in this slab
#pragma unroll
      for (int r = 0; r < ROUND; ++r) {
        const bool mine = js[r] == j;
        const int d = mine ? id[r] - s0 : 0;
        const bool first = mine && !counted[d];
        if (first) {
          counted[d] = 1;
          acc[d] = v[r];
        } else if (mine) {
          acc[d] += v[r];
        }
        const unsigned m = __ballot_sync(FULL, first);
        if (m) {
          const int leader = __ffs(m) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&n_cand, __popc(m));
          at = __shfl_sync(FULL, at, leader);
          if (first) {
            cand[at + __popc(m & ((1u << lane) - 1u))] =
                static_cast<uint16_t>(d);
          }
        }
      }
      __syncthreads();
    }
  }

  // Selection against the row's floor.
  const int nc = n_cand;
  auto key = [&](int x) {
    const int d = cand[x];
    return order_key(acc[d], s0 + d);
  };
  // One reading of the floor for the whole CTA: other rows' slabs raise
  // it meanwhile.
  if (tid == 0) floor_s = *reinterpret_cast<volatile u64*>(row_floor + b);
  __syncthreads();
  const u64 floor = floor_s;
  const u64 thr = keep_from(key, nc, k, floor, pk, row_floor + b);
  float* lv = list_v + static_cast<size_t>(b) * cap;
  int* li = list_i + static_cast<size_t>(b) * cap;
  for (int x0 = 0; x0 < nc; x0 += BT) {
    const int x = x0 + tid;
    const bool keep = x < nc && key(x) >= thr;
    const unsigned m = __ballot_sync(FULL, keep);
    if (m) {
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(row_cnt + b, __popc(m));
      at = __shfl_sync(FULL, at, leader);
      if (keep) {
        const int d = cand[x];
        const int o = at + __popc(m & ((1u << lane) - 1u));
        lv[o] = acc[d];
        li[o] = s0 + d;
      }
    }
  }
}

// -- launch 3: each row's k best -----------------------------------------

constexpr int FINAL_KMAX = 128;

__global__ void __launch_bounds__(BT)
    bm25_final_kernel(const float* list_v, const int* list_i,
                      const int* row_cnt, const u64* row_floor, int cap,
                      int k, float* out_v, int* out_i) {
  __shared__ Pick pk;
  __shared__ u64 keys_s[FINAL_KMAX];
  __shared__ float vals_s[FINAL_KMAX];
  __shared__ int ids_s[FINAL_KMAX];
  __shared__ int taken;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int n = min(row_cnt[row], cap);
  const float* lv = list_v + static_cast<size_t>(row) * cap;
  const int* li = list_i + static_cast<size_t>(row) * cap;
  auto key = [&](int x) { return order_key(lv[x], li[x]); };
  const u64 thr = keep_from(key, n, k, row_floor[row], pk, nullptr);
  if (tid == 0) taken = 0;
  __syncthreads();
  for (int x = tid; x < n; x += BT) {
    const u64 kx = key(x);
    if (kx >= thr) {
      const int slot = atomicAdd(&taken, 1);
      keys_s[slot] = kx;
      vals_s[slot] = lv[x];
      ids_s[slot] = li[x];
    }
  }
  __syncthreads();
  const int count = taken;  // min(k, the row's documents)
  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  for (int s = tid; s < k; s += BT) {
    if (s < count) {
      int rank = 0;
      for (int t = 0; t < count; ++t) rank += keys_s[t] > keys_s[s];
      ov[rank] = vals_s[s];
      oi[rank] = ids_s[s];
    } else {
      ov[s] = -INFINITY;
      oi[s] = -1;
    }
  }
}

}  // namespace

// Shared memory of the slab kernel's dynamic part: the slab's totals,
// candidates and marks, and each slot's span.
static size_t slab_smem_bytes(int shift, int T) {
  const size_t S = size_t{1} << shift;
  return S * (4 + 2 + 1) + static_cast<size_t>(T) * (8 + 4 + 4) + 4;
}

// B rows of T slots; n_slabs = ceil(N / 2^shift); span_grid CTAs a row
// in the first launch. Scratch (the caller's): span_start [B][T] int64,
// bound [B][n_slabs + 1][T] int32, row_cnt [B] int32, row_floor [B]
// uint64, list_v / list_i [B][n_slabs * k].
extern "C" int anr_bm25_sparse_top_k(
    const int* q_terms, int B, int T, const int* indptr, int V,
    const int* doc_ids, const float* impact, int N,
    const uint8_t* mask, long long mask_len, long long budget,
    long long df_cap, int k, int shift, int n_slabs, int span_grid,
    long long* span_start, int* bound, int* row_cnt,
    unsigned long long* row_floor, float* list_v, int* list_i,
    float* out_v, int* out_i, cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || k < 1 || k > FINAL_KMAX ||
      shift < SHIFT_MIN || shift > SHIFT_MAX || span_grid < 1 ||
      n_slabs != (N + (1 << shift) - 1) >> shift || n_slabs > 65535 ||
      B > 65535) {
    return cudaErrorInvalidValue;
  }
  const Fetch f{q_terms, indptr, V, T, budget, df_cap};
  const size_t span_smem = static_cast<size_t>(T) * (8 + 8 + 4 + 4) + 4;
  bm25_span_kernel<<<dim3(span_grid, B), BT, span_smem, stream>>>(
      f, doc_ids, shift, n_slabs, span_start, bound, row_cnt,
      reinterpret_cast<u64*>(row_floor));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t slab_smem = slab_smem_bytes(shift, T);
  if (slab_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bm25_slab_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(slab_smem));
    if (err != cudaSuccess) return err;
  }
  const int cap = n_slabs * k;
  bm25_slab_kernel<<<dim3(B, n_slabs), BT, slab_smem, stream>>>(
      doc_ids, impact, mask, mask_len, N, T, k, shift, n_slabs, span_start,
      bound, row_cnt, reinterpret_cast<u64*>(row_floor), cap, list_v, list_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bm25_final_kernel<<<B, BT, 0, stream>>>(
      list_v, list_i, row_cnt, reinterpret_cast<const u64*>(row_floor), cap,
      k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}
