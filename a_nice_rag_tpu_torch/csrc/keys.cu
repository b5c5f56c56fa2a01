// Order-preserving score keys for Hopper (sm_90a): the maps a packed
// selection of the fused top-k would fold on.
//
// Replaces these TPU kernels of the repository:
//   T1 the key kernel of test_xpack_key_map_monotone_roundtrip (line 433
//      of the JAX package's fused-kernel test file; _key_kernel :428): the
//      exact f32 -> i32 key of the package's xpack fold (_xpack_scores,
//      fused_topk.py:400 of its TPU kernels), and its inverse
//      (unpack_xpack_vals, :419);
//   P6 scripts/probe_bf16_fold.py:41 and :118: row reductions over
//      bf16-rounded scores (bf16_max :60, bf16_argpick :69,
//      bf16_mask_write :82) and one i32 max over a packed (value, column)
//      key (packed :93).
//
// Contract.
//   anr_xpack_keys / anr_xpack_values: out[i] = w ^ 0x7fffffff where the
//     32-bit word w = in[i] is negative as an i32, else w, for i < n. On
//     f32 bits this is the sign-flip key: keys order as the floats do
//     (-0.0 just below +0.0), and the map is its own inverse, so the same
//     kernel takes keys back to the exact f32 bits. One launch for any
//     n >= 1 and any 4-byte-aligned, non-overlapping in and out that lie
//     on the same 16-byte phase (the wrapper allocates out so); n == 0
//     launches nothing. The caller gives the launch (ops/kernels/keys.py's
//     key_plan): head = the words before in's first 16-byte boundary
//     (at most n), the 16-byte loads a thread keeps in flight, the grid.
//   anr_bf16_row_reduce: for each row r of x [R, W] (W <= 65536), with
//     s = bf16(x) (round to nearest even), four int32 rows of out [4, R]
//     (row_max and second as their f32 bits):
//       row_max[r] = max(s) as f32;
//       arg[r]     = the lowest column c with s[c] == row_max[r];
//       second[r]  = max over the row of (s == row_max ? bf16(-3e38) : s);
//       packed[r]  = (W - 1) - (max_c p[c] & 0xffff), where
//                    p[c] = (key(s[c]) << 16) | (W - 1 - c) as i32 and
//                    key(u) = (u >= 0x8000 ? 0xffff - u : u + 0x8000)
//                             - 0x8000 on the bf16 bits u. The bias keeps
//                    key << 16 out of the i32 sign bit: without it every
//                    positive score would order below every negative one.
//
// What bounds them on an H100: bytes. The keys read and write 4 bytes per
// element (2^24 + 13 elements: 0.040 ms at 3.35 TB/s); the row reduction
// reads each element once and writes 16 bytes per row ([256, 16384]:
// 16.8 MB, 0.005 ms), so at the probe's shapes its launch and the host's
// call around it weigh as much as the stream.
//
// Design. The keys are stream_sum.cu's stream: one grid-stride launch, a
// few CTAs on each SM, each thread issuing `unroll` independent 16-byte
// loads (__ldcs: read once, evict first) before it flips and stores the
// first (__stcs: the 2 x 67 MB of the timed case pass the 50 MB L2 once);
// the last batch is predicated, so every batch keeps its loads in flight.
// (On an H100 neither other cache hints, 16 loads in flight, nor runs of
// contiguous vectors a CTA moved the stream by more than the placement of
// the output in memory does.)
// The vectors follow in's 16-byte grid, which is out's too: thread t of
// the grid also takes head word t and tail word t (the words after the
// last whole vector). For a view such as x[1:] the wrapper allocates out
// that many words past its buffer's start, so every load and store of
// the body moves 16 bytes (four 4-byte stores a vector into an aligned
// out measured 0.055-0.058 ms at 2^24 + 12 words on an H100, against
// 0.048 for an aligned input of that size).
//
// The row reduction is one pass: each thread keeps a RowPart (the max
// with its lowest column, the largest value strictly below the max, the
// lowest column of +0.0), about a dozen instructions a value; the masked
// max is max(below, bf16(-3e38)): the re-max with every column equal to
// the max replaced by the mask value, without reading the row again; the
// packed-key argmax is the max's column but where the max is 0 and +0.0
// occurs.
// A row is one CTA of 256 or 512 threads (ops/kernels/keys.py's
// row_plan, by W), each issuing 8 16-byte loads (__ldg: a matrix that
// fits the 50 MB L2 stays there for its next reader) before it uses the
// first; a row whose base is not 16-byte aligned (W not a multiple of 4,
// a storage offset) takes a scalar head up to the first aligned column
// and a scalar tail. The merge is order-free, so ties go to the lowest
// column whichever thread saw them first.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned flip(unsigned w) {
  return static_cast<int>(w) < 0 ? w ^ 0x7fffffffu : w;
}

__device__ __forceinline__ uint4 flip4(uint4 v) {
  return make_uint4(flip(v.x), flip(v.y), flip(v.z), flip(v.w));
}

// Thread tid of the grid's `stride` takes head word tid (tid < head),
// the body's vectors tid, tid + stride, ... (UNROLL loads issued before
// the first store; the last batch predicated) and tail word tid. The
// body starts 16-byte aligned in `in` and in `out`.
template <int UNROLL>
__global__ void __launch_bounds__(kThreads)
    flip_kernel(const unsigned* in, unsigned* out, long long n, int head) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n_vec = (n - head) / 4;
  if (tid < head) __stcs(out + tid, flip(__ldcs(in + tid)));
  const uint4* body = reinterpret_cast<const uint4*>(in + head);
  uint4* out_body = reinterpret_cast<uint4*>(out + head);
  for (long long i = tid; i < n_vec; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * stride < n_vec) v[u] = __ldcs(body + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * stride < n_vec) {
        __stcs(out_body + i + u * stride, flip4(v[u]));
      }
    }
  }
  const long long t = head + 4 * n_vec + tid;
  if (t < n) __stcs(out + t, flip(__ldcs(in + t)));
}

int launch_flip(const void* in, void* out, long long n, int head,
                int unroll, int grid, cudaStream_t stream) {
  if (n == 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  // The body's vectors start on in's 16-byte grid and out's.
  if (n < 0 || head < 0 || head > 3 || head > n || grid < 1 || a % 4 != 0 ||
      a % 16 != b % 16 || (n - head >= 4 && (a + 4 * head) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned* src = static_cast<const unsigned*>(in);
  unsigned* dst = static_cast<unsigned*>(out);
  switch (unroll) {
    case 4:
      flip_kernel<4><<<grid, kThreads, 0, stream>>>(src, dst, n, head);
      break;
    case 8:
      flip_kernel<8><<<grid, kThreads, 0, stream>>>(src, dst, n, head);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One row's running summary of bf16-rounded values: the max ``top``, the
// lowest column holding it, ``below`` = the largest value strictly less
// than ``top`` (-inf if none), and ``pz`` = the lowest column holding
// +0.0 (W if none). Two summaries of disjoint parts merge into the
// summary of their union whatever the order (the merge is associative and
// commutative), so a row's threads and warps combine in any tree. An empty summary is (-inf, W, -inf, W): a tie at -inf takes the
// other's column.
//
// The packed key's argmax follows from it: the key orders as the values
// do, but for -0.0 < +0.0 (the key is the bf16 bits' order-preserving
// map), with the lower column first among equal keys. So it is ``col``,
// unless the max is 0 and some column holds +0.0: then ``pz``.
struct RowPart {
  float top;
  int col;
  float below;
  int pz;
};

// Column c of value x (f32; rounded to bf16 here) into the summary, on
// the same thread's earlier columns (all lower than c). ``col`` starts at
// the thread's first column, so a tie never moves it. Branch-free.
__device__ __forceinline__ void take(RowPart& p, float x, int c) {
  const float v = __bfloat162float(__float2bfloat16_rn(x));
  const float t = p.top;
  const bool gt = v > t;
  p.below = v == t ? p.below : fmaxf(p.below, fminf(v, t));
  p.col = gt ? c : p.col;
  p.top = gt ? v : t;
  p.pz = __float_as_int(v) == 0 && c < p.pz ? c : p.pz;
}

__device__ __forceinline__ void take4(RowPart& p, float4 v, int c) {
  take(p, v.x, c);
  take(p, v.y, c + 1);
  take(p, v.z, c + 2);
  take(p, v.w, c + 3);
}

__device__ __forceinline__ void merge(RowPart& a, const RowPart& b) {
  const float t = b.top > a.top ? b.top : a.top;
  float below = fmaxf(a.below, b.below);
  if (a.top < t) below = fmaxf(below, a.top);
  if (b.top < t) below = fmaxf(below, b.top);
  a.col = b.top > a.top ? b.col : (a.top > b.top ? a.col : min(a.col, b.col));
  a.top = t;
  a.below = below;
  a.pz = min(a.pz, b.pz);
}

__device__ __forceinline__ RowPart shfl_xor(const RowPart& p, int off) {
  RowPart o;
  o.top = __shfl_xor_sync(kFull, p.top, off);
  o.col = __shfl_xor_sync(kFull, p.col, off);
  o.below = __shfl_xor_sync(kFull, p.below, off);
  o.pz = __shfl_xor_sync(kFull, p.pz, off);
  return o;
}

// One pass over each row: row blockIdx.x belongs to the CTA's T threads,
// thread t taking the row's 16-byte vectors t, t + T, ..., kRowUnroll at
// a time (all their loads issued before the first is used, the last batch
// predicated), and column t of the scalar head (columns before the first
// 16-byte boundary, when the row's base is not aligned) and of the scalar
// tail. Threads merge by warp shuffles, the warps by one more warp's
// shuffles.
constexpr int kRowUnroll = 8;

// At most 64 registers a thread, so that a 512-thread CTA does not hold
// an SM alone: [256, 16384]'s 256 rows then run in one wave.
template <int T>
__global__ void __launch_bounds__(T, 1024 / T)
    bf16_row_reduce_kernel(const float* __restrict__ x, int R, int W,
                           int* __restrict__ out) {
  __shared__ RowPart warp_part[T / 32];
  const int t = threadIdx.x;
  const int r = blockIdx.x;
  const float* row = x + static_cast<size_t>(r) * W;
  const int head = min(
      W, static_cast<int>(
             ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4));
  const int n_vec = (W - head) / 4;
  const int tail0 = head + 4 * n_vec;
  // This thread's columns, in the order it takes them: the head's, its
  // vectors' (t, t + T, ...), the tail's. ``col`` starts at the first.
  const bool has_head = t < head;
  const bool has_tail = tail0 + t < W;
  const int first = has_head ? t
                    : t < n_vec ? head + 4 * t
                    : has_tail ? tail0 + t
                               : W;
  RowPart p{-INFINITY, first, -INFINITY, W};
  if (has_head) take(p, row[t], t);
  const float4* vec = reinterpret_cast<const float4*>(row + head);
  for (int i = t; i < n_vec; i += kRowUnroll * T) {
    float4 v[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (i + u * T < n_vec) v[u] = __ldg(vec + i + u * T);
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (i + u * T < n_vec) take4(p, v[u], head + 4 * (i + u * T));
    }
  }
  if (has_tail) take(p, row[tail0 + t], tail0 + t);

  for (int off = 16; off > 0; off >>= 1) merge(p, shfl_xor(p, off));
  const int lane = t % 32;
  if (lane == 0) warp_part[t / 32] = p;
  __syncthreads();
  if (t >= 32) return;
  p = warp_part[lane < T / 32 ? lane : 0];
  for (int off = 16; off > 0; off >>= 1) merge(p, shfl_xor(p, off));
  if (t == 0) {
    const float masked = __bfloat162float(__float2bfloat16_rn(-3e38f));
    out[r] = __float_as_int(p.top);
    out[R + r] = p.col;
    out[2 * R + r] = __float_as_int(fmaxf(p.below, masked));
    out[3 * R + r] = p.top == 0.f && p.pz < W ? p.pz : p.col;
  }
}

}  // namespace

extern "C" {

// head: the words before x's (keys') first 16-byte boundary, at most n;
// unroll: 4 or 8 16-byte loads in flight a thread.
int anr_xpack_keys(const float* x, int* keys, long long n, int head,
                   int unroll, int grid, void* stream) {
  return launch_flip(x, keys, n, head, unroll, grid,
                     static_cast<cudaStream_t>(stream));
}

int anr_xpack_values(const int* keys, float* x, long long n, int head,
                     int unroll, int grid, void* stream) {
  return launch_flip(keys, x, n, head, unroll, grid,
                     static_cast<cudaStream_t>(stream));
}

// out: [4, R] int32 on the device, rows (max as f32 bits, its lowest
// column, the masked max as f32 bits, the packed-key argmax); threads:
// the CTA of each row, 256 or 512.
int anr_bf16_row_reduce(const float* x, int R, int W, int threads, int* out,
                        void* stream) {
  if (R < 1 || W < 1 || W > 65536 || (threads != 256 && threads != 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 512) {
    bf16_row_reduce_kernel<512><<<R, 512, 0, s>>>(x, R, W, out);
  } else {
    bf16_row_reduce_kernel<256><<<R, 256, 0, s>>>(x, R, W, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
