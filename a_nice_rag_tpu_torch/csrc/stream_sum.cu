// Stream sums for Hopper (sm_90a): the stream-floor kernels of the port.
//
// Replaces these TPU kernels of the repository:
//   P1 bench.py:219 _sum_kernel, launched at bench.py:226: the f32 sum
//      of the 2M stage's matrix, one full pass over it (the stream floor);
//   P2 scripts/probe_hbm_stream.py:57, :108, :154 and :206: the same sum
//      over one, two or m matrices, the last seeded by a scalar operand;
//   P3 scripts/probe_dma_overlap.py:45 _kernel: the same stream plus
//      independent ALU work per tile.
//
// Contract.
//   anr_stream_sum: out[0] = bias + the float32 sum of every element of
//     1 to 8 arrays of one dtype (f32, bf16 or int8), each read once.
//   anr_stream_sum_busy: out[0] = seed + the float32 sum of one array,
//     walked in tiles of tile_elems elements; tile t goes to CTA
//     t mod grid. Each CTA carries one f32 chain w = 1.000001, stepped
//     w <- w * 1.000001 + 1e-9 (rounded after the product and after the
//     sum, never fused) x_iters times for every tile it visits, and
//     writes its final w to work_out[blockIdx.x]. Every thread of the CTA
//     runs the chain, so the work scales with the threads on the card.
//
// What bounds it on an H100: bytes. The 2M stage's matrix (2^21 x 256
// bf16, 1.074 GB) takes 0.321 ms at 3.35 TB/s, the int8 stage's
// (10,485,760 x 1024, 10.74 GB) 3.21 ms; per element the kernel does one
// conversion and one add (int8: __dp4a adds four bytes at once), far
// under the FP32 rate. The chain of the busy kernel is latency work: two
// dependent operations per step.
//
// Design.
// * stream_sum is one launch: a grid-stride loop over 16-byte vectors (4
//   f32, 8 bf16 or 16 int8), a few CTAs on each SM; each thread issues
//   UNROLL independent 16-byte loads before it adds any, so UNROLL x 16
//   bytes per thread are in flight; the loads bypass L1 (__ldcs: read
//   once, evict first). (A persistent grid that streams contiguous 8 KB
//   chunks through a ring of cp.async.bulk copies measured no faster on
//   an H100: the sign of the difference changed between runs.)
//   Elements before the first 16-byte boundary (a view that starts
//   mid-vector) and after the last whole vector take a scalar path.
// * Each thread keeps its own f32 sum; a warp-shuffle tree and one across
//   the warps give the CTA's sum, written to partials[blockIdx.x]. Then a
//   __threadfence and an atomic ticket: the CTA that draws the last
//   ticket adds the partials and the bias in a fixed order, writes
//   out[0] and sets the ticket back to 0 for the next call. So the same
//   inputs and launch shape give the same bits, and the caller keeps the
//   partials and the ticket in one buffer across calls on one stream.
//   int8 sums are exact while every partial sum stays below 2^24.
// * stream_sum_busy keeps two launches: its stream, then a finish
//   kernel of one CTA that adds the partials in the same fixed order.
//
// Plain C interface; each entry point returns the cudaError_t of its
// launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Parts {
  const void* ptr[kMaxParts];
  long long n[kMaxParts];
  int count;
};

template <int DT>
struct Elem;

template <>
struct Elem<kF32> {
  static constexpr int kSize = 4;
  __device__ __forceinline__ static float one(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ __forceinline__ static float vec(const uint4& v) {
    return (__uint_as_float(v.x) + __uint_as_float(v.y)) +
           (__uint_as_float(v.z) + __uint_as_float(v.w));
  }
};

__device__ __forceinline__ float bf16_pair(unsigned w) {
  // Little endian: the lower half is the first element.
  return __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
}

template <>
struct Elem<kBF16> {
  static constexpr int kSize = 2;
  __device__ __forceinline__ static float one(const void* p, long long i) {
    return __uint_as_float(
        static_cast<unsigned>(static_cast<const unsigned short*>(p)[i])
        << 16);
  }
  __device__ __forceinline__ static float vec(const uint4& v) {
    return (bf16_pair(v.x) + bf16_pair(v.y)) +
           (bf16_pair(v.z) + bf16_pair(v.w));
  }
};

template <>
struct Elem<kI8> {
  static constexpr int kSize = 1;
  __device__ __forceinline__ static float one(const void* p, long long i) {
    return static_cast<float>(static_cast<const signed char*>(p)[i]);
  }
  __device__ __forceinline__ static float vec(const uint4& v) {
    int s = __dp4a(static_cast<int>(v.x), 0x01010101, 0);
    s = __dp4a(static_cast<int>(v.y), 0x01010101, s);
    s = __dp4a(static_cast<int>(v.z), 0x01010101, s);
    s = __dp4a(static_cast<int>(v.w), 0x01010101, s);
    return static_cast<float>(s);
  }
};

// This thread's share of the sum of n elements at base: thread `tid` of
// `stride` takes scalar head element tid, vectors tid, tid + stride, ...
// (UNROLL of them loaded before any is added), and scalar tail element
// tid. stride >= 16 > the head and tail lengths.
template <int DT, int UNROLL>
__device__ __forceinline__ float sum_range(const void* base, long long n,
                                           long long tid, long long stride) {
  using E = Elem<DT>;
  constexpr int kVec = 16 / E::kSize;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  long long head = static_cast<long long>((16 - (addr & 15)) & 15) / E::kSize;
  if (head > n) head = n;
  float acc = 0.f;
  if (tid < head) acc += E::one(base, tid);
  const uint4* v = reinterpret_cast<const uint4*>(
      static_cast<const char*>(base) + head * E::kSize);
  const long long nvec = (n - head) / kVec;
  long long i = tid;
  for (; i + (UNROLL - 1) * stride < nvec; i += UNROLL * stride) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = __ldcs(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += E::vec(r[u]);
  }
  for (; i < nvec; i += stride) acc += E::vec(__ldcs(v + i));
  const long long t = head + nvec * kVec + tid;
  if (t < n) acc += E::one(base, t);
  return acc;
}

// The CTA's sum, valid in thread 0. Between two calls in one kernel a
// __syncthreads must separate the first's reads from the second's writes.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(kFull, v, off);
    }
  }
  return v;
}

// One launch: the CTA's partial, then the last CTA to finish (by an
// atomic ticket) adds the partials and the bias in a fixed order.
template <int DT, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    stream_sum_kernel(Parts parts, float* partials, unsigned* ticket,
                      const float* bias, float* out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.f;
  for (int p = 0; p < parts.count; ++p) {
    acc += sum_range<DT, UNROLL>(parts.ptr[p], parts.n[p], tid, stride);
  }
  const float total = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sum = 0.f;
  for (int i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    sum += __ldcg(partials + i);
  }
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    out[0] = (bias != nullptr ? bias[0] : 0.f) + sum;
    *ticket = 0u;
  }
}

template <int DT, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    stream_busy_kernel(const void* base, long long n, long long tile_elems,
                       int x_iters, float* partials, float* work_out) {
  const long long n_tiles = (n + tile_elems - 1) / tile_elems;
  float acc = 0.f;
  float w = 1.000001f;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long e0 = t * tile_elems;
    const long long len = n - e0 < tile_elems ? n - e0 : tile_elems;
    const void* tile =
        static_cast<const char*>(base) + e0 * Elem<DT>::kSize;
    acc += sum_range<DT, UNROLL>(tile, len, threadIdx.x, blockDim.x);
    // Independent of the tile's data; carried from tile to tile, so it
    // cannot leave the loop.
    for (int x = 0; x < x_iters; ++x) {
      w = __fadd_rn(__fmul_rn(w, 1.000001f), 1e-9f);
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    work_out[blockIdx.x] = w;
  }
}

// out[0] = bias + the partials, summed in a fixed order by one CTA.
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* partials, int n, const float* bias,
                  float* out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = (bias != nullptr ? bias[0] : 0.f) + total;
}

struct SumOut {
  const float* bias;
  float* partials;  // [grid] floats, then the ticket (zero between calls)
  float* out;
};

template <int DT, int UNROLL>
cudaError_t launch_sum(const Parts& parts, int grid, const SumOut& o,
                       cudaStream_t stream) {
  stream_sum_kernel<DT, UNROLL><<<grid, kThreads, 0, stream>>>(
      parts, o.partials, reinterpret_cast<unsigned*>(o.partials + grid),
      o.bias, o.out);
  return cudaGetLastError();
}

template <int DT>
cudaError_t sum_dtype(const Parts& parts, int grid, int unroll,
                      const SumOut& o, cudaStream_t stream) {
  switch (unroll) {
    case 1: return launch_sum<DT, 1>(parts, grid, o, stream);
    case 2: return launch_sum<DT, 2>(parts, grid, o, stream);
    case 4: return launch_sum<DT, 4>(parts, grid, o, stream);
    case 8: return launch_sum<DT, 8>(parts, grid, o, stream);
    default: return cudaErrorInvalidValue;
  }
}

int stream_sum_parts(int dtype, const Parts& parts, const SumOut& o,
                     int grid, int unroll, cudaStream_t s) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case kF32: err = sum_dtype<kF32>(parts, grid, unroll, o, s); break;
    case kBF16: err = sum_dtype<kBF16>(parts, grid, unroll, o, s); break;
    case kI8: err = sum_dtype<kI8>(parts, grid, unroll, o, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <int DT, int UNROLL>
cudaError_t launch_busy(const void* base, long long n, long long tile_elems,
                        int x_iters, int grid, float* partials,
                        float* work_out, cudaStream_t stream) {
  stream_busy_kernel<DT, UNROLL><<<grid, kThreads, 0, stream>>>(
      base, n, tile_elems, x_iters, partials, work_out);
  return cudaGetLastError();
}

template <int DT>
cudaError_t busy_dtype(const void* base, long long n, long long tile_elems,
                       int x_iters, int grid, int unroll, float* partials,
                       float* work_out, cudaStream_t stream) {
  switch (unroll) {
    case 1: return launch_busy<DT, 1>(base, n, tile_elems, x_iters, grid,
                                      partials, work_out, stream);
    case 2: return launch_busy<DT, 2>(base, n, tile_elems, x_iters, grid,
                                      partials, work_out, stream);
    case 4: return launch_busy<DT, 4>(base, n, tile_elems, x_iters, grid,
                                      partials, work_out, stream);
    case 8: return launch_busy<DT, 8>(base, n, tile_elems, x_iters, grid,
                                      partials, work_out, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t finish(const float* partials, int grid, const float* bias,
                   float* out, cudaStream_t stream) {
  finish_kernel<<<1, kThreads, 0, stream>>>(partials, grid, bias, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs and counts are host arrays of n_parts entries; partials holds grid
// floats and then the ticket (zero before the first call) on the device;
// unroll is 1, 2, 4 or 8.
int anr_stream_sum(int dtype, int n_parts, const void* const* ptrs,
                   const long long* counts, const float* bias,
                   float* partials, float* out, int grid, int unroll,
                   void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts{};
  parts.count = n_parts;
  for (int p = 0; p < n_parts; ++p) {
    if (counts[p] < 0) return static_cast<int>(cudaErrorInvalidValue);
    parts.ptr[p] = ptrs[p];
    parts.n[p] = counts[p];
  }
  return stream_sum_parts(dtype, parts, SumOut{bias, partials, out}, grid,
                          unroll, static_cast<cudaStream_t>(stream));
}

// anr_stream_sum of one array, without the host arrays.
int anr_stream_sum1(int dtype, const void* ptr, long long n,
                    const float* bias, float* partials, float* out, int grid,
                    int unroll, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Parts parts{};
  parts.count = 1;
  parts.ptr[0] = ptr;
  parts.n[0] = n;
  return stream_sum_parts(dtype, parts, SumOut{bias, partials, out}, grid,
                          unroll, static_cast<cudaStream_t>(stream));
}

int anr_stream_sum_busy(int dtype, const void* base, long long n,
                        long long tile_elems, int x_iters, const float* seed,
                        float* partials, float* work_out, float* out,
                        int grid, int unroll, void* stream) {
  if (n < 0 || tile_elems < 1 || x_iters < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = busy_dtype<kF32>(base, n, tile_elems, x_iters, grid, unroll,
                             partials, work_out, s);
      break;
    case kBF16:
      err = busy_dtype<kBF16>(base, n, tile_elems, x_iters, grid, unroll,
                              partials, work_out, s);
      break;
    case kI8:
      err = busy_dtype<kI8>(base, n, tile_elems, x_iters, grid, unroll,
                            partials, work_out, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(partials, grid, seed, out, s));
}

}  // extern "C"
