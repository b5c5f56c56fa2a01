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
//     32-bit word w = in[i] is negative as an i32, else w. On f32 bits
//     this is the sign-flip key: keys order as the floats do (-0.0 just
//     below +0.0), and the map is its own inverse, so the same kernel
//     takes keys back to the exact f32 bits.
//   anr_bf16_row_reduce: for each row r of x [R, W] (W <= 65536), with
//     s = bf16(x) (round to nearest even):
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
// element (2^24 elements: 0.04 ms at 3.35 TB/s); the row reduction reads
// each row once from device memory (its second pass hits L1/L2) and
// writes 16 bytes per row. Design: the keys are a grid-stride loop over
// 16-byte vectors (a scalar loop when either pointer is not 16-byte
// aligned); the row reduction gives one CTA to each row, each thread a
// strided share of its columns, and reduces across the CTA by warp
// shuffles and shared memory, twice (the second max needs the first).
//
// Plain C interface; each entry point returns the cudaError_t of its
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned flip(unsigned w) {
  return static_cast<int>(w) < 0 ? w ^ 0x7fffffffu : w;
}

__global__ void __launch_bounds__(kThreads)
    flip_vec_kernel(const uint4* in, uint4* out, long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint4 v = in[i];
    out[i] = make_uint4(flip(v.x), flip(v.y), flip(v.z), flip(v.w));
  }
}

__global__ void __launch_bounds__(kThreads)
    flip_kernel(const unsigned* in, unsigned* out, long long begin,
                long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = begin + blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = flip(in[i]);
  }
}

int launch_flip(const void* in, void* out, long long n, int grid,
                cudaStream_t stream) {
  if (n < 0 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 && n >= 4) {
    flip_vec_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n / 4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    done = n / 4 * 4;
  }
  if (done < n) {
    flip_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned*>(in), static_cast<unsigned*>(out), done,
        n);
  }
  return static_cast<int>(cudaGetLastError());
}

// (value, column) with the higher value, the lower column on a tie.
__device__ __forceinline__ void keep_best(float& v, int& c, float ov,
                                          int oc) {
  if (ov > v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    bf16_row_reduce_kernel(const float* x, int W, float* row_max, int* arg,
                           float* second, int* packed) {
  __shared__ float sv[kWarps];
  __shared__ int sc[kWarps];
  __shared__ int sp[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* row = x + static_cast<size_t>(blockIdx.x) * W;

  // Pass 1: the max with its lowest column, and the packed key's max.
  float v = -INFINITY;
  int c = W;
  int pm = INT_MIN;
  for (int col = threadIdx.x; col < W; col += kThreads) {
    const __nv_bfloat16 b = __float2bfloat16_rn(row[col]);
    keep_best(v, c, __bfloat162float(b), col);
    const int u = __bfloat16_as_ushort(b);
    const int key = (u >= 0x8000 ? 0xffff - u : u + 0x8000) - 0x8000;
    // key * 65536 is key << 16 on the i32 (no overflow after the bias).
    pm = max(pm, (key * 65536) | (W - 1 - col));
  }
  for (int off = 16; off > 0; off >>= 1) {
    keep_best(v, c, __shfl_xor_sync(kFull, v, off),
              __shfl_xor_sync(kFull, c, off));
    pm = max(pm, __shfl_xor_sync(kFull, pm, off));
  }
  if (lane == 0) {
    sv[warp] = v;
    sc[warp] = c;
    sp[warp] = pm;
  }
  __syncthreads();
  v = sv[0];
  c = sc[0];
  pm = sp[0];
  for (int w = 1; w < kWarps; ++w) {
    keep_best(v, c, sv[w], sc[w]);
    pm = max(pm, sp[w]);
  }
  __syncthreads();

  // Pass 2: the max once every column equal to it is masked.
  const float masked = bf16_round(-3e38f);
  float s2 = -INFINITY;
  for (int col = threadIdx.x; col < W; col += kThreads) {
    const float b = bf16_round(row[col]);
    s2 = fmaxf(s2, b == v ? masked : b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s2 = fmaxf(s2, __shfl_xor_sync(kFull, s2, off));
  }
  if (lane == 0) sv[warp] = s2;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) s2 = fmaxf(s2, sv[w]);
    row_max[blockIdx.x] = v;
    arg[blockIdx.x] = c;
    second[blockIdx.x] = s2;
    packed[blockIdx.x] = (W - 1) - (pm & 0xffff);
  }
}

}  // namespace

extern "C" {

int anr_xpack_keys(const float* x, int* keys, long long n, int grid,
                   void* stream) {
  return launch_flip(x, keys, n, grid, static_cast<cudaStream_t>(stream));
}

int anr_xpack_values(const int* keys, float* x, long long n, int grid,
                     void* stream) {
  return launch_flip(keys, x, n, grid, static_cast<cudaStream_t>(stream));
}

int anr_bf16_row_reduce(const float* x, int R, int W, float* row_max,
                        int* arg, float* second, int* packed, void* stream) {
  if (R < 1 || W < 1 || W > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bf16_row_reduce_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(
                                               stream)>>>(
      x, W, row_max, arg, second, packed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
