// Hopper building blocks shared by the kernels that stream rows through a
// TMA-fed mbarrier ring into wgmma (int4.cu: P7's folds; cluster_topk.cu:
// K2r, K1r, K1c): mbarriers, thread-block cluster barriers and remote
// arrivals, TMA boxes with .multicast::cluster, the 2-D tensor map over a
// matrix's rows, the 128-byte swizzled K-major layout and wgmma s8 and
// bf16 on it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "topk_common.cuh"

namespace {

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

// Byte offset of 4-byte word w (of 32) of row r in a [rows][CH] swizzled
// chunk.
__device__ __forceinline__ int word_at(int r, int w) {
  return swizzle(r, CH, 0, w / 4) + (w % 4) * 4;
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

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, bf16 x bf16 -> f32, both
// operands K-major in shared memory (16 bf16 = 32 bytes a k-step, the
// same descriptors and the same accumulator layout as wgmma_s8).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from touching the accumulators across wgmma.
__device__ __forceinline__ void pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 128 threads of warpgroup wg (named barrier 2 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// -- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// ``rows`` rows of ``row_bytes`` bytes, ``stride`` bytes apart from
// ``base``, as boxes of ``box_rows`` rows x CH bytes, 128-byte swizzle,
// zero fill past the last row and past the row.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base,
                               long long row_bytes, long long rows,
                               long long stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {CH, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch kern on grid x block with smem bytes of dynamic shared memory, in
// thread-block clusters of cl CTAs along x when cl > 0 (no cluster: 0).
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kern)(Params...), dim3 grid, int block,
                             int smem, int cl, cudaStream_t stream,
                             Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl > 0 ? cl : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of cl CTAs of ``block`` threads with smem bytes each that the
// card holds at once (a negative cudaError_t on failure).
template <typename... Params>
int max_active_clusters(void (*kern)(Params...), int block, int cl,
                        int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * 64, 1, 1);
  cfg.blockDim = dim3(block, 1, 1);
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

}  // namespace
