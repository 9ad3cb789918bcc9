// Device helpers shared by ConvMAE's kernels (fused_ln_mlp.cu, fused_front.cu
// through chained_gemm.cuh, fused_ln_mlp_bwd.cu, fused_mlp.cu,
// flash_attention.cu): conversions between the storage type T (float or
// __nv_bfloat16) and float32, the bf16 tensor-core product, the exact-erf
// GELU and the warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <cmath>

#include <type_traits>

namespace convmae {

constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the rounding point of a cast to the compute dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Exact-erf GELU in float32 (CUDA's erff, within 2 ulp), the plain version's
// F.gelu(approximate="none").  The TPU kernel used the A&S 7.1.26 erf
// (|err| 1.5e-7), which Mosaic needed for want of an erf lowering.
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulators.  Fragments:
// a = rows (gid, gid + 8) x k (2 tig, 2 tig + 8); b = k (2 tig, 2 tig + 8) x
// column gid; d = rows (gid, gid + 8) x columns (2 tig, 2 tig + 1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A[16 rows x K] . B[NT*8 rows x K]^T for one warp: A in shared
// memory (row stride lda, 16 rows from a), B in shared memory row-major with
// K contiguous (row stride ldb).  K is a multiple of 16, known at compile
// time, so the loop unrolls and the loads of later k-steps can be issued
// ahead of the products.
template <int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* pa = a + gid * lda + tig * 2;
  const __nv_bfloat16* pb = a + (gid + 8) * lda + tig * 2;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t af[4] = {ld32(pa + k0), ld32(pb + k0), ld32(pa + k0 + 8), ld32(pb + k0 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* bp = b + (nt * 8 + gid) * ldb + k0 + tig * 2;
      mma_16816(acc[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// Copy rows x cols of T (cols * sizeof(T) a multiple of 16, both pointers
// 16-byte aligned rows) from global (row stride gld) to shared (row stride
// sld) with 16-byte cp.async copies, all in flight at once; the caller waits
// with cp_async_wait_all() and a __syncthreads().
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int sld, const T* __restrict__ src,
                                                size_t gld, int rows, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int r = i / per_row, v = i - r * per_row;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * sld + v * VEC));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + r * gld + v * VEC));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

inline cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace convmae
