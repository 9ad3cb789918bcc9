// The chained-GEMM core of ConvMAE's conv-stage kernels (fused_ln_mlp.cu,
// fused_front.cu) for Hopper (sm_90a): two products chained through a
// block's shared memory, the weights streamed through a cp.async ring.
//
//   - a ring of S stages in shared memory, each stage one weight tile (or
//     one pair of tiles) copied with 16-byte cp.async, one commit group a
//     stage: the block waits for stage t with cp.async.wait_group<S - 2> and
//     a barrier, then issues stage t + S - 1 into the slot that stage t - 1
//     left, so S - 1 tiles are in flight while stage t is in the products;
//   - bf16 products on mma.sync m16n8k16 (f32 accumulators) with both
//     operands loaded by ldmatrix from padded shared rows (no bank
//     conflicts), the B operand a weight tile [N][K] with K contiguous, as
//     the model's conv weights [C_out][C_in] already are;
//   - float32 products as register tiles of FMAs on the CUDA cores (TF32
//     stays off), both operands read as float4 along K;
//   - the flax LayerNorm of a warp's rows with 8- or 16-byte loads, which
//     may be issued ahead of the rows' turn.
// The helpers of convmae_common.cuh keep their behaviour: this header only
// adds to them.
#pragma once

#include "convmae_common.cuh"

namespace chain {

using convmae::align16;
using convmae::from_f;
using convmae::gelu;
using convmae::round_to;
using convmae::to_f;
using convmae::warp_sum;

// ---- cp.async ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS elements of T (COLS * sizeof(T) a multiple of 16, rows 16-byte
// aligned) from global memory (row stride gld) to shared memory (row stride
// sld), spread over the block's NT threads; the caller commits.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void copy_tile(T* dst, int sld, const T* __restrict__ src, size_t gld,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T), PER = COLS / VEC, N = ROWS * PER;
  static_assert(COLS % VEC == 0, "rows of whole 16-byte copies");
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = tid + i * NT;
    if (N % NT == 0 || idx < N) {
      const int r = idx / PER, v = idx - r * PER;
      cp_async16(dst + r * sld + v * VEC, src + r * gld + v * VEC);
    }
  }
}

// Barrier of `threads` threads (whole warps) on hardware barrier `id` (1-15;
// 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- bf16 tensor-core products

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc[i][j] += A[16 i .. 16 i + 15][0, K) . B[8 j .. 8 j + 7][0, K)^T for one
// warp: A (MT*16 rows, row stride lda) and B (NT*8 rows, row stride ldb) in
// shared memory with K contiguous, rows 16-byte aligned; K a multiple of 16,
// NT even.  ldmatrix.x4 loads an A fragment (rows lane & 15, k (lane >> 4) * 8)
// and two n-tiles of B (rows (lane & 7) + (lane >> 4) * 8, k ((lane >> 3) & 1)
// * 8) an instruction.
template <int MT, int NT, int K>
__device__ __forceinline__ void warp_gemm_bf16(float (&acc)[MT][NT][4],
                                               const __nv_bfloat16* A, int lda,
                                               const __nv_bfloat16* B, int ldb, int lane) {
  static_assert(K % 16 == 0 && NT % 2 == 0, "whole k-steps, pairs of n-tiles");
  const __nv_bfloat16* pa = A + (lane & 15) * lda + ((lane >> 4) << 3);
  const __nv_bfloat16* pb = B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(a[i], pa + i * 16 * lda + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, pb + j * 8 * ldb + k0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        convmae::mma_16816(acc[i][j], a[i], b[0], b[1]);
        convmae::mma_16816(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// ---- float32 products on the CUDA cores

// acc[i][j] += sum_k A[i * RS][k] . B[j * CS][k] for one thread: its rows of A
// (from A, row stride lda) and of B (from B, row stride ldb) in shared
// memory, a float4 at every KS-th k below K (KS = 4: all of K, a multiple
// of 4; KS = 16: the thread's quarter of K, interleaved with three other
// lanes'); f32 sums in k order.
template <int TM, int TN, int K, int RS, int CS, int KS = 4>
__device__ __forceinline__ void thread_gemm_f32(float (&acc)[TM][TN], const float* A, int lda,
                                                const float* B, int ldb) {
  static_assert(K % KS == 0 && KS % 4 == 0, "float4 along K");
#pragma unroll 2
  for (int k = 0; k < K; k += KS) {
    float4 b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(B + j * CS * ldb + k);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + i * RS * lda + k);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a.w, b[j].w, fmaf(a.z, b[j].z, fmaf(a.y, b[j].y, fmaf(a.x, b[j].x, acc[i][j]))));
    }
  }
}

// ---- vectors of four

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// Two neighbouring values of T as floats, and back (rounded to T).
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x;
  b = t.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(t);
  b = __high2float(t);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Four neighbouring values of T as loaded (8 or 16 bytes), unpacked later.
template <typename T> struct Raw4;
template <> struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ void zero() { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ __forceinline__ void get(float (&o)[4]) const {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <> struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void get(float (&o)[4]) const {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    o[0] = __low2float(a);
    o[1] = __high2float(a);
    o[2] = __low2float(b);
    o[3] = __high2float(b);
  }
};

// A warp's share of R rows of C values of T, loaded ahead of their
// LayerNorm: each lane holds C/128 runs of 4 neighbouring values at
// 4 (lane + 32 i) of each row (a null row reads as zeros and is written as
// zeros).
template <typename T, int C, int R> struct Rows {
  static_assert(C % 128 == 0, "runs of 4 over whole warps");
  static constexpr int NQ = C / 128;
  Raw4<T> raw[R][NQ];
  bool null[R];

  __device__ __forceinline__ void load(const T* const (&src)[R], int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      null[r] = src[r] == nullptr;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (null[r]) {
          raw[r][i].zero();
        } else {
          raw[r][i].load(src[r] + 4 * (lane + 32 * i));
        }
      }
    }
  }

  // flax nn.LayerNorm of each row (float32 fast-variance statistics
  // E[x^2] - mean^2 clipped at 0, y = (x - mean) * (rsqrt(var + eps) *
  // scale) + shift, rounded to T), into dst[r] (null: not written).
  __device__ __forceinline__ void normalise(const float* __restrict__ ls,
                                            const float* __restrict__ lb, float eps,
                                            T* const (&dst)[R], int lane) const {
    float s[R], ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = 0.0f;
      ss[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        float v[4];
        raw[r][i].get(v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[r] += v[e];
          ss[r] += v[e] * v[e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = warp_sum(s[r]);
      ss[r] = warp_sum(ss[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (dst[r] == nullptr) continue;
      const float mean = s[r] / float(C);
      const float var = fmaxf(ss[r] / float(C) - mean * mean, 0.0f);
      const float rs = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int c = 4 * (lane + 32 * i);
        float v[4], o[4];
        raw[r][i].get(v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = null[r] ? 0.0f : (v[e] - mean) * (rs * ls[c + e]) + lb[c + e];
        store4(dst[r] + c, o);
      }
    }
  }
};

// Raise a kernel's dynamic shared-memory limit to `smem` once a device (the
// attribute call costs host time on every launch otherwise).
template <typename Kern>
cudaError_t set_smem_once(Kern kern, size_t smem, size_t (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= done[dev] || smem <= 48 * 1024) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess) done[dev] = smem;
  return e;
}

}  // namespace chain
