// Fused MBConv serving kernels for Hopper (sm_90a), plain C interface.
//
// Replace the JAX package's Pallas TPU kernels
//   multimodal_isic_tpu/ops/fused_dwconv.py::expand_dw_silu_pool (_exp_dw_kernel)
//   multimodal_isic_tpu/ops/fused_dwconv.py::dw_silu_pool        (_dw_kernel)
// Each computes, for one stride-1 MBConv block of the BN-folded serving
// forward:
//   [mid = round_to_T(silu(x . we + be))]       (expand variant only)
//   y    = silu(depthwise_KxK_SAME(mid) + bd)    stored in T
//   pool = mean over H, W of the f32 y before its cast (the SE squeeze)
// in one pass: the expand output never reaches device memory, and y is not
// read again for the pool.
//
// Numerics follow _dw_tile (fused_dwconv.py:150-177): taps multiply in f32 on
// values read in T; bias, silu and accumulation are f32; y is cast to T; the
// pool sums the f32 post-silu values times 1/(H*W).  The expand product
// accumulates in f32, gets + be and silu, and is rounded to T
// before the depthwise (fused_dwconv.py:235-245).
//
// What bounds it on the card.  Blocks 0-1 of B3@380 (190^2, C = 40 and 24,
// no expand) are bandwidth-bound: 9 FMAs per element read and written.  The
// deep 12^2 blocks (Cin up to 384, Cmid up to 2304) are dominated by the
// expand, Cin multiply-adds per mid element: far too many for the CUDA cores,
// so the bf16 expand runs on the tensor cores.
//
// Design.  One block per (image, tile of T output rows, chunk of CC = 32
// channels); 256 threads = 8 warps, lane = channel, so every global store of
// y and every weight load is 32 consecutive channels.
//   phase 1: fill shared memory with the tile's input rows plus the K/2-row
//            halo, [T+2p][W+2p][CC] in T.  Positions outside the image are
//            exact zeros, written AFTER expand + silu: the unfused graph pads
//            the expand output, and silu(0 . we + be) = silu(be) is not 0
//            (the halo trap, fused_dwconv.py:231-245).
//            dw variant: a 16-byte cp.async per (pixel, 8 or 4 channels), all
//            in flight at once, since these blocks are bandwidth-bound.
//            expand variant: the weight chunk sits in shared memory and only
//            in-image positions are computed.  bf16 runs on the tensor cores
//            (mma.sync m16n8k16, f32 accumulators: bf16 products are exact
//            in f32, so the numerics are those of an f32 sum); f32 runs an
//            FMA loop on the CUDA cores, NPIX positions per warp, x read 16
//            bytes at a time with warp-wide broadcast loads.
//   phase 2: each warp walks output pixels, K*K taps from shared memory with
//            the lane's weights in registers, bias, silu, store y, and keeps a
//            per-thread sum of the f32 activations.
//   pool:    blocks run in no order, so there is no scratch carry as on the
//            TPU; the 8 warp sums are reduced in shared memory and added with
//            one atomicAdd per channel into the f32 [B, C] pool, which the
//            caller zeroes.  The atomics make the order of the sum vary from
//            run to run (a few f32 ulps).
// T is the largest row tile whose shared memory fits SMEM_BUDGET (two blocks
// per SM), balanced over the tiles.  The caller guarantees channel counts that
// are multiples of 8 and 16-byte aligned rows (every EfficientNet width is).
// Left for later work: wgmma with TMA-fed tiles for the expand, a
// sliding-window depthwise, and the f32 expand on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CC = 32;                   // channels per block, one per lane
constexpr int NWARPS = 8;
constexpr int NTHREADS = CC * NWARPS;
constexpr int NPIX = 8;                  // expand pixels per warp step
constexpr size_t SMEM_BUDGET = 100 * 1024;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes (4 floats) at p, 16-byte aligned.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Shared memory for the expand weight chunk, k contiguous per channel:
// bf16 [CC][KPAD + 8] (Cin padded to 16 with zeros) for mma, whose 8-element
// row pad makes the B-fragment loads bank-conflict free; f32 [CC][Cin + 1]
// for the FMA loop (odd row stride: conflict-free across lanes).
template <typename T> __host__ __device__ constexpr size_t weight_bytes(int Cin) {
  return std::is_same_v<T, __nv_bfloat16>
             ? align16(size_t(CC) * (((Cin + 15) & ~15) + 8) * sizeof(__nv_bfloat16))
             : align16(size_t(CC) * (Cin + 1) * sizeof(float));
}

// Biases arrive in f32 or bf16 (the model's bf16 parameters, read as they are).
__device__ __forceinline__ float load_bias(const void* p, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 expand on the tensor cores: mid[q][n] = silu(sum_k x[q][k] we[n][k] + be[n])
// for the n_valid in-image positions q and the CC channels n of the chunk.
// Each warp takes m-tiles of 16 positions x 32 channels (4 mma n-tiles) and
// walks k in steps of 16 with mma.sync m16n8k16; A fragments come straight
// from global memory (32-bit loads, L1-cached), B fragments from shared memory.
// Products of bf16 are exact in f32 and the sum is f32, in the tensor core's
// order.  The caller zeroes mid and syncs afterwards.
template <typename Pix, typename Store>
__device__ __forceinline__ void expand_mma(unsigned char* we_raw,
                                           const __nv_bfloat16* __restrict__ we,
                                           const void* be, bool bias_bf16, Pix pix,
                                           Store store, int n_valid, int Cin, int C, int c0,
                                           int warp, int lane) {
  __nv_bfloat16* we_t = reinterpret_cast<__nv_bfloat16*>(we_raw);
  const int kpad = (Cin + 15) & ~15;
  const int S = kpad + 8;
  for (int i = threadIdx.x; i < kpad * CC; i += NTHREADS) {
    const int n = i / kpad, k = i - n * kpad;
    we_t[n * S + k] =
        (k < Cin && c0 + n < C) ? we[size_t(c0 + n) * Cin + k] : __float2bfloat16(0.0f);
  }
  __syncthreads();
  const int gid = lane >> 2, tig = lane & 3;
  float be_r[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = c0 + nt * 8 + tig * 2 + e;
      be_r[nt][e] = n < C ? load_bias(be, n, bias_bf16) : 0.0f;
    }
  const int n_mt = (n_valid + 15) / 16;
  for (int mt = warp; mt < n_mt; mt += NWARPS) {
    const int qa = mt * 16 + gid, qb = qa + 8;
    const __nv_bfloat16* pa = pix(min(qa, n_valid - 1));
    const __nv_bfloat16* pb = pix(min(qb, n_valid - 1));
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    for (int k0 = 0; k0 < Cin; k0 += 16) {
      const int ka = k0 + tig * 2;
      const bool hi = k0 + 8 < Cin;  // Cin % 16 == 8: the last step has 8
      const uint32_t a[4] = {ld32(pa + ka), ld32(pb + ka), hi ? ld32(pa + ka + 8) : 0u,
                             hi ? ld32(pb + ka + 8) : 0u};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* bp = we_t + (nt * 8 + gid) * S + ka;
        mma_16816(acc[nt], a, ld32(bp), ld32(bp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = e < 2 ? qa : qb;
        if (q < n_valid) store(q, nt * 8 + tig * 2 + (e & 1), silu(acc[nt][e] + be_r[nt][e & 1]));
      }
  }
}

// f32 expand on the CUDA cores: each warp register-tiles NPIX positions x one
// channel per lane, reads x 16 bytes at a time with warp-wide broadcast loads
// and does NPIX FMAs per weight load; the sum runs in Cin order.
template <typename Pix, typename Store>
__device__ __forceinline__ void expand_fma(float* we_s, const float* __restrict__ we,
                                           const void* be, bool bias_bf16, Pix pix,
                                           Store store, int n_valid, int Cin, int C, int c0,
                                           int warp, int lane) {
  const int S = Cin + 1;
  for (int i = threadIdx.x; i < Cin * CC; i += NTHREADS) {
    const int n = i / Cin, k = i - n * Cin;
    we_s[n * S + k] = c0 + n < C ? we[size_t(c0 + n) * Cin + k] : 0.0f;
  }
  __syncthreads();
  const float* w_lane = we_s + lane * S;
  const float be_c = c0 + lane < C ? load_bias(be, c0 + lane, bias_bf16) : 0.0f;
  for (int q0 = warp * NPIX; q0 < n_valid; q0 += NWARPS * NPIX) {
    const float* px[NPIX];
    float acc[NPIX];
#pragma unroll
    for (int j = 0; j < NPIX; ++j) {
      px[j] = pix(min(q0 + j, n_valid - 1));
      acc[j] = 0.0f;
    }
    for (int ci = 0; ci < Cin; ci += 4) {
      float xv[NPIX][4];
#pragma unroll
      for (int j = 0; j < NPIX; ++j) load16(px[j] + ci, xv[j]);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float w = w_lane[ci + v];
#pragma unroll
        for (int j = 0; j < NPIX; ++j) acc[j] = fmaf(xv[j][v], w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NPIX; ++j)
      if (q0 + j < n_valid) store(q0 + j, lane, silu(acc[j] + be_c));
  }
}

template <typename T, int K, bool EXPAND>
__global__ void __launch_bounds__(NTHREADS)
mbconv_dw_kernel(const T* __restrict__ x,       // [B, H, W, Cin]
                 const T* __restrict__ we,      // [C, Cin]   (EXPAND only)
                 const void* be,                // [C] f32 or bf16 (EXPAND only)
                 const T* __restrict__ wd,      // [C, K*K]
                 const void* bd,                // [C] f32 or bf16
                 T* __restrict__ y,             // [B, H, W, C]
                 float* __restrict__ pool,      // [B, C], zeroed by the caller
                 int H, int W, int Cin, int C, int tile_rows, float inv_hw,
                 bool bias_bf16) {
  constexpr int P = (K - 1) / 2;
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = W + 2 * P;
  const int rows = tile_rows + 2 * P;
  const size_t mid_bytes = align16(size_t(rows) * cols * CC * sizeof(T));
  const size_t we_bytes = EXPAND ? weight_bytes<T>(Cin) : 0;
  T* mid = reinterpret_cast<T*>(smem);                                 // [rows][cols][CC]
  unsigned char* we_raw = smem + mid_bytes;                            // expand weights
  float* red = reinterpret_cast<float*>(smem + mid_bytes + we_bytes);  // [NWARPS][CC]

  const int lane = threadIdx.x % CC;
  const int warp = threadIdx.x / CC;
  const int r0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * CC;
  const int b = blockIdx.z;
  const int c = c0 + lane;
  const bool c_ok = c < C;
  const int nc = min(CC, C - c0);        // channels of this chunk, a multiple of VEC
  const T* xb = x + size_t(b) * H * W * Cin;
  // in-image rows of the tile plus halo: [v0, v1)
  const int v0 = max(r0 - P, 0);
  const int v1 = min(r0 + tile_rows + P, H);
  const int n_valid = (v1 - v0) * W;
  auto mid_at = [&](int gr, int gc) { return ((gr - r0 + P) * cols + gc + P) * CC; };

  // ---- phase 1: shared memory <- input rows [r0 - P, r0 + tile_rows + P)
  if constexpr (EXPAND) {
    uint4* mid4 = reinterpret_cast<uint4*>(mid);
    for (int i = threadIdx.x; i < int(mid_bytes / 16); i += NTHREADS)
      mid4[i] = make_uint4(0, 0, 0, 0);
    const auto pix = [&](int q) {  // q-th in-image position of the tile + halo
      return xb + (size_t(v0 + q / W) * W + q % W) * Cin;
    };
    const auto store_mid = [&](int q, int n, float v) {
      mid[mid_at(v0 + q / W, q % W) + n] = from_f<T>(v);
    };
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      expand_mma(we_raw, we, be, bias_bf16, pix, store_mid, n_valid, Cin, C, c0, warp, lane);
    } else {
      expand_fma(reinterpret_cast<float*>(we_raw), we, be, bias_bf16, pix, store_mid,
                 n_valid, Cin, C, c0, warp, lane);
    }
  } else {
    // one 16-byte item = VEC channels of one position; halo items are zeros
    const int per_pos = nc / VEC;
    const int n_items = rows * cols * per_pos;
    for (int i = threadIdx.x; i < n_items; i += NTHREADS) {
      const int pos = i / per_pos, v = i - pos * per_pos;
      const int r = pos / cols;
      const int gr = r0 - P + r, gc = pos - r * cols - P;
      T* dst = mid + pos * CC + v * VEC;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        cp_async16(dst, xb + (size_t(gr) * W + gc) * Cin + c0 + v * VEC);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }
  __syncthreads();

  // ---- phase 2: depthwise + bias + silu, y store, per-thread pool sum
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = c_ok ? to_f(wd[size_t(c) * K * K + t]) : 0.0f;
  const float bd_c = c_ok ? load_bias(bd, c, bias_bf16) : 0.0f;
  const int out_rows = min(tile_rows, H - r0);
  float psum = 0.0f;
  if (c_ok) {
    for (int o = warp; o < out_rows * W; o += NWARPS) {
      const int i = o / W;
      const int j = o - i * W;
      float acc = 0.0f;
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          acc = fmaf(to_f(mid[((i + ky) * cols + j + kx) * CC + lane]), wk[ky * K + kx], acc);
      const float a = silu(acc + bd_c);
      y[((size_t(b) * H + r0 + i) * W + j) * C + c] = from_f<T>(a);
      psum += a;
    }
  }
  red[warp * CC + lane] = psum;
  __syncthreads();
  if (warp == 0 && c_ok) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * CC + lane];
    atomicAdd(pool + size_t(b) * C + c, s * inv_hw);
  }
}

template <typename T, int K, bool EXPAND>
cudaError_t launch(const void* x, const void* we, const void* be, const void* wd,
                   const void* bd, void* y, void* pool, int B, int H, int W, int Cin,
                   int C, bool bias_bf16, cudaStream_t stream) {
  constexpr int P = (K - 1) / 2;
  constexpr int VEC = 16 / sizeof(T);
  if (Cin % VEC != 0 || C % VEC != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t row_bytes = size_t(W + 2 * P) * CC * sizeof(T);
  const size_t fixed = (EXPAND ? weight_bytes<T>(Cin) : 0) +
                       NWARPS * CC * sizeof(float);
  if (fixed + (1 + 2 * P) * row_bytes > SMEM_BUDGET) return cudaErrorInvalidValue;
  int tile = int((SMEM_BUDGET - fixed) / row_bytes) - 2 * P;
  if (tile > H) tile = H;
  const int n_tiles = (H + tile - 1) / tile;
  tile = (H + n_tiles - 1) / n_tiles;  // same tile count, least halo recompute
  const size_t smem = align16((tile + 2 * P) * row_bytes) + fixed;
  auto kern = mbconv_dw_kernel<T, K, EXPAND>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_tiles, (C + CC - 1) / CC, B);
  mbconv_dw_kernel<T, K, EXPAND><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), be, static_cast<const T*>(wd), bd,
      static_cast<T*>(y), static_cast<float*>(pool), H, W, Cin, C, tile, 1.0f / float(H * W),
      bias_bf16);
  return cudaGetLastError();
}

template <typename T, bool EXPAND>
int dispatch(int K, const void* x, const void* we, const void* be, const void* wd,
             const void* bd, void* y, void* pool, int B, int H, int W, int Cin, int C,
             int bias_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bias_bf16 != 0;
  switch (K) {
    case 3: return launch<T, 3, EXPAND>(x, we, be, wd, bd, y, pool, B, H, W, Cin, C, bf, s);
    case 5: return launch<T, 5, EXPAND>(x, we, be, wd, bd, y, pool, B, H, W, Cin, C, bf, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// Weights in PyTorch's conv layouts: we [C, Cin], wd [C, K*K], in T; biases
// f32, or bf16 when bias_bf16 != 0.
int dw_silu_pool_f32(const void* x, const void* wd, const void* bd, void* y, void* pool,
                     int B, int H, int W, int C, int K, int bias_bf16, void* stream) {
  return dispatch<float, false>(K, x, nullptr, nullptr, wd, bd, y, pool, B, H, W, C, C,
                                bias_bf16, stream);
}

int dw_silu_pool_bf16(const void* x, const void* wd, const void* bd, void* y, void* pool,
                      int B, int H, int W, int C, int K, int bias_bf16, void* stream) {
  return dispatch<__nv_bfloat16, false>(K, x, nullptr, nullptr, wd, bd, y, pool, B, H, W, C,
                                        C, bias_bf16, stream);
}

int expand_dw_silu_pool_f32(const void* x, const void* we, const void* be, const void* wd,
                            const void* bd, void* y, void* pool, int B, int H, int W,
                            int Cin, int C, int K, int bias_bf16, void* stream) {
  return dispatch<float, true>(K, x, we, be, wd, bd, y, pool, B, H, W, Cin, C, bias_bf16,
                               stream);
}

int expand_dw_silu_pool_bf16(const void* x, const void* we, const void* be, const void* wd,
                             const void* bd, void* y, void* pool, int B, int H, int W,
                             int Cin, int C, int K, int bias_bf16, void* stream) {
  return dispatch<__nv_bfloat16, true>(K, x, we, be, wd, bd, y, pool, B, H, W, Cin, C,
                                       bias_bf16, stream);
}

const char* fused_dwconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
