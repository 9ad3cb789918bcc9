// Fused 1x1 C->F -> GELU -> 1x1 F->C2 MLP over rows for Hopper (sm_90a),
// plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/fused_mlp.py::fused_mlp (_mlp_kernel)
// over rows x [M, C] (T = float or bf16; the biases arrive as float32):
//   h   = round_T(x . w1 + b1)                f32 accumulation
//   a   = round_T(gelu(h))                    exact erf (erff), f32
//   out = round_T(a . w2 + b2)                f32 accumulation
// C, F and C2 are multiples of 128 and C2 may differ from C.  The [M, F]
// intermediate never reaches device memory.  The TPU kernel took the A&S
// 7.1.26 erf (|err| 1.5e-7) for want of a Mosaic erf lowering.
//
// What bounds it on the card: operations.  ConvViT-Base's conv stages
// (C 256 -> F 1024 -> C2 256 at M = B*56^2, C 384 -> 1536 -> 384 at M =
// B*28^2) do 4 M C F multiply-adds against ~2 M C + 2 C F values moved:
// far above the ridge.  bf16 runs on the tensor cores; float32 on the CUDA
// cores (TF32 stays off: the reference is full float32).
//
// Design: fused_ln_mlp.cu's F-chunk walk without the LayerNorm and the
// residual, for any C and C2.  One block of 256 threads (8 warps) per BM rows
// (64 in bf16, 32 in f32) copies its x rows into shared memory once, then
// walks F in chunks of FC = 32: w1[f0:f0+FC, :] and w2[:, f0:f0+FC] staged
// in shared memory (16-byte cp.async copies), h = x . w1_chunk^T (+ b1,
// round, GELU, round) into a [BM][FC] shared tile, out += a_tile .
// w2_chunk^T into the block's [BM][C2] accumulator, which stays in registers
// for the whole of F.  The epilogue adds b2, rounds and stores.  The
// accumulator's width is a template argument (C2 in 128, 256, 384, 512:
// registers bound it); C is a loop bound, and shared memory bounds it:
// (BM + FC)(C + PAD) + C2 (FC + PAD) + BM (FC + PAD) elements of T must fit
// one block (ops/fused_mlp.py::fused_mlp_smem_bytes, checked there).
// bf16 products run on mma.sync m16n8k16 with f32 accumulators; float32 runs
// register-tiled FMA loops.  Shared rows are padded (bf16 by 8, f32 by 4
// elements) so fragment loads are bank-conflict free.  As in the LN-MLP,
// every row block reads both weight matrices from L2, and each chunk is
// waited for before its products: double-buffered TMA chunks, wgmma and
// larger row blocks are left for later work.

#include "convmae_common.cuh"

namespace {

using namespace convmae;

constexpr int FC = 32;  // F chunk

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int BM = 64, PAD = 8; };
template <> struct Tile<float> { static constexpr int BM = 32, PAD = 4; };

template <typename T> struct Smem {
  static constexpr int BM = Tile<T>::BM, PAD = Tile<T>::PAD;
  static constexpr int LDW2 = FC + PAD, LDA = FC + PAD;
  int ldx;         // x tile and w1 chunk row stride: C + PAD
  size_t x, w1, w2, a;
  __host__ __device__ Smem(int C, int C2)
      : ldx(C + PAD),
        x(align16(size_t(BM) * (C + PAD) * sizeof(T))),
        w1(align16(size_t(FC) * (C + PAD) * sizeof(T))),
        w2(align16(size_t(C2) * LDW2 * sizeof(T))),
        a(align16(size_t(BM) * LDA * sizeof(T))) {}
  __host__ __device__ size_t total() const { return x + w1 + w2 + a; }
};

// acc[nt] += A[16 rows x K] . B[NT*8 rows x K]^T for one warp, A and B in
// shared memory with K contiguous; K (a multiple of 16) known only at run
// time.
template <int NT>
__device__ __forceinline__ void warp_mma_k(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* b, int ldb, int K, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* pa = a + gid * lda + tig * 2;
  const __nv_bfloat16* pb = a + (gid + 8) * lda + tig * 2;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t af[4] = {ld32(pa + k0), ld32(pb + k0), ld32(pa + k0 + 8), ld32(pb + k0 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* bp = b + (nt * 8 + gid) * ldb + k0 + tig * 2;
      mma_16816(acc[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

template <typename T, int C2>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_kernel(const T* __restrict__ x,      // [M, C]
                 const T* __restrict__ w1,     // [F, C]
                 const float* __restrict__ b1, // [F]
                 const T* __restrict__ w2,     // [C2, F]
                 const float* __restrict__ b2, // [C2]
                 T* __restrict__ out,          // [M, C2]
                 int M, int C, int F) {
  using S = Smem<T>;
  constexpr int BM = S::BM;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  const S sm(C, C2);
  const int ldx = sm.ldx;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* w1s = reinterpret_cast<T*>(smem + sm.x);
  T* w2s = reinterpret_cast<T*>(smem + sm.x + sm.w1);
  T* as = reinterpret_cast<T*>(smem + sm.x + sm.w1 + sm.w2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, M - r0);

  // ---- the block's x rows into xs (rows past M are zeros)
  copy_tile_async(xs, ldx, x + size_t(r0) * C, C, rows, C);
  for (int i = threadIdx.x; i < (BM - rows) * C; i += NTHREADS)
    xs[(rows + i / C) * ldx + i % C] = from_f<T>(0.0f);

  // output accumulator: bf16, warp = (16-row m-tile, half of the columns);
  // f32, thread = rows warp + 8 i x columns lane + 32 j
  constexpr int NT = C2 / 16;          // bf16: n-tiles of 8 in half of C2
  constexpr int RI = BM / NWARPS;      // f32: rows per thread (4)
  constexpr int CJ = C2 / 32;          // f32: columns per thread
  float acc[BF16 ? NT : RI][BF16 ? 4 : CJ];
#pragma unroll
  for (int i = 0; i < (BF16 ? NT : RI); ++i)
#pragma unroll
    for (int j = 0; j < (BF16 ? 4 : CJ); ++j) acc[i][j] = 0.0f;
  const int mt = warp & 3, nh = warp >> 2;  // bf16 warp tiles

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // the previous chunk's reads are done
    copy_tile_async(w1s, ldx, w1 + size_t(f0) * C, C, FC, C);
    copy_tile_async(w2s, S::LDW2, w2 + f0, F, C2, FC);
    cp_async_wait_all();  // the first time, the x tile too
    __syncthreads();

    // ---- h = x . w1_chunk^T + b1 -> round -> gelu -> round -> as
    if constexpr (BF16) {
      float h[2][4] = {};
      warp_mma_k<2>(h, xs + mt * 16 * ldx, ldx, w1s + nh * 16 * ldx, ldx, C, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + gid + (e >> 1) * 8;
          const int col = nh * 16 + nt * 8 + tig * 2 + (e & 1);
          const float v = round_to<T>(h[nt][e] + b1[f0 + col]);
          as[row * S::LDA + col] = from_f<T>(gelu(v));
        }
    } else {
      float h[RI] = {};
      const float* wr = reinterpret_cast<const float*>(w1s) + lane * ldx;
      const float* xf = reinterpret_cast<const float*>(xs);
#pragma unroll 4
      for (int k = 0; k < C; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 y = *reinterpret_cast<const float4*>(xf + (warp + NWARPS * i) * ldx + k);
          h[i] = fmaf(y.x, w.x, fmaf(y.y, w.y, fmaf(y.z, w.z, fmaf(y.w, w.w, h[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
        as[(warp + NWARPS * i) * S::LDA + lane] = from_f<T>(gelu(h[i] + b1[f0 + lane]));
    }
    __syncthreads();

    // ---- out += a_chunk . w2_chunk^T
    if constexpr (BF16) {
      warp_mma<NT, FC>(acc, as + mt * 16 * S::LDA, S::LDA, w2s + nh * (C2 / 2) * S::LDW2,
                              S::LDW2, lane);
    } else {
      const float* af = reinterpret_cast<const float*>(as);
      const float* wf = reinterpret_cast<const float*>(w2s);
#pragma unroll
      for (int k = 0; k < FC; k += 4) {
        float4 a[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          a[i] = *reinterpret_cast<const float4*>(af + (warp + NWARPS * i) * S::LDA + k);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(wf + (lane + 32 * j) * S::LDW2 + k);
#pragma unroll
          for (int i = 0; i < RI; ++i)
            acc[i][j] = fmaf(a[i].x, w.x,
                             fmaf(a[i].y, w.y, fmaf(a[i].z, w.z, fmaf(a[i].w, w.w, acc[i][j]))));
        }
      }
    }
  }

  // ---- epilogue: + b2, round, store
  if constexpr (BF16) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + mt * 16 + gid + hf * 8;
        const int col = nh * (C2 / 2) + nt * 8 + tig * 2;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(row) * C2 + col) =
            __floats2bfloat162_rn(acc[nt][hf * 2] + b2[col], acc[nt][hf * 2 + 1] + b2[col + 1]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = r0 + warp + NWARPS * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = lane + 32 * j;
        out[size_t(row) * C2 + col] = from_f<T>(acc[i][j] + b2[col]);
      }
    }
  }
}

template <typename T, int C2>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* out, int M, int C, int F, cudaStream_t stream) {
  const size_t smem = Smem<T>(C, C2).total();
  auto kern = fused_mlp_kernel<T, C2>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + Smem<T>::BM - 1) / Smem<T>::BM);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w1), b1,
                                         static_cast<const T*>(w2), b2, static_cast<T*>(out), M,
                                         C, F);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
             void* out, int M, int C, int F, int C2, void* stream) {
  if (M <= 0 || C <= 0 || C % 128 || F <= 0 || F % 128) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  switch (C2) {
    case 128: return launch<T, 128>(x, w1, fb1, w2, fb2, out, M, C, F, s);
    case 256: return launch<T, 256>(x, w1, fb1, w2, fb2, out, M, C, F, s);
    case 384: return launch<T, 384>(x, w1, fb1, w2, fb2, out, M, C, F, s);
    case 512: return launch<T, 512>(x, w1, fb1, w2, fb2, out, M, C, F, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one block at C, C2 (bf16 = 1: bfloat16).
long long fused_mlp_smem(int C, int C2, int bf16) {
  return static_cast<long long>(bf16 ? Smem<__nv_bfloat16>(C, C2).total()
                                     : Smem<float>(C, C2).total());
}

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// x [M, C], w1 [F, C], w2 [C2, F] and out [M, C2] in T, b1 [F] and b2 [C2]
// float32, all contiguous and 16-byte aligned.
int fused_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                  void* out, int M, int C, int F, int C2, void* stream) {
  return dispatch<float>(x, w1, b1, w2, b2, out, M, C, F, C2, stream);
}

int fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int M, int C, int F, int C2, void* stream) {
  return dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, C, F, C2, stream);
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
