// Fused LayerNorm -> 1x1 C->F -> GELU -> 1x1 F->C -> residual for Hopper
// (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/fused_mlp.py::fused_ln_mlp (_ln_mlp_kernel), forward
// the second half of ConvMAE's ConvBlock over rows x [M, C]:
//   y   = round_T(LN(x))                      f32 fast-variance stats, eps
//   h   = round_T(y . w1 + b1)                f32 accumulation
//   a   = round_T(gelu(h))                    exact erf, f32
//   out = x + round_T(a . w2 + b2)            residual added in T
// T is float or bf16; the biases and LN scale/shift arrive as float32 values.
// The [M, F] intermediate never reaches device memory.
//
// What bounds it on the card.  Latent extraction, bs 128 bf16: stage 1
// M = 128*56^2 rows, C 256, F 1024 (421 GFLOP against 0.41 GB moved) and
// stage 2 M = 128*28^2, C 384, F 1536: both far above the ~295 FLOP/byte
// ridge, so the bf16 tensor cores bound them.  The float32 validation
// forward runs the same products on the CUDA cores (TF32 stays off: the
// reference is full float32).
//
// Design.  One block of 256 threads (8 warps) per BM rows (64 in bf16, 32 in
// f32).  The block normalises its rows into shared memory once (a warp per
// row, the row's values in registers), then walks F in chunks of FC = 32:
//   stage w1[f0:f0+FC, :] and w2[:, f0:f0+FC] in shared memory (16-byte
//   cp.async copies, all in flight at once), h = y . w1_chunk^T (+ b1,
//   round, GELU, round) into a [BM][FC] shared tile, then out += a_tile . w2_chunk^T into the block's [BM][C]
//   accumulator, which stays in registers for the whole of F.  The epilogue
//   adds b2, rounds, adds the residual read from x and stores.
// bf16 products run on mma.sync m16n8k16 with f32 accumulators (products of
// bf16 values are exact in f32, so these are f32 sums in the tensor core's
// order); float32 runs register-tiled FMA loops.  Shared rows are padded
// (bf16 by 8, f32 by 4 elements) so fragment loads are bank-conflict free.
// Measured on the card, the pace is set by the weights, not the tensor
// cores: every 64-row block reads both matrices from L2 (1 MB at stage 1,
// 6.3 GB over a bs 128 call) and waits for each chunk before its products.
// Left for later work: double-buffered TMA weight chunks, wgmma, and larger
// row blocks with the accumulator split across warpgroups.

#include "convmae_common.cuh"

namespace {

using namespace convmae;

constexpr int FC = 32;  // F chunk

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int BM = 64, PAD = 8; };
template <> struct Tile<float> { static constexpr int BM = 32, PAD = 4; };

template <typename T, int C> struct Smem {
  static constexpr int BM = Tile<T>::BM, PAD = Tile<T>::PAD;
  static constexpr int LDY = C + PAD, LDW1 = C + PAD, LDW2 = FC + PAD, LDA = FC + PAD;
  static constexpr size_t Y = align16(size_t(BM) * LDY * sizeof(T));
  static constexpr size_t W1 = align16(size_t(FC) * LDW1 * sizeof(T));
  static constexpr size_t W2 = align16(size_t(C) * LDW2 * sizeof(T));
  static constexpr size_t A = align16(size_t(BM) * LDA * sizeof(T));
  static constexpr size_t TOTAL = Y + W1 + W2 + A;
};

template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
fused_ln_mlp_kernel(const T* __restrict__ x,      // [M, C]
                    const float* __restrict__ ls,  // [C]
                    const float* __restrict__ lb,  // [C]
                    const T* __restrict__ w1,      // [F, C]
                    const float* __restrict__ b1,  // [F]
                    const T* __restrict__ w2,      // [C, F]
                    const float* __restrict__ b2,  // [C]
                    T* __restrict__ out,           // [M, C]
                    int M, int F, float eps) {
  using S = Smem<T, C>;
  constexpr int BM = S::BM;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  T* w1s = reinterpret_cast<T*>(smem + S::Y);
  T* w2s = reinterpret_cast<T*>(smem + S::Y + S::W1);
  T* as = reinterpret_cast<T*>(smem + S::Y + S::W1 + S::W2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BM;

  // ---- LayerNorm of the block's rows into ys (rows past M are zeros)
  for (int r = warp; r < BM; r += NWARPS) {
    if (r0 + r < M) {
      ln_row<T, C>(x + size_t(r0 + r) * C, ls, lb, eps, ys + r * S::LDY, lane);
    } else {
      for (int c = lane; c < C; c += 32) ys[r * S::LDY + c] = from_f<T>(0.0f);
    }
  }

  // output accumulator: bf16, warp = (16-row m-tile, half of the columns);
  // f32, thread = rows warp + 8 i x columns lane + 32 j
  constexpr int NT = C / 16;           // bf16: n-tiles of 8 in half of C
  constexpr int RI = BM / NWARPS;      // f32: rows per thread (4)
  constexpr int CJ = C / 32;           // f32: columns per thread
  float acc[BF16 ? NT : RI][BF16 ? 4 : CJ];
#pragma unroll
  for (int i = 0; i < (BF16 ? NT : RI); ++i)
#pragma unroll
    for (int j = 0; j < (BF16 ? 4 : CJ); ++j) acc[i][j] = 0.0f;
  const int mt = warp & 3, nh = warp >> 2;  // bf16 warp tiles

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // ys written; the previous chunk's reads are done
    copy_tile_async(w1s, S::LDW1, w1 + size_t(f0) * C, C, FC, C);
    copy_tile_async(w2s, S::LDW2, w2 + f0, F, C, FC);
    cp_async_wait_all();
    __syncthreads();

    // ---- h = y . w1_chunk^T + b1 -> round -> gelu -> round -> as
    if constexpr (BF16) {
      float h[2][4] = {};
      warp_mma<2, C, false>(h, ys + mt * 16 * S::LDY, S::LDY, w1s + nh * 16 * S::LDW1, S::LDW1,
                            lane);
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
      const float* wr = reinterpret_cast<const float*>(w1s) + lane * S::LDW1;
      for (int k = 0; k < C; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 y =
              *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(ys) +
                                               (warp + NWARPS * i) * S::LDY + k);
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
      warp_mma<NT, FC, false>(acc, as + mt * 16 * S::LDA, S::LDA, w2s + nh * (C / 2) * S::LDW2,
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

  // ---- epilogue: + b2, round, + residual in T, store
  if constexpr (BF16) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + mt * 16 + gid + hf * 8;
        const int col = nh * (C / 2) + nt * 8 + tig * 2;
        if (row >= M) continue;
        const size_t o = size_t(row) * C + col;
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + o);
        const float v0 = round_to<T>(acc[nt][hf * 2] + b2[col]);
        const float v1 = round_to<T>(acc[nt][hf * 2 + 1] + b2[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
            __bfloat162float(xr.x) + v0, __bfloat162float(xr.y) + v1);
      }
  } else {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = r0 + warp + NWARPS * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = lane + 32 * j;
        const size_t o = size_t(row) * C + col;
        out[o] = from_f<T>(to_f(x[o]) + (acc[i][j] + b2[col]));
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const float* ls, const float* lb, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, int M, int F,
                   float eps, cudaStream_t stream) {
  using S = Smem<T, C>;
  auto kern = fused_ln_mlp_kernel<T, C>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), S::TOTAL);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + S::BM - 1) / S::BM);
  kern<<<grid, NTHREADS, S::TOTAL, stream>>>(
      static_cast<const T*>(x), ls, lb, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), M, F, eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* ls, const void* lb, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int M, int C, int F, float eps,
             void* stream) {
  if (F <= 0 || F % FC != 0 || M <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  switch (C) {
    case 256: return launch<T, 256>(x, f(ls), f(lb), w1, f(b1), w2, f(b2), out, M, F, eps, s);
    case 384: return launch<T, 384>(x, f(ls), f(lb), w1, f(b1), w2, f(b2), out, M, F, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// x, out [M, C] and the weights w1 [F, C], w2 [C, F] in T; ls, lb, b1, b2
// float32.
int fused_ln_mlp_f32(const void* x, const void* ls, const void* lb, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* out, int M, int C,
                     int F, float eps, void* stream) {
  return dispatch<float>(x, ls, lb, w1, b1, w2, b2, out, M, C, F, eps, stream);
}

int fused_ln_mlp_bf16(const void* x, const void* ls, const void* lb, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M, int C,
                      int F, float eps, void* stream) {
  return dispatch<__nv_bfloat16>(x, ls, lb, w1, b1, w2, b2, out, M, C, F, eps, stream);
}

const char* fused_ln_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
