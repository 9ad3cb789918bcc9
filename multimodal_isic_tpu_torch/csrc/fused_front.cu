// ConvMAE ConvBlock's first half for Hopper (sm_90a), plain C interface:
// LayerNorm -> 1x1 -> keep mask -> depthwise 5x5 SAME -> GELU -> 1x1 ->
// residual, in one kernel.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/fused_convblock.py::fused_front (_front_kernel), forward:
//   y  = round_T(LN(x))                          f32 fast-variance stats
//   h1 = round_T(round_T(y . w1 + b1) * keep)    0 outside the image
//   d  = round_T(round_T(sum of 25 taps in f32) + bd)
//   out = x + round_T(round_T(gelu(d)) . w2 + b2)
// on x [B, H, W, C] NHWC in T (float or bf16), w1/w2 [C_out, C_in] in T, taps
// [25, C] and every vector as float32 values.  Positions outside the image are
// zero after the first 1x1 (the unfused depthwise's SAME padding sees zeros,
// not LN(0) . w1 + b1: fused_convblock.py:81-85).
//
// What bounds it on the card.  Latent extraction, bs 128 bf16: stage 1
// [128, 56, 56, 256] (105 GFLOP of 1x1 products, 5 GFLOP of taps, 0.41 GB
// moved) and stage 2 [128, 28, 28, 384]: the bytes bound them if every
// product ran at the tensor cores' rate, but the depthwise's halo makes the
// first 1x1 recompute on the tile's border.
//
// Design.  One block of 256 threads per (TH x TW output tile, image): bf16
// 8 x 8, f32 4 x 8.  The block normalises the (TH+4) x (TW+4) halo pixels
// into shared memory once (a warp per pixel), then walks the first 1x1's
// output channels in chunks of CC (bf16 64, f32 32), as fused_ln_mlp walks F:
//   h1 chunk for every halo pixel (y . w1_chunk^T + b1, rounded, times the
//   keep factor, which is 0 outside the image) into shared memory; the 5x5
//   taps for the tile's pixels (weights in registers, f32 sums), + bd,
//   GELU, into a [TH*TW][CC] shared tile; then out += g_chunk . w2[:, chunk]^T
//   into the [TH*TW][C] accumulator, which stays in registers across chunks.
// The epilogue adds b2, rounds, adds the residual from x and stores.  bf16
// products run on mma.sync m16n8k16 (f32 accumulation) with the weight
// fragments read from global memory through L1 (both C x C matrices are
// L2-resident); float32 runs register-tiled FMA loops.  The first 1x1 is
// recomputed on the halo: (TH+4)(TW+4) / (TH TW) = 2.25 times its work in
// bf16, 3 times in f32.  The k loops are unrolled at compile time so the
// weight loads of later k-steps are issued ahead of the products.
// Left for later work: larger tiles with the halo's LN output in bf16
// registers, wgmma, and TMA-fed weight chunks.

#include "convmae_common.cuh"

namespace {

using namespace convmae;

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 8, CC = 64, PAD = 8;
};
template <> struct Tile<float> { static constexpr int TH = 4, TW = 8, CC = 32, PAD = 4; };

template <typename T, int C> struct Geo {
  static constexpr int TH = Tile<T>::TH, TW = Tile<T>::TW, CC = Tile<T>::CC;
  static constexpr int HH = TH + 4, HW = TW + 4, NH = HH * HW, NP = TH * TW;
  static constexpr int LDY = C + Tile<T>::PAD, LDH = CC + Tile<T>::PAD, LDG = LDH;
  static constexpr size_t Y = align16(size_t(NH) * LDY * sizeof(T));
  static constexpr size_t HS = align16(size_t(NH) * LDH * sizeof(T));
  static constexpr size_t GS = align16(size_t(NP) * LDG * sizeof(T));
  static constexpr size_t KF = align16(size_t(NH) * sizeof(float));
  static constexpr size_t TOTAL = Y + HS + GS + KF;
};

template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
fused_front_kernel(const T* __restrict__ x,       // [B, H, W, C]
                   const float* __restrict__ ls,  // [C]
                   const float* __restrict__ lb,  // [C]
                   const T* __restrict__ w1,      // [C_out, C_in]
                   const float* __restrict__ b1,  // [C]
                   const float* __restrict__ wd,  // [25, C]
                   const float* __restrict__ bd,  // [C]
                   const T* __restrict__ w2,      // [C_out, C_in]
                   const float* __restrict__ b2,  // [C]
                   const float* __restrict__ keep,  // [B, H, W] or null
                   T* __restrict__ out,           // [B, H, W, C]
                   int H, int W, float eps) {
  using G = Geo<T, C>;
  constexpr int TH = G::TH, TW = G::TW, CC = G::CC, HW = G::HW, NH = G::NH, NP = G::NP;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  T* hs = reinterpret_cast<T*>(smem + G::Y);
  T* gs = reinterpret_cast<T*>(smem + G::Y + G::HS);
  float* kf = reinterpret_cast<float*>(smem + G::Y + G::HS + G::GS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const T* xb = x + size_t(b) * H * W * C;

  // ---- LayerNorm of the halo pixels; the keep factor (0 outside the image)
  for (int p = warp; p < NH; p += NWARPS) {
    const int gy = ty0 - 2 + p / HW, gx = tx0 - 2 + p % HW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    if (inside) {
      ln_row<T, C>(xb + (size_t(gy) * W + gx) * C, ls, lb, eps, ys + p * G::LDY, lane);
    } else {
      for (int c = lane; c < C; c += 32) ys[p * G::LDY + c] = from_f<T>(0.0f);
    }
    if (lane == 0)
      kf[p] = !inside ? 0.0f : keep ? keep[(size_t(b) * H + gy) * W + gx] : 1.0f;
  }

  constexpr int NT = C / 16;        // bf16: n-tiles of 8 in half of C
  constexpr int RI = NP / NWARPS;   // f32: output rows per thread (4)
  constexpr int CJ = C / 32;        // f32: output columns per thread
  float acc[BF16 ? NT : RI][BF16 ? 4 : CJ];
#pragma unroll
  for (int i = 0; i < (BF16 ? NT : RI); ++i)
#pragma unroll
    for (int j = 0; j < (BF16 ? 4 : CJ); ++j) acc[i][j] = 0.0f;
  const int mt = warp & 3, nh = warp >> 2;  // bf16 warp tiles of the output

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // ys and kf written; the previous chunk's reads done

    // ---- h1 chunk for every halo pixel -> hs
    if constexpr (BF16) {
      constexpr int NG = CC / 16, ITEMS = (NH / 16) * NG;
      for (int it = warp; it < ITEMS; it += NWARPS) {
        const int m1 = it / NG, ng = it - m1 * NG;
        float h[2][4] = {};
        warp_mma<2, C, true>(h, ys + m1 * 16 * G::LDY, G::LDY, w1 + size_t(c0 + ng * 16) * C, C,
                             lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = m1 * 16 + gid + (e >> 1) * 8;
            const int col = ng * 16 + nt * 8 + tig * 2 + (e & 1);
            const float v = round_to<T>(h[nt][e] + b1[c0 + col]);
            hs[p * G::LDH + col] = from_f<T>(v * kf[p]);
          }
      }
    } else {
      constexpr int RH = NH / NWARPS;  // halo rows per thread (12)
      float h[RH] = {};
      const float* wr = reinterpret_cast<const float*>(w1) + size_t(c0 + lane) * C;
      const float* yf = reinterpret_cast<const float*>(ys);
      for (int k = 0; k < C; k += 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wr + k));
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          const float4 y = *reinterpret_cast<const float4*>(yf + (warp + NWARPS * i) * G::LDY + k);
          h[i] = fmaf(y.x, w.x, fmaf(y.y, w.y, fmaf(y.z, w.z, fmaf(y.w, w.w, h[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const int p = warp + NWARPS * i;
        hs[p * G::LDH + lane] = from_f<T>((h[i] + b1[c0 + lane]) * kf[p]);
      }
    }
    __syncthreads();

    // ---- 5x5 taps, + bd, GELU for the tile's pixels -> gs
    {
      const int ch = threadIdx.x % CC;
      float wk[25];
#pragma unroll
      for (int t = 0; t < 25; ++t) wk[t] = wd[t * C + c0 + ch];
      const float bdc = bd[c0 + ch];
      for (int o = threadIdx.x / CC; o < NP; o += NTHREADS / CC) {
        const int oy = o / TW, ox = o - oy * TW;
        float a = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 5; ++ky)
#pragma unroll
          for (int kx = 0; kx < 5; ++kx)
            a = fmaf(to_f(hs[((oy + ky) * HW + ox + kx) * G::LDH + ch]), wk[ky * 5 + kx], a);
        const float d = round_to<T>(round_to<T>(a) + bdc);
        gs[o * G::LDG + ch] = from_f<T>(gelu(d));
      }
    }
    __syncthreads();

    // ---- out += g_chunk . w2[:, chunk]^T
    if constexpr (BF16) {
      warp_mma<NT, CC, true>(acc, gs + mt * 16 * G::LDG, G::LDG,
                             w2 + size_t(nh) * (C / 2) * C + c0, C, lane);
    } else {
      const float* gf = reinterpret_cast<const float*>(gs);
      const float* wf = reinterpret_cast<const float*>(w2);
#pragma unroll
      for (int k = 0; k < CC; k += 4) {
        float4 a[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          a[i] = *reinterpret_cast<const float4*>(gf + (warp + NWARPS * i) * G::LDG + k);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float4 w =
              __ldg(reinterpret_cast<const float4*>(wf + size_t(lane + 32 * j) * C + c0 + k));
#pragma unroll
          for (int i = 0; i < RI; ++i)
            acc[i][j] = fmaf(a[i].x, w.x,
                             fmaf(a[i].y, w.y, fmaf(a[i].z, w.z, fmaf(a[i].w, w.w, acc[i][j]))));
        }
      }
    }
  }

  // ---- epilogue: + b2, round, + residual in T, store the tile's pixels
  T* ob = out + size_t(b) * H * W * C;
  if constexpr (BF16) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int o = mt * 16 + gid + hf * 8;
      const int gy = ty0 + o / TW, gx = tx0 + o % TW;
      if (gy >= H || gx >= W) continue;
      const size_t base = (size_t(gy) * W + gx) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nh * (C / 2) + nt * 8 + tig * 2;
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(xb + base + col);
        const float v0 = round_to<T>(acc[nt][hf * 2] + b2[col]);
        const float v1 = round_to<T>(acc[nt][hf * 2 + 1] + b2[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ob + base + col) = __floats2bfloat162_rn(
            __bfloat162float(xr.x) + v0, __bfloat162float(xr.y) + v1);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int o = warp + NWARPS * i;
      const int gy = ty0 + o / TW, gx = tx0 + o % TW;
      if (gy >= H || gx >= W) continue;
      const size_t base = (size_t(gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = lane + 32 * j;
        ob[base + col] = from_f<T>(to_f(xb[base + col]) + (acc[i][j] + b2[col]));
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const float* ls, const float* lb, const void* w1,
                   const float* b1, const float* wd, const float* bd, const void* w2,
                   const float* b2, const float* keep, void* out, int B, int H, int W, float eps,
                   cudaStream_t stream) {
  using G = Geo<T, C>;
  auto kern = fused_front_kernel<T, C>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), G::TOTAL);
  if (e != cudaSuccess) return e;
  const dim3 grid(((H + G::TH - 1) / G::TH) * ((W + G::TW - 1) / G::TW), B);
  kern<<<grid, NTHREADS, G::TOTAL, stream>>>(
      static_cast<const T*>(x), ls, lb, static_cast<const T*>(w1), b1, wd, bd,
      static_cast<const T*>(w2), b2, keep, static_cast<T*>(out), H, W, eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* ls, const void* lb, const void* w1, const void* b1,
             const void* wd, const void* bd, const void* w2, const void* b2, const void* keep,
             void* out, int B, int H, int W, int C, float eps, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define FRONT_CASE(CH)                                                                         \
  case CH:                                                                                     \
    return launch<T, CH>(x, f(ls), f(lb), w1, f(b1), f(wd), f(bd), w2, f(b2), f(keep), out, B, \
                         H, W, eps, s);
  switch (C) {
    FRONT_CASE(256)
    FRONT_CASE(384)
    default: return cudaErrorInvalidValue;
  }
#undef FRONT_CASE
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// x, out [B, H, W, C] and w1, w2 [C_out, C_in] in T; ls, lb, b1, bd, b2 [C],
// taps wd [25, C] and keep [B, H, W] (or null) float32.
int fused_front_f32(const void* x, const void* ls, const void* lb, const void* w1,
                    const void* b1, const void* wd, const void* bd, const void* w2,
                    const void* b2, const void* keep, void* out, int B, int H, int W, int C,
                    float eps, void* stream) {
  return dispatch<float>(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, out, B, H, W, C, eps, stream);
}

int fused_front_bf16(const void* x, const void* ls, const void* lb, const void* w1,
                     const void* b1, const void* wd, const void* bd, const void* w2,
                     const void* b2, const void* keep, void* out, int B, int H, int W, int C,
                     float eps, void* stream) {
  return dispatch<__nv_bfloat16>(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, out, B, H, W, C, eps,
                                 stream);
}

const char* fused_front_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
