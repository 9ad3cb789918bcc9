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
// product ran at the tensor cores' rate.  A block can only come near that
// if it computes each pixel's LayerNorm and first 1x1 once (no halo
// recompute) and reads the C x C weights from L2 for as many pixels as its
// shared memory holds.
//
// Design: the chained-GEMM core of fused_ln_mlp.cu (chained_gemm.cuh) over
// image rows.  A block owns one image, a band of output columns (the whole
// width where shared memory holds it: 56 at C 256 and 28 at C 384 in bf16,
// 14 in float32) and a run of output rows.  The wrapper owns the launch
// plan (ops/fused_convblock.py::front_plan: band width and count, rows a
// block, K chunk, ring stages, shared-memory bytes); the entry refuses any
// other.  The block walks its input rows r - 2 .. r_end + 1 once each:
//   - LayerNorm of the row's band + 2-column seams (a warp a pixel) into the
//     y tile, the keep factor a pixel (0 outside the image);
//   - h1 row = y . w1^T as a GEMM [band + 4 pixels] x [C] over K chunks of
//     KC, + b1, rounded, times keep, into a ring of 5 h1 rows in shared
//     memory (a row outside the image is a row of zeros).  Only the 2-column
//     seams between bands are computed twice;
//   - once the ring holds rows r - 2 .. r + 2: the 5x5 taps of output row r
//     (a thread owns a channel pair and a run of 14 (bf16) or 8 (float32)
//     output columns, slides a 5 x (run + 4) window of pairs over the ring
//     rows, the pair's taps in registers, f32 sums), + bd, GELU, into the
//     g tile (which reuses the y tile), then out row = x + round(g . w2^T +
//     b2) as a second GEMM over K chunks.
// Both GEMMs take their weight tiles [C][KC] from one cp.async ring of S
// stages that runs through the block's whole walk in a fixed order (for
// each input row: C/KC tiles of w1, then C/KC of w2), so the copy of the
// next tiles overlaps the products, the taps and the next row's LayerNorm;
// the walk skips the tiles of rows with nothing to compute.  Each row's x
// is loaded during the previous row.  One block an SM
// (shared memory).  bf16, 16 warps: they tile the pixels in 16-row groups
// and C in 4 (C 256) or 8 (C 384) column groups, mma.sync m16n8k16 with
// ldmatrix operands, f32 accumulators.  float32, 8 warps: each owns C/8
// output channels, a thread (band + 4)/4 pixels x C/64 channels of FMAs.
// No atomics: the same bits on every run.
// Left for later work: wgmma and TMA, bands of two output rows.

#include "chained_gemm.cuh"

namespace {

using namespace chain;

// Shared-memory layout of one block (ops/fused_convblock.py::
// front_smem_bytes): the h1 ring [5][BW + 4][C], the y/g tile [MP][C + PAD],
// the keep factors [MP] (float32), S weight tiles [C][KC + PAD]; each
// 16-byte aligned.  MP is BW + 4 rounded up to the bf16 row groups (16) or
// to 4 in float32.
template <typename T, int C, int BW, int KC, int S> struct Front {
  static constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int PAD = BF16 ? 8 : 4;
  static constexpr int BWI = BW + 4;
  static constexpr int MP = BF16 ? (BWI + 15) / 16 * 16 : (BWI + 3) / 4 * 4;
  static constexpr int NTH = BF16 ? 512 : 256, NW = NTH / 32;
  // output columns a tap item: about one item a thread at the slice's
  // widths in bf16 (128 or 192 channel pairs x 56 / 14 or 28 / 14 runs over
  // 512 threads); 8 in float32 (bands of 14: 2 runs a pair, 256 threads)
  static constexpr int RUN = BF16 ? 14 : 8;
  static constexpr int WN = BF16 ? NW / (MP / 16) : NW;  // warps along C
  static constexpr int LDY = C + PAD, LDW = KC + PAD;
  static constexpr size_t RING = align16(size_t(5) * BWI * C * sizeof(T));
  static constexpr size_t YG = align16(size_t(MP) * LDY * sizeof(T));
  static constexpr size_t KF = align16(size_t(MP) * sizeof(float));
  static constexpr size_t SLOT = align16(size_t(C) * LDW * sizeof(T));
  static constexpr size_t TOTAL = RING + YG + KF + S * SLOT;
  static_assert(!BF16 || (MP / 16) * WN == NW, "bf16: warps of 16 rows");
  static_assert(C % (8 * WN) == 0 && C % KC == 0, "column groups");
  static_assert(TOTAL <= 232448, "one block's shared memory");
};


template <typename T, int C, int BW, int KC, int S>
__global__ void __launch_bounds__(Front<T, C, BW, KC, S>::NTH, 1)
fused_front_kernel(const T* __restrict__ x,         // [B, H, W, C]
                   const float* __restrict__ ls,    // [C]
                   const float* __restrict__ lb,    // [C]
                   const T* __restrict__ w1,        // [C_out, C_in]
                   const float* __restrict__ b1,    // [C]
                   const float* __restrict__ wd,    // [25, C]
                   const float* __restrict__ bd,    // [C]
                   const T* __restrict__ w2,        // [C_out, C_in]
                   const float* __restrict__ b2,    // [C]
                   const float* __restrict__ keep,  // [B, H, W] or null
                   T* __restrict__ out,             // [B, H, W, C]
                   int H, int W, int band_w, int n_bx, int rows, float eps) {
  using L = Front<T, C, BW, KC, S>;
  constexpr int NK = C / KC;  // weight tiles a GEMM
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* yg = reinterpret_cast<T*>(smem + L::RING);
  float* kf = reinterpret_cast<float*>(smem + L::RING + L::YG);
  unsigned char* slots = smem + L::RING + L::YG + L::KF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x % n_bx, by = blockIdx.x / n_bx, b = blockIdx.y;
  const int x0 = bx * band_w, nb = min(band_w, W - x0), nbi = nb + 4;
  const int ro0 = by * rows, ro1 = min(H, ro0 + rows);
  const int n_iter = ro1 - ro0 + 4;  // input rows ro0 - 2 .. ro1 + 1
  const T* xb = x + size_t(b) * H * W * C;
  T* ob = out + size_t(b) * H * W * C;

  // ---- the weight ring.  The walk's tiles in order: for each input row i
  // in the image, the C/KC column tiles [u KC, u KC + KC) of w1, then for
  // each row i >= 4 (an output row) those of w2.  The producer's cursor
  // (pi, pw, pu) is the next tile to copy; tile t goes to slot t % S.
  const auto slot = [&](int t) { return reinterpret_cast<T*>(slots + (t % S) * L::SLOT); };
  const auto needs = [&](int i, int w) { return w ? i >= 4 : unsigned(ro0 - 2 + i) < unsigned(H); };
  int pi = 0, pw = 0, pu = 0, issued = 0;
  const auto settle = [&]() {  // skip the phases with nothing to compute
    while (pi < n_iter && !needs(pi, pw)) {
      pw ^= 1;
      pi += pw == 0;
    }
  };
  settle();
  const auto issue = [&]() {
    if (pi < n_iter) {
      copy_tile<T, C, KC, L::NTH>(slot(issued), L::LDW, (pw ? w2 : w1) + pu * KC, C, tid);
      if (++pu == NK) {
        pu = 0;
        pw ^= 1;
        pi += pw == 0;
        settle();
      }
    }
    ++issued;
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) issue();
  int next = 0;
  // the next tile of the walk: wait for it, a barrier (which also orders
  // the shared-memory writes before it), and the copy of tile next + S - 1
  const auto take = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue();
    return slot(next++);
  };

  // ---- the block's warp tiling of [MP pixels] x [C]
  const int gid = lane >> 2, tig = lane & 3;
  const int grp = L::BF16 ? warp / L::WN : 0, wn = L::BF16 ? warp % L::WN : 0;
  const int lm = lane >> 3, ln = lane & 7;
  constexpr int NT = C / L::WN / 8;  // bf16: n-tiles a warp
  constexpr int TM = L::MP / 4, TN = C / (8 * L::NW);  // f32: pixels x channels a thread
  float acc[L::BF16 ? 1 : TM][L::BF16 ? NT : TN][L::BF16 ? 4 : 1];
  const auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < (L::BF16 ? 1 : TM); ++i)
#pragma unroll
      for (int j = 0; j < (L::BF16 ? NT : TN); ++j)
#pragma unroll
        for (int e = 0; e < (L::BF16 ? 4 : 1); ++e) acc[i][j][e] = 0.0f;
  };
  // acc += yg[:, kt KC : kt KC + KC] . ws^T
  const auto gemm = [&](const T* ws, int kt) {
    if constexpr (L::BF16) {
      warp_gemm_bf16<1, NT, KC>(acc, yg + grp * 16 * L::LDY + kt * KC, L::LDY,
                                ws + wn * (C / L::WN) * L::LDW, L::LDW, lane);
    } else {
      float(&a2)[TM][TN] = reinterpret_cast<float(&)[TM][TN]>(acc);
      thread_gemm_f32<TM, TN, KC, 4, 8>(a2, yg + lm * L::LDY + kt * KC, L::LDY,
                                        ws + (warp * (C / L::NW) + ln) * L::LDW, L::LDW);
    }
  };
  // fn(pixel, channel, v0, v1) for each accumulator pair of the thread
  const auto each_pair = [&](auto&& fn) {
    if constexpr (L::BF16) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          fn(grp * 16 + gid + hf * 8, wn * (C / L::WN) + j * 8 + tig * 2, acc[0][j][hf * 2],
             acc[0][j][hf * 2 + 1], 1);
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          fn(lm + 4 * i, warp * (C / L::NW) + ln + 8 * j, acc[i][j][0], 0.0f, 0);
    }
  };

  // ---- the LayerNorm's input: a warp's pixels p = warp + j NW of a row,
  // loaded a row ahead
  constexpr int LR = (L::MP + L::NW - 1) / L::NW;
  const auto row_px = [&](int p) { return p < nbi && unsigned(x0 - 2 + p) < unsigned(W); };
  Rows<T, C, LR> pre;
  const auto load_row = [&](int r) {
    const T* src[LR];
#pragma unroll
    for (int j = 0; j < LR; ++j) {
      const int p = warp + j * L::NW;
      src[j] = unsigned(r) < unsigned(H) && p < L::MP && row_px(p)
                   ? xb + (size_t(r) * W + x0 - 2 + p) * C
                   : nullptr;
    }
    pre.load(src, lane);
  };
  load_row(ro0 - 2);

  for (int i = 0; i < n_iter; ++i) {
    const int ri = ro0 - 2 + i;
    const bool in = ri >= 0 && ri < H;
    T* hrow = ring + (i % 5) * L::BWI * C;
    __syncthreads();  // the previous row's g tile and taps are done with
    if (in) {
      // LayerNorm of the band's pixels of row ri (+ seams) into the y tile,
      // from the loads issued during the previous row; then the loads of
      // the next row, which land while this one is in the products and taps
      T* dst[LR];
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        const int p = warp + j * L::NW, gx = x0 - 2 + p;
        dst[j] = p < L::MP ? yg + p * L::LDY : nullptr;
        if (lane == 0 && p < L::MP)
          kf[p] = !row_px(p) ? 0.0f : keep ? keep[(size_t(b) * H + ri) * W + gx] : 1.0f;
      }
      pre.normalise(ls, lb, eps, dst, lane);
    }
    if (i + 1 < n_iter) load_row(ri + 1);
    // ---- h1 row ri = round(y . w1^T + b1) * keep into ring slot i % 5
    if (in) {
      zero_acc();
      for (int kt = 0; kt < NK; ++kt) gemm(take(), kt);
      each_pair([&](int p, int c, float v0, float v1, int two) {
        if (p >= nbi) return;
        const float k = kf[p];
        if (two) {
          store2(hrow + p * C + c, round_to<T>(v0 + b1[c]) * k, round_to<T>(v1 + b1[c + 1]) * k);
        } else {
          hrow[p * C + c] = from_f<T>(round_to<T>(v0 + b1[c]) * k);
        }
      });
    } else {
      for (int e = tid; e < nbi * C; e += L::NTH) hrow[e] = from_f<T>(0.0f);
    }

    if (i < 4) continue;  // no output row yet
    const int ro = ri - 2;
    __syncthreads();  // the h1 row is in the ring; the y tile is free

    // ---- taps of output row ro (ring slots (i + 1 .. i + 5) % 5 are rows
    // ro - 2 .. ro + 2) + bd, GELU -> the g tile
    {
      constexpr int NP = C / 2;
      constexpr int RUN = L::RUN;
      const int nruns = (nb + RUN - 1) / RUN;
      for (int it = tid; it < NP * nruns; it += L::NTH) {
        const int c = 2 * (it % NP), o0 = (it / NP) * RUN;
        float s0[RUN], s1[RUN];
#pragma unroll
        for (int o = 0; o < RUN; ++o) s0[o] = s1[o] = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 5; ++ky) {
          const T* hr = ring + ((i + 1 + ky) % 5) * L::BWI * C + c;
          float t0[5], t1[5];
#pragma unroll
          for (int kx = 0; kx < 5; ++kx) {
            t0[kx] = wd[(ky * 5 + kx) * C + c];
            t1[kx] = wd[(ky * 5 + kx) * C + c + 1];
          }
#pragma unroll
          for (int xx = 0; xx < RUN + 4; ++xx) {
            float v0 = 0.0f, v1 = 0.0f;
            if (o0 + xx < nbi) load2(hr + (o0 + xx) * C, v0, v1);
#pragma unroll
            for (int kx = 0; kx < 5; ++kx) {
              const int o = xx - kx;
              if (o >= 0 && o < RUN) {
                s0[o] = fmaf(v0, t0[kx], s0[o]);
                s1[o] = fmaf(v1, t1[kx], s1[o]);
              }
            }
          }
        }
        const float bd0 = bd[c], bd1 = bd[c + 1];
#pragma unroll
        for (int o = 0; o < RUN; ++o) {
          if (o0 + o >= nb) break;
          const float d0 = round_to<T>(round_to<T>(s0[o]) + bd0);
          const float d1 = round_to<T>(round_to<T>(s1[o]) + bd1);
          store2(yg + (o0 + o) * L::LDY + c, gelu(d0), gelu(d1));
        }
      }
    }

    // ---- out row ro = x + round(g . w2^T + b2)
    zero_acc();
    for (int kt = 0; kt < NK; ++kt) gemm(take(), kt);
    each_pair([&](int p, int c, float v0, float v1, int two) {
      if (p >= nb) return;
      const size_t o = (size_t(ro) * W + x0 + p) * C + c;
      if (two) {
        float x0v, x1v;
        load2(xb + o, x0v, x1v);
        store2(ob + o, x0v + round_to<T>(v0 + b2[c]), x1v + round_to<T>(v1 + b2[c + 1]));
      } else {
        ob[o] = from_f<T>(to_f(xb[o]) + round_to<T>(v0 + b2[c]));
      }
    });
  }
  cp_async_wait<0>();  // no copy outlives the block (the trailing groups are empty)
}

template <typename T, int C, int BW, int KC, int S>
cudaError_t launch(const void* x, const float* ls, const float* lb, const void* w1,
                   const float* b1, const float* wd, const float* bd, const void* w2,
                   const float* b2, const float* keep, void* out, int B, int H, int W,
                   int band_w, int n_bx, int rows, int n_by, float eps, size_t smem,
                   cudaStream_t stream) {
  using L = Front<T, C, BW, KC, S>;
  // the plan must match this layout and cover every pixel exactly once
  if (smem != L::TOTAL || band_w < 1 || band_w > BW || n_bx < 1 ||
      (long long)n_bx * band_w < W || (long long)(n_bx - 1) * band_w >= W || rows < 1 ||
      n_by < 1 || (long long)n_by * rows < H || (long long)(n_by - 1) * rows >= H ||
      (long long)n_bx * n_by > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kern = fused_front_kernel<T, C, BW, KC, S>;
  static size_t done[64] = {};
  const cudaError_t e = set_smem_once(kern, L::TOTAL, done);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_bx * n_by, B);
  kern<<<grid, L::NTH, L::TOTAL, stream>>>(
      static_cast<const T*>(x), ls, lb, static_cast<const T*>(w1), b1, wd, bd,
      static_cast<const T*>(w2), b2, keep, static_cast<T*>(out), H, W, band_w, n_bx, rows, eps);
  return cudaGetLastError();
}

// The instantiations, the only plans the entries take (ops/
// fused_convblock.py::_FRONT_TILES): (C, band width, K chunk, stages).
#define FRONT_PLANS_BF16(X) X(256, 56, 32, 2) X(384, 28, 32, 2)
#define FRONT_PLANS_F32(X) X(256, 14, 32, 3) X(384, 14, 16, 2)

template <typename T>
int dispatch(const void* x, const void* ls, const void* lb, const void* w1, const void* b1,
             const void* wd, const void* bd, const void* w2, const void* b2, const void* keep,
             void* out, int B, int H, int W, int C, float eps, int band_w, int n_bx, int rows,
             int n_by, int kc, int stages, long long smem, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || smem <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t sm = size_t(smem);
#define FRONT_CASE(CC, BWW, KCC, SS)                                                          \
  if (C == CC && band_w <= BWW && kc == KCC && stages == SS && sm == Front<T, CC, BWW, KCC, SS>::TOTAL) \
    return launch<T, CC, BWW, KCC, SS>(x, f(ls), f(lb), w1, f(b1), f(wd), f(bd), w2, f(b2),    \
                                       f(keep), out, B, H, W, band_w, n_bx, rows, n_by, eps,  \
                                       sm, s);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    FRONT_PLANS_BF16(FRONT_CASE)
  } else {
    FRONT_PLANS_F32(FRONT_CASE)
  }
#undef FRONT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok),
// or cudaErrorInvalidValue for a plan this file does not build.  x, out
// [B, H, W, C] and w1, w2 [C_out, C_in] in T; ls, lb, b1, bd, b2 [C], taps wd
// [25, C] and keep [B, H, W] (or null) float32.  The plan (ops/
// fused_convblock.py::front_plan): output columns a band and bands, output
// rows a block and row bands, the K chunk, ring stages and the block's
// shared-memory bytes.
int fused_front_f32(const void* x, const void* ls, const void* lb, const void* w1,
                    const void* b1, const void* wd, const void* bd, const void* w2,
                    const void* b2, const void* keep, void* out, int B, int H, int W, int C,
                    float eps, int band_w, int n_bx, int rows, int n_by, int kc, int stages,
                    long long smem, void* stream) {
  return dispatch<float>(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, out, B, H, W, C, eps, band_w,
                         n_bx, rows, n_by, kc, stages, smem, stream);
}

int fused_front_bf16(const void* x, const void* ls, const void* lb, const void* w1,
                     const void* b1, const void* wd, const void* bd, const void* w2,
                     const void* b2, const void* keep, void* out, int B, int H, int W, int C,
                     float eps, int band_w, int n_bx, int rows, int n_by, int kc, int stages,
                     long long smem, void* stream) {
  return dispatch<__nv_bfloat16>(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, out, B, H, W, C, eps,
                                 band_w, n_bx, rows, n_by, kc, stages, smem, stream);
}

const char* fused_front_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
