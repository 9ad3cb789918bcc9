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
// reference is full float32).  What a block can do about it: read each
// weight chunk from L2 for as many rows as its registers and shared memory
// hold, keep the copy of the next chunks in flight while the products run,
// and cross few barriers.
//
// Design: two chained products, as FlashAttention chains q.k^T and p.v.  y
// stays resident in shared memory like Q; F is walked in chunks of FC; each
// chunk's w1 rows [FC][C] play K and its w2 columns [C][FC] play V, GELU
// takes the place of the softmax (no rescale).  The wrapper owns the launch
// plan (ops/fused_mlp.py::ln_mlp_plan: rows a block BM, chunk FC, ring
// stages S, shared-memory bytes); the entry refuses any plan that is not
// one of this file's instantiations or whose shared-memory size differs.
//   - The block's rows are normalised into shared memory once (a warp a row,
//     8- or 16-byte loads) while the first S - 1 weight chunks are already
//     in flight: the w1/w2 chunk pairs stream through a ring of S stages
//     (chained_gemm.cuh), so chunk k + S - 1 lands while chunk k is in the
//     products; one block barrier a chunk.
//   - bf16 (BM 128 and FC 64 at C 256, BM 96 and FC 32 at C 384; BM/8
//     warps; a 64-row, 32-wide plan where 64 does not divide F): warp (g1, ch) computes h for 16 rows and half of the chunk's
//     columns (mma.sync m16n8k16, ldmatrix operands), adds b1, rounds,
//     applies GELU and rounds into the a tile; the four warps of a 32-row
//     group meet on a named barrier of 128 threads (they are the producers
//     and the consumers of those a rows), and warp (g2, cq) accumulates
//     a . w2^T into its 32 rows x C/4 outputs, which stay in registers for
//     the whole of F: C/4 f32 registers a thread (64 at C 256 with 512
//     threads, 96 at C 384 with 384).  32-row warp tiles halve the shared
//     reads of w2 against 16-row ones.
//   - float32 (BM 64, 256 threads): register tiles of FMAs, a warp owning
//     8 rows in both products so that h passes to the second behind a
//     __syncwarp.  h: a lane sums a quarter of K (interleaved float4s) for
//     FC/8 columns, the quarters added and scattered by shuffles (each lane
//     then takes the bias and GELU of a quarter of the sums, no
//     divergence); the output: C/32 columns a lane, C/4 f32 registers a
//     thread; FC 32 at C 256, 16 at C 384 so that two stages fit.
// The epilogue adds b2, rounds, adds the residual read from x and stores.
// Rows past M are normalised as zeros and never stored.  No atomics: the
// same bits on every run.
// Left for later work: wgmma with TMA-fed weight chunks and clusters that
// multicast each chunk to two blocks.

#include "chained_gemm.cuh"

namespace {

using namespace chain;

// Shared-memory layout of one block (ops/fused_mlp.py::ln_mlp_smem_bytes):
// y [BM][C + PAD], S stages of (w1 chunk [FC][C + PAD], w2 chunk [C][FC +
// PAD]), the a tile [BM][FC + PAD]; each 16-byte aligned.
template <typename T, int C, int BM, int FC, int S> struct LnMlp {
  static constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int PAD = BF16 ? 8 : 4;
  static constexpr int NTH = BF16 ? 4 * BM : 256;
  static constexpr int NW = NTH / 32;
  static constexpr int LDY = C + PAD, LDW1 = C + PAD, LDW2 = FC + PAD, LDA = FC + PAD;
  static constexpr size_t Y = align16(size_t(BM) * LDY * sizeof(T));
  static constexpr size_t W1 = align16(size_t(FC) * LDW1 * sizeof(T));
  static constexpr size_t W2 = align16(size_t(C) * LDW2 * sizeof(T));
  static constexpr size_t STAGE = W1 + W2;
  static constexpr size_t A = align16(size_t(BM) * LDA * sizeof(T));
  static constexpr size_t TOTAL = Y + S * STAGE + A;
  static_assert(!BF16 || (BM % 32 == 0 && BM / 32 <= 15 && FC % 32 == 0), "bf16 row groups");
  static_assert(BF16 || (BM % 32 == 0 && FC % 8 == 0), "f32 tiles");
  static_assert(TOTAL <= 232448, "one block's shared memory");
};

template <typename T, int C, int BM, int FC, int S>
__global__ void __launch_bounds__(LnMlp<T, C, BM, FC, S>::NTH, 1)
fused_ln_mlp_kernel(const T* __restrict__ x,      // [M, C]
                    const float* __restrict__ ls,  // [C]
                    const float* __restrict__ lb,  // [C]
                    const T* __restrict__ w1,      // [F, C]
                    const float* __restrict__ b1,  // [F]
                    const T* __restrict__ w2,      // [C, F]
                    const float* __restrict__ b2,  // [C]
                    T* __restrict__ out,           // [M, C]
                    int M, int F, float eps) {
  using L = LnMlp<T, C, BM, FC, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + L::Y;
  T* as = reinterpret_cast<T*>(smem + L::Y + S * L::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int nch = F / FC;

  const auto w1s = [&](int k) { return reinterpret_cast<T*>(ring + (k % S) * L::STAGE); };
  const auto w2s = [&](int k) { return reinterpret_cast<T*>(ring + (k % S) * L::STAGE + L::W1); };
  // chunk k's w1 rows and w2 columns into stage k % S, one commit group
  // (empty past the last chunk, so the group count stays one a chunk)
  const auto issue = [&](int k) {
    if (k < nch) {
      copy_tile<T, FC, C, L::NTH>(w1s(k), L::LDW1, w1 + size_t(k) * FC * C, C, tid);
      copy_tile<T, C, FC, L::NTH>(w2s(k), L::LDW2, w2 + size_t(k) * FC, F, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);

  // ---- LayerNorm of the block's rows into ys (rows past M are zeros)
  for (int r = warp; r < BM; r += L::NW) {
    const T* src[1] = {r0 + r < M ? x + size_t(r0 + r) * C : nullptr};
    T* const dst[1] = {ys + r * L::LDY};
    Rows<T, C, 1> row;
    row.load(src, lane);
    row.normalise(ls, lb, eps, dst, lane);
  }

  if constexpr (L::BF16) {
    // P1 role: warp (g1, ch) owns h rows [16 g1, +16) x chunk columns
    // [ch FC/2, +FC/2); P2 role: warp (g2, cq) owns output rows [32 g2, +32)
    // x columns [cq C/4, +C/4).  The four warps 4 g2 .. 4 g2 + 3 are both the
    // producers and the consumers of a rows [32 g2, +32).
    const int g1 = warp >> 1, ch = warp & 1, g2 = warp >> 2, cq = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    constexpr int NT1 = FC / 16;  // n-tiles of 8 in half of the chunk
    constexpr int NT2 = C / 32;   // n-tiles of 8 in a quarter of C
    float acc[2][NT2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    const T* ya = ys + g1 * 16 * L::LDY;

    for (int k = 0; k < nch; ++k) {
      cp_async_wait<S - 2>();
      __syncthreads();  // chunk k landed for every thread; ys written; stage k - 1 free
      issue(k + S - 1);

      // h = y . w1_chunk^T for 16 rows x FC/2 columns, + b1, round, gelu, round
      float h[1][NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[0][j][e] = 0.0f;
      warp_gemm_bf16<1, NT1, C>(h, ya, L::LDY, w1s(k) + ch * (FC / 2) * L::LDW1, L::LDW1, lane);
      const float* b1k = b1 + k * FC;
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = g1 * 16 + gid + hf * 8;
          const int col = ch * (FC / 2) + j * 8 + tig * 2;
          const float v0 = gelu(round_to<T>(h[0][j][hf * 2] + b1k[col]));
          const float v1 = gelu(round_to<T>(h[0][j][hf * 2 + 1] + b1k[col + 1]));
          store2(as + row * L::LDA + col, v0, v1);
        }
      named_barrier(1 + g2, 128);  // a rows [32 g2, +32) are whole

      // out[32 rows, a quarter of C] += a . w2_chunk^T
      warp_gemm_bf16<2, NT2, FC>(acc, as + g2 * 32 * L::LDA, L::LDA,
                                 w2s(k) + cq * (C / 4) * L::LDW2, L::LDW2, lane);
    }

    // ---- epilogue: + b2, round, + residual in T, store
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + g2 * 32 + i * 16 + gid + hf * 8;
          const int col = cq * (C / 4) + j * 8 + tig * 2;
          if (row >= M) continue;
          const size_t o = size_t(row) * C + col;
          float x0, x1;
          load2(x + o, x0, x1);
          const float v0 = round_to<T>(acc[i][j][hf * 2] + b2[col]);
          const float v1 = round_to<T>(acc[i][j][hf * 2 + 1] + b2[col + 1]);
          store2(out + o, x0 + v0, x1 + v1);
        }
  } else {
    // A warp owns rows [w BM/8, +BM/8) in both products, so h reaches the
    // second product behind a __syncwarp, not a block barrier.  h: lane (lk,
    // ln) sums the float4s k = 4 lk + 16 t (a quarter of K, interleaved so
    // the four lanes' y reads fall in different banks) for columns ln + 8 j,
    // and the four quarters are added by shuffles (lanes ln + 8 lk).  The
    // output: lane owns columns lane + 32 j of the warp's rows.
    const int lk = lane >> 3, ln = lane & 7;
    constexpr int RW = BM / 8, TN1 = FC / 8, TN2 = C / 32;
    const float* yf = reinterpret_cast<const float*>(ys) + warp * RW * L::LDY;
    float* af = reinterpret_cast<float*>(as) + warp * RW * L::LDA;
    float acc[RW][TN2];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < TN2; ++j) acc[i][j] = 0.0f;

    for (int k = 0; k < nch; ++k) {
      cp_async_wait<S - 2>();
      __syncthreads();  // chunk k landed; ys written; stage k - 1 free
      issue(k + S - 1);
      const float* w1f = reinterpret_cast<const float*>(w1s(k));
      const float* w2f = reinterpret_cast<const float*>(w2s(k));

      float h[RW][TN1];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < TN1; ++j) h[i][j] = 0.0f;
      thread_gemm_f32<RW, TN1, C, 1, 8, 16>(h, yf + 4 * lk, L::LDY, w1f + ln * L::LDW1 + 4 * lk,
                                            L::LDW1);
      // add the four quarters and scatter the sums: lane lk keeps the
      // RW/4 rows [lk RW/4, +RW/4) of its columns, fully summed
      float* hv = &h[0][0];
      constexpr int NV = RW * TN1;
      const bool hi = lk & 2, lo = lk & 1;
#pragma unroll
      for (int q = 0; q < NV / 2; ++q) {
        const float send = hi ? hv[q] : hv[q + NV / 2], keep = hi ? hv[q + NV / 2] : hv[q];
        hv[q] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int q = 0; q < NV / 4; ++q) {
        const float send = lo ? hv[q] : hv[q + NV / 4], keep = lo ? hv[q + NV / 4] : hv[q];
        hv[q] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      const float* b1k = b1 + k * FC;
#pragma unroll
      for (int q = 0; q < NV / 4; ++q) {
        const int i = lk * (RW / 4) + q / TN1, col = ln + 8 * (q % TN1);
        af[i * L::LDA + col] = gelu(hv[q] + b1k[col]);
      }
      __syncwarp();  // the warp's a rows are whole

      thread_gemm_f32<RW, TN2, FC, 1, 32>(acc, af, L::LDA, w2f + lane * L::LDW2, L::LDW2);
    }

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = r0 + warp * RW + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN2; ++j) {
        const int col = lane + 32 * j;
        const size_t o = size_t(row) * C + col;
        out[o] = from_f<T>(to_f(x[o]) + (acc[i][j] + b2[col]));
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the trailing groups are empty)
}

template <typename T, int C, int BM, int FC, int S>
cudaError_t launch(const void* x, const float* ls, const float* lb, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, int M, int F,
                   float eps, size_t smem, cudaStream_t stream) {
  using L = LnMlp<T, C, BM, FC, S>;
  if (smem != L::TOTAL || F % FC != 0) return cudaErrorInvalidValue;
  auto kern = fused_ln_mlp_kernel<T, C, BM, FC, S>;
  static size_t done[64] = {};
  const cudaError_t e = set_smem_once(kern, L::TOTAL, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM);
  kern<<<grid, L::NTH, L::TOTAL, stream>>>(
      static_cast<const T*>(x), ls, lb, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), M, F, eps);
  return cudaGetLastError();
}

// The instantiations, the only plans the entries take (ops/fused_mlp.py::
// _LN_MLP_TILES): (C, BM, FC, S) for bf16 and for float32.
#define LN_MLP_PLANS_BF16(X) X(256, 128, 64, 2) X(256, 64, 32, 3) X(384, 96, 32, 2)
#define LN_MLP_PLANS_F32(X) X(256, 64, 32, 2) X(384, 64, 16, 2)

template <typename T>
int dispatch(const void* x, const void* ls, const void* lb, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int M, int C, int F, float eps, int bm,
             int fc, int stages, long long smem, void* stream) {
  if (F <= 0 || M <= 0 || smem <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t sm = size_t(smem);
#define LN_MLP_CASE(CC, BMM, FCC, SS)                                                        \
  if (C == CC && bm == BMM && fc == FCC && stages == SS)                                     \
    return launch<T, CC, BMM, FCC, SS>(x, f(ls), f(lb), w1, f(b1), w2, f(b2), out, M, F, eps, \
                                       sm, s);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    LN_MLP_PLANS_BF16(LN_MLP_CASE)
  } else {
    LN_MLP_PLANS_F32(LN_MLP_CASE)
  }
#undef LN_MLP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok),
// or cudaErrorInvalidValue for a plan this file does not build.  x, out
// [M, C] and the weights w1 [F, C], w2 [C, F] in T; ls, lb, b1, b2 float32.
// The plan (ops/fused_mlp.py::ln_mlp_plan): rows a block bm, F chunk fc,
// ring stages, and the block's shared-memory bytes.
int fused_ln_mlp_f32(const void* x, const void* ls, const void* lb, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* out, int M, int C,
                     int F, float eps, int bm, int fc, int stages, long long smem,
                     void* stream) {
  return dispatch<float>(x, ls, lb, w1, b1, w2, b2, out, M, C, F, eps, bm, fc, stages, smem,
                         stream);
}

int fused_ln_mlp_bf16(const void* x, const void* ls, const void* lb, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M, int C,
                      int F, float eps, int bm, int fc, int stages, long long smem,
                      void* stream) {
  return dispatch<__nv_bfloat16>(x, ls, lb, w1, b1, w2, b2, out, M, C, F, eps, bm, fc, stages,
                                 smem, stream);
}

const char* fused_ln_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
