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
// cores (TF32 stays off: the reference is full float32).  What a kernel can
// do about it: issue the products at the tensor cores' full rate (wgmma),
// keep the weight copies off the threads and in flight while the products
// run (TMA into a ring), and read each weight chunk for as many rows as the
// registers hold (every row tile streams both weight matrices from L2).
//
// bf16 (wgmma_chain.cuh): a persistent grid, one block an SM walking row
// tiles; in a block, two consumer warpgroups and one producer warp (setmaxnreg
// gives the consumers 232 registers a thread, the producer 40).
//   - The producer brings the tile's x rows in by TMA ([BM][64] boxes, 128-byte
//     swizzle; rows past M read as zeros) and then, for each F chunk of FC
//     columns, w1[:, chunk] and w2[chunk, :] as they lie in device memory
//     (MN-major boxes, read through wgmma's transpose bit: no copy of the
//     weights a call) into a ring of S stages, each guarded by a full and an
//     empty mbarrier.  The next tile's x comes in as soon as the consumers'
//     last first product of the tile is done, so the loads of tile t + 1
//     overlap the last chunk and the epilogue of tile t.
//   - A consumer warpgroup computes h = x . w1_chunk for its 64 rows on wgmma
//     (both operands in shared memory), adds b1, rounds, applies the GELU and
//     rounds in registers, packs a into the A fragments of the second product
//     and issues acc += a . w2_chunk on wgmma with A from registers: a never
//     touches shared memory.  The second product runs while the warpgroup
//     waits for the next chunk and issues its first product; the two
//     warpgroups' GELUs overlap each other's products.  acc, [64, C2W] in
//     float32, stays in registers for the whole of F.
//   - Split: C2 <= 256 (NSPLIT 1): BM = 128 rows a tile, 64 a warpgroup, all
//     C2 columns (acc C2/2 registers a thread).  C2 >= 384 (NSPLIT 2): 64 rows
//     a tile shared by both warpgroups, each owning C2/2 columns (96 or 128
//     registers), and each computing the whole h of the 64 rows.  That first
//     product is done twice, but it is bound by shared-memory reads of x and
//     w1 (m64 x FC from shared memory), about as many as when each warpgroup
//     takes half of h's columns and the halves of a are shared through
//     shared memory, which would add a barrier between the warpgroups and a
//     second product with A from shared memory.
//   - The epilogue adds b2, rounds and stores 4 bytes a value pair, rows
//     below M only.
// The wrapper's plan (ops/fused_mlp.py::mlp_plan) gives BM, FC, the ring's
// stages and the shared-memory bytes: F chunks of 64 in two stages where they
// fit beside the x tile (ConvViT-Base's stage 1: the first product's m64 x 64
// tiles read half the shared memory a product of m64 x 32 ones), else the
// deepest ring of 32-wide chunks (stage 2: three stages), 16 where C is large.
// What still bounds it (scripts/probe_fo_mlp.py, PERF.md): the exact-erf
// GELU on the CUDA cores, which costs about as much as a product and
// overlaps the products only across the two warpgroups, and the stream of
// the weight chunks from L2 for every 128-row tile.
//
// float32 (chained_gemm.cuh): PR 9's FMA core of the LN-MLP without the
// LayerNorm and the residual.  A block of 256 threads a BM-row tile (64, or 32
// where C is large); x stays in shared memory; the F chunks stream through a
// two-stage cp.async ring of w1^T rows [FC][C] and w2^T columns [C2][FC]
// (the wrapper passes the weights transposed: the core reads K-contiguous
// rows of both operands); a warp owns BM/8 rows in both products (h by
// quarter-K lanes added by shuffles, GELU, a behind a __syncwarp), acc
// [BM/8][C2/32] a thread in registers across F.
//
// No atomics, no split of any sum: the same bits on every run.

#include "chained_gemm.cuh"
#include "wgmma_chain.cuh"

namespace {

using chain::align16;
using chain::cp_async_commit;
using chain::cp_async_wait;
using chain::gelu;
using chain::round_to;
using chain::thread_gemm_f32;
using convmae::copy_tile_async;

constexpr int SMEM_LIMIT = 232448;

// Per-device caches: the dynamic shared-memory limit set for a kernel, the
// number of SMs.
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

// ---------------------------------------------------------------- bf16

constexpr int WG_THREADS = 384;  // consumer warpgroups 0 and 1, the producer warpgroup 2
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int MAX_STAGES = 8;
constexpr int X_BOX = 64;    // columns of an x box (128 bytes)
constexpr int W1_BOX = 128;  // rows of a w1 box
constexpr int W2_BOX = 64;   // columns of a w2 box

// Shared memory of a block (ops/fused_mlp.py::mlp_smem_bytes): 1024 bytes to
// align the tiles, x [BM][C], S stages of (w1 chunk [C][FC], w2 chunk
// [FC][C2]), 256 bytes of mbarriers.
size_t wg_smem(int bm, int fc, int stages, int c, int c2) {
  return 1024 + size_t(bm) * c * 2 + size_t(stages) * (size_t(c) * fc + size_t(fc) * c2) * 2 + 256;
}

template <int C2, int NSPLIT, int FC>
__global__ void __launch_bounds__(WG_THREADS, 1)
mlp_wgmma(const __grid_constant__ CUtensorMap tm_x,   // x [M, C]
          const __grid_constant__ CUtensorMap tm_w1,  // w1 [C, F]
          const __grid_constant__ CUtensorMap tm_w2,  // w2 [F, C2]
          const float* __restrict__ b1, const float* __restrict__ b2,
          __nv_bfloat16* __restrict__ out, int M, int C, int F, int S) {
  using namespace wgchain;
  constexpr int BM = 128 / NSPLIT;  // rows a tile
  constexpr int C2W = C2 / NSPLIT;  // output columns a consumer warpgroup
  static_assert(FC == 16 || FC == 32 || FC == 64, "an F chunk of one w1 box");
  static_assert(C2W % 64 == 0 && C2W / 2 <= 128, "the accumulator's registers");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t xb = uint32_t(BM) * C * 2, w1b = uint32_t(C) * FC * 2;
  const uint32_t stb = w1b + uint32_t(FC) * C2 * 2;
  unsigned char* xs = sm;
  unsigned char* ring = sm + xb;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + size_t(S) * stb);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* x_full = empty + MAX_STAGES;
  uint64_t* x_empty = x_full + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = F / FC;
  const int ntiles = (M + BM - 1) / BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // a consumer warp each
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread issues every TMA load of the block
    reg_dealloc<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        mbar_wait(x_empty, (it & 1) ^ 1);
        mbar_expect_tx(x_full, xb);
        for (int g = 0; g < C / X_BOX; ++g)
          tma_load_2d(xs + size_t(g) * BM * X_BOX * 2, &tm_x, x_full, g * X_BOX, tile * BM);
        for (int k = 0; k < nch; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], stb);
          unsigned char* st = ring + size_t(stage) * stb;
          for (int rb = 0; rb < C / W1_BOX; ++rb)
            tma_load_2d(st + size_t(rb) * W1_BOX * FC * 2, &tm_w1, &full[stage], k * FC,
                        rb * W1_BOX);
          for (int g = 0; g < C2 / W2_BOX; ++g)
            tma_load_2d(st + w1b + size_t(g) * FC * W2_BOX * 2, &tm_w2, &full[stage], g * W2_BOX,
                        k * FC);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg, warp wl of it
    reg_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, q = lane & 3;
    const int r0w = NSPLIT == 1 ? 64 * wg : 0;    // the warpgroup's first row in the tile
    const int c0w = NSPLIT == 1 ? 0 : wg * C2W;   // its first output column
    const uint32_t x_a = smem_u32(xs) + uint32_t(r0w) * X_BOX * 2;
    const uint32_t ring_a = smem_u32(ring);
    constexpr uint32_t LBO = uint32_t(FC) * W2_BOX * 2;  // between w2 boxes
    float acc[C2W / 2], h[FC / 2];
#pragma unroll
    for (int i = 0; i < C2W / 2; ++i) acc[i] = 0.0f;
    int stage = 0;  // the next chunk to wait for, over the block's walk
    uint32_t phase = 0, it = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      mbar_wait(x_full, it & 1);
      int prev = 0;
      for (int k = 0; k < nch; ++k) {
        mbar_wait(&full[stage], phase);
        const uint32_t st = ring_a + uint32_t(stage) * stb;

        // h = x . w1_chunk: 64 rows x FC columns
#pragma unroll
        for (int i = 0; i < FC / 2; ++i) h[i] = 0.0f;
        fence_regs(h);
        mma_fence();
#pragma unroll 4
        for (int kk = 0; kk < C / 16; ++kk)
          mma_ss<FC>(h, kmajor_sw128(x_a, uint32_t(BM) * X_BOX * 2, kk), mnmajor<FC>(st, w1b, kk),
                     kk > 0);
        mma_commit();
        mma_wait<0>();  // this chunk's first product and the last chunk's second
        fence_regs(h);
        fence_regs(acc);
        if (lane == 0) {
          if (k > 0) mbar_arrive(&empty[prev]);
          if (k == nch - 1) mbar_arrive(x_empty);
        }

        // + b1, round, GELU, round, packed into the A fragments of the second
        // product (n8-tile j, rows g + 8 hf: register 2 (j % 2) + hf of step
        // j / 2)
        const float* bk = b1 + k * FC;
        uint32_t a[FC / 16][4];
#pragma unroll
        for (int j = 0; j < FC / 8; ++j) {
          const float2 bias = *reinterpret_cast<const float2*>(bk + 8 * j + 2 * q);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                gelu(round_to<__nv_bfloat16>(h[4 * j + 2 * hf] + bias.x)),
                gelu(round_to<__nv_bfloat16>(h[4 * j + 2 * hf + 1] + bias.y)));
            a[j / 2][2 * (j % 2) + hf] = *reinterpret_cast<const uint32_t*>(&v);
          }
        }

        // acc += a . w2_chunk[:, c0w:c0w + C2W], in n128 (and n64) pieces; it
        // runs while the warpgroup waits for the next chunk and issues its
        // first product
        const uint32_t w2a = st + w1b + uint32_t(c0w / W2_BOX) * LBO;
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < FC / 16; ++kk) {
          const int sd = (k > 0 || kk > 0) ? 1 : 0;
#pragma unroll
          for (int p = 0; p < C2W / 128; ++p)
            mma_rs<128>(*reinterpret_cast<float(*)[64]>(acc + 64 * p), a[kk],
                        mnmajor<64>(w2a + 2 * p * LBO, LBO, kk), sd);
          if constexpr (C2W % 128 != 0)
            mma_rs<64>(*reinterpret_cast<float(*)[32]>(acc + 64 * (C2W / 128)), a[kk],
                       mnmajor<64>(w2a + 2 * (C2W / 128) * LBO, LBO, kk), sd);
        }
        mma_commit();
        fence_regs(acc);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      mma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: + b2, round, store the rows below M
      const int row = tile * BM + r0w + 16 * wl + g;
#pragma unroll
      for (int j = 0; j < C2W / 8; ++j) {
        const int col = c0w + 8 * j + 2 * q;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (row + 8 * hf < M)
            *reinterpret_cast<__nv_bfloat162*>(out + size_t(row + 8 * hf) * C2 + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hf] + bias.x,
                                      acc[4 * j + 2 * hf + 1] + bias.y);
        }
      }
    }
  }
}

template <int C2, int NSPLIT, int FC>
cudaError_t launch_bf16(const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, void* out, int M, int C, int F, int stages, size_t smem,
                        cudaStream_t stream) {
  constexpr int BM = 128 / NSPLIT;
  if (stages < 2 || stages > MAX_STAGES || F % FC != 0 || smem != wg_smem(BM, FC, stages, C, C2) ||
      smem > size_t(SMEM_LIMIT))
    return cudaErrorInvalidValue;
  CUtensorMap mx, m1, m2;
  cudaError_t e = wgchain::make_map_2d(&mx, x, M, C, BM, X_BOX);
  if (e == cudaSuccess) e = wgchain::make_map_2d(&m1, w1, C, F, W1_BOX, FC);
  if (e == cudaSuccess) e = wgchain::make_map_2d(&m2, w2, F, C2, FC, W2_BOX);
  if (e != cudaSuccess) return e;
  auto kern = mlp_wgmma<C2, NSPLIT, FC>;
  static size_t done[64] = {};
  e = chain::set_smem_once(kern, smem, done);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = (M + BM - 1) / BM;
  kern<<<tiles < sms ? tiles : sms, WG_THREADS, smem, stream>>>(
      mx, m1, m2, b1, b2, static_cast<__nv_bfloat16*>(out), M, C, F, stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

// Shared memory of a block (ops/fused_mlp.py::mlp_smem_bytes): x [BM][C + 4],
// two stages of (w1^T chunk [FC][C + 4], w2^T chunk [C2][FC + 4]), the a tile
// [BM][FC + 4], each 16-byte aligned.
constexpr int F32_PAD = 4, F32_STAGES = 2, F32_THREADS = 256, K_SLICE = 128;

size_t f32_smem(int bm, int fc, int c, int c2) {
  return align16(size_t(bm) * (c + F32_PAD) * 4) +
         F32_STAGES * (align16(size_t(fc) * (c + F32_PAD) * 4) +
                       align16(size_t(c2) * (fc + F32_PAD) * 4)) +
         align16(size_t(bm) * (fc + F32_PAD) * 4);
}

template <int C2, int BM, int FC>
__global__ void __launch_bounds__(F32_THREADS, 1)
mlp_f32(const float* __restrict__ x,    // [M, C]
        const float* __restrict__ w1t,  // [F, C]
        const float* __restrict__ b1,   // [F]
        const float* __restrict__ w2t,  // [C2, F]
        const float* __restrict__ b2,   // [C2]
        float* __restrict__ out,        // [M, C2]
        int M, int C, int F) {
  constexpr int S = F32_STAGES, LDA = FC + F32_PAD, LDW2 = FC + F32_PAD;
  constexpr int RW = BM / 8, TN1 = FC / 8, TN2 = C2 / 32;
  static_assert(RW % 4 == 0 && FC % 8 == 0 && C2 % 32 == 0, "f32 tiles");
  const int ldx = C + F32_PAD;
  const size_t XB = align16(size_t(BM) * ldx * 4), W1B = align16(size_t(FC) * ldx * 4);
  const size_t STB = W1B + align16(size_t(C2) * LDW2 * 4);
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + XB;
  float* as = reinterpret_cast<float*>(ring + S * STB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, M - r0);
  const int nch = F / FC;

  const auto w1s = [&](int k) { return reinterpret_cast<float*>(ring + (k % S) * STB); };
  const auto w2s = [&](int k) { return reinterpret_cast<float*>(ring + (k % S) * STB + W1B); };
  // chunk k's w1^T rows and w2^T columns into stage k % S, one commit group
  const auto issue = [&](int k) {
    if (k < nch) {
      copy_tile_async(w1s(k), ldx, w1t + size_t(k) * FC * C, C, FC, C);
      copy_tile_async(w2s(k), LDW2, w2t + size_t(k) * FC, F, C2, FC);
    }
    cp_async_commit();
  };
  // the x rows (zeros past M) ride in chunk 0's group
  copy_tile_async(xs, ldx, x + size_t(r0) * C, C, rows, C);
  for (int i = tid; i < (BM - rows) * C; i += F32_THREADS) xs[(rows + i / C) * ldx + i % C] = 0.0f;
  issue(0);

  // A warp owns rows [w RW, +RW) in both products.  h: lane (lk, ln) sums the
  // float4s k = 4 lk + 16 t (a quarter of K) for columns ln + 8 j, the
  // quarters added by shuffles; the output: columns lane + 32 j.
  const int lk = lane >> 3, ln = lane & 7;
  const float* xf = xs + warp * RW * ldx;
  float* af = as + warp * RW * LDA;
  float acc[RW][TN2];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < TN2; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < nch; ++k) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk k (and the x rows) landed; stage k - 1 free
    issue(k + S - 1);
    const float* w1f = w1s(k);
    const float* w2f = w2s(k);

    float h[RW][TN1];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) h[i][j] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += K_SLICE)
      thread_gemm_f32<RW, TN1, K_SLICE, 1, 8, 16>(h, xf + 4 * lk + c0, ldx,
                                                   w1f + ln * ldx + 4 * lk + c0, ldx);
    // add the four quarters and scatter the sums: lane lk keeps the RW/4
    // rows [lk RW/4, +RW/4) of its columns, fully summed
    float* hv = &h[0][0];
    constexpr int NV = RW * TN1;
    const bool hi = lk & 2, lo = lk & 1;
#pragma unroll
    for (int v = 0; v < NV / 2; ++v) {
      const float send = hi ? hv[v] : hv[v + NV / 2], keep = hi ? hv[v + NV / 2] : hv[v];
      hv[v] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int v = 0; v < NV / 4; ++v) {
      const float send = lo ? hv[v] : hv[v + NV / 4], keep = lo ? hv[v + NV / 4] : hv[v];
      hv[v] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    const float* b1k = b1 + k * FC;
#pragma unroll
    for (int v = 0; v < NV / 4; ++v) {
      const int i = lk * (RW / 4) + v / TN1, col = ln + 8 * (v % TN1);
      af[i * LDA + col] = gelu(hv[v] + b1k[col]);
    }
    __syncwarp();  // the warp's a rows are whole

    thread_gemm_f32<RW, TN2, FC, 1, 32>(acc, af, LDA, w2f + lane * LDW2, LDW2);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = r0 + warp * RW + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN2; ++j) {
      const int col = lane + 32 * j;
      out[size_t(row) * C2 + col] = acc[i][j] + b2[col];
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the trailing group is empty)
}

template <int C2, int BM, int FC>
cudaError_t launch_f32(const void* x, const void* w1t, const float* b1, const void* w2t,
                       const float* b2, void* out, int M, int C, int F, size_t smem,
                       cudaStream_t stream) {
  if (F % FC != 0 || C % K_SLICE != 0 || smem != f32_smem(BM, FC, C, C2) ||
      smem > size_t(SMEM_LIMIT))
    return cudaErrorInvalidValue;
  auto kern = mlp_f32<C2, BM, FC>;
  static size_t done[64] = {};
  const cudaError_t e = chain::set_smem_once(kern, smem, done);
  if (e != cudaSuccess) return e;
  kern<<<(M + BM - 1) / BM, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1t), b1,
      static_cast<const float*>(w2t), b2, static_cast<float*>(out), M, C, F);
  return cudaGetLastError();
}

// The configurations, the only plans the entries take (ops/fused_mlp.py::
// _MLP_TILES): bf16 (C2, rows a tile, FC) with any ring of 2..MAX_STAGES
// stages; float32 (C2, rows a block, FC) with two stages.
#define MLP_PLANS_BF16(X)                                                                  \
  X(128, 128, 64) X(128, 64, 32) X(128, 64, 16) X(256, 128, 64) X(256, 128, 32)            \
  X(256, 64, 32) X(256, 64, 16) X(384, 64, 32) X(384, 64, 16) X(512, 64, 32)               \
  X(512, 64, 16)
#define MLP_PLANS_F32(X)                                                                   \
  X(128, 64, 32) X(128, 64, 16) X(128, 32, 16) X(256, 64, 32) X(256, 64, 16) X(256, 32, 16) \
  X(384, 64, 32) X(384, 64, 16) X(384, 32, 16) X(512, 64, 32) X(512, 64, 16) X(512, 32, 16)

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok),
// or cudaErrorInvalidValue for a plan this file does not build.  The plan
// (ops/fused_mlp.py::mlp_plan): rows a tile bm, F chunk fc, ring stages and
// the block's shared-memory bytes.  b1 [F] and b2 [C2] float32; every array
// contiguous and 16-byte aligned.
// bf16: x [M, C], w1 [C, F], w2 [F, C2] and out [M, C2] in bf16.
int fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int M, int C, int F, int C2, int bm, int fc, int stages,
                   long long smem, void* stream) {
  if (M <= 0 || C <= 0 || C % 128 || F <= 0 || F % 128 || smem <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
#define MLP_CASE(CC2, BMM, FCC)                                                        \
  if (C2 == CC2 && bm == BMM && fc == FCC)                                             \
    return launch_bf16<CC2, 128 / BMM, FCC>(x, w1, fb1, w2, fb2, out, M, C, F, stages, \
                                            size_t(smem), s);
  MLP_PLANS_BF16(MLP_CASE)
#undef MLP_CASE
  return cudaErrorInvalidValue;
}

// float32: x [M, C], w1t [F, C] (w1 transposed), w2t [C2, F] (w2 transposed)
// and out [M, C2] in float32; stages 2.
int fused_mlp_f32(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
                  void* out, int M, int C, int F, int C2, int bm, int fc, int stages,
                  long long smem, void* stream) {
  if (M <= 0 || C <= 0 || C % 128 || F <= 0 || F % 128 || smem <= 0 || stages != F32_STAGES)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
#define MLP_CASE(CC2, BMM, FCC)                                                             \
  if (C2 == CC2 && bm == BMM && fc == FCC)                                                  \
    return launch_f32<CC2, BMM, FCC>(x, w1t, fb1, w2t, fb2, out, M, C, F, size_t(smem), s);
  MLP_PLANS_F32(MLP_CASE)
#undef MLP_CASE
  return cudaErrorInvalidValue;
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
