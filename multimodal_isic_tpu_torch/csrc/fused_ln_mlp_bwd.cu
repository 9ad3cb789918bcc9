// Backward of the fused LayerNorm -> 1x1 C->F -> GELU -> 1x1 F->C -> residual
// for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/fused_mlp.py::_ln_bwd (_ln_mlp_bwd_kernel)
// Given x and the output cotangent g [M, C] and the forward's weights it
// recomputes the forward and produces, with the TPU kernel's rounding points
// (T = float or bf16; the products accumulate in float32):
//   y   = round_T(xhat * ls + lb),  xhat = (x - mean) * rsqrt(var + eps)
//   h   = round_T(y . w1 + b1)                        widened to f32
//   a   = round_T(gelu(h))
//   dh  = round_T((g . w2^T) * gelu'(h))
//   dw2 = a^T . g     db2 = sum g     dw1 = y^T . dh     db1 = sum dh
//   dy  = dh . w1^T   dls = sum dy * xhat   dlb = sum dy
//   dx  = g + round_T(rsqrt(var + eps) * (dy*ls - mean(dy*ls) - xhat * mean(dy*ls*xhat)))
// The [M, F] intermediates (h, a, dh) never reach device memory.
//
// What bounds it on the card.  The backward's products are ~10 M C F
// operations (the h recompute, g.w2^T, a^T g, y^T dh, dh.w1^T) against
// ~4 M C + 4 C F values moved: far above the ridge, so operations bound it.
// At bs 16 float32 they run on the CUDA cores (TF32 stays off): stage 1
// (M 50176, C 256, F 1024) and stage 2 (M 12544, C 384, F 1536).
//
// Design.  The TPU kernel runs its grid in order and keeps dw1/dw2 resident
// across row blocks.  Here row blocks run in parallel, and one float32
// atomicAdd per weight element and row block would cost ~8e8 atomics at stage
// 1, so the work is split in two passes plus a fixed-order reduction, which
// makes the sums the same from run to run:
//  (A) rows: a persistent block walks row blocks blockIdx.x, +gridDim.x, ...
//      For each block of BM rows it normalises the rows into shared memory
//      (y; g beside it), walks F in chunks of FC = 32 (w1 and w2 rows of the
//      chunk staged with cp.async), recomputes h and g.w2^T for the chunk,
//      forms dh in shared memory and accumulates dy [BM, C] += dh . w1_chunk
//      in registers across F.  The epilogue (a warp per row) finishes the
//      LayerNorm backward and dx, and adds the rows' dy*xhat, dy and g into
//      per-column partials that stay in registers; at the end the block
//      writes one [3, C] partial.
//  (B) weights: block (F chunk, row split) stages its w1/w2 rows once, then
//      walks its rows BM at a time: LayerNorm, h and g.w2^T for the chunk,
//      a^T and dh^T into shared memory, and dw1^T[chunk, :] += dh^T . y,
//      dw2[chunk, :] += a^T . g, db1 += sum dh in registers; it writes one
//      partial per split.
//  (R) one thread per output element sums the partials in index order.
// Both passes compute h and g.w2^T: ~14 M C F operations in all.
// bf16 products run on mma.sync m16n8k16 with f32 accumulators (the operands
// whose contraction runs down the rows of a row-major tile come through
// ldmatrix .trans); float32 runs register-tiled FMA loops.  Shared rows are
// padded so fragment loads are bank-conflict free.

#include "convmae_common.cuh"

namespace {

using namespace convmae;

constexpr int FC = 32;         // F chunk (pass A) and a weight block's F width (pass B)
constexpr int GRID_A = 264;    // pass A blocks at most (2 per SM of an H100)
constexpr int TARGET_B = 264;  // pass B blocks at most: F/FC chunks x row splits

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int BM = 64, PAD = 8; };
template <> struct Tile<float> { static constexpr int BM = 32, PAD = 4; };

template <typename T, int C> struct Smem {
  static constexpr int BM = Tile<T>::BM, PAD = Tile<T>::PAD;
  static constexpr int LDC = C + PAD;   // rows of C values: y, g, w1 and w2 chunks
  static constexpr int LDH = FC + PAD;  // pass A: dh [BM][FC]
  static constexpr int LDM = BM + PAD;  // pass B: a^T, dh^T [FC][BM]
  static constexpr size_t ROWS = align16(size_t(BM) * LDC * sizeof(T));
  static constexpr size_t W = align16(size_t(FC) * LDC * sizeof(T));
  static constexpr size_t DH = align16(size_t(BM) * LDH * sizeof(T));
  static constexpr size_t STATS = align16(size_t(2) * BM * sizeof(float));
  static constexpr size_t TR = align16(size_t(FC) * LDM * sizeof(T));
  static constexpr size_t A_TOTAL = 2 * ROWS + 2 * W + DH + STATS;
  static constexpr size_t B_TOTAL = 2 * ROWS + 2 * W + 2 * TR;
  static_assert(2 * ROWS >= size_t(BM) * C * sizeof(float), "dy scratch fits over y, g");
  static_assert(2 * W >= size_t(NWARPS) * 3 * C * sizeof(float),
                "column partials fit over the weight chunks");
};

__device__ __forceinline__ float gelu_grad(float h) {
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  return cdf + h * (expf(-0.5f * h * h) * 0.3989422804014327f);
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Four 8x8 bf16 tiles, transposed: thread t gives the address of row t & 7 of
// tile t >> 3 and receives, of each tile, rows 2(t % 4), 2(t % 4) + 1 of column
// t / 4 -- an mma.sync B fragment of a [k][n] row-major tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The rows r0 .. r0 + BM - 1: y = round_T(xhat * ls + lb) into ys and g into
// gs (rows past M are zeros in both, so they add nothing); the rows' mean and
// rsqrt(var + eps) into st when it is given.  A warp per row.
template <typename T, int C>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, const T* __restrict__ g,
                                          const float* __restrict__ ls,
                                          const float* __restrict__ lb, float eps, int r0,
                                          int M, T* ys, T* gs, float* st, int lane, int warp) {
  using S = Smem<T, C>;
  constexpr int VPL = C / 32;
  constexpr int NV = C * sizeof(T) / 16;  // 16-byte vectors in a row
  for (int r = warp; r < S::BM; r += NWARPS) {
    const int row = r0 + r;
    T* yd = ys + r * S::LDC;
    uint4* gd = reinterpret_cast<uint4*>(gs + r * S::LDC);
    if (row < M) {
      const T* xr = x + size_t(row) * C;
      float v[VPL];
      float s = 0.0f, ss = 0.0f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        v[i] = to_f(xr[lane + 32 * i]);
        s += v[i];
        ss += v[i] * v[i];
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mean = s / float(C);
      const float rs = rsqrtf(fmaxf(ss / float(C) - mean * mean, 0.0f) + eps);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        yd[c] = from_f<T>((v[i] - mean) * rs * ls[c] + lb[c]);
      }
      const uint4* gr = reinterpret_cast<const uint4*>(g + size_t(row) * C);
      for (int i = lane; i < NV; i += 32) gd[i] = gr[i];
      if (st != nullptr && lane == 0) {
        st[2 * r] = mean;
        st[2 * r + 1] = rs;
      }
    } else {
      for (int c = lane; c < C; c += 32) yd[c] = from_f<T>(0.0f);
      for (int i = lane; i < NV; i += 32) gd[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// For the F chunk staged in w1s/w2s (FC rows of w1^T and w2): h = round_T(y .
// w1^T + b1) and p = g . w2^T over the block's BM rows; emit(row, col, a, dh)
// with a = round_T(gelu(h)) and dh = round_T(p * gelu'(h)).
template <typename T, int C, typename Emit>
__device__ __forceinline__ void recompute_chunk(const T* ys, const T* gs, const T* w1s,
                                                const T* w2s, const float* __restrict__ b1c,
                                                int lane, int warp, Emit emit) {
  using S = Smem<T, C>;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int mt = warp & 3, nh = warp >> 2, gid = lane >> 2, tig = lane & 3;
    float h[2][4] = {}, p[2][4] = {};
    warp_mma<2, C, false>(h, ys + mt * 16 * S::LDC, S::LDC, w1s + nh * 16 * S::LDC, S::LDC,
                          lane);
    warp_mma<2, C, false>(p, gs + mt * 16 * S::LDC, S::LDC, w2s + nh * 16 * S::LDC, S::LDC,
                          lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + gid + (e >> 1) * 8;
        const int col = nh * 16 + nt * 8 + tig * 2 + (e & 1);
        const float hv = round_to<T>(h[nt][e] + b1c[col]);
        emit(row, col, from_f<T>(gelu(hv)), from_f<T>(p[nt][e] * gelu_grad(hv)));
      }
  } else {
    constexpr int RI = S::BM / NWARPS;
    float h[RI] = {}, p[RI] = {};
    const float* w1r = reinterpret_cast<const float*>(w1s) + lane * S::LDC;
    const float* w2r = reinterpret_cast<const float*>(w2s) + lane * S::LDC;
    const float* yf = reinterpret_cast<const float*>(ys);
    const float* gf = reinterpret_cast<const float*>(gs);
    for (int k = 0; k < C; k += 4) {
      const float4 wa = *reinterpret_cast<const float4*>(w1r + k);
      const float4 wb = *reinterpret_cast<const float4*>(w2r + k);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int o = (warp + NWARPS * i) * S::LDC + k;
        const float4 y = *reinterpret_cast<const float4*>(yf + o);
        const float4 gg = *reinterpret_cast<const float4*>(gf + o);
        h[i] = fmaf(y.x, wa.x, fmaf(y.y, wa.y, fmaf(y.z, wa.z, fmaf(y.w, wa.w, h[i]))));
        p[i] = fmaf(gg.x, wb.x, fmaf(gg.y, wb.y, fmaf(gg.z, wb.z, fmaf(gg.w, wb.w, p[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float hv = h[i] + b1c[lane];
      emit(warp + NWARPS * i, lane, gelu(hv), p[i] * gelu_grad(hv));
    }
  }
}

// ---------------------------------------------------------------- pass A
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_bwd_rows(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ls,
                const float* __restrict__ lb, const T* __restrict__ w1,  // [F, C]
                const float* __restrict__ b1, const T* __restrict__ w2,  // [F, C]
                T* __restrict__ dx, float* __restrict__ part,            // [gridDim.x][3][C]
                int M, int F, float eps) {
  using S = Smem<T, C>;
  constexpr int BM = S::BM;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int VPL = C / 32;
  constexpr int NT = C / 16;        // bf16: n-tiles in a warp's half of C
  constexpr int RI = BM / NWARPS;   // f32: rows per thread
  constexpr int CJ = C / 32;        // f32: columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + S::ROWS);
  T* w1s = reinterpret_cast<T*>(smem + 2 * S::ROWS);
  T* w2s = reinterpret_cast<T*>(smem + 2 * S::ROWS + S::W);
  T* dhs = reinterpret_cast<T*>(smem + 2 * S::ROWS + 2 * S::W);
  float* st = reinterpret_cast<float*>(smem + 2 * S::ROWS + 2 * S::W + S::DH);
  float* dys = reinterpret_cast<float*>(smem);                // [BM][C] over ys, gs
  float* colp = reinterpret_cast<float*>(smem + 2 * S::ROWS);  // [NWARPS][3][C] at the end
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;  // bf16 warp tiles of dy
  const int nrb = (M + BM - 1) / BM;

  float pls[VPL], plb[VPL], pb2[VPL];  // this warp's column sums over its rows
#pragma unroll
  for (int i = 0; i < VPL; ++i) pls[i] = plb[i] = pb2[i] = 0.0f;

  for (int rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    const int r0 = rb * BM;
    __syncthreads();  // the previous row block's epilogue is done with dys and st
    load_rows<T, C>(x, g, ls, lb, eps, r0, M, ys, gs, st, lane, warp);

    float acc[BF16 ? NT : RI][BF16 ? 4 : CJ];
#pragma unroll
    for (int i = 0; i < (BF16 ? NT : RI); ++i)
#pragma unroll
      for (int j = 0; j < (BF16 ? 4 : CJ); ++j) acc[i][j] = 0.0f;

    for (int f0 = 0; f0 < F; f0 += FC) {
      __syncthreads();  // rows loaded; the previous chunk's reads are done
      copy_tile_async(w1s, S::LDC, w1 + size_t(f0) * C, C, FC, C);
      copy_tile_async(w2s, S::LDC, w2 + size_t(f0) * C, C, FC, C);
      cp_async_wait_all();
      __syncthreads();
      recompute_chunk<T, C>(ys, gs, w1s, w2s, b1 + f0, lane, warp,
                            [&](int row, int col, T, T dh) { dhs[row * S::LDH + col] = dh; });
      __syncthreads();
      // dy += dh . w1_chunk  (w1s[f][c] is the [k][n] tile)
      if constexpr (BF16) {
#pragma unroll
        for (int k0 = 0; k0 < FC; k0 += 16) {
          const __nv_bfloat16* pa = dhs + (mt * 16 + gid) * S::LDH + k0 + tig * 2;
          const __nv_bfloat16* pb = pa + 8 * S::LDH;
          const uint32_t af[4] = {ld32(pa), ld32(pb), ld32(pa + 8), ld32(pb + 8)};
          const __nv_bfloat16* bt =
              w1s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LDC + nh * (C / 2) +
              (lane >> 4) * 8;
#pragma unroll
          for (int np = 0; np < NT; np += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, bt + np * 8);
            mma_16816(acc[np], af, b[0], b[1]);
            mma_16816(acc[np + 1], af, b[2], b[3]);
          }
        }
      } else {
        const float* dh = reinterpret_cast<const float*>(dhs);
        const float* w = reinterpret_cast<const float*>(w1s);
#pragma unroll 2
        for (int f = 0; f < FC; f += 4) {
          float4 d[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            d[i] = *reinterpret_cast<const float4*>(dh + (warp + NWARPS * i) * S::LDH + f);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              const float wv = w[(f + q) * S::LDC + lane + 32 * j];
#pragma unroll
              for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(comp(d[i], q), wv, acc[i][j]);
            }
        }
      }
    }
    __syncthreads();  // every read of ys and gs is done: dy goes over them
    if constexpr (BF16) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = mt * 16 + gid + hf * 8;
          const int col = nh * (C / 2) + nt * 8 + tig * 2;
          *reinterpret_cast<float2*>(dys + row * C + col) =
              make_float2(acc[nt][hf * 2], acc[nt][hf * 2 + 1]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dys[(warp + NWARPS * i) * C + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();

    // LayerNorm backward and dx, a warp per row; column partials
    for (int r = warp; r < BM; r += NWARPS) {
      const int row = r0 + r;
      if (row >= M) break;
      const float mean = st[2 * r], rs = st[2 * r + 1];
      const T* xr = x + size_t(row) * C;
      const T* gr = g + size_t(row) * C;
      float xh[VPL], dxh[VPL], gv[VPL];
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        xh[i] = (to_f(xr[c]) - mean) * rs;
        gv[i] = to_f(gr[c]);
        const float dy = dys[r * C + c];
        pls[i] += dy * xh[i];
        plb[i] += dy;
        pb2[i] += gv[i];
        dxh[i] = dy * ls[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float m1 = s1 / float(C), m2 = s2 / float(C);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float dl = rs * (dxh[i] - m1 - xh[i] * m2);
        dx[size_t(row) * C + lane + 32 * i] = from_f<T>(gv[i] + round_to<T>(dl));
      }
    }
  }
  __syncthreads();  // the weight chunks are no longer read: partials go over them
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    colp[(warp * 3 + 0) * C + c] = pls[i];
    colp[(warp * 3 + 1) * C + c] = plb[i];
    colp[(warp * 3 + 2) * C + c] = pb2[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += NTHREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += colp[w * 3 * C + e];
    part[size_t(blockIdx.x) * 3 * C + e] = s;
  }
}

// ---------------------------------------------------------------- pass B
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_bwd_weights(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ ls, const float* __restrict__ lb,
                   const T* __restrict__ w1,  // [F, C]
                   const float* __restrict__ b1, const T* __restrict__ w2,  // [F, C]
                   float* __restrict__ part,  // [gridDim.y][2 F C + F]
                   int M, int F, int rows_per, float eps) {
  using S = Smem<T, C>;
  constexpr int BM = S::BM;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int NQ = C / 32;  // bf16: n-tiles in a warp's quarter of C; f32: columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + S::ROWS);
  T* w1s = reinterpret_cast<T*>(smem + 2 * S::ROWS);
  T* w2s = reinterpret_cast<T*>(smem + 2 * S::ROWS + S::W);
  T* at = reinterpret_cast<T*>(smem + 2 * S::ROWS + 2 * S::W);
  T* dht = reinterpret_cast<T*>(smem + 2 * S::ROWS + 2 * S::W + S::TR);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int f0 = blockIdx.x * FC;
  const int rbeg = blockIdx.y * rows_per;
  const int rend = min(M, rbeg + rows_per);

  copy_tile_async(w1s, S::LDC, w1 + size_t(f0) * C, C, FC, C);
  copy_tile_async(w2s, S::LDC, w2 + size_t(f0) * C, C, FC, C);

  float acc1[BF16 ? NQ : 4][BF16 ? 4 : NQ], acc2[BF16 ? NQ : 4][BF16 ? 4 : NQ];
#pragma unroll
  for (int i = 0; i < (BF16 ? NQ : 4); ++i)
#pragma unroll
    for (int j = 0; j < (BF16 ? 4 : NQ); ++j) acc1[i][j] = acc2[i][j] = 0.0f;
  float db1 = 0.0f;
  const int mt = warp & 1, cq = warp >> 1;  // bf16 warp tiles of the [FC][C] sums

  for (int r0 = rbeg; r0 < rend; r0 += BM) {
    __syncthreads();  // the previous rows' reads of ys, gs, at, dht are done
    load_rows<T, C>(x, g, ls, lb, eps, r0, M, ys, gs, nullptr, lane, warp);
    cp_async_wait_all();
    __syncthreads();
    recompute_chunk<T, C>(ys, gs, w1s, w2s, b1 + f0, lane, warp,
                          [&](int row, int col, T a, T dh) {
                            at[col * S::LDM + row] = a;
                            dht[col * S::LDM + row] = dh;
                          });
    __syncthreads();
    if (threadIdx.x < FC) {
      const T* d = dht + threadIdx.x * S::LDM;
      for (int m = 0; m < BM; ++m) db1 += to_f(d[m]);
    }
    // dw1^T[chunk] += dh^T . y,  dw2[chunk] += a^T . g  (contraction over rows)
    if constexpr (BF16) {
#pragma unroll
      for (int k0 = 0; k0 < BM; k0 += 16) {
        const int ao = (mt * 16 + gid) * S::LDM + k0 + tig * 2;
        const uint32_t ad[4] = {ld32(dht + ao), ld32(dht + ao + 8 * S::LDM), ld32(dht + ao + 8),
                                ld32(dht + ao + 8 * S::LDM + 8)};
        const uint32_t aa[4] = {ld32(at + ao), ld32(at + ao + 8 * S::LDM), ld32(at + ao + 8),
                                ld32(at + ao + 8 * S::LDM + 8)};
        const int bo = (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LDC + cq * (C / 4) +
                       (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NQ; np += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, ys + bo + np * 8);
          mma_16816(acc1[np], ad, b[0], b[1]);
          mma_16816(acc1[np + 1], ad, b[2], b[3]);
          ldsm_x4_trans(b, gs + bo + np * 8);
          mma_16816(acc2[np], aa, b[0], b[1]);
          mma_16816(acc2[np + 1], aa, b[2], b[3]);
        }
      }
    } else {
      const float* dh = reinterpret_cast<const float*>(dht);
      const float* af = reinterpret_cast<const float*>(at);
      const float* yf = reinterpret_cast<const float*>(ys);
      const float* gf = reinterpret_cast<const float*>(gs);
#pragma unroll 2
      for (int m = 0; m < BM; m += 4) {
        float4 d[4], a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i] = *reinterpret_cast<const float4*>(dh + (warp + NWARPS * i) * S::LDM + m);
          a[i] = *reinterpret_cast<const float4*>(af + (warp + NWARPS * i) * S::LDM + m);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int o = (m + q) * S::LDC + lane + 32 * j;
            const float yv = yf[o], gv = gf[o];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc1[i][j] = fmaf(comp(d[i], q), yv, acc1[i][j]);
              acc2[i][j] = fmaf(comp(a[i], q), gv, acc2[i][j]);
            }
          }
      }
    }
  }

  cp_async_wait_all();  // (a split always has rows: a no-op)
  float* pw = part + size_t(blockIdx.y) * (2 * size_t(F) * C + F);
  float* pw1 = pw + size_t(f0) * C;
  float* pw2 = pw + size_t(F) * C + size_t(f0) * C;
  if constexpr (BF16) {
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const size_t o = size_t(mt * 16 + gid + hf * 8) * C + cq * (C / 4) + nt * 8 + tig * 2;
        *reinterpret_cast<float2*>(pw1 + o) = make_float2(acc1[nt][hf * 2], acc1[nt][hf * 2 + 1]);
        *reinterpret_cast<float2*>(pw2 + o) = make_float2(acc2[nt][hf * 2], acc2[nt][hf * 2 + 1]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const size_t o = size_t(warp + NWARPS * i) * C + lane + 32 * j;
        pw1[o] = acc1[i][j];
        pw2[o] = acc2[i][j];
      }
  }
  if (threadIdx.x < FC) pw[2 * size_t(F) * C + f0 + threadIdx.x] = db1;
}

// ---------------------------------------------------------------- reduction
// ow[e] = sum over the nsplit weight partials (e < nw), ov[v] = sum over the
// nblk row-pass partials, each in index order.
__global__ void ln_mlp_bwd_reduce(const float* __restrict__ pw, int nsplit, int nw,
                                  const float* __restrict__ pv, int nblk, int nv,
                                  float* __restrict__ ow, float* __restrict__ ov) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < nw) {
    float s = 0.0f;
    for (int k = 0; k < nsplit; ++k) s += pw[size_t(k) * nw + e];
    ow[e] = s;
  } else if (e < nw + nv) {
    const int v = e - nw;
    float s = 0.0f;
    for (int k = 0; k < nblk; ++k) s += pv[size_t(k) * nv + v];
    ov[v] = s;
  }
}

struct Plan {
  int ga;        // pass A blocks
  int nsplit;    // pass B row splits
  int rows_per;  // rows of a split (a multiple of BM)
  long long pv, pw;  // partial floats of each pass
};

template <typename T>
Plan plan(int M, int C, int F) {
  constexpr int BM = Tile<T>::BM;
  const int nrb = (M + BM - 1) / BM;
  const int nchunk = F / FC;
  Plan p;
  p.ga = nrb < GRID_A ? nrb : GRID_A;
  // at most TARGET_B blocks: blocks past it would make a last wave that
  // runs nearly empty (288 blocks at one an SM fill 73% of three waves)
  int s0 = TARGET_B / nchunk;
  s0 = s0 < nrb ? s0 : nrb;
  s0 = s0 > 0 ? s0 : 1;
  const int rbs = (nrb + s0 - 1) / s0;
  p.nsplit = (nrb + rbs - 1) / rbs;
  p.rows_per = rbs * BM;
  p.pv = 3LL * C * p.ga;
  p.pw = (2LL * F * C + F) * p.nsplit;
  return p;
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* g, const float* ls, const float* lb,
                   const void* w1, const float* b1, const void* w2, void* dx, float* ow,
                   float* ov, int M, int F, float eps, float* ws, cudaStream_t stream) {
  using S = Smem<T, C>;
  auto ka = ln_mlp_bwd_rows<T, C>;
  auto kb = ln_mlp_bwd_weights<T, C>;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(ka), S::A_TOTAL);
  if (e != cudaSuccess) return e;
  e = set_smem(reinterpret_cast<const void*>(kb), S::B_TOTAL);
  if (e != cudaSuccess) return e;
  const Plan p = plan<T>(M, C, F);
  float* pv = ws;
  float* pw = ws + p.pv;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  ka<<<p.ga, NTHREADS, S::A_TOTAL, stream>>>(xt, gt, ls, lb, w1t, b1, w2t, static_cast<T*>(dx),
                                             pv, M, F, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kb<<<dim3(F / FC, p.nsplit), NTHREADS, S::B_TOTAL, stream>>>(xt, gt, ls, lb, w1t, b1, w2t, pw,
                                                               M, F, p.rows_per, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nw = 2 * F * C + F, nv = 3 * C;
  ln_mlp_bwd_reduce<<<(nw + nv + 255) / 256, 256, 0, stream>>>(pw, p.nsplit, nw, pv, p.ga, nv,
                                                               ow, ov);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, const void* ls, const void* lb, const void* w1,
             const void* b1, const void* w2, void* dx, void* ow, void* ov, int M, int C, int F,
             float eps, void* ws, void* stream) {
  if (F <= 0 || F % FC != 0 || M <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o1 = static_cast<float*>(ow);
  float* o2 = static_cast<float*>(ov);
  float* w = static_cast<float*>(ws);
  switch (C) {
    case 256:
      return launch<T, 256>(x, g, f(ls), f(lb), w1, f(b1), w2, dx, o1, o2, M, F, eps, w, s);
    case 384:
      return launch<T, 384>(x, g, f(ls), f(lb), w1, f(b1), w2, dx, o1, o2, M, F, eps, w, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of scratch the entries below need for (M, C, F) in float32 (bf16 = 0)
// or bf16 (bf16 = 1): the two passes' partial sums.
long long fused_ln_mlp_bwd_workspace(int M, int C, int F, int bf16) {
  if (M <= 0 || F <= 0 || F % FC != 0) return 0;
  const Plan p = bf16 ? plan<__nv_bfloat16>(M, C, F) : plan<float>(M, C, F);
  return p.pv + p.pw;
}

// Each entry launches three kernels on `stream` and returns cudaGetLastError()
// (0 = ok).  x, g, dx [M, C] and w1 (= w1^T of the forward, i.e. [F, C]), w2
// [F, C] in T; ls, lb, b1 float32.  ow (float32, 2 F C + F): dw1^T [F, C], dw2
// [F, C], db1 [F]; ov (float32, 3 C): dls, dlb, db2.  ws: the workspace.
int fused_ln_mlp_bwd_f32(const void* x, const void* g, const void* ls, const void* lb,
                         const void* w1, const void* b1, const void* w2, void* dx, void* ow,
                         void* ov, int M, int C, int F, float eps, void* ws, void* stream) {
  return dispatch<float>(x, g, ls, lb, w1, b1, w2, dx, ow, ov, M, C, F, eps, ws, stream);
}

int fused_ln_mlp_bwd_bf16(const void* x, const void* g, const void* ls, const void* lb,
                          const void* w1, const void* b1, const void* w2, void* dx, void* ow,
                          void* ov, int M, int C, int F, float eps, void* ws, void* stream) {
  return dispatch<__nv_bfloat16>(x, g, ls, lb, w1, b1, w2, dx, ow, ov, M, C, F, eps, ws,
                                 stream);
}

const char* fused_ln_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
