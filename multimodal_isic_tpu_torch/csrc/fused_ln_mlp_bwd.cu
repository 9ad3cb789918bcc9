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
//
// What bounds it on the card.  The function's products are 10 M C F
// operations (h, g.w2^T, a^T g, y^T dh, dh.w1^T) against ~4 M C + 4 C F
// values moved: far above the ridge, so operations bound it.  At bs 16
// float32 they run on the CUDA cores (TF32 stays off): stage 1 (M 50176,
// C 256, F 1024) and stage 2 (M 12544, C 384, F 1536); bf16 on the tensor
// cores.
//
// The first design (two passes that both recomputed h and g.w2^T, 14 M C F
// operations, FMA loops reading a shared word for every 2-4 FMAs, one 138-208
// KB block an SM, weight chunks waited for without double buffering) ran at
// 20% of the bound in float32, slower than its plain version.  This design
// does the function's 10 M C F and nothing more: the [M, F] intermediates
// round_T(a) and round_T(dh) go to a workspace once (2 M F values, written
// once, read twice).  Measured on an H100 at stage 1 bs 16 f32, the act
// GEMMs that a recompute would repeat take ~1.4 ms a call, the workspace
// traffic they save ~0.4 ms, so the workspace wins; every product is then a
// GEMM of one shape:
//  (L) ln rows: a warp a row; mean and rsqrt(var + eps) to `stats`, y to the
//      workspace.
//  (H) act tiles [128 rows x 128 F]: h = y . w1 and p = g . w2^T side by
//      side (two accumulators, K = C), epilogue a = round_T(gelu(h + b1))
//      and dh = round_T(p * gelu'(h)) to the workspace (bf16: through shared
//      memory, so the stores are 16-byte row pieces).
//  (D) dy tiles [128 x 128]: dy = dh . w1^T (K = F), float32 to the
//      workspace.
//  (N) LayerNorm backward rows (a warp a row, a persistent grid): dx and the
//      per-block column partials of dy * xhat, dy and g.
//  (W) weight tiles [128 F x 128 C] over one of nsplit row ranges (split K):
//      dw1^T = dh^T . y or dw2 = a^T . g, and db1 = sum dh in the dw1^T
//      blocks of the first C tile; one partial per split.
//  (R) one thread per output element sums the partials in index order, so
//      the sums are the same bits on every run (no float atomics).
// Each GEMM streams its operand tiles through a 3-stage ring of 16-byte
// cp.async copies (one __syncthreads a k-tile, the next tiles in flight
// while one is used), the operands in shared memory as they are stored.
// float32: 256 threads, each an 8 x 8 register micro-tile (of each product
// in H) over k-steps of 4, fed by float4 shared reads -- of 4 rows a k where
// the contraction runs down the rows, of 4 k a row where it runs along them
// -- 256 FMAs for 16 float4 reads a k-step.  bf16: 8 warps of mma.sync
// m16n8k16 with 64 x 32 warp tiles, fragments through ldmatrix (.trans where
// the contraction runs down the rows).  Rows are padded so the reads are
// bank-conflict free; M and F may be ragged (zero-filled loads, masked
// stores).

#include "convmae_common.cuh"

namespace {

using namespace convmae;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;       // GEMM ring depth
constexpr int SPLIT_ROWS = 32;  // the weight GEMMs' row splits are multiples of it
constexpr int ACT_BN = 128;     // F columns of an act tile
constexpr int DY_BN = 128;      // C columns of a dy tile

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int BK = 16, PAD = 4; };
template <> struct Cfg<bf16> { static constexpr int BK = 32, PAD = 8; };

// a = gelu(h) (convmae::gelu's expression) and d = gelu'(h) = Phi(h) + h phi(h)
// in float32, from one erff.
__device__ __forceinline__ void gelu_and_grad(float h, float& a, float& d) {
  const float e = erff(h * 0.70710678118654752f);
  a = 0.5f * h * (1.0f + e);
  d = 0.5f * (1.0f + e) + h * (expf(-0.5f * h * h) * 0.3989422804014327f);
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols of T from global (row stride ld, element (r, c) valid while
// r < rlim and c < clim; clim a multiple of 16 bytes) into shared (row
// stride sld), 16-byte copies, the rest zero-filled.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_rows(T* dst, int sld, const T* __restrict__ src, size_t ld,
                                          int rlim, int clim) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER = COLS / VEC;
  static_assert((ROWS * PER) % NTHREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * PER / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS;
    const int r = i / PER, c = (i - r * PER) * VEC;
    const bool valid = r < rlim && c < clim;
    cp16(dst + r * sld + c, valid ? src + size_t(r) * ld + c : src, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ------------------------------------------------------------------ GEMM
// One operand pair of a GEMM tile: C[x, n] += sum_k A(x, k) B(k, n).
// A is stored [x][k] (AK false: row stride lda) or [k][x] (AK true); B is
// always stored [k][n] (row stride ldb).  xlim, nlim, klim bound the valid
// elements (counted from the tile's corner).
template <typename T>
struct Operand {
  const T* a;
  size_t lda;
  const T* b;
  size_t ldb;
};

// A block tile BM x BN of NOPS products over K, 256 threads, a STAGES-deep
// cp.async ring.  float32: acc[NOPS][TM][TN] per thread, rows ty*4 + i (+ BM/2
// for i >= 4), columns tx*4 + j (+ BN/2 for j >= 4), ty = tid / 16, tx =
// tid % 16.  bf16: warps 2 (x) x 4 (n), acc[NOPS][MT][NT][4] in the mma.sync
// accumulator layout.
template <typename T, int BM, int BN, int NOPS, bool AK>
struct Gemm {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int BK = Cfg<T>::BK, PAD = Cfg<T>::PAD;
  // shared memory keeps A as it is stored: [k][x] (AK) or [x][k]
  static constexpr int A_LD = AK ? BM + PAD : BK + PAD;
  static constexpr int A_ELEMS = (AK ? BK : BM) * A_LD;
  static constexpr int B_LD = BN + PAD;
  static constexpr int B_ELEMS = BK * B_LD;
  static constexpr int STAGE = NOPS * (A_ELEMS + B_ELEMS);
  static constexpr size_t SMEM = size_t(STAGES) * STAGE * sizeof(T);
  // float32 micro-tile
  static constexpr int TM = BM / 16, TN = BN / 16;
  // bf16 warp tile
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(F32 ? (TM == 8 && (TN == 8 || TN == 4)) : (MT >= 1 && NT % 2 == 0), "tile");
  static constexpr int A1 = F32 ? TM : MT, A2 = F32 ? TN : NT, A3 = F32 ? 1 : 4;
  float acc[NOPS][A1][A2][A3];

  __device__ __forceinline__ T* a_tile(T* smem, int stage, int op) const {
    return smem + stage * STAGE + op * (A_ELEMS + B_ELEMS);
  }
  __device__ __forceinline__ T* b_tile(T* smem, int stage, int op) const {
    return a_tile(smem, stage, op) + A_ELEMS;
  }

  __device__ __forceinline__ void load(T* smem, int stage, const Operand<T> (&ops)[NOPS], int k0,
                                       int xlim, int nlim, int klim) const {
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      T* as = a_tile(smem, stage, o);
      if constexpr (AK) {
        load_rows<T, BK, BM>(as, A_LD, ops[o].a + size_t(k0) * ops[o].lda, ops[o].lda,
                             klim - k0, xlim);
      } else {
        load_rows<T, BM, BK>(as, A_LD, ops[o].a + k0, ops[o].lda, xlim, klim - k0);
      }
      load_rows<T, BK, BN>(b_tile(smem, stage, o), B_LD, ops[o].b + size_t(k0) * ops[o].ldb,
                           ops[o].ldb, klim - k0, nlim);
    }
  }

  __device__ __forceinline__ void compute(T* smem, int stage) {
    if constexpr (F32) {
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
      for (int o = 0; o < NOPS; ++o) {
        const float* as = a_tile(smem, stage, o);
        const float* bs = b_tile(smem, stage, o);
#pragma unroll
        for (int k = 0; k < BK; k += 4) {
          // A: [k][x], a float4 of 4 rows a k; [x][k], a float4 of 4 k a row
          float4 a4[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int x = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
            if constexpr (AK) {
              if ((i & 3) == 0) {
                const float4 c0 = *reinterpret_cast<const float4*>(as + k * A_LD + x);
                const float4 c1 = *reinterpret_cast<const float4*>(as + (k + 1) * A_LD + x);
                const float4 c2 = *reinterpret_cast<const float4*>(as + (k + 2) * A_LD + x);
                const float4 c3 = *reinterpret_cast<const float4*>(as + (k + 3) * A_LD + x);
                a4[i] = make_float4(c0.x, c1.x, c2.x, c3.x);
                a4[i + 1] = make_float4(c0.y, c1.y, c2.y, c3.y);
                a4[i + 2] = make_float4(c0.z, c1.z, c2.z, c3.z);
                a4[i + 3] = make_float4(c0.w, c1.w, c2.w, c3.w);
              }
            } else {
              a4[i] = *reinterpret_cast<const float4*>(as + x * A_LD + k);
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 b0 = *reinterpret_cast<const float4*>(bs + (k + kk) * B_LD + tx * 4);
            float bv[TN];
            bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
            if constexpr (TN == 8) {
              const float4 b1 =
                  *reinterpret_cast<const float4*>(bs + (k + kk) * B_LD + BN / 2 + tx * 4);
              bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float av = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[o][i][j][0] = fmaf(av, bv[j], acc[o][i][j][0]);
            }
          }
        }
      }
    } else {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int wx = (warp & 1) * WM, wn = (warp >> 1) * WN;
#pragma unroll
      for (int o = 0; o < NOPS; ++o) {
        const bf16* as = a_tile(smem, stage, o);
        const bf16* bs = b_tile(smem, stage, o);
#pragma unroll
        for (int k0 = 0; k0 < BK; k0 += 16) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int x0 = wx + mt * 16;
            if constexpr (AK) {  // [k][x]: matrices (x 0-7 | 8-15) x (k 0-7 | 8-15)
              const int q = lane >> 3;
              ldsm_x4_trans(af[mt], as + (k0 + (lane & 7) + (q >> 1) * 8) * A_LD + x0 +
                                        (q & 1) * 8);
            } else {  // [x][k]
              ldsm_x4(af[mt], as + (x0 + (lane & 15)) * A_LD + k0 + (lane >> 4) * 8);
            }
          }
#pragma unroll
          for (int np = 0; np < NT; np += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, bs + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * B_LD + wn +
                                 np * 8 + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(acc[o][mt][np], af[mt], b[0], b[1]);
              mma_16816(acc[o][mt][np + 1], af[mt], b[2], b[3]);
            }
          }
        }
      }
    }
  }

  // acc = sum over k in [0, klim) of the NOPS products of the tile; hook(stage)
  // runs on each k-tile's shared stage after the products have read it.
  template <typename Hook>
  __device__ __forceinline__ void run(T* smem, const Operand<T> (&ops)[NOPS], int xlim, int nlim,
                                      int klim, Hook hook) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
#pragma unroll
      for (int i = 0; i < A1; ++i)
#pragma unroll
        for (int j = 0; j < A2; ++j)
#pragma unroll
          for (int e = 0; e < A3; ++e) acc[o][i][j][e] = 0.0f;
    const int kt = (klim + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kt) load(smem, s, ops, s * BK, xlim, nlim, klim);
      cp_commit();
    }
    for (int t = 0; t < kt; ++t) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile t landed; every thread is done with tile t - 1
      const int nxt = t + STAGES - 1;
      if (nxt < kt) load(smem, nxt % STAGES, ops, nxt * BK, xlim, nlim, klim);
      cp_commit();
      compute(smem, t % STAGES);
      hook(t % STAGES);
    }
    cp_wait<0>();
  }

  // fn(op values[NOPS] for NV consecutive columns, x, n, NV) over the
  // thread's accumulator: NV = 4 (float32) or 2 (bf16) columns at a time.
  template <typename Fn>
  __device__ __forceinline__ void epilogue(Fn fn) const {
    if constexpr (F32) {
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j0 = 0; j0 < TN; j0 += 4) {
          const int x = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
          const int n = (j0 < 4 ? 0 : BN / 2) + tx * 4;
          float v[NOPS][4];
#pragma unroll
          for (int o = 0; o < NOPS; ++o)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[o][j] = acc[o][i][j0 + j][0];
          fn(v, x, n);
        }
    } else {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int gid = lane >> 2, tig = lane & 3;
      const int wx = (warp & 1) * WM, wn = (warp >> 1) * WN;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float v[NOPS][2];
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
              v[o][0] = acc[o][mt][nt][hf * 2];
              v[o][1] = acc[o][mt][nt][hf * 2 + 1];
            }
            fn(v, wx + mt * 16 + gid + hf * 8, wn + nt * 8 + tig * 2);
          }
    }
  }
};

template <typename T, int NV> struct Vec;
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<float, 2> {
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<bf16, 2> {
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

// ----------------------------------------------------------- (L) ln rows
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_bwd_ln(const T* __restrict__ x, const float* __restrict__ ls, const float* __restrict__ lb,
              T* __restrict__ y, float* __restrict__ stats, int M, float eps) {
  constexpr int VPL = C / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (row >= M) return;
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
    y[size_t(row) * C + c] = from_f<T>((v[i] - mean) * rs * ls[c] + lb[c]);
  }
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rs;
  }
}

// ------------------------------------------------------- (H) act tiles
template <typename T>
using ActGemm = Gemm<T, 128, ACT_BN, 2, false>;

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
ln_mlp_bwd_act(const T* __restrict__ y, const T* __restrict__ g, const T* __restrict__ w1,
               const T* __restrict__ w2t, const float* __restrict__ b1, T* __restrict__ wa,
               T* __restrict__ wdh, int M, int C, int F) {
  using G = ActGemm<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.x * 128, f0 = blockIdx.y * ACT_BN;
  const Operand<T> ops[2] = {{y + size_t(m0) * C, size_t(C), w1 + f0, size_t(F)},
                             {g + size_t(m0) * C, size_t(C), w2t + f0, size_t(F)}};
  G gm;
  gm.run(smem, ops, M - m0, F - f0, C, [](int) {});
  // a = round_T(gelu(h)), dh = round_T(p * gelu'(h)) at (row xr, column n)
  const auto act = [&](const float (&v)[2][4], int n, int nv, float* a, float* dh) {
#pragma unroll
    for (int j = 0; j < nv; ++j) {
      const float hv = round_to<T>(v[0][j] + b1[f0 + n + j]);
      gelu_and_grad(hv, a[j], dh[j]);
      dh[j] *= v[1][j];
    }
  };
  if constexpr (std::is_same_v<T, float>) {
    gm.epilogue([&](const auto& v, int xr, int n) {
      const int m = m0 + xr, f = f0 + n;
      if (m >= M || f >= F) return;
      float a[4], dh[4];
      act(v, n, 4, a, dh);
      Vec<float, 4>::store(wa + size_t(m) * F + f, a);
      Vec<float, 4>::store(wdh + size_t(m) * F + f, dh);
    });
  } else {
    // bf16: the accumulator layout gives 4-byte pieces of 8 rows a warp
    // store, so the tile goes through shared memory (over the ring) and out
    // as 16-byte row pieces
    constexpr int LDT = ACT_BN + 8;
    static_assert(2 * 128 * LDT <= STAGES * G::STAGE, "the tile fits the ring");
    bf16* sa = smem;
    bf16* sd = smem + 128 * LDT;
    __syncthreads();  // every warp is done with the ring
    gm.epilogue([&](const auto& v, int xr, int n) {
      if (f0 + n >= F) return;
      float w[2][4] = {{v[0][0], v[0][1]}, {v[1][0], v[1][1]}};
      float a[2], dh[2];
      act(w, n, 2, a, dh);
      Vec<bf16, 2>::store(sa + xr * LDT + n, a);
      Vec<bf16, 2>::store(sd + xr * LDT + n, dh);
    });
    __syncthreads();
    constexpr int PER = ACT_BN / 8;  // 16-byte pieces a row
    for (int i = threadIdx.x; i < 128 * PER; i += NTHREADS) {
      const int r = i / PER, c = (i - r * PER) * 8;
      const size_t o = size_t(m0 + r) * F + f0 + c;
      if (m0 + r < M && f0 + c < F) {
        *reinterpret_cast<uint4*>(wa + o) = *reinterpret_cast<const uint4*>(sa + r * LDT + c);
        *reinterpret_cast<uint4*>(wdh + o) = *reinterpret_cast<const uint4*>(sd + r * LDT + c);
      }
    }
  }
}

// -------------------------------------------------------- (D) dy tiles
template <typename T>
using DyGemm = Gemm<T, 128, DY_BN, 1, false>;

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
ln_mlp_bwd_dy(const T* __restrict__ wdh, const T* __restrict__ w1k, float* __restrict__ dy,
              int M, int C, int F) {
  using G = DyGemm<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.x * 128, c0 = blockIdx.y * DY_BN;
  const Operand<T> ops[1] = {{wdh + size_t(m0) * F, size_t(F), w1k + c0, size_t(C)}};
  G gm;
  gm.run(smem, ops, M - m0, C - c0, F, [](int) {});
  gm.epilogue([&](const auto& v, int xr, int n) {
    constexpr int NV = std::extent_v<std::remove_reference_t<decltype(v)>, 1>;
    const int m = m0 + xr;
    if (m < M) Vec<float, NV>::store(dy + size_t(m) * C + c0 + n, v[0]);
  });
}

// ---------------------------------------------- (N) LayerNorm backward rows
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_bwd_norm(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ls,
                const float* __restrict__ dy, const float* __restrict__ stats,
                T* __restrict__ dx, float* __restrict__ part, int M) {
  constexpr int VPL = C / 32;
  __shared__ float colp[NWARPS][3][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pls[VPL], plb[VPL], pb2[VPL];  // this warp's column sums over its rows
#pragma unroll
  for (int i = 0; i < VPL; ++i) pls[i] = plb[i] = pb2[i] = 0.0f;
  for (int row = blockIdx.x * NWARPS + warp; row < M; row += gridDim.x * NWARPS) {
    const float mean = stats[2 * row], rs = stats[2 * row + 1];
    const T* xr = x + size_t(row) * C;
    const T* gr = g + size_t(row) * C;
    const float* dr = dy + size_t(row) * C;
    float xh[VPL], dxh[VPL], gv[VPL];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xh[i] = (to_f(xr[c]) - mean) * rs;
      gv[i] = to_f(gr[c]);
      const float d = dr[c];
      pls[i] += d * xh[i];
      plb[i] += d;
      pb2[i] += gv[i];
      dxh[i] = d * ls[c];
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
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    colp[warp][0][c] = pls[i];
    colp[warp][1][c] = plb[i];
    colp[warp][2][c] = pb2[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += NTHREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += (&colp[w][0][0])[e];
    part[size_t(blockIdx.x) * 3 * C + e] = s;
  }
}

// --------------------------------------------------- (W) weight tiles
template <typename T>
using WGemm = Gemm<T, 128, 128, 1, true>;

// grid (F tiles, C tiles, 2 x nsplit): z even dw1^T = dh^T . y, z odd
// dw2 = a^T . g, over rows [split * rows_per, +rows_per); partials
// [nsplit][dw1^T F C | dw2 F C | db1 F].
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
ln_mlp_bwd_weights(const T* __restrict__ wdh, const T* __restrict__ wa, const T* __restrict__ y,
                   const T* __restrict__ g, float* __restrict__ part, int M, int C, int F,
                   int rows_per) {
  using G = WGemm<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int f0 = blockIdx.x * 128, c0 = blockIdx.y * 128;
  const int which = blockIdx.z & 1, split = blockIdx.z >> 1;
  const int r0 = split * rows_per;
  const int klim = min(rows_per, M - r0);
  const T* A = (which ? wa : wdh) + size_t(r0) * F + f0;
  const T* B = (which ? g : y) + size_t(r0) * C + c0;
  const Operand<T> ops[1] = {{A, size_t(F), B, size_t(C)}};
  const bool sum_db1 = which == 0 && blockIdx.y == 0;
  float db1 = 0.0f;  // thread t < 128: column f0 + t of dh over the split's rows
  G gm;
  gm.run(smem, ops, F - f0, C - c0, klim, [&](int stage) {
    if (sum_db1 && threadIdx.x < 128) {
      const T* as = gm.a_tile(smem, stage, 0);  // [k][f], zero past the rows
#pragma unroll
      for (int k = 0; k < G::BK; ++k) db1 += to_f(as[k * G::A_LD + threadIdx.x]);
    }
  });
  float* pw = part + size_t(split) * (2 * size_t(F) * C + F);
  float* out = pw + size_t(which) * F * C;
  gm.epilogue([&](const auto& v, int xr, int n) {
    constexpr int NV = std::extent_v<std::remove_reference_t<decltype(v)>, 1>;
    const int f = f0 + xr;
    if (f < F) Vec<float, NV>::store(out + size_t(f) * C + c0 + n, v[0]);
  });
  if (sum_db1 && threadIdx.x < 128 && f0 + int(threadIdx.x) < F)
    pw[2 * size_t(F) * C + f0 + threadIdx.x] = db1;
}

// ------------------------------------------------------------ (R) reduction
// ow[e] = sum over the nsplit weight partials (e < nw), ov[v] = sum over the
// nblk row partials, each in index order.
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

// ----------------------------------------------------------- launch plan
// The wrapper's choices (ops/fused_mlp.py::ln_mlp_bwd_plan), checked here.
struct Plan {
  int gn;        // LayerNorm-backward blocks (a persistent grid)
  int nsplit;    // weight-tile row splits
  int rows_per;  // rows of a split (a multiple of SPLIT_ROWS)
};

// The workspace's segments (ops/fused_mlp.py::ln_mlp_bwd_workspace): y,
// round(a) and round(dh) in T; dy [M, C], the row stats [M, 2] and the two
// partial-sum buffers ([gn, 3 C] and [nsplit, 2 F C + F]) in float32.
template <typename T>
struct Ws {
  T *y, *a, *dh;
  float *dy, *st, *pv, *pw;
};

template <typename T, int C>
cudaError_t launch(const T* x, const T* g, const float* ls, const float* lb, const T* w1,
                   const T* w1k, const T* w2t, const float* b1, T* dx, float* ow, float* ov,
                   int M, int F, float eps, const Ws<T>& w, const Plan& p, cudaStream_t stream) {
  T *y = w.y, *wa = w.a, *wdh = w.dh;
  float *dy = w.dy, *st = w.st, *pv = w.pv, *pw = w.pw;
  const auto kact = ln_mlp_bwd_act<T>;
  const auto kdy = ln_mlp_bwd_dy<T>;
  const auto kw = ln_mlp_bwd_weights<T>;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(kact), ActGemm<T>::SMEM);
  if (e == cudaSuccess) e = set_smem(reinterpret_cast<const void*>(kdy), DyGemm<T>::SMEM);
  if (e == cudaSuccess) e = set_smem(reinterpret_cast<const void*>(kw), WGemm<T>::SMEM);
  if (e != cudaSuccess) return e;
  const int mt = (M + 127) / 128;
  ln_mlp_bwd_ln<T, C><<<(M + NWARPS - 1) / NWARPS, NTHREADS, 0, stream>>>(x, ls, lb, y, st, M,
                                                                         eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kact<<<dim3(mt, (F + ACT_BN - 1) / ACT_BN), NTHREADS, ActGemm<T>::SMEM, stream>>>(
      y, g, w1, w2t, b1, wa, wdh, M, C, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kdy<<<dim3(mt, C / DY_BN), NTHREADS, DyGemm<T>::SMEM, stream>>>(wdh, w1k, dy, M, C, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ln_mlp_bwd_norm<T, C><<<p.gn, NTHREADS, 0, stream>>>(x, g, ls, dy, st, dx, pv, M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kw<<<dim3((F + 127) / 128, C / 128, 2 * p.nsplit), NTHREADS, WGemm<T>::SMEM, stream>>>(
      wdh, wa, y, g, pw, M, C, F, p.rows_per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int nw = 2 * F * C + F, nv = 3 * C;
  ln_mlp_bwd_reduce<<<(nw + nv + 255) / 256, 256, 0, stream>>>(pw, p.nsplit, nw, pv, p.gn, nv,
                                                               ow, ov);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, const void* ls, const void* lb, const void* w1,
             const void* w1k, const void* w2t, const void* b1, void* dx, void* ow, void* ov,
             int M, int C, int F, float eps, void* const* ws, int gn, int nsplit, int rows_per,
             void* stream) {
  if (F <= 0 || F % 32 != 0 || M <= 0 || gn < 1 || rows_per <= 0 ||
      rows_per % SPLIT_ROWS != 0 || nsplit != (M + rows_per - 1) / rows_per)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  T* d = static_cast<T*>(dx);
  float* o1 = static_cast<float*>(ow);
  float* o2 = static_cast<float*>(ov);
  const Ws<T> w{static_cast<T*>(ws[0]),     static_cast<T*>(ws[1]),     static_cast<T*>(ws[2]),
                static_cast<float*>(ws[3]), static_cast<float*>(ws[4]), static_cast<float*>(ws[5]),
                static_cast<float*>(ws[6])};
  const Plan p{gn, nsplit, rows_per};
  switch (C) {
    case 256:
      return launch<T, 256>(t(x), t(g), f(ls), f(lb), t(w1), t(w1k), t(w2t), f(b1), d, o1, o2,
                            M, F, eps, w, p, s);
    case 384:
      return launch<T, 384>(t(x), t(g), f(ls), f(lb), t(w1), t(w1k), t(w2t), f(b1), d, o1, o2,
                            M, F, eps, w, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches six kernels on `stream` and returns cudaGetLastError()
// (0 = ok).  x, g, dx [M, C]; w1 [C, F] and w1k = w1^T [F, C], w2t = w2^T
// [C, F], all in T; ls, lb, b1 float32.  ow (float32, 2 F C + F): dw1^T
// [F, C], dw2 [F, C], db1 [F]; ov (float32, 3 C): dls, dlb, db2.  ws: the
// seven workspace segments, in Ws's order, 16-byte aligned; gn, nsplit,
// rows_per: the launch plan (cudaErrorInvalidValue if it does not cover M).
int fused_ln_mlp_bwd_f32(const void* x, const void* g, const void* ls, const void* lb,
                         const void* w1, const void* w1k, const void* w2t, const void* b1,
                         void* dx, void* ow, void* ov, int M, int C, int F, float eps,
                         void* const* ws, int gn, int nsplit, int rows_per, void* stream) {
  return dispatch<float>(x, g, ls, lb, w1, w1k, w2t, b1, dx, ow, ov, M, C, F, eps, ws, gn, nsplit,
                         rows_per, stream);
}

int fused_ln_mlp_bwd_bf16(const void* x, const void* g, const void* ls, const void* lb,
                          const void* w1, const void* w1k, const void* w2t, const void* b1,
                          void* dx, void* ow, void* ov, int M, int C, int F, float eps,
                          void* const* ws, int gn, int nsplit, int rows_per, void* stream) {
  return dispatch<bf16>(x, g, ls, lb, w1, w1k, w2t, b1, dx, ow, ov, M, C, F, eps, ws, gn, nsplit,
                        rows_per, stream);
}

const char* fused_ln_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
