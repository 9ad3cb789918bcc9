// Non-causal softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/attention.py::flash_attention (_flash_kernel), forward:
//   out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
// with an online softmax over tiles of keys, so the [N, N] scores never
// exist.  q, k and v are read where they lie, in T (float or bf16) through
// arbitrary (batch, head, token) strides with D contiguous: the model hands
// over views of its [B, N, 3, H, D] qkv projection.  The result is rounded to
// T and written to a contiguous [B, N, H, D] tensor, the layout the output
// projection reads.
//
// What bounds it on the card.  ConvMAE's encoder at bs 128 bf16: [128, 12,
// 196, 64], 7.55 GFLOP of q.k^T and as many of p.v a layer against 154 MB of
// q/k/v/out.  The first design (one thread a query row, both products as
// float32 FMAs) ran at 13% of its CUDA-core bound and lost to SDPA: every
// float4 shared read fed 4 FMAs, qr[64] + acc[64] a thread capped occupancy,
// and N = 196 left 60 of 256 threads idle.
//
// Design.  A block is one (b, h) pair and W warps of queries (W from the
// wrapper: the fewest query blocks of at most 8 warps, so N = 196 runs as 2
// blocks of 7 warps and N = 49 as one block, and only whole warps past N
// idle).  K and V stream through a 2-stage ring of 64-key tiles in shared
// memory, filled with 16-byte cp.async copies (rows past N zero-filled), so
// the next tile lands while the current one is used.
//  bf16: a warp owns 16 query rows.  q.k^T runs on the tensor cores
//    (mma.sync m16n8k16, bf16 x bf16 products exact in float32, float32
//    sums) and the scores are scaled after the product; 1/sqrt(D) is a
//    power of two for D = 64, so that is the JAX model's q * (1/sqrt(D))
//    exactly, and for D = 32 it adds one float32 rounding (2^-24 relative)
//    per score.  The scores stay in registers in the accumulator layout,
//    which is the A-fragment layout of the next product: p (float32) is
//    split into bf16 hi = round(p) and lo = round(p - hi), and p.v runs as
//    two tensor-core products (hi.v + lo.v, exact products, float32 sums);
//    hi + lo carries p to 2^-17 relative, far inside a bf16 output's
//    rounding.  V's B fragments come through ldmatrix .trans.
//  float32 (TF32 stays off: the reference is full float32): a warp owns 8
//    query rows; lane (ty, tx) holds a 4 x 4 micro-tile of scores (queries
//    4 ty .. 4 ty + 3, keys tx + 16 i) and then a 4 x D/16 tile of the
//    output, so every float4 shared read feeds 4 FMAs (16 FMAs per two
//    float4 reads in q.k^T, 64 per eight in p.v); p goes through a small
//    per-warp shared tile to change hands.  q is scaled by 1/sqrt(D) in
//    shared memory before the product, as the JAX kernel does.
// Rows are padded (8 bf16 / 4 floats) so fragment and float4 reads are
// bank-conflict free.  No atomics: the same bits on every run.

#include "convmae_common.cuh"

namespace {

using namespace convmae;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;        // keys a ring stage
constexpr int STAGES = 2;     // ring depth
constexpr int MAX_WARPS = 8;  // warps a block

template <typename T> struct Rows;  // query rows a warp owns, row padding
template <> struct Rows<bf16> { static constexpr int WARP = 16, PAD = 8; };
template <> struct Rows<float> { static constexpr int WARP = 8, PAD = 4; };

// Shared memory of one block: the query tile, the K/V ring and (float32) the
// per-warp p tiles.  The wrapper passes its own count
// (ops/attention.py::attention_smem_bytes); a launch checks the two agree.
template <typename T>
constexpr size_t smem_bytes(int D, int warps) {
  const size_t ld = size_t(D + Rows<T>::PAD) * sizeof(T);
  const size_t qt = size_t(warps) * Rows<T>::WARP * ld;
  const size_t ring = size_t(STAGES) * 2 * KT * ld;
  const size_t pt =
      std::is_same_v<T, float> ? size_t(warps) * Rows<T>::WARP * (KT + 4) * sizeof(float) : 0;
  return qt + ring + pt;
}

// 16-byte copy global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a [N, D] operand (token stride sn) into shared
// (row stride ld elements), rows at or past N zero-filled.  All threads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int sn,
                                          int r0, int rows, int N) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * VEC;
    const bool valid = r0 + r < N;
    cp16(dst + r * ld + c, src + size_t(valid ? r0 + r : 0) * sn + c, valid);
  }
}

// Four 8x8 bf16 tiles, transposed: an mma.sync B fragment of a [k][n]
// row-major tile (thread t addresses row t & 7 of tile t >> 3).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, N;
  int qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn;
  float scale;
};

// ------------------------------------------------------------------- bf16
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
flash_attention_bf16_kernel(const Args a) {
  constexpr int LD = D + Rows<bf16>::PAD;
  constexpr int NB = KT / 8;   // n8 score blocks a tile
  constexpr int KD = D / 16;   // k16 steps of q.k^T
  constexpr int ND = D / 8;    // n8 output blocks
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [nw * 16][LD]
  bf16* ring = qs + nw * 16 * LD;            // [STAGES][K, V][KT][LD]
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * nw * 16;
  const int wr0 = q0 + warp * 16;  // this warp's first query row
  const bool active = wr0 < N;     // warp-uniform
  const bf16* qb = static_cast<const bf16*>(a.q) + size_t(b) * a.qsb + size_t(h) * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + size_t(b) * a.ksb + size_t(h) * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + size_t(b) * a.vsb + size_t(h) * a.vsh;
  const int nt = (N + KT - 1) / KT;

  load_tile<bf16, D>(qs, LD, qb, a.qsn, q0, nw * 16, N);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nt) {
      load_tile<bf16, D>(ring + (s * 2) * KT * LD, LD, kb, a.ksn, s * KT, KT, N);
      load_tile<bf16, D>(ring + (s * 2 + 1) * KT * LD, LD, vb, a.vsn, s * KT, KT, N);
    }
    cp_commit();
  }
  cp_wait<STAGES - 1>();
  __syncthreads();

  uint32_t qf[KD][4];  // this warp's 16 query rows as A fragments
  {
    const bf16* pa = qs + (warp * 16 + gid) * LD + tig * 2;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld32(pa + kk * 16);
      qf[kk][1] = ld32(pa + 8 * LD + kk * 16);
      qf[kk][2] = ld32(pa + kk * 16 + 8);
      qf[kk][3] = ld32(pa + 8 * LD + kk * 16 + 8);
    }
  }
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows gid, gid + 8

  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 1>();
    __syncthreads();  // tile t is in its stage for every thread
    const bf16* ks = ring + ((t % STAGES) * 2) * KT * LD;
    const bf16* vs = ks + KT * LD;
    const int nk = min(KT, N - t * KT);
    if (active) {
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (nb * 8 < nk) {
            const bf16* bp = ks + (nb * 8 + gid) * LD + kk * 16 + tig * 2;
            mma_16816(s[nb], qf[kk], ld32(bp), ld32(bp + 8));
          }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = nb * 8 + tig * 2 + (e & 1) < nk;
          s[nb][e] = valid ? s[nb][e] * a.scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // key 0 of the tile exists, so mx is finite; exp(-inf) = 0 the first time
      const float al[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
      l[0] *= al[0];
      l[1] *= al[1];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        o[i][0] *= al[0];
        o[i][1] *= al[0];
        o[i][2] *= al[1];
        o[i][3] *= al[1];
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (kk * 16 < nk) {
          float p[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[j][e] = __expf(s[2 * kk + j][e] - mx[e >> 1]);
              l[e >> 1] += p[j][e];
            }
          // A fragment: rows (gid, gid + 8) x keys (2 tig, 2 tig + 8) of the k16 step
          const uint32_t hi[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                  pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
          float r[2][4];  // p - hi, exact in float32
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              r[j][e] = p[j][e] - __bfloat162float(__float2bfloat16_rn(p[j][e]));
          const uint32_t lo[4] = {pack_bf16(r[0][0], r[0][1]), pack_bf16(r[0][2], r[0][3]),
                                  pack_bf16(r[1][0], r[1][1]), pack_bf16(r[1][2], r[1][3])};
          const bf16* bt =
              vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int np = 0; np < ND; np += 2) {
            uint32_t bfr[4];
            ldsm_x4_trans(bfr, bt + np * 8);
            mma_16816(o[np], hi, bfr[0], bfr[1]);
            mma_16816(o[np + 1], hi, bfr[2], bfr[3]);
            mma_16816(o[np], lo, bfr[0], bfr[1]);
            mma_16816(o[np + 1], lo, bfr[2], bfr[3]);
          }
        }
      }
      m[0] = mx[0];
      m[1] = mx[1];
    }
    __syncthreads();  // every warp is done with this stage
    if (t + STAGES < nt) {
      const int st = t % STAGES;
      load_tile<bf16, D>(ring + (st * 2) * KT * LD, LD, kb, a.ksn, (t + STAGES) * KT, KT, N);
      load_tile<bf16, D>(ring + (st * 2 + 1) * KT * LD, LD, vb, a.vsn, (t + STAGES) * KT, KT, N);
    }
    cp_commit();
  }
  cp_wait<0>();
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  // stage the warp's [16, D] output in its own query rows, then 16-byte stores
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    *reinterpret_cast<uint32_t*>(os + gid * LD + i * 8 + tig * 2) =
        pack_bf16(o[i][0] * inv[0], o[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (gid + 8) * LD + i * 8 + tig * 2) =
        pack_bf16(o[i][2] * inv[1], o[i][3] * inv[1]);
  }
  __syncwarp();
  constexpr int PER_ROW = D / 8;
  bf16* ob = static_cast<bf16*>(a.out);
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * 8;
    const int row = wr0 + r;
    if (row < N)
      *reinterpret_cast<uint4*>(ob + ((size_t(b) * N + row) * a.H + h) * D + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
  }
}

// ---------------------------------------------------------------- float32
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
flash_attention_f32_kernel(const Args a) {
  constexpr int LD = D + Rows<float>::PAD;
  constexpr int LP = KT + 4;      // p tile row stride
  constexpr int DT = D / 16;      // output dims a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  float* qs = reinterpret_cast<float*>(smem);  // [nw * 8][LD]
  float* ring = qs + nw * 8 * LD;              // [STAGES][K, V][KT][LD]
  float* ps = ring + STAGES * 2 * KT * LD;     // [nw][8][LP]
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & 15, ty = lane >> 4;
  const int q0 = blockIdx.x * nw * 8;
  const int wr0 = q0 + warp * 8;
  const bool active = wr0 < N;
  const float* qb = static_cast<const float*>(a.q) + size_t(b) * a.qsb + size_t(h) * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + size_t(b) * a.ksb + size_t(h) * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + size_t(b) * a.vsb + size_t(h) * a.vsh;
  const int nt = (N + KT - 1) / KT;

  load_tile<float, D>(qs, LD, qb, a.qsn, q0, nw * 8, N);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nt) {
      load_tile<float, D>(ring + (s * 2) * KT * LD, LD, kb, a.ksn, s * KT, KT, N);
      load_tile<float, D>(ring + (s * 2 + 1) * KT * LD, LD, vb, a.vsn, s * KT, KT, N);
    }
    cp_commit();
  }
  cp_wait<STAGES - 1>();
  __syncthreads();
  // q * (1/sqrt(D)) in float32, as the JAX kernel scales q before the product
  for (int i = threadIdx.x; i < nw * 8 * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    qs[r * LD + c] *= a.scale;
  }

  const float* qw = qs + (warp * 8 + ty * 4) * LD;  // this lane's 4 query rows
  float* pw = ps + warp * 8 * LP;
  float o[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) o[i][j] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 1>();
    __syncthreads();
    const float* ks = ring + ((t % STAGES) * 2) * KT * LD;
    const float* vs = ks + KT * LD;
    const int nk = min(KT, N - t * KT);
    if (active) {
      float s[4][4] = {};  // [query][key tx + 16 j]
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qw + i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      float mx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mx[i] = m[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (tx + 16 * j >= nk) s[i][j] = -INFINITY;
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        const float al = expf(m[i] - mx[i]);
        l[i] *= al;
#pragma unroll
        for (int j = 0; j < DT; ++j) o[i][j] *= al;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - mx[i]);
          l[i] += p;
          pw[(ty * 4 + i) * LP + tx + 16 * j] = p;
        }
        m[i] = mx[i];
      }
      __syncwarp();
      for (int j0 = 0; j0 < nk; j0 += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(pw + (ty * 4 + i) * LP + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[DT];
          const float* vr = vs + (j0 + jj) * LD + tx * DT;
          if constexpr (DT == 4) {
            const float4 w = *reinterpret_cast<const float4*>(vr);
            vv[0] = w.x, vv[1] = w.y, vv[2] = w.z, vv[3] = w.w;
          } else {
            const float2 w = *reinterpret_cast<const float2*>(vr);
            vv[0] = w.x, vv[1] = w.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int j = 0; j < DT; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
          }
        }
      }
      __syncwarp();  // p is read before the next tile overwrites it
    }
    __syncthreads();
    if (t + STAGES < nt) {
      const int st = t % STAGES;
      load_tile<float, D>(ring + (st * 2) * KT * LD, LD, kb, a.ksn, (t + STAGES) * KT, KT, N);
      load_tile<float, D>(ring + (st * 2 + 1) * KT * LD, LD, vb, a.vsn, (t + STAGES) * KT, KT,
                          N);
    }
    cp_commit();
  }
  cp_wait<0>();
  if (!active) return;
  float* ob = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = wr0 + ty * 4 + i;
    if (row >= N) continue;
    const float inv = 1.0f / l[i];
    float* op = ob + ((size_t(b) * N + row) * a.H + h) * D + tx * DT;
    if constexpr (DT == 4) {
      *reinterpret_cast<float4*>(op) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
    } else {
      *reinterpret_cast<float2*>(op) = make_float2(o[i][0] * inv, o[i][1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, int warps, size_t smem, cudaStream_t stream) {
  void (*kern)(Args);
  if constexpr (std::is_same_v<T, bf16>) {
    kern = flash_attention_bf16_kernel<D>;
  } else {
    kern = flash_attention_f32_kernel<D>;
  }
  if (smem != smem_bytes<T>(D, warps)) return cudaErrorInvalidValue;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const int rows = warps * Rows<T>::WARP;
  const dim3 grid((a.N + rows - 1) / rows, B * a.H);
  kern<<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(Args a, int B, int D, int warps, long long smem, void* stream) {
  if (B <= 0 || a.H <= 0 || a.N <= 0 || B * a.H > 65535 || warps < 1 || warps > MAX_WARPS ||
      smem <= 0)
    return cudaErrorInvalidValue;
  a.scale = float(1.0 / sqrt(double(D)));  // as the JAX kernel's f32(1/math.sqrt(D))
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(a, B, warps, size_t(smem), s);
    case 64: return launch<T, 64>(a, B, warps, size_t(smem), s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// q, k, v [B, H, N, D] in T with element strides (batch, head, token) each
// and D contiguous, 16-byte aligned rows; out [B, N, H, D] contiguous in T.
// `warps`: warps a block (1..8), each 16 (bf16) or 8 (float32) query rows;
// `smem`: a block's shared memory in bytes, as the kernel lays it out.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int N, int D, int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                        int vsb, int vsh, int vsn, int warps, long long smem, void* stream) {
  const Args a{q, k, v, out, H, N, qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, 0.0f};
  return dispatch<float>(a, B, D, warps, smem, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int N, int D, int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                         int vsb, int vsh, int vsn, int warps, long long smem, void* stream) {
  const Args a{q, k, v, out, H, N, qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, 0.0f};
  return dispatch<bf16>(a, B, D, warps, smem, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
