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
// in one launch: the expand output never reaches device memory, and y is not
// read again for the pool.
//
// Numerics follow _dw_tile (fused_dwconv.py:150-177): taps multiply in f32 on
// values read in T; bias, silu and accumulation are f32; y is cast to T; the
// pool sums the f32 post-silu values times 1/(H*W).  The expand product
// accumulates in f32, gets + be and silu, and is rounded to T before the
// depthwise (fused_dwconv.py:235-245).
//
// What bounds it on the card.  By bytes (x and y once) every call of the
// B3@380 serving forward would take 3-220 us; at 12^2-24^2 a call moves only
// 1-8 MB.  What the first design spent beyond that was fixed cost a block
// (32 channels a block, so x was read Cmid/32 times with uncoalesced 4-byte
// A loads; weights staged an element at a time; the whole halo buffer
// zeroed; 100 KB of shared memory; float atomics on the pool and a memset)
// and instructions: K^2 shared-memory reads an output and an IEEE silu
// (expf and a division, ~30 instructions an element, twice an element on
// the expand path).  Measured on the card, the depthwise phase and silu are
// issue-bound, the deep expand's k-slice ring latency-bound, and the
// special-function unit (2 ops a silu) bounds the 95^2 blocks near 0.3 ms a
// bs 128 call.
//
// Design.  The wrapper owns the launch plan (ops/fused_dwconv.py::
// mbconv_plan: channel chunk, row tile or band, shared-memory size); each
// entry recomputes its own shared-memory layout and refuses a plan that does
// not match it or does not cover the rows exactly once.
//   expand (one block = one image x TILE output rows x CC mid channels, with
//   4 * CC threads: CC = 64, two blocks an SM, or CC = 128 in bf16 where one
//   block covers a 12^2 image, so x is read Cmid/128 times):
//     - the weight chunk [CC][Cin] sits in shared memory (16-byte cp.async,
//       rows past Cmid and k past Cin zero-filled);
//     - the expand is a tiled GEMM over the in-image positions of tile + halo
//       (contiguous in x): m-groups of 128 positions, k-slices of 32 (64 at
//       CC = 128), through a 3-stage 16-byte cp.async ring; bf16 on mma.sync
//       m16n8k16 with ldmatrix fragments (warp tile 32 x 32), f32 as an FMA
//       register tile on the CUDA cores (8 x 4 a thread); f32 accumulators;
//     - the epilogue adds be, applies silu, rounds to T and writes into the
//       shared halo buffer [TILE + 2P][W + 2P][CC] (channel pairs permuted by
//       buffer column, see swz, so the epilogue's stores do not conflict and
//       the depthwise's loads keep compile-time offsets); only the
//       out-of-image border is zeroed, before the GEMM: out-of-image
//       positions are exact zeros after the expand (the halo trap,
//       fused_dwconv.py:231-245: silu(0 . we + be) is not 0).
//   dw (one block = one image x BAND output rows x a chunk of <= 64
//   channels, 256 threads): input rows stream through a ring of K + DEPTH
//   row buffers (cp.async, DEPTH rows ahead), so a band boundary is the
//   only place where halo rows are read twice.
//   depthwise (both): a thread owns one pair of channels and a run of R
//   output columns (8 expand, 6 dw); it slides a K x (R + K - 1) window of
//   pairs along the row from shared memory (each value read (R + K - 1) / R
//   times a tap row, not K times), keeps the pair's K*K taps in registers,
//   and stores y as pairs (a warp's stores cover whole 128-byte lines).
//   Threads are laid out (slot, pair) with a fixed pair each, so at C = 24
//   or 40 only 4 or 16 of 256 threads idle.
//   silu: v * rcp(1 + e^-v) on ex2.approx and rcp.approx (a few f32 ulps).
//   pool: each thread sums its pair over its outputs, the block reduces the
//   slots in order in shared memory; a block that covers all rows of its
//   image writes the pool directly, otherwise it writes its partial sums to
//   a float32 scratch and the last block of its (image, chunk) to arrive
//   (a counter the kernel resets to 0) adds the partials in tile order.  No
//   float atomics and no memset: the same bits on every run.
// Left for later work: the halo rows' expand is computed twice at 95^2 and
// 48^2 (tiles of 4 and 7 rows keep two blocks an SM); packing several 12^2
// images into one block; wgmma/TMA for the expand; one special-function op
// a silu; the f32 expand on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;  // dw: 8 warps; expand: 4 * CC (CC = 64 or 128 mid channels)
constexpr int DW_CC = 64;      // dw: the widest channel chunk
constexpr int MG = 128;        // expand: GEMM rows (positions) an m-group
// expand: GEMM k-slice, 64 at CC = 128 (the 12^2 blocks, where Cin 232-384
// pads little and fewer, larger stages hide more latency), else 32
__host__ __device__ constexpr int bk_of(int cc) { return cc == 128 ? 64 : 32; }
constexpr int STAGES = 3;      // expand: cp.async ring of k-slices
constexpr int DEPTH = 3;       // dw: input rows in flight ahead of the row computed
constexpr int R_DW = 6;        // dw depthwise: output columns a thread's run
constexpr int R_EX = 8;        // expand depthwise: the same (a multiple of 8: see swz)
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same_v<T, __nv_bfloat16>;
}

// Shared-memory row pads (elements): the rows of the ring and the weight
// chunk are an odd multiple of 16 bytes long, so 8 consecutive rows (an
// ldmatrix, or the f32 loop's column reads) hit 8 distinct 16-byte bank
// groups.
template <typename T> __host__ __device__ constexpr int pad() { return is_bf16<T>() ? 8 : 4; }
__host__ __device__ constexpr int kpad(int cin, int bk) { return (cin + bk - 1) / bk * bk; }

// ---- the layouts that the wrapper's plan must match (ops/fused_dwconv.py)
template <typename T> struct ExpandSmem {
  size_t mid, w, ring, red, total;
  __host__ __device__ ExpandSmem(int cc, int tile, int W, int K, int cin) {
    const int P = (K - 1) / 2;
    mid = align16(size_t(tile + 2 * P) * (W + 2 * P) * cc * sizeof(T));
    w = align16(size_t(cc) * (kpad(cin, bk_of(cc)) + pad<T>()) * sizeof(T));
    ring = align16(size_t(STAGES) * MG * (bk_of(cc) + pad<T>()) * sizeof(T));
    red = size_t(8) * cc * sizeof(float);  // 8 slots of cc / 2 pairs
    total = mid + w + ring + red + 16;
  }
};

template <typename T> struct DwSmem {
  size_t slot, ring, red, total;
  __host__ __device__ DwSmem(int cc, int W, int K) {
    const int P = (K - 1) / 2;
    slot = align16(size_t(W + 2 * P) * cc * sizeof(T));
    ring = slot * (K + DEPTH);
    red = size_t(NTHREADS / (cc / 2)) * cc * sizeof(float);
    total = ring + red + 16;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// silu(v) = v / (1 + e^-v) as v * rcp(1 + e^-v) on the special-function
// unit: ex2.approx and rcp.approx (0 where e^-v overflows), each within 2
// ulps, so silu is within a few f32 ulps of the IEEE quotient.  (The IEEE
// division and a correctly rounded reciprocal cost about 30 instructions an
// element, which made the depthwise phase instruction-bound.)
__device__ __forceinline__ float silu(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + __expf(-v)));
  return v * r;
}

// Biases arrive in f32 or bf16 (the model's bf16 parameters, read as they are).
__device__ __forceinline__ float load_bias(const void* p, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// A pair of channels (2 consecutive elements) in and out of T.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16-byte cp.async; src_bytes 0 zero-fills the destination (src stays valid).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes = 16) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// Element offset of channel pair p at buffer column bc within a position of
// the expand's halo buffer [rows][cols][CC]: the 32 pairs are permuted by
// XOR with 4 * (bc & 7), so the epilogue's stores (8 consecutive positions
// a store) hit 8 distinct 16-byte bank groups, and the depthwise's loads
// (one position a warp, runs of R_EX = 8 columns from a multiple of 8) see a
// compile-time key.
__device__ __forceinline__ int swz(int bc, int p) { return 2 * (p ^ ((bc & 7) << 2)); }


// ---- depthwise: one run of R output columns of one row, one channel pair
// at(ky, j) -> the pair at buffer column col0 + j (halo included) of the
// ky-th input row of the output row.  Columns past the row (the last run's,
// up to R - 1) read the next row or the shared memory after the buffer: they feed
// only outputs past W, which are not stored.  y_row points at the pair's
// channel of column 0 of the output row.
template <typename T, int K, int R, typename At>
__device__ __forceinline__ void dw_run(At at, const float2 (&w)[K * K], float2 bias, int col0,
                                       int W, int C, T* __restrict__ y_row, float2& psum) {
  float2 acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    float2 win[R + K - 1];
#pragma unroll
    for (int j = 0; j < R + K - 1; ++j) win[j] = load_pair(at(ky, j));
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[j].x = fmaf(win[j + kx].x, w[ky * K + kx].x, acc[j].x);
        acc[j].y = fmaf(win[j + kx].y, w[ky * K + kx].y, acc[j].y);
      }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (col0 + j < W) {
      const float a = silu(acc[j].x + bias.x), b = silu(acc[j].y + bias.y);
      store_pair(y_row + size_t(col0 + j) * C, a, b);
      psum.x += a;
      psum.y += b;
    }
}

// The pair's taps (wd is [C][K*K] in T) and bias, zeros past C.
template <typename T, int K>
__device__ __forceinline__ void pair_weights(const T* __restrict__ wd, const void* bd,
                                             bool bias_bf16, int c, bool on,
                                             float2 (&w)[K * K], float2& bias) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    w[t] = on ? make_float2(to_f(wd[size_t(c) * K * K + t]), to_f(wd[size_t(c + 1) * K * K + t]))
              : make_float2(0.0f, 0.0f);
  bias = on ? make_float2(load_bias(bd, c, bias_bf16), load_bias(bd, c + 1, bias_bf16))
            : make_float2(0.0f, 0.0f);
}

// ---- pool: the slots' pair sums -> red[slot][cc] -> one sum a channel in
// slot order; written directly when the block covers all rows of its image
// (n_tiles == 1), else as a partial, and the last block of the (image,
// chunk) to arrive adds the partials in tile order and resets the counter.
struct PoolArgs {
  float* pool;      // [B, C]
  float* partial;   // [n_tiles, B, C] (n_tiles > 1)
  int* counters;    // [B, n_chunks], zero before and after the launch
  int B, C, n_tiles;
  float inv_hw;
};

__device__ __forceinline__ void finish_pool(const PoolArgs& a, float2 psum, bool writer, int slot,
                                            int p, int slots, int cc, int nc, int c0,
                                            float* red, int* flag) {
  const int b = blockIdx.z, tile = blockIdx.x;
  const int counter = b * gridDim.y + blockIdx.y;
  if (writer) {
    red[slot * cc + 2 * p] = psum.x;
    red[slot * cc + 2 * p + 1] = psum.y;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const size_t c = size_t(b) * a.C + c0 + t;  // index into [B, C]
  float s = 0.0f;
  if (t < nc)
    for (int k = 0; k < slots; ++k) s += red[k * cc + t];
  if (a.n_tiles == 1) {
    if (t < nc) a.pool[c] = s * a.inv_hw;
    return;
  }
  if (t < nc) a.partial[size_t(tile) * a.B * a.C + c] = s;
  __threadfence();
  __syncthreads();
  if (t == 0) *flag = atomicAdd(a.counters + counter, 1) == a.n_tiles - 1;
  __syncthreads();
  if (*flag) {
    __threadfence();
    if (t < nc) {
      float total = 0.0f;
      for (int k = 0; k < a.n_tiles; ++k) total += __ldcg(a.partial + size_t(k) * a.B * a.C + c);
      a.pool[c] = total * a.inv_hw;
    }
    if (t == 0) a.counters[counter] = 0;
  }
}

// ---- expand GEMM helpers (bf16 on the tensor cores)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

// ---- the expand variant: 4 * CC threads, warps 4 (GEMM rows) x CC / 32
// (GEMM columns); two blocks an SM at CC = 64, one at CC = 128
template <typename T, int K, int CC>
__global__ void __launch_bounds__(4 * CC, 512 / (4 * CC))
mbconv_expand_kernel(const T* __restrict__ x,   // [B, H, W, Cin]
                     const T* __restrict__ we,  // [C, Cin]
                     const void* be,            // [C] f32 or bf16
                     const T* __restrict__ wd,  // [C, K*K]
                     const void* bd,            // [C] f32 or bf16
                     T* __restrict__ y,         // [B, H, W, C]
                     PoolArgs pa, int H, int W, int Cin, int tile_rows, bool bias_bf16) {
  constexpr int P = (K - 1) / 2;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BK = bk_of(CC);
  constexpr int AS = BK + pad<T>();  // ring row stride (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = 4 * CC;
  const ExpandSmem<T> L(CC, tile_rows, W, K, Cin);
  T* mid = reinterpret_cast<T*>(smem);                                   // [rows][cols][CC]
  T* ws = reinterpret_cast<T*>(smem + L.mid);                            // [CC][KP + pad]
  T* ring = reinterpret_cast<T*>(smem + L.mid + L.w);                    // [STAGES][MG][AS]
  float* red = reinterpret_cast<float*>(smem + L.mid + L.w + L.ring);    // [slots][CC]
  int* flag = reinterpret_cast<int*>(smem + L.mid + L.w + L.ring + L.red);

  const int C = pa.C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * CC;
  const int nc = min(CC, C - c0);
  const int cols = W + 2 * P, rows = tile_rows + 2 * P;
  const int KP = kpad(Cin, BK), KS = KP / BK, WS = KP + pad<T>();
  // GEMM rows: the in-image positions of rows [v0, v1), contiguous in x
  const int v0 = max(r0 - P, 0), v1 = min(r0 + tile_rows + P, H);
  const int M = (v1 - v0) * W;
  const T* xa = x + (size_t(b) * H + v0) * W * Cin;
  const int n_st = (M + MG - 1) / MG * KS;

  // weight chunk, then the first two stages of A (16-byte copies; rows past
  // C and k past Cin are zero-filled)
  for (int i = tid; i < CC * (KP / VEC); i += NT) {
    const int n = i / (KP / VEC), k = (i - n * (KP / VEC)) * VEC;
    const bool ok = n < nc && k < Cin;
    cp_async16(ws + n * WS + k, ok ? we + size_t(c0 + n) * Cin + k : we, ok ? 16 : 0);
  }
  const auto load_stage = [&](int s) {
    constexpr int PER = BK / VEC;
    const int mg = s / KS, k0 = (s - mg * KS) * BK;
    T* dst = ring + (s % STAGES) * MG * AS;
    for (int i = tid; i < MG * PER; i += NT) {
      const int r = i / PER, k = k0 + (i - r * PER) * VEC;
      const int q = min(mg * MG + r, M - 1);
      const bool ok = k < Cin;
      cp_async16(dst + r * AS + k - k0, ok ? xa + size_t(q) * Cin + k : xa, ok ? 16 : 0);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {  // the weights ride in stage 0's group
    if (s < n_st) load_stage(s);
    cp_async_commit();
  }

  // zero the out-of-image border of the halo buffer (whole positions)
  for (int br = 0; br < rows; ++br) {
    const int g = r0 - P + br;
    T* row = mid + size_t(br) * cols * CC;
    if (g < 0 || g >= H) {
      for (int i = tid; i < cols * (CC / VEC); i += NT) zero16(row + i * VEC);
    } else if (P > 0) {
      for (int i = tid; i < 2 * P * (CC / VEC); i += NT) {
        const int j = i / (CC / VEC), v = i - j * (CC / VEC);
        zero16(row + (j < P ? j : W + j) * CC + v * VEC);
      }
    }
  }

  // GEMM row q (an in-image position) -> its element offset in the halo
  // buffer and its buffer column, once a row and m-group
  const auto row_at = [&](int q, int& bc) {
    const int vr = q / W, vc = q - vr * W;
    bc = vc + P;
    return ((v0 + vr - r0 + P) * cols + bc) * CC;
  };
  const auto bias = [&](int n) { return n < nc ? load_bias(be, c0 + n, bias_bf16) : 0.0f; };

  if constexpr (is_bf16<T>()) {
    const int wm = warp & 3, wn = warp >> 2, gid = lane >> 2, tig = lane & 3;
    float be_r[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) be_r[nt][e] = bias(wn * 32 + nt * 8 + tig * 2 + e);
    float acc[2][4][4] = {};
    for (int s = 0; s < n_st; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (s + STAGES - 1 < n_st) load_stage(s + STAGES - 1);
      cp_async_commit();
      const int mg = s / KS, ks = s - mg * KS;
      const T* A = ring + (s % STAGES) * MG * AS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], A + (wm * 32 + mt * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, ws + (wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * WS +
                             ks * BK + kk + ((lane >> 3) & 1) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
      }
      if (ks == KS - 1) {  // + be, silu, round to T, into the halo buffer
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = mg * MG + wm * 32 + mt * 16 + gid + h * 8;
            int bc = 0;
            T* dst = mid + (q < M ? row_at(q, bc) : 0);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (q < M)
                store_pair(dst + swz(bc, wn * 16 + nt * 4 + tig),
                           silu(acc[mt][nt][2 * h] + be_r[nt][0]),
                           silu(acc[mt][nt][2 * h + 1] + be_r[nt][1]));
              acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.0f;
            }
          }
      }
    }
  } else {
    // f32: thread (ty, tx) owns GEMM rows ty + 16 i and the column pairs tx
    // and tx + CC / 4 (pairs, for the pair stores into the halo buffer);
    // each sum runs in k order
    constexpr int TX = CC / 4;
    const int tx = tid % TX, ty = tid / TX;
    float be_r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) be_r[j] = bias(2 * tx + (j & 1) + (j >> 1) * 2 * TX);
    float acc[8][4] = {};
    for (int s = 0; s < n_st; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (s + STAGES - 1 < n_st) load_stage(s + STAGES - 1);
      cp_async_commit();
      const int mg = s / KS, ks = s - mg * KS;
      const T* A = ring + (s % STAGES) * MG * AS;
      const T* Wk = ws + ks * BK;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[8], bw[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = A[(ty + 16 * i) * AS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = Wk[(2 * tx + (j & 1) + (j >> 1) * 2 * TX) * WS + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
      if (ks == KS - 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = mg * MG + ty + 16 * i;
          int bc = 0;
          T* dst = mid + (q < M ? row_at(q, bc) : 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (q < M)
              store_pair(dst + swz(bc, tx + TX * h), silu(acc[i][2 * h] + be_r[2 * h]),
                         silu(acc[i][2 * h + 1] + be_r[2 * h + 1]));
            acc[i][2 * h] = acc[i][2 * h + 1] = 0.0f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // depthwise: thread (slot, pair), runs of R columns of the tile's rows
  constexpr int NP = CC / 2, SLOTS = NT / NP;
  const int slot = tid / NP, p = tid - slot * NP;
  const bool on = 2 * p < nc;
  float2 w2[K * K], bias2;
  pair_weights<T, K>(wd, bd, bias_bf16, c0 + 2 * p, on, w2, bias2);
  const int out_rows = min(tile_rows, H - r0);
  const int runs = (W + R_EX - 1) / R_EX;
  float2 psum = make_float2(0.0f, 0.0f);
  if (on) {
    for (int it = slot; it < out_rows * runs; it += SLOTS) {
      const int i = it / runs, run = it - i * runs;
      const T* base = mid + size_t(i * cols + run * R_EX) * CC;
      const auto at = [&](int ky, int j) { return base + (ky * cols + j) * CC + swz(j, p); };
      dw_run<T, K, R_EX>(at, w2, bias2, run * R_EX, W, C,
                         y + (size_t(b) * H + r0 + i) * W * C + c0 + 2 * p, psum);
    }
  }
  finish_pool(pa, psum, true, slot, p, SLOTS, CC, nc, c0, red, flag);
}

// ---- the dw variant: rows [r0, r0 + band_rows) of one image and one chunk
// of cc channels; input rows stream through a ring of K + DEPTH row buffers
// [W + 2P][cc] whose halo columns stay zero.
template <typename T, int K>
__global__ void __launch_bounds__(NTHREADS, 2)
mbconv_dw_kernel(const T* __restrict__ x,   // [B, H, W, C]
                 const T* __restrict__ wd,  // [C, K*K]
                 const void* bd,            // [C] f32 or bf16
                 T* __restrict__ y,         // [B, H, W, C]
                 PoolArgs pa, int H, int W, int cc, int band_rows, bool bias_bf16) {
  constexpr int P = (K - 1) / 2;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NS = K + DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const DwSmem<T> L(cc, W, K);
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.ring);
  int* flag = reinterpret_cast<int*>(smem + L.ring + L.red);
  const size_t slot_el = L.slot / sizeof(T);

  const int C = pa.C;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * band_rows, r1 = min(r0 + band_rows, H);
  const int c0 = blockIdx.y * cc, nc = min(cc, C - c0);
  const int cpv = cc / VEC, npv = nc / VEC;  // 16-byte copies a position
  const T* xb = x + size_t(b) * H * W * C + c0;

  for (int i = tid; i < NS * 2 * P * cpv; i += NTHREADS) {  // halo columns
    const int s = i / (2 * P * cpv), rem = i - s * 2 * P * cpv;
    const int j = rem / cpv, v = rem - j * cpv;
    zero16(ring + s * slot_el + (j < P ? j : W + j) * cc + v * VEC);
  }
  const auto load_row = [&](int g) {  // input row g into its slot, one group
    if (g < r1 + P) {
      T* dst = ring + ((g - r0 + P) % NS) * slot_el + P * cc;
      if (g >= 0 && g < H) {
        const T* src = xb + size_t(g) * W * C;
        for (int i = tid; i < W * npv; i += NTHREADS) {
          const int pos = i / npv, v = i - pos * npv;
          cp_async16(dst + pos * cc + v * VEC, src + size_t(pos) * C + v * VEC);
        }
      } else {
        for (int i = tid; i < W * cpv; i += NTHREADS) zero16(dst + i * VEC);
      }
    }
    cp_async_commit();
  };
  for (int g = r0 - P; g < r0 + P + DEPTH; ++g) load_row(g);

  const int np = cc / 2, slots = NTHREADS / np;
  const int slot = tid / np, p = tid - slot * np;
  const bool writer = slot < slots, on = writer && 2 * p < nc;
  float2 w2[K * K], bias2;
  pair_weights<T, K>(wd, bd, bias_bf16, c0 + 2 * p, on, w2, bias2);
  const int runs = (W + R_DW - 1) / R_DW;
  float2 psum = make_float2(0.0f, 0.0f);
  for (int r = r0; r < r1; ++r) {
    cp_async_wait<DEPTH - 1>();  // rows up to r + P have landed
    __syncthreads();             // ... for every thread; row r - 1 is done
    load_row(r + P + DEPTH);     // into the slot of row r - P - 1
    if (on) {
      const T* rowp[K];
#pragma unroll
      for (int ky = 0; ky < K; ++ky) rowp[ky] = ring + ((r - r0 + ky) % NS) * slot_el + 2 * p;
      T* y_row = y + (size_t(b) * H + r) * W * C + c0 + 2 * p;
      for (int run = slot; run < runs; run += slots) {
        const auto at = [&](int ky, int j) { return rowp[ky] + (run * R_DW + j) * cc; };
        dw_run<T, K, R_DW>(at, w2, bias2, run * R_DW, W, C, y_row, psum);
      }
    }
  }
  cp_async_wait<0>();
  finish_pool(pa, psum, writer, slot, p, slots, cc, nc, c0, red, flag);
}

// ---- launches: check the plan against this file's layout, then launch
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline bool covers(int rows_per, int n, int H) {
  return rows_per >= 1 && n >= 1 && (n - 1) * rows_per < H && n * rows_per >= H;
}

// Raise the kernel's dynamic shared-memory limit to smem on the current
// device, once: `done` (one entry a device, per kernel) keeps the largest
// size set so far, so a launch sets the attribute only when it grows.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem, size_t (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess) done[dev] = smem;
  return e;
}

template <typename T, int K, int CC>
cudaError_t launch_expand(const void* x, const void* we, const void* be, const void* wd,
                          const void* bd, void* y, const PoolArgs& pa, int H, int W, int Cin,
                          bool bias_bf16, int tile_rows, size_t smem, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (Cin % VEC || pa.C % VEC || !aligned16(x) || !aligned16(we) ||
      !covers(tile_rows, pa.n_tiles, H) || (pa.n_tiles > 1 && (!pa.partial || !pa.counters)) ||
      ExpandSmem<T>(CC, tile_rows, W, K, Cin).total != smem || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = mbconv_expand_kernel<T, K, CC>;
  static size_t done[64] = {};
  const cudaError_t e = set_smem(kern, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid(pa.n_tiles, (pa.C + CC - 1) / CC, pa.B);
  kern<<<grid, 4 * CC, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), be, static_cast<const T*>(wd), bd,
      static_cast<T*>(y), pa, H, W, Cin, tile_rows, bias_bf16);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_dw(const void* x, const void* wd, const void* bd, void* y,
                      const PoolArgs& pa, int H, int W, bool bias_bf16, int cc, int band_rows,
                      size_t smem, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (pa.C % VEC || !aligned16(x) || cc < VEC || cc % VEC || cc > DW_CC ||
      !covers(band_rows, pa.n_tiles, H) || (pa.n_tiles > 1 && (!pa.partial || !pa.counters)) ||
      DwSmem<T>(cc, W, K).total != smem || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = mbconv_dw_kernel<T, K>;
  static size_t done[64] = {};
  const cudaError_t e = set_smem(kern, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid(pa.n_tiles, (pa.C + cc - 1) / cc, pa.B);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(wd),
                                         bd, static_cast<T*>(y), pa, H, W, cc, band_rows,
                                         bias_bf16);
  return cudaGetLastError();
}

PoolArgs pool_args(void* pool, void* partial, void* counters, int B, int H, int W, int C,
                   int n_tiles) {
  return PoolArgs{static_cast<float*>(pool), static_cast<float*>(partial),
                  static_cast<int*>(counters), B, C, n_tiles, 1.0f / float(H * W)};
}

template <typename T>
int expand_entry(const void* x, const void* we, const void* be, const void* wd, const void* bd,
                 void* y, void* pool, void* partial, void* counters, int B, int H, int W,
                 int Cin, int C, int K, int bias_bf16, int cc, int tile_rows, int n_tiles,
                 long long smem, void* stream) {
  const PoolArgs pa = pool_args(pool, partial, counters, B, H, W, C, n_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bias_bf16 != 0;
  const size_t sm = size_t(smem);
#define MBCONV_EXPAND(K_, CC_) \
  launch_expand<T, K_, CC_>(x, we, be, wd, bd, y, pa, H, W, Cin, bf, tile_rows, sm, s)
  switch (K * 1000 + cc) {
    case 3064: return MBCONV_EXPAND(3, 64);
    case 5064: return MBCONV_EXPAND(5, 64);
    case 3128: return MBCONV_EXPAND(3, 128);
    case 5128: return MBCONV_EXPAND(5, 128);
    default: return cudaErrorInvalidValue;
  }
#undef MBCONV_EXPAND
}

template <typename T>
int dw_entry(const void* x, const void* wd, const void* bd, void* y, void* pool, void* partial,
             void* counters, int B, int H, int W, int C, int K, int bias_bf16, int cc,
             int band_rows, int n_bands, long long smem, void* stream) {
  const PoolArgs pa = pool_args(pool, partial, counters, B, H, W, C, n_bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bias_bf16 != 0;
  switch (K) {
    case 3: return launch_dw<T, 3>(x, wd, bd, y, pa, H, W, bf, cc, band_rows, size_t(smem), s);
    case 5: return launch_dw<T, 5>(x, wd, bd, y, pa, H, W, bf, cc, band_rows, size_t(smem), s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 = ok), or cudaErrorInvalidValue for a plan this file's layout refuses.
// Weights in PyTorch's conv layouts: we [C, Cin], wd [C, K*K], in T; biases
// f32, or bf16 when bias_bf16 != 0.  The plan (ops/fused_dwconv.py::
// mbconv_plan): channel chunk cc, rows a block, blocks along H, and the
// block's shared-memory bytes.  partial [n_tiles, B, C] float32 and
// counters [B, ceil(C / cc)] int32 (zero, and left zero) are read only when
// n_tiles > 1.
int dw_silu_pool_f32(const void* x, const void* wd, const void* bd, void* y, void* pool,
                     void* partial, void* counters, int B, int H, int W, int C, int K,
                     int bias_bf16, int cc, int band_rows, int n_bands, long long smem,
                     void* stream) {
  return dw_entry<float>(x, wd, bd, y, pool, partial, counters, B, H, W, C, K, bias_bf16, cc,
                         band_rows, n_bands, smem, stream);
}

int dw_silu_pool_bf16(const void* x, const void* wd, const void* bd, void* y, void* pool,
                      void* partial, void* counters, int B, int H, int W, int C, int K,
                      int bias_bf16, int cc, int band_rows, int n_bands, long long smem,
                      void* stream) {
  return dw_entry<__nv_bfloat16>(x, wd, bd, y, pool, partial, counters, B, H, W, C, K,
                                 bias_bf16, cc, band_rows, n_bands, smem, stream);
}

int expand_dw_silu_pool_f32(const void* x, const void* we, const void* be, const void* wd,
                            const void* bd, void* y, void* pool, void* partial, void* counters,
                            int B, int H, int W, int Cin, int C, int K, int bias_bf16, int cc,
                            int tile_rows, int n_tiles, long long smem, void* stream) {
  return expand_entry<float>(x, we, be, wd, bd, y, pool, partial, counters, B, H, W, Cin, C, K,
                             bias_bf16, cc, tile_rows, n_tiles, smem, stream);
}

int expand_dw_silu_pool_bf16(const void* x, const void* we, const void* be, const void* wd,
                             const void* bd, void* y, void* pool, void* partial,
                             void* counters, int B, int H, int W, int Cin, int C, int K,
                             int bias_bf16, int cc, int tile_rows, int n_tiles, long long smem,
                             void* stream) {
  return expand_entry<__nv_bfloat16>(x, we, be, wd, bd, y, pool, partial, counters, B, H, W,
                                     Cin, C, K, bias_bf16, cc, tile_rows, n_tiles, smem, stream);
}

const char* fused_dwconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
