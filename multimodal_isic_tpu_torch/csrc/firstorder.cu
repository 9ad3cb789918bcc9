// First-order accumulation over ROI maps, batched over maps, Hopper (sm_90a),
// plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_hist.py::firstorder_accumulate_pallas
//   (_firstorder_kernel)
// For each map b of image [B, N] float32 and levels [B, N] int32, over the
// valid pixels (levels > 0: every positive code, codes above NG included):
//   stats[b] = [n, Sx, min, max, S c, S c^2, S c^3, S c^4, S |c|]   float32
//   mu = round_f32(Sx) / max(n, 1) in float32,  c = x - mu in float32
//   hist[b][k - 1] = #{levels == k} for k = 1..NG (NG = 64); a code above NG
//   counts in stats only (the TPU kernel's 128-lane one-hot is sliced to NG).
// An empty map keeps the TPU kernel's sentinels: min 3.4e38, max -3.4e38,
// every sum 0.
//
// Numerics.  n and hist are integer counts, min and max exact in any order:
// they equal the plain version bit for bit.  The six sums accumulate in
// float64 (each power of c taken in float64 from the float32 c) and are
// rounded to float32 once, at the end.  Every block reduces its pixels in a
// fixed order (thread, then warp shuffle, then warps in index order) and the
// blocks' partials are summed in index order, so a rerun gives the same bits;
// no float atomics.  The TPU kernel summed in float32, block after block: the
// tests hold the sums to ops/histogram.py::SUM_TOL of their magnitude.
//
// What bounds it on the card: memory.  Both inputs are read once per phase
// (8 bytes a pixel); the function needs them once: at the radiomics chunk's
// call (64 maps of 450 x 600) 138 MB, 41 us at 3.35 TB/s.  The float64 work
// (~8 operations a valid pixel) is far below the card's float64 rate.
//
// Design.  The TPU kernel runs a (2, blocks) grid in order and carries the
// sums in scratch from phase 0 into phase 1.  Here both phases are a grid of
// (chunk, map) blocks of 256 threads, enough chunks to put ~4 blocks on every
// SM, reading float4 / int4 vectors when the rows allow it:
//   phase 0: n, Sx, min, max and an NG-bin histogram (one per warp in shared
//            memory, integer atomics) per block -> partials;
//   phase 1: each block sums its map's phase-0 partials in index order for
//            mu (the same bits in every block), accumulates the centred sums
//            -> partials; the block that finishes its map last (an integer
//            ticket, zeroed by phase 0) sums the partials in index order and
//            writes stats and hist.
// Two launches in one stream; the workspace (partials and tickets) is
// allocated by the caller (firstorder_workspace bytes).
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NG = 64;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SMS = 132;
constexpr int MIN_CHUNK = 4096;  // pixels a block at least
constexpr int NSUM = 5;          // centred sums
constexpr float BIG = 3.4e38f;   // the TPU kernel's min / max sentinels

struct Part0 {
  double sx;
  float mn, mx;
  int n, pad;
};

struct Plan {
  int chunk, nchunk;
};

Plan plan(int B, int N) {
  int want = std::max(1, (4 * SMS + B - 1) / B);
  want = std::min(want, std::max(1, (N + MIN_CHUNK - 1) / MIN_CHUNK));
  int chunk = (N + want - 1) / want;
  chunk = (chunk + 3) & ~3;  // vector loads: chunk boundaries on 4 pixels
  return {chunk, (N + chunk - 1) / chunk};
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

struct Workspace {
  Part0* p0;       // [B, nchunk]
  double* p1;      // [B, nchunk, NSUM]
  int* hp;         // [B, nchunk, NG]
  unsigned* tick;  // [B]
  size_t bytes;
};

Workspace carve(void* base, int B, int nchunk) {
  const size_t parts = size_t(B) * nchunk;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  Workspace w;
  size_t off = 0;
  w.p0 = reinterpret_cast<Part0*>(p + off);
  off += align256(parts * sizeof(Part0));
  w.p1 = reinterpret_cast<double*>(p + off);
  off += align256(parts * NSUM * sizeof(double));
  w.hp = reinterpret_cast<int*>(p + off);
  off += align256(parts * NG * sizeof(int));
  w.tick = reinterpret_cast<unsigned*>(p + off);
  off += align256(size_t(B) * sizeof(unsigned));
  w.bytes = off;
  return w;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Calls take(x, level) for every pixel of this block's chunk of map b, each
// thread on a fixed set of pixels.
template <typename Take>
__device__ __forceinline__ void walk(const float* __restrict__ x, const int32_t* __restrict__ lv,
                                     int N, int chunk, bool vec, Take&& take) {
  const size_t row = size_t(blockIdx.y) * N;
  const int begin = blockIdx.x * chunk;
  const int end = min(N, begin + chunk);
  if (vec) {  // N a multiple of 4, both rows 16-byte aligned
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const int4* l4 = reinterpret_cast<const int4*>(lv + row);
    for (int v = begin / 4 + threadIdx.x; v < end / 4; v += THREADS) {
      const float4 a = x4[v];
      const int4 l = l4[v];
      take(a.x, l.x);
      take(a.y, l.y);
      take(a.z, l.z);
      take(a.w, l.w);
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += THREADS) take(x[row + i], lv[row + i]);
  }
}

__global__ void __launch_bounds__(THREADS)
firstorder_phase0(const float* __restrict__ x, const int32_t* __restrict__ lv, int N, int chunk,
                  int nchunk, bool vec, Workspace ws) {
  __shared__ int hist[NWARPS][NG];
  __shared__ double s_sx[NWARPS];
  __shared__ float s_mn[NWARPS], s_mx[NWARPS];
  __shared__ int s_n[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < NWARPS * NG; i += THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();

  int n = 0;
  double sx = 0.0;
  float mn = BIG, mx = -BIG;
  int* h = hist[warp];
  walk(x, lv, N, chunk, vec, [&](float v, int l) {
    if (l > 0) {
      ++n;
      sx += double(v);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      if (l <= NG) atomicAdd(&h[l - 1], 1);
    }
  });
  n = warp_sum(n);
  sx = warp_sum(sx);
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (lane == 0) {
    s_n[warp] = n;
    s_sx[warp] = sx;
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();

  const size_t part = size_t(blockIdx.y) * nchunk + blockIdx.x;
  for (int i = tid; i < NG; i += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += hist[w][i];
    ws.hp[part * NG + i] = s;
  }
  if (tid == 0) {
    Part0 p{0.0, BIG, -BIG, 0, 0};
    for (int w = 0; w < NWARPS; ++w) {
      p.n += s_n[w];
      p.sx += s_sx[w];
      p.mn = fminf(p.mn, s_mn[w]);
      p.mx = fmaxf(p.mx, s_mx[w]);
    }
    ws.p0[part] = p;
    if (blockIdx.x == 0) ws.tick[blockIdx.y] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
firstorder_phase1(const float* __restrict__ x, const int32_t* __restrict__ lv, int N, int chunk,
                  int nchunk, bool vec, Workspace ws, float* __restrict__ stats,
                  float* __restrict__ hist) {
  __shared__ float s_mu;
  __shared__ double s_part[NWARPS][NSUM];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const Part0* p0 = ws.p0 + size_t(b) * nchunk;
  if (tid == 0) {  // mu from the map's phase-0 partials, in index order
    int n = 0;
    double sx = 0.0;
    for (int j = 0; j < nchunk; ++j) {
      n += p0[j].n;
      sx += p0[j].sx;
    }
    s_mu = float(sx) / fmaxf(float(n), 1.0f);
  }
  __syncthreads();

  const float mu = s_mu;
  double a[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  walk(x, lv, N, chunk, vec, [&](float v, int l) {
    if (l > 0) {
      const double c = double(v - mu);
      const double c2 = c * c;
      a[0] += c;
      a[1] += c2;
      a[2] += c2 * c;
      a[3] += c2 * c2;
      a[4] += fabs(c);
    }
  });
#pragma unroll
  for (int i = 0; i < NSUM; ++i) a[i] = warp_sum(a[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NSUM; ++i) s_part[warp][i] = a[i];
  }
  __syncthreads();
  double* p1 = ws.p1 + size_t(b) * nchunk * NSUM;
  if (tid < NSUM) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += s_part[w][tid];
    p1[blockIdx.x * NSUM + tid] = s;
  }

  // the map's last block to finish sums every partial in index order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ws.tick[b], 1u) == unsigned(nchunk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* st = stats + size_t(b) * 9;
  if (tid < NSUM) {
    double s = 0.0;
    for (int j = 0; j < nchunk; ++j) s += __ldcg(p1 + j * NSUM + tid);
    st[4 + tid] = float(s);
  } else if (tid == NSUM) {
    int n = 0;
    double sx = 0.0;
    float mn = BIG, mx = -BIG;
    for (int j = 0; j < nchunk; ++j) {
      n += p0[j].n;
      sx += p0[j].sx;
      mn = fminf(mn, p0[j].mn);
      mx = fmaxf(mx, p0[j].mx);
    }
    st[0] = float(n);
    st[1] = float(sx);
    st[2] = mn;
    st[3] = mx;
  }
  const int* hp = ws.hp + size_t(b) * nchunk * NG;
  for (int i = tid; i < NG; i += THREADS) {
    int s = 0;
    for (int j = 0; j < nchunk; ++j) s += hp[j * NG + i];
    hist[size_t(b) * NG + i] = float(s);
  }
}

}  // namespace

extern "C" {

// Bytes of workspace firstorder_accumulate needs for B maps of N pixels.
long long firstorder_workspace(int B, int N) {
  if (B <= 0 || N <= 0) return 0;
  return static_cast<long long>(carve(nullptr, B, plan(B, N).nchunk).bytes);
}

// Launches both phases on `stream` and returns cudaGetLastError() (0 = ok).
// image [B, N] float32, levels [B, N] int32 (contiguous), stats [B, 9] and
// hist [B, NG] float32, ws firstorder_workspace(B, N) bytes (256-byte
// aligned).
int firstorder_accumulate(const void* image, const void* levels, void* stats, void* hist, int B,
                          int N, void* ws, void* stream) {
  if (B <= 0 || N <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(B, N);
  const Workspace w = carve(ws, B, p.nchunk);
  const dim3 grid(p.nchunk, B);
  const bool vec = (N & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(levels)) &
                    15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(image);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  firstorder_phase0<<<grid, THREADS, 0, s>>>(x, lv, N, p.chunk, p.nchunk, vec, w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  firstorder_phase1<<<grid, THREADS, 0, s>>>(x, lv, N, p.chunk, p.nchunk, vec, w,
                                             static_cast<float*>(stats),
                                             static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}

const char* firstorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
