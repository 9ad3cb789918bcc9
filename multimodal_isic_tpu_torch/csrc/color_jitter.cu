// Colour jitter for Hopper (sm_90a), plain C interface.
//
// Replaces no pallas_call: the JAX package's ColorJitter
//   multimodal_isic_tpu/data/augment.py:331-423 (color_jitter, _rgb_to_hsv,
//   _hsv_to_rgb)
// is plain jnp, and the port ran it as plain PyTorch
// (ops/color_jitter.py::color_jitter_reference), which computes all four
// adjustments of the whole batch at each of its four steps and selects one
// per image: 16 full-batch candidates and 4 HSV round trips, several hundred
// launches a call.  This kernel applies each image's own order in registers.
// For every image b of imgs [B, H, W, 3] float32 (0..255) whose apply flag is
// set, the adjustments run in the order perm[b] (0 brightness, 1 contrast,
// 2 saturation, 3 hue):
//   brightness  x * fb
//   contrast    m + fc * (x - m),  m = the image's mean of gray(clamp(x))
//   saturation  g + fs * (x - g),  g = gray(clamp(x)) of the pixel
//   hue         rgb(h + fh mod 1, s, v) * 255, (h, s, v) = hsv(clamp(x) / 255)
// then clamp to 0..255; clamp(x) is x clamped to 0..255 and gray =
// 0.299 r + 0.587 g + 0.114 b.  The running value between steps is not
// clamped.  An image whose flag is 0 is copied bit for bit.  Each perm row
// must be a permutation of 0..3, as data/augment.py::color_jitter_draw gives
// it: the kernel takes a code's low two bits and does not check the row.
//
// Numerics.  Every product, sum and quotient is rounded as the plain
// version rounds it on the card, one operation at a time (explicit
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: no FMA contraction; a
// quotient of two tensors is an IEEE division, a tensor over 255 or 6 a
// product with the float32 reciprocal, as PyTorch computes it on a CUDA
// tensor; the CPU divides, within an ulp of that): the 1e-12 floors of
// _rgb_to_hsv, remainder(., 1) with the divisor's sign (fmod's signed
// fractional part, plus 1 where it is negative), i = floor(6h) mod 6 and
// _hsv_to_rgb's sector table.  What may differ from the plain version: gray's
// three products are summed left to right (the plain version's is a matrix
// product, summed in the library's order), and the mean: each thread sums its
// pixels' gray in float64, the warp by shuffles, the block's warps in index
// order, the cluster's blocks in rank order, and the mean is the float64 sum
// over n rounded once.  The order is fixed by the image size alone, so a
// rerun gives the same bits, and an image's result does not depend on the
// batch around it (no float atomics).
//
// What bounds it on the card: memory.  The result needs each pixel read
// once and written once: at bs 64, 380^2, 2 * 110.9 MB = 221.8 MB, 66 us at
// 3.35 TB/s.  This design reads a drawn image twice, and its hue step (three
// IEEE divisions a pixel) is a few hundred instructions: on the H100 the
// launch takes ~0.13-0.15 ms at bs 64, of which a batch with no image drawn
// (a copy) takes 0.088 and the hue step about two thirds of the rest
// (PERF.md).
//
// Design.  Contrast comes once in each image's order and every adjustment
// before it is pointwise, so the mean it needs is one pass that applies the
// order's prefix pixel by pixel.  One launch, one thread-block cluster of
// CLUSTER = 8 blocks an image (grid CLUSTER x B):
//   - block r takes the image's pixels [r S, (r + 1) S), S = slice_px(n) (a
//     multiple of CHUNK); its warps walk the slice in chunks of CHUNK = 128
//     pixels (384 floats), chunk k to warp k mod 16;
//   - a chunk is read with coalesced 4-byte loads (lane l: floats l, l + 32,
//     ...; any alignment, any size) into the warp's buffer in shared memory,
//     from which lane l takes pixels 4l .. 4l + 3 as three float4 (no bank
//     conflicts).  Issuing the next chunk's loads before computing this one
//     was slower (H100, PERF.md): 16 warps a block and two blocks an SM
//     (64 registers) keep enough loads in flight;
//   - phase 1: the prefix of the order before contrast, then gray(clamp(x))
//     summed; the block's sum goes to shared memory; cluster.sync(); every
//     block reads the cluster's eight sums over distributed shared memory in
//     rank order, so every block holds the same mean bits;
//   - phase 2: the block reads its slice again, applies the whole order and
//     the final clamp and writes through the same buffer.  It walks its
//     chunks in reverse, so the chunks read last in phase 1, the likeliest
//     still in the 50 MB L2, are read first; phase 2's loads are marked
//     evict-first;
//   - a last cluster.sync() keeps each block's sum alive while the others
//     may read it.  An image not drawn skips both syncs: its blocks copy
//     their slices.
// At bs 64, 264 blocks are resident at once (two an SM), and a cluster of an
// image not drawn, a copy, soon makes room for the next; phase 1 reads the
// drawn half of the batch (~55 MB), so much of phase 2's second read comes
// from L2.
//
// The wrapper owns the plan (ops/color_jitter.py::jitter_plan: cluster,
// threads, slice); the library recomputes its own and refuses any other.
// Built by ops/_build.py with nvcc at first launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;             // blocks an image (a portable cluster)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;             // pixels a warp's step, 4 a lane
constexpr int CF = 3 * CHUNK;          // floats of a chunk
constexpr int LOADS = CF / 32;         // floats a lane loads of a chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr int BRIGHTNESS = 0, CONTRAST = 1, SATURATION = 2;
// x / 255 and h / 6 as the plain version computes them on the card: PyTorch
// divides a CUDA tensor by a Python number as a product with its float32
// reciprocal
constexpr float INV255 = 1.0f / 255.0f, INV6 = 1.0f / 6.0f;

// Pixels a block takes: an eighth of the image, rounded up to whole chunks.
__host__ __device__ constexpr long long slice_px(long long n) {
  return ((n + CLUSTER - 1) / CLUSTER + CHUNK - 1) / CHUNK * CHUNK;
}

__device__ __forceinline__ float clamp255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// clamp(x) @ LUMA: three products, summed left to right
__device__ __forceinline__ float gray(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(clamp255(r), 0.299f),
                             __fmul_rn(clamp255(g), 0.587f)),
                   __fmul_rn(clamp255(b), 0.114f));
}

// torch.remainder(a, 1.0): fmod(a, 1), the fractional part with a's sign
// (exact; -0 for a negative whole number), plus 1 where it is negative
__device__ __forceinline__ float rem1(float a) {
  const float m = copysignf(__fsub_rn(a, truncf(a)), a);
  return m < 0.0f ? __fadd_rn(m, 1.0f) : m;
}

// The hue step on one pixel: _rgb_to_hsv, the shift, _hsv_to_rgb.  Of
// rc, gc, bc the plain version computes all three and selects two; this
// computes the two it selects (the same bits), and the branch without a
// constant adds 0 first (exact: the quotients are >= 0).
__device__ __forceinline__ void hue_px(float& R, float& G, float& B, float fh) {
  const float r = __fmul_rn(clamp255(R), INV255);
  const float g = __fmul_rn(clamp255(G), INV255);
  const float b = __fmul_rn(clamp255(B), INV255);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = __fsub_rn(maxc, minc);
  const float s = maxc > 0.0f ? __fdiv_rn(delta, fmaxf(maxc, 1e-12f)) : 0.0f;
  const float safe = fmaxf(delta, 1e-12f);
  // r max: bc - gc; else g max: 2 + rc - bc; else 4 + gc - rc
  const bool rmax = r == maxc, gmax = !rmax && g == maxc;
  const float base = rmax ? 0.0f : gmax ? 2.0f : 4.0f;
  const float add = rmax ? b : gmax ? r : g;
  const float sub = rmax ? g : gmax ? b : r;
  float h = __fsub_rn(__fadd_rn(base, __fdiv_rn(__fsub_rn(maxc, add), safe)),
                      __fdiv_rn(__fsub_rn(maxc, sub), safe));
  h = delta > 0.0f ? rem1(__fmul_rn(h, INV6)) : 0.0f;
  h = rem1(__fadd_rn(h, fh));
  const float v = maxc;
  const float h6 = __fmul_rn(h, 6.0f);
  const float fi = floorf(h6);
  const float f = __fsub_rn(h6, fi);
  const float p = __fmul_rn(v, __fsub_rn(1.0f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, f)));
  const float t = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, __fsub_rn(1.0f, f))));
  int i = static_cast<int>(fi) % 6;
  if (i < 0) i += 6;
  float ro, go, bo;  // r: v q p p t v, g: t v v q p p, b: p p t v v q
  switch (i) {
    case 0: ro = v; go = t; bo = p; break;
    case 1: ro = q; go = v; bo = p; break;
    case 2: ro = p; go = v; bo = t; break;
    case 3: ro = p; go = q; bo = v; break;
    case 4: ro = t; go = p; bo = v; break;
    default: ro = v; go = p; bo = q; break;
  }
  R = __fmul_rn(ro, 255.0f);
  G = __fmul_rn(go, 255.0f);
  B = __fmul_rn(bo, 255.0f);
}

struct Job {  // one image's adjustments, the same in every thread
  int ops;    // the order, 2 bits a step
  int cpos;   // the step that is contrast
  float fb, fc, fs, fh;
};

// Adjustment `op` on a lane's 4 pixels x[3q + c]; `mean` is contrast's.
__device__ __forceinline__ void adjust(int op, float (&x)[12], const Job& j,
                                       float mean) {
  if (op == BRIGHTNESS) {
#pragma unroll
    for (int k = 0; k < 12; ++k) x[k] = __fmul_rn(x[k], j.fb);
  } else if (op == CONTRAST) {
#pragma unroll
    for (int k = 0; k < 12; ++k)
      x[k] = __fadd_rn(mean, __fmul_rn(j.fc, __fsub_rn(x[k], mean)));
  } else if (op == SATURATION) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float g = gray(x[3 * q], x[3 * q + 1], x[3 * q + 2]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        x[3 * q + c] = __fadd_rn(g, __fmul_rn(j.fs, __fsub_rn(x[3 * q + c], g)));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) hue_px(x[3 * q], x[3 * q + 1], x[3 * q + 2], j.fh);
  }
}

// Floats [0, nf) of a chunk at src, lane-strided: v[k] = src[lane + 32 k].
template <bool kLast>
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int nf,
                                           int lane, float (&v)[LOADS]) {
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < nf ? (kLast ? __ldcs(src + i) : __ldg(src + i)) : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(float* __restrict__ dst, int nf, int lane,
                                            const float (&v)[LOADS]) {
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = lane + 32 * k;
    if (i < nf) dst[i] = v[k];
  }
}

// The lane's 4 pixels from / to the warp's chunk buffer (three float4).
__device__ __forceinline__ void take_px(const float* wb, int lane, float (&x)[12]) {
  const float4* w4 = reinterpret_cast<const float4*>(wb) + 3 * lane;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float4 a = w4[m];
    x[4 * m] = a.x;
    x[4 * m + 1] = a.y;
    x[4 * m + 2] = a.z;
    x[4 * m + 3] = a.w;
  }
}

__device__ __forceinline__ void put_px(float* wb, int lane, const float (&x)[12]) {
  float4* w4 = reinterpret_cast<float4*>(wb) + 3 * lane;
#pragma unroll
  for (int m = 0; m < 3; ++m)
    w4[m] = make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Block r of image b's cluster: pixels [lo, hi) of the image, `slice` a block.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
color_jitter_kernel(const float* __restrict__ src, const uint8_t* __restrict__ apply,
                    const float* __restrict__ fb, const float* __restrict__ fc,
                    const float* __restrict__ fs, const float* __restrict__ fh,
                    const long long* __restrict__ perm, float* __restrict__ out,
                    int n, int slice) {
  __shared__ __align__(16) float buf[WARPS][CF];
  __shared__ double wsum[WARPS];
  __shared__ double part;  // the block's sum, read by the cluster
  __shared__ float s_mean;
  const int b = blockIdx.y;
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = min(n, r * slice), hi = min(n, lo + slice);
  const int nch = (hi - lo + CHUNK - 1) / CHUNK;
  const size_t base = static_cast<size_t>(b) * n * 3;
  const float* img = src + base;
  float* dst = out + base;
  const auto at = [&](int k) { return 3 * static_cast<size_t>(lo + k * CHUNK); };
  const auto floats = [&](int k) { return 3 * min(CHUNK, hi - lo - k * CHUNK); };

  if (!apply[b]) {  // not drawn: a copy, bit for bit
    for (int k = warp; k < nch; k += WARPS) {
      float v[LOADS];
      load_chunk<true>(img + at(k), floats(k), lane, v);
      store_chunk(dst + at(k), floats(k), lane, v);
    }
    return;
  }

  Job job;
  job.ops = 0;
  job.cpos = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int op = static_cast<int>(perm[4 * static_cast<size_t>(b) + s] & 3);
    job.ops |= op << (2 * s);
    if (op == CONTRAST) job.cpos = s;
  }
  job.fb = fb[b];
  job.fc = fc[b];
  job.fs = fs[b];
  job.fh = fh[b];
  const auto op_at = [&](int s) { return (job.ops >> (2 * s)) & 3; };
  float* wb = buf[warp];
  float v[LOADS], x[12];

  // ---- phase 1: the order's prefix before contrast, gray(clamp(x)) summed
  double acc = 0.0;
  for (int k = warp; k < nch; k += WARPS) {
    const int nf = floats(k);
    load_chunk<false>(img + at(k), nf, lane, v);
    __syncwarp(FULL);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) wb[lane + 32 * m] = v[m];
    __syncwarp(FULL);
    take_px(wb, lane, x);
#pragma unroll 1
    for (int s = 0; s < job.cpos; ++s) adjust(op_at(s), x, job, 0.0f);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (3 * (4 * lane + q) < nf) acc += static_cast<double>(gray(x[3 * q], x[3 * q + 1], x[3 * q + 2]));
  }
  acc = warp_sum(acc);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += wsum[w];
    part = t;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sum is written
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k) t += *cluster.map_shared_rank(&part, k);
    s_mean = static_cast<float>(t / static_cast<double>(n));
  }
  __syncthreads();
  const float mean = s_mean;

  // ---- phase 2: the whole order and the final clamp, chunks in reverse
  for (int k = warp + (nch - 1 - warp) / WARPS * WARPS; k >= 0 && warp < nch; k -= WARPS) {
    const int nf = floats(k);
    load_chunk<true>(img + at(k), nf, lane, v);
    __syncwarp(FULL);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) wb[lane + 32 * m] = v[m];
    __syncwarp(FULL);
    take_px(wb, lane, x);
#pragma unroll 1  // one copy of each adjustment's code: the hue step is long
    for (int s = 0; s < 4; ++s) adjust(op_at(s), x, job, mean);
#pragma unroll
    for (int m = 0; m < 12; ++m) x[m] = clamp255(x[m]);
    put_px(wb, lane, x);
    __syncwarp(FULL);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) v[m] = wb[lane + 32 * m];
    store_chunk(dst + at(k), nf, lane, v);
  }
  cluster.sync();  // no block leaves while another may read its sum
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a plan that is not this library's.
// src and out [B, n, 3] float32 (n = H * W pixels), apply [B] uint8,
// brightness, contrast, saturation, hue [B] float32, perm [B, 4] int64; all
// contiguous on one device.  Plan: cluster, threads and slice as
// ops/color_jitter.py::jitter_plan gives them (the grid is cluster x B).
int color_jitter_f32(const void* src, const void* apply, const void* brightness,
                     const void* contrast, const void* saturation, const void* hue,
                     const void* perm, void* out, int b, int n, int cluster,
                     int threads, int slice, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || 3LL * n + 3LL * CHUNK > 0x7fffffffLL
      || cluster != CLUSTER || threads != THREADS || slice != slice_px(n))
    return static_cast<int>(cudaErrorInvalidValue);
  color_jitter_kernel<<<dim3(CLUSTER, b), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const uint8_t*>(apply),
      static_cast<const float*>(brightness), static_cast<const float*>(contrast),
      static_cast<const float*>(saturation), static_cast<const float*>(hue),
      static_cast<const long long*>(perm), static_cast<float*>(out), n, slice);
  return static_cast<int>(cudaGetLastError());
}

const char* color_jitter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
