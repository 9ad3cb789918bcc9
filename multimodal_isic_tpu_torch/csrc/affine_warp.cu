// Batched affine image warp for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_warp.py::affine_warp_batch
//   (_warp_kernel, with its mirror_pad copy)
// the ShiftScaleRotate warp of the fast fusion train policy.  For every
// output pixel (x, y) of image b:
//   sx = i11*x + i12*y + i13,  sy = i21*x + i22*y + i23        (f32)
//   reflect sx into [0, W-1] and sy into [0, H-1], REFLECT_101
//   out[b, y, x, :] = bilinear blend of the four taps around (sy, sx)
// which is data/augment.py::_warp_taps(order=1) at those coordinates
// (augment.py:162-219).  Images whose apply flag is 0 come through
// unchanged, so the policy's select (augment.py:540) is this same launch.
//
// Numerics.  The coordinates are computed with explicitly rounded f32
// multiplies and adds in the JAX order (no FMA contraction), so they are
// those of the plain version.  REFLECT_101 is _mirror_coord: period 2(n-1),
// |c| mod period, then min(m, period - m); n = 1 maps to 0.  |c| mod period
// is |c| itself below one period (fmodf(a, p) == a exactly for 0 <= a < p),
// so fmodf, a software loop for a divisor that is no constant, runs only
// for the rare overhang beyond a period: the same bits at a fraction of the
// instructions.  The +1 tap is clamped to n-1, where its weight is exactly 0
// (the edge duplicates of _warp_taps).  The blend is in f32, its roundings
// explicit (a product and three fused multiply-adds).  The TPU
// kernel's bf16 tent weights (pallas_warp.py:34-39) have no counterpart:
// this kernel computes in f32 only.
//
// What bounds it on the card: memory.  Each output pixel reads 4 taps of C
// floats and writes C floats, a few dozen flops.  At bs 16, 380^2, C = 3, f32
// the input and output are 2*16*380^2*3*4 B = 55.4 MB: 16.5 us at 3.35 TB/s
// (132 us at bs 128).
//
// Design (the launch plan is the wrapper's, ops/affine_warp.py::warp_plan;
// this library recomputes its own and refuses any other).
// - A warp's task is a strip of STRIP = 128 output pixels of one row; a
//   block is 8 such tasks in row-major order (b, y, strip), so the blocks
//   that run together read neighbouring source rows.
// - Lane l computes the pixels l, l + 32, l + 64, l + 96 of its strip: in
//   each tap load the 32 lanes read neighbouring source pixels, so the
//   gathers of a warp coalesce into few lines, served by L1/L2.  All four
//   pixels are computed unconditionally (the strip's ragged end at
//   in-image coordinates, not written): no branch stands between their 48
//   tap loads.  What holds the kernel back is the L1 work of these
//   gathers: a warp's 32 pixels of one row fall on up to 10 source rows at
//   15 degrees, and without its taps the kernel runs in a third of its
//   time.  Three ways to cut that work gained nothing on the H100 and were
//   taken out (PERF.md): loading a tap row's 6 floats as 2 or 3 aligned
//   float4; warp tasks of 8 x 4 pixel patches (fewer source rows a load,
//   but slower stores); staging each 32 x 32 tile's source window in
//   shared memory (reflected into the window its taps read, copied with
//   cp.async, double-buffered in persistent blocks), whose copies cost as
//   much as the taps they saved.
// - Stores: each pixel's C outputs go to a row buffer of the warp in shared
//   memory (lanes 3 words apart at C = 3: no bank conflicts), laid out at
//   the output row's alignment, and the warp writes the strip with 16-byte
//   stores: 128 * 3 * 4 B = 1536 B in three instructions of 512 contiguous
//   bytes, instead of 12-byte stores at a 12-byte stride.  A ragged head or
//   tail (an output row offset that is no multiple of 4 floats) goes out in
//   scalar stores, in the same kernel.
// - Images whose apply flag is 0: the strip is a plain 16-byte copy (the
//   same ragged-edge rule) in the same launch.
// - Coordinates are reflected in place: there is no padded copy of the
//   batch in device memory, no band and no pad budget, so any affine map
//   and any image size is exact.
//
// Built by ops/_build.py with nvcc at first launch, like fused_dwconv.cu;
// its library name hashes every csrc/ source, so adding or editing this file
// rebuilds both libraries once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PX_LANE = 4;                 // output pixels a lane
constexpr int STRIP = 32 * PX_LANE;        // output pixels a warp's task
constexpr int MAX_C = 56;                  // channels the row buffers hold
constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

// shared memory of a block: WARPS row buffers of STRIP * C + 4 floats
__host__ __device__ constexpr int smem_bytes(int c) {
  return WARPS * (STRIP * c + 4) * 4;
}

// _mirror_coord: REFLECT_101 into [0, n-1]
__device__ __forceinline__ float mirror_coord(float c, int n) {
  if (n == 1) return 0.0f;
  const float period = 2.0f * static_cast<float>(n - 1);
  const float a = fabsf(c);
  const float m = a < period ? a : fmodf(a, period);
  return fminf(m, period - m);
}

// The four-tap blend, its roundings explicit: a product and three fused
// multiply-adds.
__device__ __forceinline__ float blend(float t00, float t01, float t10,
                                       float t11, float w00, float w01,
                                       float w10, float w11) {
  return __fmaf_rn(t11, w11, __fmaf_rn(t10, w10, __fmaf_rn(t01, w01,
                                                           __fmul_rn(t00, w00))));
}

// Floats [0, n) of a warp's row buffer `buf` (laid out from float
// `lead` = g % 4, so buf[lead + i] goes to dst[i] and dst = out + g, g a
// float offset) to device memory: scalar head and tail, 16-byte body.
__device__ __forceinline__ void store_row(float* __restrict__ out, size_t g,
                                          const float* buf, int n, int lane) {
  const int lead = static_cast<int>(g & 3);
  const int head = min(n, (4 - lead) & 3);
  const int body = (n - head) / 4;
  if (lane < head) out[g + lane] = buf[lead + lane];
  const float4* b4 = reinterpret_cast<const float4*>(buf + lead + head);
  float4* o4 = reinterpret_cast<float4*>(out + g + head);
  for (int i = lane; i < body; i += 32) o4[i] = b4[i];
  const int done = head + 4 * body;
  if (lane < n - done) out[g + done + lane] = buf[lead + done + lane];
}

// Floats [0, n) from src + g to out + g (the same layout): 16-byte body.
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ out, size_t g,
                                         int n, int lane) {
  const int head = min(n, static_cast<int>((4 - (g & 3)) & 3));
  const int body = (n - head) / 4;
  if (lane < head) out[g + lane] = __ldg(src + g + lane);
  const float4* s4 = reinterpret_cast<const float4*>(src + g + head);
  float4* o4 = reinterpret_cast<float4*>(out + g + head);
  for (int i = lane; i < body; i += 32) o4[i] = __ldg(s4 + i);
  const int done = head + 4 * body;
  if (lane < n - done) out[g + done + lane] = __ldg(src + g + done + lane);
}

// CT: the channel count where it is a compile-time constant (3), else 0.
template <int CT>
__global__ void __launch_bounds__(THREADS, 4)
affine_warp_kernel(const float* __restrict__ src, const float* __restrict__ inv,
                   const uint8_t* __restrict__ apply, float* __restrict__ out,
                   int n_tasks, int h, int w, int c_rt, int oh, int ow) {
  extern __shared__ __align__(16) float rowbuf[];
  const int c = CT > 0 ? CT : c_rt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + warp;
  if (task >= n_tasks) return;
  const int n_strips = (ow + STRIP - 1) / STRIP;
  const int row = task / n_strips;               // b * oh + y
  const int xb = (task - row * n_strips) * STRIP;
  const int b = row / oh, y = row - b * oh;
  const int n_px = min(STRIP, ow - xb);
  const size_t g = (static_cast<size_t>(row) * ow + xb) * c;  // out float offset

  if (apply != nullptr && apply[b] == 0) {  // caller guarantees oh, ow == h, w
    copy_row(src, out, g, n_px * c, lane);
    return;
  }

  float* buf = rowbuf + warp * (STRIP * c + 4);
  const int lead = static_cast<int>(g & 3);
  const float* img = src + static_cast<size_t>(b) * h * w * c;
  const float* p = inv + 6 * b;
  const float i11 = __ldg(p), i12 = __ldg(p + 1), i13 = __ldg(p + 2);
  const float i21 = __ldg(p + 3), i22 = __ldg(p + 4), i23 = __ldg(p + 5);
  const float yf = static_cast<float>(y);
  const float ry = __fmul_rn(i12, yf), ry2 = __fmul_rn(i22, yf);
  // All four pixels are computed (a pixel past the strip's end at a
  // reflected, in-image coordinate, and not written), so that nothing
  // orders one pixel's tap loads after another's.
#pragma unroll
  for (int k = 0; k < PX_LANE; ++k) {
    const int j = lane + 32 * k;
    const float xf = static_cast<float>(xb + j);
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(i11, xf), ry), i13);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(i21, xf), ry2), i23);
    const float mx = mirror_coord(sx, w);
    const float my = mirror_coord(sy, h);
    const float fx0 = floorf(mx), fy0 = floorf(my);
    const float fx = mx - fx0, fy = my - fy0;
    const int x0 = static_cast<int>(fx0), y0 = static_cast<int>(fy0);
    const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    const float* r0 = img + static_cast<size_t>(y0) * w * c;
    const float* r1 = img + static_cast<size_t>(y1) * w * c;
    float* d = buf + lead + j * c;
    for (int ch = 0; ch < c; ++ch) {
      const float v = blend(__ldg(r0 + x0 * c + ch), __ldg(r0 + x1 * c + ch),
                            __ldg(r1 + x0 * c + ch), __ldg(r1 + x1 * c + ch),
                            w00, w01, w10, w11);
      if (j < n_px) d[ch] = v;
    }
  }
  __syncwarp(FULL);
  store_row(out, g, buf, n_px * c, lane);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a plan that is not this library's layout.
// src [B, H, W, C] f32, inv [B, 6] f32, apply [B] uint8 or null (all warped),
// out [B, OH, OW, C] f32; all contiguous on one device, src and out 16-byte
// aligned.  Plan: pixels a lane, threads, blocks, stage bytes (none) and
// smem as ops/affine_warp.py::warp_plan gives them.
int affine_warp_f32(const void* src, const void* inv, const void* apply, void* out,
                    int b, int h, int w, int c, int oh, int ow, int px_lane,
                    int threads, int blocks, int stage, int smem, void* stream) {
  const long long n_tasks =
      static_cast<long long>(b) * oh * ((ow + STRIP - 1) / STRIP);
  if (b < 1 || h < 1 || w < 1 || c < 1 || c > MAX_C || oh < 1 || ow < 1
      || n_tasks > 0x7fffffffLL || px_lane != PX_LANE || threads != THREADS
      || stage != 0 || smem != smem_bytes(c) || smem > MAX_SMEM
      || static_cast<long long>(blocks) != (n_tasks + WARPS - 1) / WARPS
      || reinterpret_cast<uintptr_t>(src) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(src);
  const float* ip = static_cast<const float*>(inv);
  const uint8_t* ap = static_cast<const uint8_t*>(apply);
  float* op = static_cast<float*>(out);
  auto kernel = c == 3 ? affine_warp_kernel<3> : affine_warp_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, THREADS, smem, s>>>(sp, ip, ap, op, static_cast<int>(n_tasks),
                                       h, w, c, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

const char* affine_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
