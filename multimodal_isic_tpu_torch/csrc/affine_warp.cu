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
// |c| mod period (fmodf, exact), then min(m, period - m); n = 1 maps to 0.
// The +1 tap is clamped to n-1, where its weight is exactly 0 (the edge
// duplicates of _warp_taps).  The blend is in f32.  The TPU kernel's bf16
// tent weights (pallas_warp.py:34-39) have no counterpart: this kernel
// computes in f32 only.
//
// What bounds it on the card: memory.  Each output pixel reads 4 taps of C
// floats and writes C floats, a few dozen flops.  At bs 16, 380^2, C = 3, f32
// the input and output are 2*16*380^2*3*4 B = 55.4 MB: 16.5 us at 3.35 TB/s
// (132 us at bs 128).
//
// Design.  One thread per output pixel, all C channels; a block of 32 x 8
// threads covers 32 columns of 8 rows of one image.  Neighbouring threads of
// a warp are neighbouring output columns, whose source coordinates differ by
// (i11, i21), |i21| <= 0.3 for the policy: their taps fall on one or two
// source rows and neighbouring columns, so the gathers of a warp coalesce
// into a few 128-byte lines, and L1/L2 serve the rows that the 8 warps of a
// block and the next block share.  The coordinates are reflected in place:
// there is no padded copy of the batch in device memory, no band and no pad
// budget, so any affine map and any image size is exact.  Left for later
// work: vector loads of the taps, several pixels per thread.
//
// Built by ops/_build.py with nvcc at first launch, like fused_dwconv.cu;
// its library name hashes every csrc/ source, so adding or editing this file
// rebuilds both libraries once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

// _mirror_coord: REFLECT_101 into [0, n-1]
__device__ __forceinline__ float mirror_coord(float c, int n) {
  if (n == 1) return 0.0f;
  const float period = 2.0f * static_cast<float>(n - 1);
  const float m = fmodf(fabsf(c), period);
  return fminf(m, period - m);
}

__global__ void __launch_bounds__(BX * BY)
affine_warp_kernel(const float* __restrict__ src, const float* __restrict__ inv,
                   const uint8_t* __restrict__ apply, float* __restrict__ out,
                   int h, int w, int c, int oh, int ow) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= ow || y >= oh) return;
  const float* img = src + static_cast<size_t>(b) * h * w * c;
  float* dst = out + ((static_cast<size_t>(b) * oh + y) * ow + x) * c;

  if (apply != nullptr && apply[b] == 0) {  // caller guarantees oh, ow == h, w
    const float* s = img + (static_cast<size_t>(y) * w + x) * c;
    for (int ch = 0; ch < c; ++ch) dst[ch] = s[ch];
    return;
  }

  const float* p = inv + 6 * b;
  const float xf = static_cast<float>(x), yf = static_cast<float>(y);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(p[0], xf), __fmul_rn(p[1], yf)), p[2]);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(p[3], xf), __fmul_rn(p[4], yf)), p[5]);
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
  for (int ch = 0; ch < c; ++ch) {
    dst[ch] = __ldg(r0 + x0 * c + ch) * w00 + __ldg(r0 + x1 * c + ch) * w01
            + __ldg(r1 + x0 * c + ch) * w10 + __ldg(r1 + x1 * c + ch) * w11;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
// src [B, H, W, C] f32, inv [B, 6] f32, apply [B] uint8 or null (all warped),
// out [B, OH, OW, C] f32; all contiguous on one device.
int affine_warp_f32(const void* src, const void* inv, const void* apply, void* out,
                    int b, int h, int w, int c, int oh, int ow, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((ow + BX - 1) / BX, (oh + BY - 1) / BY, b);
  affine_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(inv),
      static_cast<const uint8_t*>(apply), static_cast<float*>(out), h, w, c, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

const char* affine_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
