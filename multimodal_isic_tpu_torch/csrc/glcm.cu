// Gray-level co-occurrence counts of a batch of masked maps, Hopper (sm_90a),
// plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_glcm.py::glcm_matrices_pallas
//   (_glcm_kernel, with _neighbor_columns)
// which backs texture.glcm_features.  For each map m, each of the 4 force2D
// angles a = (dy, dx) in {(0,1), (1,-1), (1,0), (1,1)} and each pixel p:
// the pair (lv[p], lv[p + (dy, dx)]) counts when p is inside the ROI
// (mask != 0, 1 <= lv <= 64) and p + (dy, dx) lies in the frame and inside
// too (_neighbor_columns, pallas_glcm.py:64-78).  The output is the
// symmetric matrix P + P^T in float32, [M, 4, 64, 64], which is exactly
// glcm_matrices_pallas's result for every map.
//
// Numerics: integers only.  Counts are int32 in shared memory; the flush adds
// P[a][i][j] + P[a][j][i] (at most 2*H*W < 2^24) to the zeroed float32 output
// with atomicAdd, exact for integers in any order: equal to the plain version
// bit for bit.
//
// What bounds it on the card: memory.  The levels (int32) and the mask
// (uint8) are read once, 5 bytes a pixel; the output is 64 KB a map.  At the
// radiomics chunk (M = 64 maps of 450 x 600) that is 69.1 + 17.3 MB read and
// 4.2 MB written: 27 us at 3.35 TB/s.  The neighbour reads hit L1/L2 (the
// next row of the same block).
//
// Design.  The TPU kernel built bf16 one-hot tiles in VMEM for one MXU
// contraction (no scatter on the TPU); Hopper has shared-memory atomics, so
// each block keeps the map's 4 x 64 x 64 int32 histogram (64 KB, dynamic
// shared memory above the 48 KB default) and adds one count per valid pair.
// Blocks cover (a chunk of pixels, a map): grid (chunks, M); threads stride
// the chunk so that loads coalesce.  At the end each block adds its
// symmetrised non-zero bins to the map's output.  Left for later work:
// per-warp sub-histograms against atomic contention on flat regions, and
// vector loads.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NG = 64;
constexpr int BINS = 4 * NG * NG;
constexpr int THREADS = 512;
constexpr int CHUNK = 32768;  // pixels per block
constexpr int SMEM = BINS * 4;

__global__ void __launch_bounds__(THREADS)
glcm_counts_kernel(const int32_t* __restrict__ levels,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int h, int w) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < BINS; i += THREADS) hist[i] = 0;
  __syncthreads();

  const int n = h * w;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const int32_t* lv = levels + base;
  const uint8_t* mk = mask + base;
  const int begin = blockIdx.x * CHUNK;
  const int end = min(n, begin + CHUNK);
  const int dys[4] = {0, 1, 1, 1};
  const int dxs[4] = {1, -1, 0, 1};

  for (int p = begin + threadIdx.x; p < end; p += THREADS) {
    if (mk[p] == 0) continue;
    const int c = lv[p];
    if (c < 1 || c > NG) continue;
    const int y = p / w;
    const int x = p - y * w;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ny = y + dys[a];
      const int nx = x + dxs[a];
      if (ny >= h || nx < 0 || nx >= w) continue;
      const int q = ny * w + nx;
      if (mk[q] == 0) continue;
      const int v = lv[q];
      if (v < 1 || v > NG) continue;
      atomicAdd(&hist[(a * NG + c - 1) * NG + v - 1], 1);
    }
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(blockIdx.y) * BINS;
  for (int i = threadIdx.x; i < BINS; i += THREADS) {
    const int a = i / (NG * NG);
    const int r = i - a * NG * NG;
    const int ci = r / NG;
    const int cj = r - ci * NG;
    const int v = hist[i] + hist[a * NG * NG + cj * NG + ci];
    if (v != 0) atomicAdd(&o[i], static_cast<float>(v));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
// levels [M, H, W] int32, mask [M, H, W] uint8/bool (inside != 0), out
// [M, 4, 64, 64] float32 zeroed by the caller; all contiguous on one device.
int glcm_counts(const void* levels, const void* mask, void* out, int m, int h,
                int w, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glcm_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = h * w;
  const dim3 grid((n + CHUNK - 1) / CHUNK, m);
  glcm_counts_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(levels), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* glcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
