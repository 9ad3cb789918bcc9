// Joint histograms of code pairs, batched over rows, Hopper (sm_90a), plain C
// interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_hist.py::joint_histogram_pallas
//   (_joint_hist_kernel)
// which backs the GLRLM (gray x run length) matrix of texture.glrlm_features.
// For each row r: P[r][a-1][b-1] = #{k : codes_a[r][k] = a and
// codes_b[r][k] = b}, counting only 1 <= a <= na and 1 <= b <= nb (the
// one-hot rows of the TPU kernel drop every other code, 0 = skip included).
// out [B, na, nb] float32.  On the radiomics path a row is one (map, angle),
// the codes are (gray, clip(length, 1, 640)) at the run starts and 0
// elsewhere: na = 64, nb = 640, B = 4 M.
//
// Numerics: integer counts, added to the zeroed float32 output with atomicAdd
// (exact below 2^24 in any order): equal to the plain version bit for bit.
//
// What bounds it on the card: memory.  The two code arrays are read once,
// 8 bytes an element, and the histograms written once: at the radiomics chunk
// (B = 256 rows of 270,000 codes) 553 MB read and 42 MB written, 178 us at
// 3.35 TB/s.
//
// Design.  The TPU kernel built one-hot tiles and contracted them on the MXU,
// na x nb x N multiply-adds for N counts.  Here a block keeps one row's
// na x nb int32 histogram in shared memory (64 x 640 x 4 = 160 KB, dynamic
// shared memory above the 48 KB default) and adds one shared-memory atomic
// per counted pair; the codes are read as int4 vectors when the row length
// allows.  Blocks cover (a chunk of the row, a row), enough chunks to put
// two blocks' worth of work on every SM; each block then adds its non-zero
// bins to the row's output.  Most codes on the path are 0 (only run starts
// count), so the read, not the atomics, is the cost.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 1024;
constexpr int SMS = 132;
constexpr int MIN_CHUNK = 8192;

__device__ __forceinline__ void count(int* hist, int a, int b, int na, int nb) {
  if (a >= 1 && a <= na && b >= 1 && b <= nb)
    atomicAdd(&hist[(a - 1) * nb + (b - 1)], 1);
}

__global__ void __launch_bounds__(THREADS)
joint_hist_kernel(const int32_t* __restrict__ ca, const int32_t* __restrict__ cb,
                  float* __restrict__ out, int n, int na, int nb, int chunk,
                  bool vec) {
  extern __shared__ int hist[];
  const int bins = na * nb;
  for (int i = threadIdx.x; i < bins; i += THREADS) hist[i] = 0;
  __syncthreads();

  const size_t row = static_cast<size_t>(blockIdx.y) * n;
  const int begin = blockIdx.x * chunk;
  const int end = min(n, begin + chunk);
  if (vec) {  // aligned rows, n and chunk multiples of 4: int4 loads
    const int4* a4 = reinterpret_cast<const int4*>(ca + row);
    const int4* b4 = reinterpret_cast<const int4*>(cb + row);
    for (int v = begin / 4 + threadIdx.x; v < end / 4; v += THREADS) {
      const int4 a = a4[v];
      const int4 b = b4[v];
      count(hist, a.x, b.x, na, nb);
      count(hist, a.y, b.y, na, nb);
      count(hist, a.z, b.z, na, nb);
      count(hist, a.w, b.w, na, nb);
    }
  } else {
    for (int k = begin + threadIdx.x; k < end; k += THREADS)
      count(hist, ca[row + k], cb[row + k], na, nb);
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(blockIdx.y) * bins;
  for (int i = threadIdx.x; i < bins; i += THREADS)
    if (hist[i] != 0) atomicAdd(&o[i], static_cast<float>(hist[i]));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
// codes_a, codes_b [B, N] int32, out [B, na, nb] float32 zeroed by the
// caller; na * nb * 4 bytes must fit one block's shared memory.
int joint_histogram(const void* codes_a, const void* codes_b, void* out,
                    int rows, int n, int na, int nb, void* stream) {
  const int smem = na * nb * 4;
  cudaError_t err = cudaFuncSetAttribute(
      joint_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int chunks = (2 * SMS + rows - 1) / rows;
  chunks = std::max(1, std::min(chunks, (n + MIN_CHUNK - 1) / MIN_CHUNK));
  int chunk = (n + chunks - 1) / chunks;
  chunk = (chunk + 3) & ~3;
  const dim3 grid((n + chunk - 1) / chunk, rows);
  const bool vec = (n & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(codes_a) |
                     reinterpret_cast<uintptr_t>(codes_b)) & 15) == 0;
  joint_hist_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes_a), static_cast<const int32_t*>(codes_b),
      static_cast<float*>(out), n, na, nb, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* joint_histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
