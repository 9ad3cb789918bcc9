// Same-level 8-connected components of a batch of masked maps, Hopper
// (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_cc.py::connected_components_pallas
//   (_cc_kernel)
// which labels the GLSZM zones of texture_extra.glszm_features.  Two pixels
// are linked when both are inside the ROI, have the same level and are
// 8-neighbours.  label[p] = the minimum linear index (y * W + x, within the
// map) of p's component, and H * W outside the ROI: the labels of
// connected_components_pallas and of the XLA hooking loop
// (texture_extra.py:22-83).  out [M, H, W] int32.
//
// Numerics: integers only, equal to the plain version bit for bit.  The
// union-find below links the larger root under the smaller with atomicMin, so
// every parent index is at most its child's and a component's final root is
// its minimum index, whatever order the links land in.
//
// What bounds it on the card: memory.  The levels (int32) and the inside
// flags (1 byte) are read once and the labels written once: at the radiomics
// chunk (M = 64 maps of 450 x 600) 86.4 MB read and 69.1 MB written, 46 us at
// 3.35 TB/s.  The union-find's pointer chasing reads the labels again through
// L2.
//
// Design.  A 450 x 600 map is 1.08 MB of labels, far beyond one block's
// 227 KB of shared memory, so the TPU kernel's VMEM-resident sweep to a fixed
// point does not carry over.  Instead, global-memory union-find in three
// launches:
//  1. init: one warp per row walks 32-pixel chunks left to right; the run
//     starts of a chunk form a ballot mask, and each lane's label is its
//     horizontal run's start (the highest set bit at or below it, else the
//     last start of the chunks to its left), as texture_extra.py:44-50
//     starts.  A run's start is its own parent, so rows are merged already.
//  2. merge: one thread per pixel unites it with its same-level neighbours in
//     the row above (up-left, up, up-right; the row below unites with this
//     one): find both roots, atomicMin the larger root's parent to the
//     smaller, retry while another thread won (Playne & Hawick's union).
//  3. compress: every inside pixel takes its root.
// The reads inside find go through L2 (__ldcg): parents written by other SMs'
// atomics are never served stale from L1.  Left for later work: a
// shared-memory pass per tile before the global merge.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(ROW_WARPS * 32)
cc_init_kernel(const int32_t* __restrict__ levels,
               const uint8_t* __restrict__ inside, int32_t* __restrict__ label,
               int h, int w) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (y >= h) return;  // whole warps leave together
  const size_t row = (static_cast<size_t>(blockIdx.y) * h + y) * w;
  const int32_t* lv = levels + row;
  const uint8_t* in = inside + row;
  int32_t* lab = label + row;
  const int big = h * w;

  int carry_start = 0;       // last run start left of the chunk (x)
  bool left_in = false;      // the pixel left of the chunk
  int left_lv = -1;
  for (int base = 0; base < w; base += 32) {
    const int x = base + lane;
    const bool valid = x < w;
    const bool cin = valid && in[x] != 0;
    const int clv = valid ? lv[x] : -1;
    int plv = __shfl_up_sync(0xffffffffu, clv, 1);
    bool pin = __shfl_up_sync(0xffffffffu, cin, 1);
    if (lane == 0) { plv = left_lv; pin = left_in; }
    const bool start = cin && (!pin || plv != clv);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned at_or_before = starts & ((2u << lane) - 1u);
    const int run_x = at_or_before ? base + 31 - __clz(at_or_before) : carry_start;
    if (valid) lab[x] = cin ? y * w + run_x : big;
    if (starts) carry_start = base + 31 - __clz(starts);
    left_in = __shfl_sync(0xffffffffu, cin, 31);
    left_lv = __shfl_sync(0xffffffffu, clv, 31);
  }
}

__device__ __forceinline__ int find_root(const int32_t* lab, int x) {
  int parent = __ldcg(lab + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(lab + x);
  }
  return x;
}

__device__ void unite(int32_t* lab, int a, int b) {
  bool done = false;
  do {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a < b) {
      const int old = atomicMin(lab + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(lab + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(THREADS)
cc_merge_kernel(const int32_t* __restrict__ levels,
                const uint8_t* __restrict__ inside, int32_t* label, int h,
                int w) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = h * w;
  if (p >= n) return;
  const size_t map = static_cast<size_t>(blockIdx.y) * n;
  const int32_t* lv = levels + map;
  const uint8_t* in = inside + map;
  int32_t* lab = label + map;
  if (in[p] == 0) return;
  const int y = p / w;
  if (y == 0) return;
  const int x = p - y * w;
  const int c = lv[p];
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = x + dx;
    if (nx < 0 || nx >= w) continue;
    const int q = p - w + dx;
    if (in[q] != 0 && lv[q] == c) unite(lab, p, q);
  }
}

__global__ void __launch_bounds__(THREADS)
cc_compress_kernel(const uint8_t* __restrict__ inside, int32_t* label, int h,
                   int w) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = h * w;
  if (p >= n) return;
  const size_t map = static_cast<size_t>(blockIdx.y) * n;
  if (inside[map + p] == 0) return;  // already H * W
  int32_t* lab = label + map;
  lab[p] = find_root(lab, p);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
// levels [M, H, W] int32, inside [M, H, W] bool/uint8, out [M, H, W] int32;
// all contiguous on one device.
int connected_components(const void* levels, const void* inside, void* out,
                         int m, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  const uint8_t* in = static_cast<const uint8_t*>(inside);
  int32_t* lab = static_cast<int32_t*>(out);
  cc_init_kernel<<<dim3((h + ROW_WARPS - 1) / ROW_WARPS, m), ROW_WARPS * 32, 0, s>>>(
      lv, in, lab, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h * w + THREADS - 1) / THREADS, m);
  cc_merge_kernel<<<grid, THREADS, 0, s>>>(lv, in, lab, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_compress_kernel<<<grid, THREADS, 0, s>>>(in, lab, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* connected_components_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
