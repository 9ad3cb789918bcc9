// GLRLM run bookkeeping for the 4 angles of a batch of masked maps, Hopper
// (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_glrlm.py::glrlm_runs_pallas (_runs_kernel)
// which backs texture.glrlm_features.  For each map m, angle a = (dy, dx) in
// {(0,1), (1,-1), (1,0), (1,1)} and cell p inside the ROI, the packed word
//   start << 18 | gray << 11 | min(length, 2047)
// where start = the previous cell p - (dy, dx) is outside the frame, outside
// the ROI or of another level; gray = lv[p]; length = (position of the first
// run end at or after p along the line) - (position of p) + 1.  Cells outside
// the ROI get 0.  out [M, 4, H, W] int32, the bit layout of pallas_glrlm.py
// :32-34 and _runs_kernel's output (:81-84) for every map.
//
// Numerics: integers only, equal to the plain version bit for bit.
//
// What bounds it on the card: memory.  The levels (int32) and the inside
// flags (1 byte) are read once and 4 int32 words written per cell: at the
// radiomics chunk (M = 64 maps of 450 x 600) 86.4 MB read and 276 MB written,
// 108 us at 3.35 TB/s.
//
// Design.  The TPU kernel kept the map in VMEM and found each cell's run end
// by a doubling reverse cumulative min (log2(span) shifted copies per angle).
// Here a line is walked once, from its far end backwards, carrying the
// position of the current run's end: O(1) work per cell.
//  - Angle (0, 1), rows: one warp per row walks 32-cell chunks from the right.
//    The neighbours come from lane shuffles (lane 0 and 31 read across the
//    chunk edge), the run ends of a chunk form one ballot mask, and each
//    lane's run end is the lowest set bit at or above it, else the first end
//    of the chunks to its right.  Loads and stores coalesce.
//  - Angles (1, -1), (1, 0), (1, 1): one thread per line (column or
//    diagonal), all threads walking the rows together from the bottom up, so
//    that the cells a warp touches in one step lie side by side in one row.
// Two launches per call.  Left for later work: vector loads, fewer idle
// threads on the short diagonals.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEN_MAX = (1 << 11) - 1;
constexpr int ROW_WARPS = 8;
constexpr int LINE_THREADS = 128;

__device__ __forceinline__ int32_t pack(bool start, int lv, int length) {
  return (start ? (1 << 18) : 0) | (lv << 11) | min(length, LEN_MAX);
}

// Angle (0, 1): one warp per row.
__global__ void __launch_bounds__(ROW_WARPS * 32)
runs_rows_kernel(const int32_t* __restrict__ levels,
                 const uint8_t* __restrict__ inside, int32_t* __restrict__ out,
                 int h, int w) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (y >= h) return;  // whole warps leave together
  const int m = blockIdx.y;
  const size_t row = (static_cast<size_t>(m) * h + y) * w;
  const int32_t* lv = levels + row;
  const uint8_t* in = inside + row;
  int32_t* o = out + (static_cast<size_t>(m) * 4 * h + y) * w;  // angle 0

  int carry_end = INT32_MAX;        // first run end right of the chunk
  bool right_in = false;            // the cell right of the chunk
  int right_lv = -1;
  for (int base = ((w - 1) / 32) * 32; base >= 0; base -= 32) {
    const int x = base + lane;
    const bool valid = x < w;
    const bool cin = valid && in[x] != 0;
    const int clv = valid ? lv[x] : -1;
    int nlv = __shfl_down_sync(0xffffffffu, clv, 1);
    bool nin = __shfl_down_sync(0xffffffffu, cin, 1);
    if (lane == 31) { nlv = right_lv; nin = right_in; }
    int plv = __shfl_up_sync(0xffffffffu, clv, 1);
    bool pin = __shfl_up_sync(0xffffffffu, cin, 1);
    if (lane == 0) {
      pin = x > 0 && in[x - 1] != 0;
      plv = x > 0 ? lv[x - 1] : -1;
    }
    const bool is_end = cin && (!nin || nlv != clv);
    const bool start = cin && (!pin || plv != clv);
    const unsigned ends = __ballot_sync(0xffffffffu, is_end);
    const unsigned at_or_after = ends >> lane;
    const int end = at_or_after ? x + __ffs(at_or_after) - 1 : carry_end;
    if (valid) o[x] = cin ? pack(start, clv, end - x + 1) : 0;
    if (ends) carry_end = base + __ffs(ends) - 1;
    right_in = __shfl_sync(0xffffffffu, cin, 0);
    right_lv = __shfl_sync(0xffffffffu, clv, 0);
  }
}

// Angles 1..3, (1, -1), (1, 0), (1, 1): one thread per line.
__global__ void __launch_bounds__(LINE_THREADS)
runs_lines_kernel(const int32_t* __restrict__ levels,
                  const uint8_t* __restrict__ inside, int32_t* __restrict__ out,
                  int h, int w) {
  const int a = blockIdx.y + 1;
  const int m = blockIdx.z;
  const int l = blockIdx.x * LINE_THREADS + threadIdx.x;
  int y0, x0, len, dx;
  if (a == 2) {                       // (1, 0): columns
    if (l >= w) return;
    y0 = 0; x0 = l; len = h; dx = 0;
  } else if (a == 3) {                // (1, 1): x - y = d
    if (l >= h + w - 1) return;
    const int d = l - (h - 1);
    y0 = max(0, -d); x0 = y0 + d; len = min(h - y0, w - x0); dx = 1;
  } else {                            // (1, -1): x + y = s
    if (l >= h + w - 1) return;
    y0 = max(0, l - (w - 1)); x0 = l - y0; len = min(h - y0, x0 + 1); dx = -1;
  }
  const size_t map = static_cast<size_t>(m) * h * w;
  const int32_t* lv = levels + map;
  const uint8_t* in = inside + map;
  int32_t* o = out + (static_cast<size_t>(m) * 4 + a) * h * w;

  // walk k = len-1 .. 0 (cell (y0 + k, x0 + k*dx)), row by row from the
  // bottom so that a warp's cells of one step share a row
  const int y_last = y0 + len - 1;
  bool cin = false, nin = false;
  int clv = -1, nlv = -1;
  int end_k = 0;
  for (int y = h - 1; y >= 0; --y) {
    const int k = y - y0;
    if (k < 0 || y > y_last) continue;
    const int x = x0 + k * dx;
    const int p = y * w + x;
    if (y == y_last) { cin = in[p] != 0; clv = lv[p]; }
    bool pin = false;
    int plv = -1;
    if (k > 0) {
      const int q = p - w - dx;       // cell k-1
      pin = in[q] != 0;
      plv = lv[q];
    }
    int32_t v = 0;
    if (cin) {
      if (!nin || nlv != clv) end_k = k;
      v = pack(!pin || plv != clv, clv, end_k - k + 1);
    }
    o[p] = v;
    nin = cin; nlv = clv; cin = pin; clv = plv;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
// levels [M, H, W] int32, inside [M, H, W] bool/uint8, out [M, 4, H, W]
// int32; all contiguous on one device.
int glrlm_runs(const void* levels, const void* inside, void* out, int m, int h,
               int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  const uint8_t* in = static_cast<const uint8_t*>(inside);
  int32_t* o = static_cast<int32_t*>(out);
  runs_rows_kernel<<<dim3((h + ROW_WARPS - 1) / ROW_WARPS, m), ROW_WARPS * 32, 0, s>>>(
      lv, in, o, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lines = h + w - 1;
  runs_lines_kernel<<<dim3((lines + LINE_THREADS - 1) / LINE_THREADS, 3, m),
                      LINE_THREADS, 0, s>>>(lv, in, o, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* glrlm_runs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
