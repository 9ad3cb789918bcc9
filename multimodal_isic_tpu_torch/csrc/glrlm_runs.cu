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
// 108 us at 3.35 TB/s.  A walk along each line (a thread a column or
// diagonal, a step a row) keeps one dependent load in flight a thread and
// reads the input once an angle; a second pass over the input to resolve
// the runs that cross bands costs another 86 MB and its own launch.
//
// Design: all four angles from one copy of a band of rows in shared memory,
// in one launch.  The wrapper's plan (ops/glrlm_runs.py::runs_plan: band
// rows, bands, threads, shared memory) is checked here; any other plan is
// refused with cudaErrorInvalidValue.  A block takes a ticket (an atomic
// counter: bands bottom first, map by map), stages its band with the rows
// above and below it (cp.async, 16 bytes where W allows), then
//  - builds, for each vertical angle and each line crossing the band, a
//    32-bit mask of the rows where a run ends;
//  - publishes, for each line entering the band from above, the row of its
//    first run end in the band, or none (int16 [M, bands, 3, W]), and marks
//    the band ready with this launch's epoch;
//  - resolves each run that leaves the band at the bottom from the first
//    band below with an end on the line (one record where the run ends in
//    the next band).  Those bands took earlier tickets, so they are
//    resident or done and never wait on this one: the wait ends;
//  - writes every cell's four words, a warp a row, four cells a lane, in
//    128-cell chunks from the right: the row runs' ends come from a ballot
//    of the lanes' end flags and the previous chunk's first end, the
//    vertical ones from the masks (the first set bit at or below the row;
//    two aligned 16-byte reads a diagonal) or the carry.  Stores are 16
//    bytes a lane, one angle's plane at a time.
// The input is read about 1.1 times (the halo rows) and the output written
// once.  The counter and the epoch live in device memory, per (device,
// stream), zeroed once by the wrapper: the block that takes the last ticket
// resets the counter and moves the epoch on, so a ready flag of an earlier
// launch never matches.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "map_stage.cuh"

namespace {

constexpr int LEN_MAX = (1 << 11) - 1;
constexpr int MAX_BAND = 32;         // rows a band: one 32-bit mask a line
constexpr int MAX_SIZE = 2047;       // H, W: run lengths fit 11 bits
constexpr int MAX_SMEM = 232448;
constexpr int16_t NO_END = 0x7fff;   // a published line with no run end
constexpr int CHUNK = 128;           // cells a warp writes at once
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t pack(bool start, int lv, int length) {
  return (start ? (1 << 18) : 0) | (lv << 11) | min(length, LEN_MAX);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }

// Mask entries an angle: the lines crossing a band, rounded up to a quad,
// and a quad more for the two-quad reads of the diagonals.
__host__ __device__ __forceinline__ int mask_len(int band_h, int w) {
  return round4(w + band_h) + 4;
}

// Shared memory of the band kernel: levels and flags of band_h + 2 rows of
// round4(W) cells, the masks [3][mask_len], the carries [3][round4(W)], the
// block's ticket and epoch.
__host__ __device__ inline int band_smem(int band_h, int w) {
  const int wp = round4(w);
  return (band_h + 2) * wp * 4 + round16((band_h + 2) * wp) +
         3 * mask_len(band_h, w) * 4 + 3 * wp * 4 + 16;
}

// The rows where a run ends along the line that enters shared row k0 +
// r_first at column x and steps dx a row, over band rows r_first .. rows - 1
// (shared row k0 + rows is the row below the band): bit r for band row r.
__device__ __forceinline__ uint32_t line_ends(const int32_t* slv,
                                              const uint8_t* sin, int wp,
                                              int w, int k0, int r_first,
                                              int x, int dx, int rows) {
  uint32_t mask = 0;
  bool cin = sin[(k0 + r_first) * wp + x] != 0;
  int clv = slv[(k0 + r_first) * wp + x];
  // no early exit: the loads of later rows do not wait on earlier ones
#pragma unroll 4
  for (int r = r_first; r < rows; ++r) {
    x += dx;
    const bool next_in_frame = x >= 0 && x < w;
    bool nin = false;
    int nlv = 0;
    if (next_in_frame) {
      nin = sin[(k0 + r + 1) * wp + x] != 0;
      nlv = slv[(k0 + r + 1) * wp + x];
    }
    if (cin && !(nin && nlv == clv)) mask |= 1u << r;
    cin = nin;  // out of the frame: no further ends
    clv = nlv;
  }
  return mask;
}

// The band kernel.  Block b of map m (from a ticket: bands bottom first);
// warps own rows.  state [0] the ticket counter, [1] the last launch's
// epoch (both left so for the next launch); ready [M * n_bands] the epoch
// at which each band published its records ends [M, n_bands, 3, W].
template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
runs_band_kernel(const int32_t* __restrict__ levels,
                 const uint8_t* __restrict__ inside, int16_t* ends,
                 int* ready, int* state, int32_t* __restrict__ out, int h,
                 int w, int band_h, int n_bands) {
  extern __shared__ int4 smem_raw[];
  const int wp = round4(w), ml = mask_len(band_h, w);
  int32_t* slv = reinterpret_cast<int32_t*>(smem_raw);
  uint8_t* sin = reinterpret_cast<uint8_t*>(slv + (band_h + 2) * wp);
  uint32_t* masks = reinterpret_cast<uint32_t*>(sin + round16((band_h + 2) * wp));
  int32_t* carry = reinterpret_cast<int32_t*>(masks + 3 * ml);
  int& s_ticket = carry[3 * wp];
  int& s_epoch = carry[3 * wp + 1];
  if (threadIdx.x == 0) {
    // the epoch is read before the ticket is taken: the block that takes
    // the last ticket knows every block has read it, and moves it on
    const int epoch = *reinterpret_cast<volatile int*>(state + 1) + 1;
    __threadfence();
    const int t = atomicAdd(state, 1);
    if (t == static_cast<int>(gridDim.x) - 1) {
      atomicExch(state, 0);
      atomicExch(state + 1, epoch);
    }
    s_ticket = t;
    s_epoch = epoch;
  }
  __syncthreads();
  const int epoch = s_epoch;
  const int m = s_ticket / n_bands, b = n_bands - 1 - s_ticket % n_bands;
  const int y0 = b * band_h, rows = min(band_h, h - y0);
  const size_t map = static_cast<size_t>(m) * h * w;
  // shared row k holds map row y0 - 1 + k
  map_stage::stage<VEC>(levels + map, inside + map, slv, sin, y0 - 1, rows + 2,
                        0, w, h, w, wp);
  map_stage::stage_wait();
  __syncthreads();

  // masks: angle a = 0, 1, 2 is dx = -1, 0, +1 (ANGLES_2D 1..3).  Line i:
  // dx 0, column x = i; dx +1, x - r = i - (rows - 1); dx -1, x + r = i.
  const int n_diag = w + rows - 1;
  for (int j = threadIdx.x; j < w + 2 * n_diag; j += blockDim.x) {
    int a, i;
    if (j < n_diag) { a = 0; i = j; }
    else if (j < n_diag + w) { a = 1; i = j - n_diag; }
    else { a = 2; i = j - n_diag - w; }
    const int dx = a - 1;
    // the line's first row inside the frame and its column there
    int r0 = 0, x = i;
    if (dx == 1) { x = i - (rows - 1); r0 = max(0, -x); x += r0; }
    if (dx == -1 && x > w - 1) { r0 = x - (w - 1); x = w - 1; }
    masks[a * ml + i] = r0 < rows ? line_ends(slv, sin, wp, w, 1, r0, x, dx, rows) : 0u;
  }
  __syncthreads();
  // publish, for each vertical angle and each line entering the band from
  // above (its mask from row 0), the row of its first run end in the band
  int16_t* rec = ends + static_cast<size_t>(m) * n_bands * 3 * w;
  if (b > 0) {
    for (int j = threadIdx.x; j < 3 * w; j += blockDim.x) {
      const int a = j / w, xt = j - a * w;
      const uint32_t mk = masks[a * ml + (a == 2 ? xt + rows - 1 : xt)];
      __stcg(rec + (static_cast<size_t>(b) * 3 + a) * w + xt,
             static_cast<int16_t>(mk ? y0 + __ffs(mk) - 1 : NO_END));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(ready + m * n_bands + b, epoch);
    }
  }
  // carries: where the bottom row's cell continues its run into the band
  // below, the row of the run's end there, from the first band below with
  // an end on the line.  Those bands took earlier tickets, so they run or
  // have run: the wait ends.
  for (int j = threadIdx.x; j < 3 * w; j += blockDim.x) {
    const int a = j / w, xb = j - a * w, dx = a - 1;
    int c = NO_END;
    int xt = xb + dx;
    if (b + 1 < n_bands && xt >= 0 && xt < w && sin[rows * wp + xb] != 0 &&
        sin[(rows + 1) * wp + xt] != 0 &&
        slv[(rows + 1) * wp + xt] == slv[rows * wp + xb]) {
      for (int bb = b + 1; bb < n_bands && xt >= 0 && xt < w; ++bb) {
        volatile int* flag = ready + m * n_bands + bb;
        while (*flag != epoch) __nanosleep(64);
        __threadfence();
        const int v = __ldcg(rec + (static_cast<size_t>(bb) * 3 + a) * w + xt);
        if (v != NO_END) { c = v; break; }
        xt += dx * min(band_h, h - bb * band_h);
      }
    }
    carry[a * wp + xb] = c;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = static_cast<size_t>(h) * w;
  int32_t* o = out + static_cast<size_t>(m) * 4 * plane;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    const int y = y0 + r, k = r + 1;
    int carry_row = 0;  // first row end right of the chunk (set before use)
    for (int base = ((w - 1) / CHUNK) * CHUNK; base >= 0; base -= CHUNK) {
      const int x = base + 4 * lane;
      int cv[4] = {0, 0, 0, 0}, uv[4] = {0, 0, 0, 0};
      uint32_t cf = 0, uf = 0;
      if (x < wp) {
        const int4 c4 = *reinterpret_cast<const int4*>(slv + k * wp + x);
        const int4 u4 = *reinterpret_cast<const int4*>(slv + (k - 1) * wp + x);
        cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
        uv[0] = u4.x; uv[1] = u4.y; uv[2] = u4.z; uv[3] = u4.w;
        cf = *reinterpret_cast<const uint32_t*>(sin + k * wp + x);
        uf = *reinterpret_cast<const uint32_t*>(sin + (k - 1) * wp + x);
      }
      // neighbours x - 1 and x + 4 of this row and the row above
      int cl = __shfl_up_sync(FULL, cv[3], 1), ul = __shfl_up_sync(FULL, uv[3], 1);
      uint32_t cfl = __shfl_up_sync(FULL, cf >> 24, 1), ufl = __shfl_up_sync(FULL, uf >> 24, 1);
      int cr = __shfl_down_sync(FULL, cv[0], 1), ur = __shfl_down_sync(FULL, uv[0], 1);
      uint32_t cfr = __shfl_down_sync(FULL, cf & 0xffu, 1), ufr = __shfl_down_sync(FULL, uf & 0xffu, 1);
      if (lane == 0) {
        cfl = ufl = 0;
        if (x > 0) {
          cl = slv[k * wp + x - 1]; cfl = sin[k * wp + x - 1];
          ul = slv[(k - 1) * wp + x - 1]; ufl = sin[(k - 1) * wp + x - 1];
        }
      }
      if (lane == 31) {
        cfr = ufr = 0;
        if (x + 4 < wp) {
          cr = slv[k * wp + x + 4]; cfr = sin[k * wp + x + 4];
          ur = slv[(k - 1) * wp + x + 4]; ufr = sin[(k - 1) * wp + x + 4];
        }
      }
      // cells x - 1 .. x + 4 of both rows, index + 1
      int lc[6] = {cl, cv[0], cv[1], cv[2], cv[3], cr};
      int lu[6] = {ul, uv[0], uv[1], uv[2], uv[3], ur};
      bool ic[6], iu[6];
      ic[0] = cfl != 0; iu[0] = ufl != 0; ic[5] = cfr != 0; iu[5] = ufr != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ic[i + 1] = ((cf >> (8 * i)) & 0xffu) != 0;
        iu[i + 1] = ((uf >> (8 * i)) & 0xffu) != 0;
      }
      // row runs (angle 0): ends in this lane, then the first end to its right
      uint32_t e4 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ic[i + 1] && !(ic[i + 2] && lc[i + 2] == lc[i + 1])) e4 |= 1u << i;
      const int first_here = e4 ? x + __ffs(e4) - 1 : 0;
      const uint32_t any = __ballot_sync(FULL, e4 != 0);
      const uint32_t right = lane == 31 ? 0u : any & (FULL << (lane + 1));
      const int nxt = __shfl_sync(FULL, first_here, right ? __ffs(right) - 1 : lane);
      const int right_end = right ? nxt : carry_row;
      if (any) carry_row = __shfl_sync(FULL, first_here, __ffs(any) - 1);

      // the quad's masks: its columns' (one 16-byte read), its diagonals'
      // (the line index is x + an offset that is the same for the whole
      // warp: two aligned 16-byte reads and a uniform shift)
      uint32_t mq[3][4];
      if (x < wp) {
        const uint4 col = *reinterpret_cast<const uint4*>(masks + ml + x);
        mq[1][0] = col.x; mq[1][1] = col.y; mq[1][2] = col.z; mq[1][3] = col.w;
#pragma unroll
        for (int a = 0; a < 3; a += 2) {
          const int li = x + (a == 2 ? rows - 1 - r : r);
          const uint4 lo = *reinterpret_cast<const uint4*>(masks + a * ml + (li & ~3));
          const uint4 hi = *reinterpret_cast<const uint4*>(masks + a * ml + (li & ~3) + 4);
          const uint32_t q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          const int sft = li & 3;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mq[a][i] = sft == 0 ? q[i] : sft == 1 ? q[i + 1] : sft == 2 ? q[i + 2] : q[i + 3];
        }
      }
      int word[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xi = x + i, c = lc[i + 1];
        const bool cin = ic[i + 1];
        const uint32_t e = e4 >> i;
        const int end0 = e ? xi + __ffs(e) - 1 : right_end;
        word[0][i] = cin ? pack(!(ic[i] && lc[i] == c), c, end0 - xi + 1) : 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int dx = a - 1;
          // previous cell (y - 1, xi - dx): index i + 1 - dx of the row above
          const bool start = !(iu[i + 1 - dx] && lu[i + 1 - dx] == c);
          int len = 0;
          if (cin) {
            const uint32_t mk = mq[a][i] >> r;
            len = mk ? __ffs(mk) : carry[a * wp + xi + dx * (rows - 1 - r)] - y + 1;
          }
          word[a + 1][i] = cin ? pack(start, c, len) : 0;
        }
      }
      if (x < w) {
        const size_t g = static_cast<size_t>(y) * w + x;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if constexpr (VEC) {
            *reinterpret_cast<int4*>(o + a * plane + g) =
                make_int4(word[a][0], word[a][1], word[a][2], word[a][3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (x + i < w) o[a * plane + g + i] = word[a][i];
          }
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

template <bool VEC>
int launch(const int32_t* lv, const uint8_t* in, int16_t* ends, int* ready,
           int* state, int32_t* o, int m, int h, int w, int band_h,
           int n_bands, int threads, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      runs_band_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  runs_band_kernel<VEC><<<m * n_bands, threads, smem, s>>>(
      lv, in, ends, ready, state, o, h, w, band_h, n_bands);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a plan this file does not take.
// levels [M, H, W] int32, inside [M, H, W] bool/uint8, out [M, 4, H, W]
// int32, ends int16 [M, n_bands, 3, W] (scratch); ready int32 [>= M *
// n_bands] and state int32 [2], zeroed once and kept for every later launch
// on the stream; all contiguous on one device.  The plan (ops/glrlm_runs.py::
// runs_plan): bands of band_h rows (<= 32) covering H exactly once, a
// multiple of 32 threads (<= 512), and band_smem bytes.
int glrlm_runs(const void* levels, const void* inside, void* out, void* ends,
               void* ready, void* state, int m, int h, int w, int band_h,
               int n_bands, int threads, int smem, void* stream) {
  if (m < 1 || m > 65535 || h < 1 || w < 1 || h > MAX_SIZE || w > MAX_SIZE ||
      band_h < 1 || band_h > MAX_BAND ||
      n_bands != (h + band_h - 1) / band_h ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      smem != band_smem(band_h, w) || smem > MAX_SMEM || ends == nullptr ||
      ready == nullptr || state == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  const uint8_t* in = static_cast<const uint8_t*>(inside);
  int16_t* e = static_cast<int16_t*>(ends);
  int* rd = static_cast<int*>(ready);
  int* st = static_cast<int*>(state);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0 && aligned(levels, 16) && aligned(inside, 4) && aligned(out, 16))
    return launch<true>(lv, in, e, rd, st, o, m, h, w, band_h, n_bands, threads,
                        smem, s);
  return launch<false>(lv, in, e, rd, st, o, m, h, w, band_h, n_bands, threads,
                       smem, s);
}

const char* glrlm_runs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
