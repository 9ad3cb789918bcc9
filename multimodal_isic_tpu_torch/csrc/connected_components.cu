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
// Numerics: integers only, equal to the plain version bit for bit.  Every
// union links the larger root under the smaller with atomicMin (Playne &
// Hawick), so every parent index is at most its child's and a component's
// final root is its minimum index, whatever order the links land in.
//
// What bounds it on the card: memory.  The levels (int32) and the inside
// flags (1 byte) are read once and the labels written once: at the radiomics
// chunk (M = 64 maps of 450 x 600) 86.4 MB read and 69.1 MB written, 46 us at
// 3.35 TB/s.  A union-find over device memory instead pays a chain of
// dependent L2 loads a link (a few hundred cycles a hop) for every pixel;
// here the unions in shared memory are what keeps it above its bound.
//
// Design: the block-based union-find of Allegretti, Bolelli and Grana, in
// three launches.  The wrapper's plan (ops/connected_components.py::cc_plan:
// tile rows and columns, tiles along H and W, threads, shared memory) is
// checked here; any other plan is refused with cudaErrorInvalidValue.
//  1. tile: a block owns a tile of at most 32 rows x 128 columns (27 x 120
//     at the chunk: four blocks an SM), copied to shared memory with
//     cp.async.  A warp owns rows, a lane every 32nd column (a warp's
//     shared accesses fall in 32 banks).  Row runs come from a ballot of
//     the run starts; each inside pixel's parent starts as its run's start.
//     Links to the row above are made only where they join a new run (a
//     run's first pixel looks at its three upper neighbours, a later pixel
//     only at the upper right one when the one above does not match): a
//     warp queues its row's links by ballot, then unites them a link a
//     lane, so that its lanes stay busy.  Row-major order within a tile is
//     the map's order restricted to it, so the tile root is the component's
//     minimum index inside the tile; each pixel is written as the map index
//     of its tile root, 16 bytes a lane.  All intra-tile links stay out of
//     device memory.
//  2. border: only the pixels on a tile's top row or left column unite
//     across tiles, in device memory, by the same run rules (4.2% of the
//     pixels at the chunk).  The chains run through tile roots only.  A
//     root hooked under another marks its tile dirty.
//  3. flatten: in the dirty tiles only, each inside pixel's label (its tile
//     root) becomes the root of the root's chain where that differs.
// The unions are ECL-CC's (Jaiganesh & Burtscher; the union-find section
// below).  Launches 2 and 3 are skipped where one tile covers the map.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "map_stage.cuh"

namespace {

constexpr int MAX_TILE_H = 32;
constexpr int MAX_TILE_W = 128;  // four columns a lane for the stores
constexpr int MAX_THREADS = 512;
constexpr int MAX_SMEM = 232448;
constexpr int BORDER_THREADS = 256;
constexpr int FLAT_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ union-find
// A root is hooked under the smaller root with atomicCAS, which fails if
// another thread hooked it first; every find points each node it passes at
// its grandparent, a plain store (only nodes that are no longer roots are
// written, and with an ancestor).  Trees never split, so the races cost
// retries, not labels.  Shared parents are read volatile; device ones
// through L2 (__ldcg: parents written by other SMs are never served stale
// from L1).

struct SharedPar {
  volatile int* p;
  __device__ int load(int x) const { return p[x]; }
  __device__ void store(int x, int v) const { p[x] = v; }
  __device__ int cas(int x, int expect, int v) const {
    return atomicCAS(const_cast<int*>(p) + x, expect, v);
  }
  __device__ void hooked(int) const {}
};

// A map's labels; a root hooked under another marks its tile dirty (the
// flatten visits dirty tiles only: elsewhere every label is final).
struct GlobalPar {
  int32_t* p;
  int* dirty;  // the map's tiles, row-major
  int w, tile_h, tile_w, n_tx;
  __device__ int load(int x) const { return __ldcg(p + x); }
  __device__ void store(int x, int v) const { __stcg(p + x, v); }
  __device__ int cas(int x, int expect, int v) const {
    return atomicCAS(p + x, expect, v);
  }
  __device__ void hooked(int x) const {
    const int y = x / w;
    dirty[(y / tile_h) * n_tx + (x - y * w) / tile_w] = 1;
  }
};

template <class P>
__device__ __forceinline__ int find(const P& par, int x) {
  int cur = par.load(x);
  if (cur == x) return x;
  int next;
  while (cur != (next = par.load(cur))) {
    par.store(x, next);
    x = cur;
    cur = next;
  }
  return cur;
}

template <class P>
__device__ void unite(const P& par, int a, int b) {
  a = find(par, a);
  b = find(par, b);
  while (a != b) {
    if (a > b) { const int t = a; a = b; b = t; }
    const int old = par.cas(b, b, a);
    if (old == b) {
      par.hooked(b);
      return;
    }
    b = find(par, old);  // b was hooked meanwhile: go on from its new root
  }
}

// Phase 1.  Block (tx, ty, m); warp r owns tile rows r, r + warps, ...,
// lane l the columns l, l + 32, l + 64, l + 96 of a row (so that the
// union-find's shared accesses of a warp fall in 32 banks) and the quad
// 4l .. 4l + 3 for the label stores.  Shared: parents [tile_h][tile_w] (-1
// outside), levels, flags (1 byte); the levels' space holds the labels at
// the end.
template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
cc_tile_kernel(const int32_t* __restrict__ levels,
               const uint8_t* __restrict__ inside, int32_t* __restrict__ label,
               int* __restrict__ dirty, int h, int w, int tile_h, int tile_w) {
  extern __shared__ int4 smem_raw[];
  const int tsz = tile_h * tile_w;
  volatile int* par = reinterpret_cast<int*>(smem_raw);
  const SharedPar sp{par};
  int* slv = reinterpret_cast<int*>(smem_raw) + tsz;
  uint32_t* queue = reinterpret_cast<uint32_t*>(slv + tsz);  // [2 * tsz]
  uint8_t* sfl = reinterpret_cast<uint8_t*>(queue + 2 * tsz);
  if (threadIdx.x == 0) {
    dirty[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * tile_h;
  const int tw = min(tile_w, w - x0), th = min(tile_h, h - y0);
  const size_t map = static_cast<size_t>(blockIdx.z) * h * w;
  map_stage::stage<VEC>(levels + map, inside + map, slv, sfl, y0, th, x0, tw,
                        h, w, tile_w);
  map_stage::stage_wait();
  __syncthreads();

  // row runs: each pixel's parent is its run's start (a ballot of the starts
  // of 32 columns, then the last start of the columns to their left)
  for (int r = warp; r < th; r += nwarps) {
    const int row = r * tile_w;
    int carry = -1;
    for (int base = 0; base < tw; base += 32) {
      const int c = base + lane, p = row + c;
      const bool cin = c < tw && sfl[p] != 0;
      const bool start =
          cin && !(c > 0 && sfl[p - 1] != 0 && slv[p - 1] == slv[p]);
      const unsigned starts = __ballot_sync(FULL, start);
      const unsigned upto = starts & (FULL >> (31 - lane));
      const int run = upto ? base + 31 - __clz(upto) : carry;
      if (c < tile_w) par[p] = cin ? row + run : -1;
      if (starts) carry = base + 31 - __clz(starts);
    }
  }
  __syncthreads();

  // links to the row above, where they join a new run: a warp queues its
  // row's links (a pixel makes at most two; a ballot packs them into the
  // row's 2 * tile_w slots), then makes them a link a lane, so that every
  // lane has a union to make.  A link joins the two pixels' parents (an
  // ancestor of each: the run's start at first).
  for (int r = warp; r < th; r += nwarps) {
    if (r == 0) continue;
    const int row = r * tile_w;
    uint32_t* q = queue + 2 * row;
    int n_q = 0;
    for (int base = 0; base < tw; base += 32) {
      const int c = base + lane, p = row + c;
      int to[2];
      int n_links = 0;
      if (c < tw && sfl[p] != 0) {
        const int v = slv[p], up = p - tile_w;
        const bool start = !(c > 0 && sfl[p - 1] != 0 && slv[p - 1] == v);
        const bool mu = sfl[up] != 0 && slv[up] == v;
        const bool mr = c + 1 < tw && sfl[up + 1] != 0 && slv[up + 1] == v;
        if (start) {
          if (mu) {
            to[n_links++] = up;
          } else {
            if (c > 0 && sfl[up - 1] != 0 && slv[up - 1] == v) to[n_links++] = up - 1;
            if (mr) to[n_links++] = up + 1;
          }
        } else if (mr && !mu) {
          to[n_links++] = up + 1;
        }
      }
      const uint32_t from = n_links ? static_cast<uint32_t>(par[p]) << 12 : 0u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const unsigned has = __ballot_sync(FULL, n_links > k);
        if (has == 0) break;
        if (n_links > k)
          q[n_q + __popc(has & ((1u << lane) - 1u))] = from | par[to[k]];
        n_q += __popc(has);
      }
    }
    __syncwarp();
    for (int i = lane; i < n_q; i += 32)
      unite(sp, static_cast<int>(q[i] >> 12), static_cast<int>(q[i] & 0xfffu));
  }
  __syncthreads();

  // each pixel: the map index of its tile root, staged in the levels' place
  // and stored a quad a lane
  const int big = h * w;
  for (int r = warp; r < th; r += nwarps) {
    const int row = r * tile_w;
    for (int c = lane; c < tw; c += 32) {
      const int p = row + c;
      int out = big;
      if (sfl[p] != 0) {
        const int root = find(sp, p);
        par[p] = root;
        const int ry = root / tile_w;
        out = (y0 + ry) * w + x0 + (root - ry * tile_w);
      }
      slv[p] = out;
    }
    __syncwarp();
    const int c0 = 4 * lane;
    if (c0 < tw) {
      const size_t g = map + static_cast<size_t>(y0 + r) * w + x0 + c0;
      if constexpr (VEC) {
        *reinterpret_cast<int4*>(label + g) =
            *reinterpret_cast<const int4*>(slv + row + c0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c0 + i < tw) label[g + i] = slv[row + c0 + i];
      }
    }
  }
}

// ---------------------------------------------------------------- device

// Phase 2.  Thread t of map blockIdx.y: first the pixels of every tile's
// top row below the first tile row ((n_ty - 1) * W), then those of every
// tile's left column right of the first tile column ((n_tx - 1) * H).
__global__ void __launch_bounds__(BORDER_THREADS)
cc_border_kernel(const int32_t* __restrict__ levels,
                 const uint8_t* __restrict__ inside, int32_t* label,
                 int* dirty, int h, int w, int tile_h, int tile_w, int n_ty,
                 int n_tx) {
  const size_t map = static_cast<size_t>(blockIdx.y) * h * w;
  const int32_t* lv = levels + map;
  const uint8_t* in = inside + map;
  const GlobalPar gp{label + map, dirty + blockIdx.y * n_ty * n_tx, w, tile_h,
                     tile_w, n_tx};
  int t = blockIdx.x * BORDER_THREADS + threadIdx.x;
  const int n_rows = (n_ty - 1) * w;
  if (t < n_rows) {
    // a tile's top row: links to the row above, by the tile kernel's rules
    // over the whole map row (the left link across a tile column is made
    // below, so a run here may span tiles)
    const int y = (t / w + 1) * tile_h, x = t - (t / w) * w;
    const int p = y * w + x;
    if (in[p] == 0) return;
    const int c = lv[p];
    const bool start = !(x > 0 && in[p - 1] != 0 && lv[p - 1] == c);
    const int up = p - w;
    const bool mu = in[up] != 0 && lv[up] == c;
    const bool mr = x + 1 < w && in[up + 1] != 0 && lv[up + 1] == c;
    if (start) {
      if (mu) {
        unite(gp, p, up);
      } else {
        if (x > 0 && in[up - 1] != 0 && lv[up - 1] == c) unite(gp, p, up - 1);
        if (mr) unite(gp, p, up + 1);
      }
    } else if (mr && !mu) {
      unite(gp, p, up + 1);
    }
    return;
  }
  t -= n_rows;
  if (t >= (n_tx - 1) * h) return;
  // a tile's left column: the left link, else the diagonal ones inside the
  // tile row (a left neighbour that matches is linked to both within its
  // own tile; the diagonals across a tile row are the top rows' above)
  const int x = (t / h + 1) * tile_w, y = t - (t / h) * h;
  const int p = y * w + x;
  if (in[p] == 0) return;
  const int c = lv[p];
  if (in[p - 1] != 0 && lv[p - 1] == c) {
    unite(gp, p, p - 1);
    return;
  }
  const int ty0 = (y / tile_h) * tile_h;
  const int ty1 = min(h, ty0 + tile_h);
  if (y - 1 >= ty0 && in[p - w - 1] != 0 && lv[p - w - 1] == c)
    unite(gp, p, p - w - 1);
  if (y + 1 < ty1 && in[p + w - 1] != 0 && lv[p + w - 1] == c)
    unite(gp, p, p + w - 1);
}

// Phase 3.  Block (tx, ty, m), a dirty tile only: each inside pixel's
// label (its tile root) is replaced by the root of the root's chain where
// that differs.  Quads of 4 labels a thread (16-byte loads with VEC).
// Reads need not bypass L1 here: a stale parent is still an ancestor, and
// every store is a final root.
template <bool VEC>
__global__ void __launch_bounds__(FLAT_THREADS)
cc_flatten_kernel(int32_t* label, const int* __restrict__ dirty, int h, int w,
                  int tile_h, int tile_w) {
  if (dirty[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] == 0)
    return;
  const int n = h * w;
  int32_t* lab = label + static_cast<size_t>(blockIdx.z) * n;
  const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * tile_h;
  const int tw = min(tile_w, w - x0), th = min(tile_h, h - y0);
  const int qn = (tw + 3) / 4;
  for (int j = threadIdx.x; j < th * qn; j += FLAT_THREADS) {
    const int r = j / qn, c0 = (j - r * qn) * 4;
    const int g = (y0 + r) * w + x0 + c0;
    int v[4];
    if constexpr (VEC) {
      const int4 a = *reinterpret_cast<const int4*>(lab + g);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = c0 + i < tw ? lab[g + i] : n;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = v[i];
      if (t >= n) continue;  // outside
      int root = t, p = lab[t];
      while (p != root) {
        root = p;
        p = lab[root];
      }
      if (root != t) lab[g + i] = root;
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a plan this file does not take.
// levels [M, H, W] int32, inside [M, H, W] bool/uint8, out [M, H, W] int32;
// all contiguous on one device.  The plan (ops/connected_components.py::
// cc_plan): tiles of tile_h rows (<= 32) x tile_w columns (a multiple of 4,
// <= 128), n_ty x n_tx of them covering the map exactly once, a warp a row
// up to 16 warps, and 17 * tile_h * tile_w bytes of shared memory a tile
// (parents, levels, two queued links a pixel, flags).
int connected_components(const void* levels, const void* inside, void* out,
                         void* dirty, int m, int h, int w, int tile_h,
                         int tile_w, int n_ty, int n_tx, int threads, int smem,
                         void* stream) {
  if (m < 1 || h < 1 || w < 1 || m > 65535 || dirty == nullptr ||
      static_cast<long long>(h) * w >= 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_h < 1 || tile_h > MAX_TILE_H || tile_w < 4 ||
      tile_w > MAX_TILE_W || tile_w % 4 != 0 ||
      n_ty != (h + tile_h - 1) / tile_h || n_tx != (w + tile_w - 1) / tile_w ||
      n_ty > 65535 || threads != 32 * min(tile_h, 16) ||
      smem != 17 * tile_h * tile_w || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  const uint8_t* in = static_cast<const uint8_t*>(inside);
  int32_t* lab = static_cast<int32_t*>(out);
  int* dt = static_cast<int*>(dirty);
  const bool vec = w % 4 == 0 && aligned(levels, 16) && aligned(out, 16) &&
                   aligned(inside, 4);
  const dim3 tiles(n_tx, n_ty, m);
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(cc_tile_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cc_tile_kernel<true><<<tiles, threads, smem, s>>>(lv, in, lab, dt, h, w, tile_h, tile_w);
  } else {
    err = cudaFuncSetAttribute(cc_tile_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cc_tile_kernel<false><<<tiles, threads, smem, s>>>(lv, in, lab, dt, h, w, tile_h, tile_w);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || (n_ty == 1 && n_tx == 1)) return static_cast<int>(err);
  const long long border = static_cast<long long>(n_ty - 1) * w +
                           static_cast<long long>(n_tx - 1) * h;
  cc_border_kernel<<<dim3((border + BORDER_THREADS - 1) / BORDER_THREADS, m),
                     BORDER_THREADS, 0, s>>>(lv, in, lab, dt, h, w, tile_h,
                                             tile_w, n_ty, n_tx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    cc_flatten_kernel<true><<<tiles, FLAT_THREADS, 0, s>>>(lab, dt, h, w, tile_h, tile_w);
  else
    cc_flatten_kernel<false><<<tiles, FLAT_THREADS, 0, s>>>(lab, dt, h, w, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}

const char* connected_components_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
