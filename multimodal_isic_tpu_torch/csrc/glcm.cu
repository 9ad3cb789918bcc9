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
// Numerics: integers only.  Every output word is written once, by a plain
// store, from integer sums taken in a fixed order: equal to the plain
// version bit for bit, the same bits on every run, no memset before it.
//
// What bounds it on the card: memory.  The levels (int32) and the mask
// (uint8) are read once, 5 bytes a pixel; the output is 64 KB a map.  At the
// radiomics chunk (M = 64 maps of 450 x 600) that is 86.4 MB read and 4.2 MB
// written: 27 us at 3.35 TB/s.
//
// Design.  The TPU kernel built bf16 one-hot tiles in VMEM for one MXU
// contraction (no scatter on the TPU).  Here one thread-block cluster of
// CLUSTER blocks counts one map; the wrapper's plan (ops/glcm.py::glcm_plan)
// gives the band height and the rounds, and this library recomputes its own
// and refuses any other.
// - Band: block r of the cluster counts the pairs whose centre lies in its
//   band of rows (band (round * CLUSTER + r)); the row below the band is
//   read as a halo for the three downward angles.
// - Counters: P + P^T needs only the bins i <= j of each angle (a pair
//   (c, v) counts in (min, max); the diagonal is doubled at the end): 2080
//   bins an angle.  A band holds at most 65,535 pixels, and a bin takes at
//   most one count a centre pixel, so two 16-bit counters share a 32-bit
//   word.  The histogram is 16.6 KB, so five blocks fit an SM and all 64
//   clusters of a chunk are resident at once (a full 64 x 64 histogram of
//   16-bit counters left 62 of 64 resident on the H100: two waves).
// - Loads: a lane owns 4 columns of a 128-column strip; a task is a strip
//   over a segment of about SEG_ROWS rows of the band, and warp w takes
//   tasks w, w + 8, ...  A warp reads a task's rows through a ring of 4 row
//   slots in shared memory, filled with cp.async (16 bytes of levels and 4
//   of mask bytes a lane; lane 31 also the column right of the strip, lane
//   0 the one left of it) three rows ahead of the row being counted: a
//   walk that loaded a row only when it needed it spent 0.092 ms a call on
//   its loads alone, through the ring 0.048 (two rows ahead or three
//   alike); the loads are the larger part of the kernel's time.  Where W
//   is no multiple of 4 or a map is not aligned, the lanes load cell by
//   cell instead.  The codes fold the mask and the 1..64 range (0 = no
//   pair), 8 bits each.
//   The right and down-left neighbours come from the neighbouring lane by
//   __shfl.  A warp's row wholly outside the ROI counts nothing.
// - Collisions: a lane's four pairs of an angle that fall in one bin (a
//   smooth or flat region) take one atomic of 4, other pairs one each; on
//   the smooth LoG images that took the cost of colliding atomics from
//   about 0.02 ms a call to none.  Grouping the lanes that share a bin
//   (__match_any_sync) gained nothing on the H100, and adding a lane's runs
//   of equal pairs in registers first was slower (PERF.md).
// - Flush, without device-memory atomics: after cluster.sync(), block r sums
//   its slice of the bins over the cluster's histograms through distributed
//   shared memory (cluster.map_shared_rank), unpacked into 32-bit totals in
//   its own shared memory; after another cluster.sync() it writes its slice
//   of the output with 16-byte stores, reading each (min, max) bin from the
//   block that owns it.  A map larger than CLUSTER bands of 65,535 pixels
//   takes several rounds of counting and summing.
//
// Built by ops/_build.py with nvcc at first launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NG = 64;
constexpr int BINS = 4 * NG * NG;         // output bins a map
constexpr int TRI = NG * (NG + 1) / 2;    // counted bins an angle: i <= j
constexpr int WORDS = 4 * TRI / 2;        // two 16-bit counters a word
constexpr int CLUSTER = 8;                // blocks a map (portable size)
constexpr int SLICE = 4 * TRI / CLUSTER;  // counted bins a block sums
constexpr int OUT_SLICE = BINS / CLUSTER; // output bins a block writes
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 128;                // columns a warp covers, 4 a lane
constexpr int SEG_ROWS = 8;               // rows of a warp's task (about)
constexpr int RING = 4;                   // row slots a warp
constexpr int SLOT = STRIP * 5 + 16;      // levels, mask bytes, edge cells
constexpr int MAX_BAND_PX = 65535;        // 16-bit counters
constexpr int SMEM = WORDS * 4 + SLICE * 4 + WARPS * RING * SLOT;
constexpr unsigned FULL = 0xffffffffu;

static_assert(SLICE % 8 == 0 && SLICE / 8 <= THREADS, "one uint4 a thread");
static_assert(SLOT % 16 == 0 && (WORDS * 4 + SLICE * 4) % 16 == 0, "16-byte slots");

__device__ __forceinline__ uint32_t code(int v, uint32_t m) {
  return (m != 0u && v >= 1 && v <= NG) ? static_cast<uint32_t>(v) : 0u;
}

__device__ __forceinline__ uint32_t one_code(const int32_t* __restrict__ lv,
                                             const uint8_t* __restrict__ mk,
                                             int y, int x, int h, int w) {
  if (y >= h || x < 0 || x >= w) return 0u;
  const size_t g = static_cast<size_t>(y) * w + x;
  return code(__ldg(lv + g), __ldg(mk + g));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// A lane's part of row y in its warp's ring slot (VEC only): 16 bytes of
// levels and 4 of mask bytes at column x, and for lane 31 the cell at
// x + 4, for lane 0 the cell at x - 1 (level, and the mask word that holds
// its byte).  One commit group a row, also where nothing is copied.
template <bool VEC>
__device__ __forceinline__ void fetch_row(uint8_t* slot,
                                          const int32_t* __restrict__ lv,
                                          const uint8_t* __restrict__ mk,
                                          int y, int last, int x, int h, int w,
                                          int lane) {
  if constexpr (VEC) {
    if (y <= last && x < w) {
      const size_t g = static_cast<size_t>(y) * w + x;
      cp_async16(slot + 16 * lane, lv + g);
      cp_async4(slot + 4 * STRIP + 4 * lane, mk + g);
      if (lane == 31 && x + 4 < w) {
        cp_async4(slot + 5 * STRIP, lv + g + 4);
        cp_async4(slot + 5 * STRIP + 4, mk + g + 4);
      }
      if (lane == 0 && x > 0) {
        cp_async4(slot + 5 * STRIP + 8, lv + g - 1);
        cp_async4(slot + 5 * STRIP + 12, mk + g - 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// The codes of row y at columns x .. x + 3 (the 4 bytes of a word), at
// x + 4 (lane 31) and at x - 1 (lane 0): 0 outside the frame and past row
// `last`.
template <bool VEC>
__device__ __forceinline__ void row_codes(const uint8_t* slot,
                                          const int32_t* __restrict__ lv,
                                          const uint8_t* __restrict__ mk,
                                          int y, int last, int x, int h, int w,
                                          int lane, uint32_t& quad,
                                          uint32_t& right, uint32_t& left) {
  quad = right = left = 0u;
  if (y > last || x >= w) return;
  if constexpr (VEC) {
    const int4 l = *reinterpret_cast<const int4*>(slot + 16 * lane);
    const uint32_t m = *reinterpret_cast<const uint32_t*>(slot + 4 * STRIP + 4 * lane);
    quad = code(l.x, m & 0xffu) | code(l.y, (m >> 8) & 0xffu) << 8
         | code(l.z, (m >> 16) & 0xffu) << 16 | code(l.w, m >> 24) << 24;
    const int32_t* e = reinterpret_cast<const int32_t*>(slot + 5 * STRIP);
    if (lane == 31 && x + 4 < w)
      right = code(e[0], static_cast<uint32_t>(e[1]) & 0xffu);
    if (lane == 0 && x > 0) left = code(e[2], static_cast<uint32_t>(e[3]) >> 24);
  } else {
    const size_t g = static_cast<size_t>(y) * w + x;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (x + i < w) quad |= code(__ldg(lv + g + i), __ldg(mk + g + i)) << (8 * i);
    if (lane == 31) right = one_code(lv, mk, y, x + 4, h, w);
    if (lane == 0) left = one_code(lv, mk, y, x - 1, h, w);
  }
}

__device__ __forceinline__ uint32_t tri_bin(int a, uint32_t c, uint32_t v) {
  const uint32_t lo = min(c, v), hi = max(c, v);
  return a * TRI + ((hi * (hi - 1u)) >> 1) + lo - 1u;
}

// The pairs (c_i, nb_i), i = 0..3, of angle a, each in bin (min, max); four
// equal pairs (a smooth or flat region) with one atomic.
__device__ __forceinline__ void count_angle(uint32_t* hist, int a, uint32_t c,
                                            uint32_t nb) {
  const uint32_t c0 = c & 0xffu, n0 = nb & 0xffu;
  if (c0 != 0u && n0 != 0u && c == c0 * 0x01010101u && nb == n0 * 0x01010101u) {
    const uint32_t bin = tri_bin(a, c0, n0);
    atomicAdd(hist + (bin >> 1), 4u << ((bin & 1u) << 4));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t ci = (c >> (8 * i)) & 0xffu, vi = (nb >> (8 * i)) & 0xffu;
    if (ci != 0u && vi != 0u) {
      const uint32_t bin = tri_bin(a, ci, vi);
      atomicAdd(hist + (bin >> 1), 1u << ((bin & 1u) << 4));
    }
  }
}

// A task: a 128-column strip (lane column x) and a segment of the band's
// rows [r0, r1); its rows to read are r0 .. last (the row below r1 - 1 as
// a halo where the map has it).
struct Task {
  int x, r0, r1, last;
};

__device__ __forceinline__ Task task_of(int t, int n_strips, int y0, int rows,
                                        int n_seg, int h, int lane) {
  const int seg = t / n_strips;
  Task k;
  k.x = (t - seg * n_strips) * STRIP + 4 * lane;
  k.r0 = y0 + seg * rows / n_seg;
  k.r1 = y0 + (seg + 1) * rows / n_seg;
  k.last = min(k.r1, h - 1);
  return k;
}

// Block r of a cluster, one map a cluster (blockIdx.y).  Shared memory: the
// packed band histogram [WORDS], the slice totals [SLICE], the warps' row
// rings [WARPS][RING][SLOT bytes].
template <bool VEC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 5)
glcm_cluster_kernel(const int32_t* __restrict__ levels,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int h, int w, int band_h, int rounds) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;
  uint32_t* tot = smem + WORDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem + WORDS + SLICE)
                  + warp * RING * SLOT;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const size_t base = static_cast<size_t>(blockIdx.y) * h * w;
  const int32_t* lv = levels + base;
  const uint8_t* mk = mask + base;
  const int n_strips = (w + STRIP - 1) / STRIP;

  for (int round = 0; round < rounds; ++round) {
    for (int i = threadIdx.x; i < WORDS / 4; i += THREADS)
      reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const int y0 = (round * CLUSTER + r) * band_h;
    const int rows = max(0, min(h, y0 + band_h) - y0);
    const int n_seg = (rows + SEG_ROWS - 1) / SEG_ROWS;
    const int n_tasks = n_strips * n_seg;
    for (int t = warp; t < n_tasks; t += WARPS) {
      const Task tk = task_of(t, n_strips, y0, rows, n_seg, h, lane);
      // rows r0 .. r0 + 3 into the ring, then each row RING - 1 rows ahead
#pragma unroll
      for (int k = 0; k < RING; ++k)
        fetch_row<VEC>(ring + ((tk.r0 + k) % RING) * SLOT, lv, mk, tk.r0 + k,
                       tk.last, tk.x, h, w, lane);
      if constexpr (VEC) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      uint32_t c, c_right, c_left;
      row_codes<VEC>(ring + (tk.r0 % RING) * SLOT, lv, mk, tk.r0, tk.last, tk.x, h,
                     w, lane, c, c_right, c_left);
      for (int y = tk.r0; y < tk.r1; ++y) {
        fetch_row<VEC>(ring + (y % RING) * SLOT, lv, mk, y + RING, tk.last, tk.x,
                       h, w, lane);
        if constexpr (VEC) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
        uint32_t d, d_right, d_left;
        row_codes<VEC>(ring + ((y + 1) % RING) * SLOT, lv, mk, y + 1, tk.last,
                       tk.x, h, w, lane, d, d_right, d_left);
        const uint32_t c_nx = __shfl_down_sync(FULL, c, 1);
        const uint32_t d_nx = __shfl_down_sync(FULL, d, 1);
        const uint32_t d_pv = __shfl_up_sync(FULL, d, 1);
        if (__any_sync(FULL, c != 0u)) {  // a row of the strip outside the ROI: none
          const uint32_t cr = lane == 31 ? c_right : c_nx & 0xffu;
          const uint32_t dr = lane == 31 ? d_right : d_nx & 0xffu;
          const uint32_t dl = lane == 0 ? d_left : d_pv >> 24;
          count_angle(hist, 0, c, (c >> 8) | (cr << 24));
          count_angle(hist, 1, c, (d << 8) | dl);
          count_angle(hist, 2, c, d);
          count_angle(hist, 3, c, (d >> 8) | (dr << 24));
        }
        c = d;
        c_right = d_right;
      }
    }
    cluster.sync();  // every band of the round counted

    // this block's slice of the bins, summed over the cluster in rank order
    if (threadIdx.x < SLICE / 8) {
      uint32_t s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = round == 0 ? 0u : tot[threadIdx.x * 8 + i];
      for (int k = 0; k < CLUSTER; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(hist, k))[r * (SLICE / 8) + threadIdx.x];
        s[0] += v.x & 0xffffu; s[1] += v.x >> 16;
        s[2] += v.y & 0xffffu; s[3] += v.y >> 16;
        s[4] += v.z & 0xffffu; s[5] += v.z >> 16;
        s[6] += v.w & 0xffffu; s[7] += v.w >> 16;
      }
      uint4* t = reinterpret_cast<uint4*>(tot + threadIdx.x * 8);
      t[0] = make_uint4(s[0], s[1], s[2], s[3]);
      t[1] = make_uint4(s[4], s[5], s[6], s[7]);
    }
    cluster.sync();  // every slice summed; the histograms may be reused
  }

  // the output slice: (a, i, j .. j + 3) from the bins (a, min, max), the
  // diagonal doubled (P + P^T)
  float4* o = reinterpret_cast<float4*>(out + blockIdx.y * static_cast<size_t>(BINS)
                                        + r * OUT_SLICE);
  for (int q = threadIdx.x; q < OUT_SLICE / 4; q += THREADS) {
    const int ob = r * OUT_SLICE + q * 4;
    const int a = ob >> 12, i = (ob >> 6) & (NG - 1), j = ob & (NG - 1);
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int lo = min(i, j + t) + 1, hi = max(i, j + t) + 1;
      const int bin = a * TRI + ((hi * (hi - 1)) >> 1) + lo - 1;
      const int owner = bin / SLICE;
      const uint32_t n = cluster.map_shared_rank(tot, owner)[bin - owner * SLICE];
      v[t] = static_cast<float>(lo == hi ? 2u * n : n);
    }
    o[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  cluster.sync();  // no block leaves while another reads its totals
}

// The library's own layout for [m, h, w] maps (ops/glcm.py::glcm_plan)
int band_rows(int h, int w) {
  const int even = (h + CLUSTER - 1) / CLUSTER;
  return w > MAX_BAND_PX ? 0 : (even < MAX_BAND_PX / w ? even : MAX_BAND_PX / w);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a plan that is not this library's layout.
// levels [M, H, W] int32, mask [M, H, W] uint8/bool (inside != 0), out
// [M, 4, 64, 64] float32 (every element written; no zeroing needed); all
// contiguous on one device.  Plan: cluster, band_h, rounds, threads and smem
// as ops/glcm.py::glcm_plan gives them.
int glcm_counts(const void* levels, const void* mask, void* out, int m, int h,
                int w, int cluster, int band_h, int rounds, int threads,
                int smem, void* stream) {
  const int bh = band_rows(h, w);
  if (m < 1 || m > 65535 || h < 1 || w < 1 || bh < 1 || cluster != CLUSTER
      || threads != THREADS || smem != SMEM || band_h != bh
      || rounds != (h + CLUSTER * bh - 1) / (CLUSTER * bh))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(levels) % 16 == 0
                   && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const dim3 grid(CLUSTER, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(levels);
  const uint8_t* k = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (vec)
    glcm_cluster_kernel<true><<<grid, THREADS, SMEM, s>>>(l, k, o, h, w, bh, rounds);
  else
    glcm_cluster_kernel<false><<<grid, THREADS, SMEM, s>>>(l, k, o, h, w, bh, rounds);
  return static_cast<int>(cudaGetLastError());
}

const char* glcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
