// First-order accumulation over ROI maps, batched over maps, Hopper (sm_90a),
// plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/pallas_hist.py::firstorder_accumulate_pallas
//   (_firstorder_kernel)
// For each map b of image [B, N] float32 and levels [B, N] int32, over the
// valid pixels (levels > 0: every positive code, codes above NG included):
//   stats[b] = [n, Sx, min, max, S c, S c^2, S c^3, S c^4, S |c|]   float32
//   mu = round_f32(Sx) / max(n, 1) in float32,  c = x - mu in float32
//   hist[b][k - 1] = #{levels == k} for k = 1..NG (NG = 64); a code above NG
//   counts in stats only (the TPU kernel's 128-lane one-hot is sliced to NG).
// An empty map keeps the TPU kernel's sentinels: min 3.4e38, max -3.4e38,
// every sum 0.
//
// Numerics.  n and hist are integer counts, min and max exact in any order:
// they equal the plain version bit for bit.  The six sums accumulate in
// float64 (each power of c taken in float64 from the float32 c) and are
// rounded to float32 once, at the end.  Every block reduces its pixels in a
// fixed order (thread, then warp shuffle, then warps in index order) and the
// blocks' partials are summed in index order, so a rerun gives the same bits;
// no float atomics.  The TPU kernel summed in float32, block after block: the
// tests hold the sums to ops/histogram.py::SUM_TOL of their magnitude.
//
// What bounds it on the card: memory.  The function needs both inputs once
// (8 bytes a pixel): at the radiomics chunk's call (64 maps of 450 x 600)
// 138 MB, 41 us at 3.35 TB/s.  The float64 work (~8 operations a valid
// pixel) is below the card's float64 rate.  Phase 1 needs mu, which needs
// all of phase 0, so a design that streams the map from device memory in
// both phases reads it twice (the two-pass kernel below: 76% of its two-read
// floor, 38% of the bound).
//
// Design (the cluster path, maps of up to 884,736 pixels; the radiomics
// chunk's 270,000): one thread-block cluster of CLUSTER = 16 blocks a map (a
// non-portable size, launched with cudaLaunchKernelEx) reads the map from
// device memory once and keeps it on chip.
//   - Block r loads its slice of the map, pixels [r P, (r + 1) P), with
//     16-byte loads of both arrays (a scalar head and tail where a row is off
//     16 bytes or N is no multiple of 4; U loads of each in flight a thread)
//     and takes phase 0 (n, Sx, min, max, a histogram a warp in shared
//     memory) on the values in registers as they arrive.  Each warp compacts
//     the x of its valid pixels into a region of shared memory of its own
//     (ballot and popc: the order is fixed by the walk), so phase 1 runs its
//     float64 work on valid pixels only, every lane busy; at 450 x 600 that
//     is 74 KB a block, and two blocks share an SM.
//   - cluster.sync(); warp 0 of every block reads the cluster's (n, Sx)
//     partials, lane k from block k (distributed shared memory,
//     cluster.map_shared_rank), and sums them in rank order by shuffles, so
//     every block holds the same mu bits; phase 1 (the centred sums) reads
//     only shared memory.
//   - cluster.sync(); block 0 gathers the partials the same way, sums them in
//     rank order and writes stats and hist; a last cluster.sync() keeps every
//     block alive while it reads.
// One launch a call, the input read once, no workspace, no ticket.  What
// still bounds it (scripts/probe_fo_mlp.py, PERF.md): a cluster starts its
// map's phase 1 only when all its blocks have loaded their slices, and the
// 64 maps of the chunk's call run as 4 rounds of the clusters that fit at
// once, so device memory idles between a round's loads and the next's.
//
// Design (the two-pass path, larger maps): the TPU kernel runs a (2, blocks)
// grid in order and carries the sums in scratch from phase 0 into phase 1.
// Here both phases are a grid of (chunk, map) blocks of 256 threads, enough
// chunks to put ~4 blocks on every SM, reading float4 / int4 vectors when the
// rows allow it:
//   phase 0: n, Sx, min, max and an NG-bin histogram (one per warp in shared
//            memory, integer atomics) per block -> partials;
//   phase 1: each block sums its map's phase-0 partials in index order for
//            mu (the same bits in every block), accumulates the centred sums
//            -> partials; the block that finishes its map last (an integer
//            ticket, zeroed by phase 0) sums the partials in index order and
//            writes stats and hist.
// Two launches in one stream; the workspace (partials and tickets) is
// allocated by the caller (the plan's workspace bytes).
//
// The wrapper owns the plan (ops/histogram.py::firstorder_plan: the path,
// the slice and the dynamic shared memory); the library recomputes its own
// and refuses any other.  Built by ops/_build.py with nvcc at first launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int NG = 64;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SMS = 132;
constexpr int MIN_CHUNK = 4096;  // pixels a block at least
constexpr int NSUM = 5;          // centred sums
constexpr float BIG = 3.4e38f;   // the TPU kernel's min / max sentinels

// The cluster path (ops/histogram.py: FO_CLUSTER, FO_THREADS, FO_STATIC,
// SMEM_LIMIT): a block's static shared memory stays within STATIC_MAX, its
// dynamic shared memory is its warps' regions of compacted x.
constexpr int CLUSTER = 16;       // blocks a map (a non-portable cluster size)
constexpr int CT = 512;           // threads a cluster block
constexpr int CW = CT / 32;
constexpr int U = 4;              // 16-byte loads of each array in flight a thread
constexpr int STATIC_MAX = 8192;
constexpr int SMEM_LIMIT = 232448;

struct Part0 {
  double sx;
  float mn, mx;
  int n, pad;
};

struct Plan {
  int chunk, nchunk;
};

Plan plan(int B, int N) {
  int want = std::max(1, (4 * SMS + B - 1) / B);
  want = std::min(want, std::max(1, (N + MIN_CHUNK - 1) / MIN_CHUNK));
  int chunk = (N + want - 1) / want;
  chunk = (chunk + 3) & ~3;  // vector loads: chunk boundaries on 4 pixels
  return {chunk, (N + chunk - 1) / chunk};
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

struct Workspace {
  Part0* p0;       // [B, nchunk]
  double* p1;      // [B, nchunk, NSUM]
  int* hp;         // [B, nchunk, NG]
  unsigned* tick;  // [B]
  size_t bytes;
};

Workspace carve(void* base, int B, int nchunk) {
  const size_t parts = size_t(B) * nchunk;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  Workspace w;
  size_t off = 0;
  w.p0 = reinterpret_cast<Part0*>(p + off);
  off += align256(parts * sizeof(Part0));
  w.p1 = reinterpret_cast<double*>(p + off);
  off += align256(parts * NSUM * sizeof(double));
  w.hp = reinterpret_cast<int*>(p + off);
  off += align256(parts * NG * sizeof(int));
  w.tick = reinterpret_cast<unsigned*>(p + off);
  off += align256(size_t(B) * sizeof(unsigned));
  w.bytes = off;
  return w;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Calls take(x, level) for every pixel of this block's chunk of map b, each
// thread on a fixed set of pixels.
template <typename Take>
__device__ __forceinline__ void walk(const float* __restrict__ x, const int32_t* __restrict__ lv,
                                     int N, int chunk, bool vec, Take&& take) {
  const size_t row = size_t(blockIdx.y) * N;
  const int begin = blockIdx.x * chunk;
  const int end = min(N, begin + chunk);
  if (vec) {  // N a multiple of 4, both rows 16-byte aligned
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const int4* l4 = reinterpret_cast<const int4*>(lv + row);
    for (int v = begin / 4 + threadIdx.x; v < end / 4; v += THREADS) {
      const float4 a = x4[v];
      const int4 l = l4[v];
      take(a.x, l.x);
      take(a.y, l.y);
      take(a.z, l.z);
      take(a.w, l.w);
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += THREADS) take(x[row + i], lv[row + i]);
  }
}

__global__ void __launch_bounds__(THREADS)
firstorder_phase0(const float* __restrict__ x, const int32_t* __restrict__ lv, int N, int chunk,
                  int nchunk, bool vec, Workspace ws) {
  __shared__ int hist[NWARPS][NG];
  __shared__ double s_sx[NWARPS];
  __shared__ float s_mn[NWARPS], s_mx[NWARPS];
  __shared__ int s_n[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < NWARPS * NG; i += THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();

  int n = 0;
  double sx = 0.0;
  float mn = BIG, mx = -BIG;
  int* h = hist[warp];
  walk(x, lv, N, chunk, vec, [&](float v, int l) {
    if (l > 0) {
      ++n;
      sx += double(v);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      if (l <= NG) atomicAdd(&h[l - 1], 1);
    }
  });
  n = warp_sum(n);
  sx = warp_sum(sx);
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (lane == 0) {
    s_n[warp] = n;
    s_sx[warp] = sx;
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();

  const size_t part = size_t(blockIdx.y) * nchunk + blockIdx.x;
  for (int i = tid; i < NG; i += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += hist[w][i];
    ws.hp[part * NG + i] = s;
  }
  if (tid == 0) {
    Part0 p{0.0, BIG, -BIG, 0, 0};
    for (int w = 0; w < NWARPS; ++w) {
      p.n += s_n[w];
      p.sx += s_sx[w];
      p.mn = fminf(p.mn, s_mn[w]);
      p.mx = fmaxf(p.mx, s_mx[w]);
    }
    ws.p0[part] = p;
    if (blockIdx.x == 0) ws.tick[blockIdx.y] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
firstorder_phase1(const float* __restrict__ x, const int32_t* __restrict__ lv, int N, int chunk,
                  int nchunk, bool vec, Workspace ws, float* __restrict__ stats,
                  float* __restrict__ hist) {
  __shared__ float s_mu;
  __shared__ double s_part[NWARPS][NSUM];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const Part0* p0 = ws.p0 + size_t(b) * nchunk;
  if (tid == 0) {  // mu from the map's phase-0 partials, in index order
    int n = 0;
    double sx = 0.0;
    for (int j = 0; j < nchunk; ++j) {
      n += p0[j].n;
      sx += p0[j].sx;
    }
    s_mu = float(sx) / fmaxf(float(n), 1.0f);
  }
  __syncthreads();

  const float mu = s_mu;
  double a[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  walk(x, lv, N, chunk, vec, [&](float v, int l) {
    if (l > 0) {
      const double c = double(v - mu);
      const double c2 = c * c;
      a[0] += c;
      a[1] += c2;
      a[2] += c2 * c;
      a[3] += c2 * c2;
      a[4] += fabs(c);
    }
  });
#pragma unroll
  for (int i = 0; i < NSUM; ++i) a[i] = warp_sum(a[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NSUM; ++i) s_part[warp][i] = a[i];
  }
  __syncthreads();
  double* p1 = ws.p1 + size_t(b) * nchunk * NSUM;
  if (tid < NSUM) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += s_part[w][tid];
    p1[blockIdx.x * NSUM + tid] = s;
  }

  // the map's last block to finish sums every partial in index order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ws.tick[b], 1u) == unsigned(nchunk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* st = stats + size_t(b) * 9;
  if (tid < NSUM) {
    double s = 0.0;
    for (int j = 0; j < nchunk; ++j) s += __ldcg(p1 + j * NSUM + tid);
    st[4 + tid] = float(s);
  } else if (tid == NSUM) {
    int n = 0;
    double sx = 0.0;
    float mn = BIG, mx = -BIG;
    for (int j = 0; j < nchunk; ++j) {
      n += p0[j].n;
      sx += p0[j].sx;
      mn = fminf(mn, p0[j].mn);
      mx = fmaxf(mx, p0[j].mx);
    }
    st[0] = float(n);
    st[1] = float(sx);
    st[2] = mn;
    st[3] = mx;
  }
  const int* hp = ws.hp + size_t(b) * nchunk * NG;
  for (int i = tid; i < NG; i += THREADS) {
    int s = 0;
    for (int j = 0; j < nchunk; ++j) s += hp[j * NG + i];
    hist[size_t(b) * NG + i] = float(s);
  }
}

// ---- the cluster path

constexpr unsigned FULL = 0xffffffffu;

// Partials a block shares with its cluster (read by the others through
// distributed shared memory).
struct Shared {
  int whist[CW][NG];     // phase 0 histograms, one a warp
  double wsx[CW];
  float wmn[CW], wmx[CW];
  int wn[CW];
  double wsum[CW][NSUM];
  // the block's totals
  double sx, sum[NSUM];
  float mn, mx;
  int n;
  int hist[NG];
  float mu;
};
static_assert(sizeof(Shared) <= STATIC_MAX, "static shared memory of a cluster block");

struct ClusterPlan {
  int size, slice, region;  // blocks a map, pixels a block, values a warp's region
  size_t smem;              // dynamic shared memory a block
};

// The cluster's split of N pixels: warp w of a block compacts the values of
// its valid pixels into region w of `region` floats (its pixels at most: 128
// a step of the vector walk, and the scalar head and tail).  size 0: a block
// cannot keep its slice (the two-pass path).
ClusterPlan cluster_plan(int N) {
  const long long p = ((static_cast<long long>(N) + CLUSTER - 1) / CLUSTER + 3) & ~3LL;
  const long long region = 128 * ((p / 4 + CT - 1) / CT) + 32;
  const size_t smem = size_t(CW) * size_t(region) * 4;
  if (smem + STATIC_MAX > size_t(SMEM_LIMIT)) return {0, 0, 0, 0};
  return {CLUSTER, static_cast<int>(p), static_cast<int>(region), smem};
}

// Block r of a cluster of cluster.num_blocks() blocks, map blockIdx.y, pixels
// [r P, (r + 1) P).  Dynamic shared memory: CW regions of R floats.
__global__ void __launch_bounds__(CT, 2)
firstorder_cluster(const float* __restrict__ x, const int32_t* __restrict__ lv, int N, int P,
                   int R, bool vec, float* __restrict__ stats, float* __restrict__ hist) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) float xs[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int s = min(N, r * P);
  const int len = min(N, s + P) - s;
  const float* xr = x + size_t(b) * N + s;
  const int32_t* lr = lv + size_t(b) * N + s;
  float* xw = xs + size_t(warp) * R;
  for (int i = tid; i < CW * NG; i += CT) (&sh.whist[0][0])[i] = 0;
  __syncthreads();

  // ---- load the slice once; phase 0 on the values in registers; the warp
  // compacts its valid values into its region (every lane calls take: has
  // says whether it holds a pixel)
  int n = 0, cnt = 0;
  double sx = 0.0;
  float mn = BIG, mx = -BIG;
  int* h = sh.whist[warp];
  const auto take = [&](bool has, float v, int l) {
    const bool ok = has && l > 0;
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) {
      xw[cnt + __popc(m & lt)] = v;
      ++n;
      sx += double(v);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      if (l <= NG) atomicAdd(&h[l - 1], 1);
    }
    cnt += __popc(m);
  };
  const auto scalars = [&](int lo, int hi) {  // pixels [lo, hi), warp-uniform steps
    for (int i0 = lo + 32 * warp; i0 < hi; i0 += CT) {
      const int i = i0 + lane;
      const bool has = i < hi;
      take(has, has ? xr[i] : 0.0f, has ? lr[i] : 0);
    }
  };
  // x and levels share their phase against 16 bytes (vec): pixels before
  // the first 16-byte boundary, whole vectors, then the tail
  const int head =
      vec ? min(len, int((4 - ((reinterpret_cast<uintptr_t>(xr) >> 2) & 3)) & 3)) : len;
  const int nv = (len - head) >> 2;
  scalars(0, head);
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  const int4* l4 = reinterpret_cast<const int4*>(lr + head);
  for (int v0 = 32 * warp; v0 < nv; v0 += U * CT) {
    float4 a[U];
    int4 l[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * CT + lane;
      a[u] = v < nv ? __ldcs(x4 + v) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      l[u] = v < nv ? __ldcs(l4 + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + u * CT >= nv) break;  // warp-uniform
      const bool has = v0 + u * CT + lane < nv;
      take(has, a[u].x, l[u].x);
      take(has, a[u].y, l[u].y);
      take(has, a[u].z, l[u].z);
      take(has, a[u].w, l[u].w);
    }
  }
  scalars(head + 4 * nv, len);

  n = warp_sum(n);
  sx = warp_sum(sx);
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (lane == 0) {
    sh.wn[warp] = n;
    sh.wsx[warp] = sx;
    sh.wmn[warp] = mn;
    sh.wmx[warp] = mx;
  }
  __syncthreads();
  if (tid < NG) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < CW; ++w) c += sh.whist[w][tid];
    sh.hist[tid] = c;
  } else if (tid == NG) {
    int bn = 0;
    double bsx = 0.0;
    float bmn = BIG, bmx = -BIG;
    for (int w = 0; w < CW; ++w) {
      bn += sh.wn[w];
      bsx += sh.wsx[w];
      bmn = fminf(bmn, sh.wmn[w]);
      bmx = fmaxf(bmx, sh.wmx[w]);
    }
    sh.n = bn;
    sh.sx = bsx;
    sh.mn = bmn;
    sh.mx = bmx;
  }
  cluster.sync();  // every block's phase-0 totals are written

  // ---- mu from the cluster's (n, Sx), lane k reading block k, summed in
  // rank order: the same bits in every block
  if (warp == 0) {
    int pn = 0;
    double psx = 0.0;
    if (lane < cs) {
      const Shared* o = cluster.map_shared_rank(&sh, lane);
      pn = o->n;
      psx = o->sx;
    }
    int cn = 0;
    double csx = 0.0;
    for (int k = 0; k < cs; ++k) {
      cn += __shfl_sync(FULL, pn, k);
      csx += __shfl_sync(FULL, psx, k);
    }
    if (lane == 0) sh.mu = float(csx) / fmaxf(float(cn), 1.0f);
  }
  __syncthreads();

  // ---- phase 1 over the warp's compacted values
  const float mu = sh.mu;
  double acc[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = lane; i < cnt; i += 32) {
    const double c = double(xw[i] - mu);
    const double c2 = c * c;
    acc[0] += c;
    acc[1] += c2;
    acc[2] += c2 * c;
    acc[3] += c2 * c2;
    acc[4] += fabs(c);
  }
#pragma unroll
  for (int i = 0; i < NSUM; ++i) acc[i] = warp_sum(acc[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NSUM; ++i) sh.wsum[warp][i] = acc[i];
  }
  __syncthreads();
  if (tid < NSUM) {
    double t = 0.0;
    for (int w = 0; w < CW; ++w) t += sh.wsum[w][tid];
    sh.sum[tid] = t;
  }
  cluster.sync();  // every block's centred sums are written

  // ---- block 0 sums the cluster's partials in rank order and writes the map
  if (r == 0) {
    if (warp == 0) {
      int pn = 0;
      double psx = 0.0, ps[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
      float pmn = BIG, pmx = -BIG;
      if (lane < cs) {
        const Shared* o = cluster.map_shared_rank(&sh, lane);
        pn = o->n;
        psx = o->sx;
        pmn = o->mn;
        pmx = o->mx;
#pragma unroll
        for (int i = 0; i < NSUM; ++i) ps[i] = o->sum[i];
      }
      int cn = 0;
      double csx = 0.0, csum[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
      float cmn = BIG, cmx = -BIG;
      for (int k = 0; k < cs; ++k) {
        cn += __shfl_sync(FULL, pn, k);
        csx += __shfl_sync(FULL, psx, k);
        cmn = fminf(cmn, __shfl_sync(FULL, pmn, k));
        cmx = fmaxf(cmx, __shfl_sync(FULL, pmx, k));
#pragma unroll
        for (int i = 0; i < NSUM; ++i) csum[i] += __shfl_sync(FULL, ps[i], k);
      }
      if (lane == 0) {
        float* st = stats + size_t(b) * 9;
        st[0] = float(cn);
        st[1] = float(csx);
        st[2] = cmn;
        st[3] = cmx;
#pragma unroll
        for (int i = 0; i < NSUM; ++i) st[4 + i] = float(csum[i]);
      }
    }
    // the cluster's histograms gathered into this block's value regions,
    // which phase 1 is done with
    int* gather = reinterpret_cast<int*>(xs);
    for (int t = tid; t < cs * NG; t += CT)
      gather[t] = cluster.map_shared_rank(&sh, t / NG)->hist[t % NG];
    __syncthreads();
    if (tid < NG) {
      int c = 0;
      for (int k = 0; k < cs; ++k) c += gather[k * NG + tid];
      hist[size_t(b) * NG + tid] = float(c);
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its partials
}

// The library's plan for B maps of N pixels (ops/histogram.py::
// firstorder_plan): *path 0 = the cluster path (*cluster blocks a map,
// *slice pixels a block, *region values a warp, *smem bytes of dynamic
// shared memory, *ws 0), 1 = the two-pass path (*ws bytes of workspace, the
// others 0).  Returns 0, or cudaErrorInvalidValue where no path takes the
// maps.
int library_plan(int B, int N, int* path, int* cluster, int* slice, int* region,
                 long long* smem, long long* ws) {
  if (B <= 0 || N <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterPlan c = cluster_plan(N);
  *path = c.size > 0 ? 0 : 1;
  *cluster = c.size;
  *slice = c.slice;
  *region = c.region;
  *smem = static_cast<long long>(c.smem);
  *ws = c.size > 0 ? 0 : static_cast<long long>(carve(nullptr, B, plan(B, N).nchunk).bytes);
  return 0;
}

}  // namespace

extern "C" {

// Launches the plan's path on `stream` and returns cudaGetLastError() (0 =
// ok), or cudaErrorInvalidValue for a plan that is not library_plan's.
// image [B, N] float32, levels [B, N] int32 (contiguous), stats [B, 9] and
// hist [B, NG] float32; ws (two-pass path) ws_bytes of workspace, 256-byte
// aligned.
int firstorder_accumulate(const void* image, const void* levels, void* stats, void* hist, int B,
                          int N, int path, int cluster, int slice, int region, long long smem,
                          void* ws, long long ws_bytes, void* stream) {
  int want[4] = {0, 0, 0, 0};
  long long want_smem = 0, want_ws = 0;
  if (library_plan(B, N, &want[0], &want[1], &want[2], &want[3], &want_smem, &want_ws) != 0 ||
      path != want[0] || cluster != want[1] || slice != want[2] || region != want[3] ||
      smem != want_smem || ws_bytes != want_ws || (path == 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(image);
  const int32_t* lv = static_cast<const int32_t*>(levels);
  if (path == 0) {
    static size_t done[64] = {};  // the attributes set, a device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (size_t(smem) > done[dev]) {
      e = cudaFuncSetAttribute(firstorder_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(firstorder_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      done[dev] = size_t(smem);
    }
    const uintptr_t xa = reinterpret_cast<uintptr_t>(image), la = reinterpret_cast<uintptr_t>(levels);
    const bool vec = ((xa | la) & 3) == 0 && ((xa ^ la) & 15) == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B);
    cfg.blockDim = dim3(CT);
    cfg.dynamicSmemBytes = size_t(smem);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, firstorder_cluster, x, lv, N, slice, region, vec,
                           static_cast<float*>(stats), static_cast<float*>(hist));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan p = plan(B, N);
  const Workspace w = carve(ws, B, p.nchunk);
  const dim3 grid(p.nchunk, B);
  const bool vec = (N & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(levels)) &
                    15) == 0;
  firstorder_phase0<<<grid, THREADS, 0, s>>>(x, lv, N, p.chunk, p.nchunk, vec, w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  firstorder_phase1<<<grid, THREADS, 0, s>>>(x, lv, N, p.chunk, p.nchunk, vec, w,
                                             static_cast<float*>(stats),
                                             static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}

const char* firstorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
