// Non-causal softmax attention in float32 for Hopper (sm_90a), plain C
// interface.
//
// Replaces the JAX package's Pallas TPU kernel
//   multimodal_isic_tpu/ops/attention.py::flash_attention (_flash_kernel), forward:
//   out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
// computed in float32 with an online softmax, so the [N, N] scores never
// exist.  q, k and v are read where they lie, in T (float or bf16; bf16 ->
// f32 is exact, which is what the JAX model's casts compute) through
// arbitrary (batch, head, token) strides with D contiguous: the model hands
// over views of its [B, N, 3, H, D] qkv projection.  The result is rounded
// to T and written to a contiguous [B, N, H, D] tensor, the layout the output
// projection reads.
//
// What bounds it on the card.  ConvMAE's encoder, bs 128: [128, 12, 196, 64],
// 15.1 GFLOP a layer against 0.31 GB of float32 q/k/v/out: the float32 CUDA
// cores bound it (TF32 stays off: the reference is full float32).  N is at
// most 196, so no padded keys are needed: every loop is bounded by N.
//
// Design.  One thread per query row, BQ = 128 queries a block, grid (query
// blocks, B*H).  The thread keeps its scaled q row and its f32 output
// accumulator (D values each) in registers.  Keys and values stream through
// shared memory in tiles of KT = 64 (converted to f32 once); each thread
// walks a tile in steps of S = 16 keys: 16 dot products (every thread reads
// the same key row, a shared-memory broadcast), the step's max, one rescale
// of the accumulator by exp(m_old - m_new), then 16 multiply-adds of v rows.
// Left for later work: tensor cores (3xTF32 or bf16 splits) and several
// threads per row for more blocks in flight at N = 49.

#include "convmae_common.cuh"

namespace {

using namespace convmae;

constexpr int BQ = 128;  // queries (threads) a block
constexpr int KT = 64;   // keys a shared-memory tile
constexpr int S = 16;    // keys a register step

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int N, int qsb,
                       int qsh, int qsn, int ksb, int ksh, int ksn, int vsb, int vsh, int vsn,
                       float scale) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int qi = blockIdx.x * BQ + threadIdx.x;
  const bool valid = qi < N;

  float qr[D], acc[D];
  {
    const T* qp = q + size_t(b) * qsb + size_t(h) * qsh + size_t(valid ? qi : 0) * qsn;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f(qp[d]) * scale;
      acc[d] = 0.0f;
    }
  }
  float m = -INFINITY, l = 0.0f;
  const T* kb = k + size_t(b) * ksb + size_t(h) * ksh;
  const T* vb = v + size_t(b) * vsb + size_t(h) * vsh;

  for (int t0 = 0; t0 < N; t0 += KT) {
    const int nk = min(KT, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nk * (D / VEC); i += BQ) {
      const int r = i / (D / VEC), c = (i - r * (D / VEC)) * VEC;
      const uint4 kw = __ldg(reinterpret_cast<const uint4*>(kb + size_t(t0 + r) * ksn + c));
      const uint4 vw = __ldg(reinterpret_cast<const uint4*>(vb + size_t(t0 + r) * vsn + c));
      const T* kt = reinterpret_cast<const T*>(&kw);
      const T* vt = reinterpret_cast<const T*>(&vw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r][c + e] = to_f(kt[e]);
        vs[r][c + e] = to_f(vt[e]);
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += S) {
      float s[S];
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < S; ++jj) {
        float dot = -INFINITY;
        if (j0 + jj < nk) {
          const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
          dot = 0.0f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kv = kr[d4];
            dot = fmaf(qr[4 * d4], kv.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
          }
        }
        s[jj] = dot;
        mt = fmaxf(mt, dot);
      }
      const float m_new = fmaxf(m, mt);  // finite: key j0 exists
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < S; ++jj) {
        if (j0 + jj < nk) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }
  if (!valid) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* op = out + ((size_t(b) * N + qi) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; d += VEC) {
    uint4 pk;
    T* w = reinterpret_cast<T*>(&pk);
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[e] = from_f<T>(acc[d + e] * inv);
    *reinterpret_cast<uint4*>(op + d) = pk;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
                   const int* st, cudaStream_t stream) {
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      float(1.0 / sqrt(double(D))));  // as the JAX kernel's f32(1/math.sqrt(D))
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
             int D, const int* st, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, N, st, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, N, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// q, k, v [B, H, N, D] in T with element strides (batch, head, token) each
// and D contiguous, 16-byte aligned rows; out [B, N, H, D] contiguous in T.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int N, int D, int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                        int vsb, int vsh, int vsn, void* stream) {
  const int st[9] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn};
  return dispatch<float>(q, k, v, out, B, H, N, D, st, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int N, int D, int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                         int vsb, int vsh, int vsn, void* stream) {
  const int st[9] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn};
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, N, D, st, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
