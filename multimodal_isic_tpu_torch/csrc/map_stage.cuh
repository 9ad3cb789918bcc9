// Staging of a window of an int32 level map and its 1-byte inside flags in
// shared memory, for the radiomics kernels that work on a tile or band of a
// map (connected_components.cu, glrlm_runs.cu).
//
// With VEC (W a multiple of 4, levels 16-byte and flags 4-byte aligned) every
// 4-cell quad is copied with cp.async (16 bytes of levels, 4 of flags), so a
// block has its whole window in flight at once instead of one load a thread
// at a time; otherwise cell by cell.  Rows outside the frame and columns past
// the window's width get level 0 and flag 0.  The caller waits with
// stage_wait() and a __syncthreads().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace map_stage {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Map rows y_first .. y_first + n_rows - 1, columns x0 .. x0 + cols - 1 of a
// map of h x w cells → shared rows 0 .. n_rows - 1 of `stride` cells (a
// multiple of 4, >= cols): levels slv, flags sfl (1 byte each, as stored).
template <bool VEC>
__device__ __forceinline__ void stage(const int32_t* __restrict__ lv,
                                      const uint8_t* __restrict__ in,
                                      int32_t* slv, uint8_t* sfl, int y_first,
                                      int n_rows, int x0, int cols, int h,
                                      int w, int stride) {
  const int qw = stride / 4;
  for (int j = threadIdx.x; j < n_rows * qw; j += blockDim.x) {
    const int k = j / qw, c = (j - k * qw) * 4;
    const int y = y_first + k;
    int32_t* dl = slv + k * stride + c;
    uint8_t* df = sfl + k * stride + c;
    const size_t g = static_cast<size_t>(y) * w + x0 + c;
    if (y < 0 || y >= h || c >= cols) {
      *reinterpret_cast<int4*>(dl) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<uint32_t*>(df) = 0u;
    } else if constexpr (VEC) {
      cp_async16(dl, lv + g);
      cp_async4(df, in + g);
    } else {
      int t[4] = {0, 0, 0, 0};
      uint32_t f = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c + i < cols) {
          t[i] = lv[g + i];
          f |= static_cast<uint32_t>(in[g + i] != 0) << (8 * i);
        }
      }
      *reinterpret_cast<int4*>(dl) = make_int4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<uint32_t*>(df) = f;
    }
  }
}

}  // namespace map_stage
