// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cmvs {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One RGB pixel of the uint8 atlas [N, H, WA, 3], indices clamped.
__device__ __forceinline__ void atlas_rgb(const uint8_t* atlas, int n,
                                          int H, int WA, int y, int x,
                                          float rgb[3]) {
  y = clampi(y, 0, H - 1);
  x = clampi(x, 0, WA - 1);
  const uint8_t* p = atlas + ((static_cast<long long>(n) * H + y) * WA + x) * 3;
  rgb[0] = static_cast<float>(p[0]);
  rgb[1] = static_cast<float>(p[1]);
  rgb[2] = static_cast<float>(p[2]);
}

}  // namespace cmvs
