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

// The k x k sampling block of pair p: starts[p] = (n, sy, sx_atlas), each
// clamped into the atlas like the reference's CLIP-mode block gather.
struct Block {
  int n, sy, sx;
};

__device__ __forceinline__ Block block_of(const int* starts, long long p,
                                          int N, int H, int WA, int k) {
  Block b;
  b.n = clampi(starts[p * 3], 0, N - 1);
  b.sy = clampi(starts[p * 3 + 1], 0, H - k > 0 ? H - k : 0);
  b.sx = clampi(starts[p * 3 + 2], 0, WA - k > 0 ? WA - k : 0);
  return b;
}

// Bilinear RGB at block-relative position (rx, ry) inside block `b`; a
// tap outside [0, k) of the block weighs 0 (the reference's block
// semantics, ops/texture.block_bilinear). Operation order of the plain
// version, so both round alike under -fmad=false.
__device__ __forceinline__ void block_sample(const uint8_t* atlas, int H,
                                             int WA, Block b, int k,
                                             float rx, float ry,
                                             float val[3]) {
  const float fx = floorf(rx), fy = floorf(ry);
  const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
  const float ax = rx - fx, ay = ry - fy;
  const float wx0 = (lx >= 0 && lx < k) ? 1.f - ax : 0.f;
  const float wx1 = (lx + 1 >= 0 && lx + 1 < k) ? ax : 0.f;
  const float wy0 = (ly >= 0 && ly < k) ? 1.f - ay : 0.f;
  const float wy1 = (ly + 1 >= 0 && ly + 1 < k) ? ay : 0.f;
  float p00[3], p01[3], p10[3], p11[3];  // p<dx><dy>
  atlas_rgb(atlas, b.n, H, WA, b.sy + ly, b.sx + lx, p00);
  atlas_rgb(atlas, b.n, H, WA, b.sy + ly + 1, b.sx + lx, p01);
  atlas_rgb(atlas, b.n, H, WA, b.sy + ly, b.sx + lx + 1, p10);
  atlas_rgb(atlas, b.n, H, WA, b.sy + ly + 1, b.sx + lx + 1, p11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float row0 = wy0 * p00[c] + wy1 * p01[c];
    const float row1 = wy0 * p10[c] + wy1 * p11[c];
    val[c] = wx0 * row0 + wx1 * row1;
  }
}

// Deviations from the per-channel mean of one warp's window win[s2 * 3]
// (in place); returns the variance over all 3 * s2 values.
__device__ __forceinline__ float center_window(float* win, int s2, int lane,
                                               const float sum[3]) {
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = warp_sum(sum[c]) / s2;
  __syncwarp();
  float sq = 0.f;
  for (int s = lane; s < s2; s += 32) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = win[s * 3 + c] - mean[c];
      win[s * 3 + c] = d;
      sq += d * d;
    }
  }
  return warp_sum(sq) / (3.f * s2);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
__host__ inline cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cmvs
