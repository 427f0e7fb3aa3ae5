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

// ---- The v1 tile rule (K3, K5-K7) ----------------------------------------
// A pair samples one kTile x kTile-px tile of the atlas: a tap outside the
// tile weighs 0, and a tile pixel past the atlas edge reads 0 (the
// reference zero-pads its tiles).

constexpr int kTile = 32;            // tile extent in px
constexpr int kTileRow = 3 * kTile;  // bytes per staged tile row
constexpr int kTileStride = 12;      // tile origin stride in px

// A tile: pixel (0, 0) at `px`, rows `row` bytes apart, pixels (x, y) with
// x < w, y < h readable (w, h < kTile where the tile passes the atlas edge).
struct Tile {
  const uint8_t* px;
  int row, w, h;
};

// A tile staged in shared memory by `stage_tile`.
__device__ __forceinline__ Tile staged_tile(const uint8_t* smem) {
  return {smem, kTileRow, kTile, kTile};
}

// The tile at atlas pixel (ox, oy) of view n, read in place.
__device__ __forceinline__ Tile atlas_tile(const uint8_t* atlas, int n, int H,
                                           int WA, int ox, int oy) {
  return {atlas + ((static_cast<long long>(n) * H + oy) * WA + ox) * 3,
          WA * 3, WA - ox < kTile ? WA - ox : kTile,
          H - oy < kTile ? H - oy : kTile};
}

// One RGB tap (x, y) of tile `t`; 0 outside it.
__device__ __forceinline__ void tile_rgb(Tile t, int x, int y, float rgb[3]) {
  const bool in = x >= 0 && x < t.w && y >= 0 && y < t.h;
  const uint8_t* p = t.px + (in ? y * t.row + x * 3 : 0);
  rgb[0] = in ? static_cast<float>(p[0]) : 0.f;
  rgb[1] = in ? static_cast<float>(p[1]) : 0.f;
  rgb[2] = in ? static_cast<float>(p[2]) : 0.f;
}

// One warp copies the tile at atlas pixel (ox, oy) of view n into shared
// memory tile[kTile * kTileRow], byte by byte, pixels past the atlas edge
// as 0. Returns the sum of the bytes this lane copied.
__device__ __forceinline__ unsigned stage_tile(uint8_t* tile,
                                               const uint8_t* atlas, int n,
                                               int H, int WA, int ox, int oy,
                                               int lane) {
  unsigned sum = 0;
  for (int i = lane; i < kTile * kTileRow; i += 32) {
    const int y = oy + i / kTileRow;
    const int xb = ox * 3 + i % kTileRow;
    const uint8_t v =
        (y >= 0 && y < H && xb >= 0 && xb < WA * 3)
            ? atlas[(static_cast<long long>(n) * H + y) * WA * 3 + xb]
            : 0;
    tile[i] = v;
    sum += v;
  }
  return sum;
}

// The TPU kernels' bilinear hat weight of a tap at distance d.
__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

// Bilinear RGB at tile-relative (rx, ry) with hat weights, interpolated in
// y first, then in x: the order of the TPU kernels' y-interpolation and
// fold matmuls (ops/ablate.tile_bilinear is the plain version).
__device__ __forceinline__ void tile_bilinear(Tile t, float rx, float ry,
                                              float val[3]) {
  const float fx = floorf(rx), fy = floorf(ry);
  const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
  const float wx0 = hat(rx - fx), wx1 = hat(rx - (fx + 1.f));
  const float wy0 = hat(ry - fy), wy1 = hat(ry - (fy + 1.f));
  float p00[3], p01[3], p10[3], p11[3];  // p<dx><dy>
  tile_rgb(t, lx, ly, p00);
  tile_rgb(t, lx, ly + 1, p01);
  tile_rgb(t, lx + 1, ly, p10);
  tile_rgb(t, lx + 1, ly + 1, p11);
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
