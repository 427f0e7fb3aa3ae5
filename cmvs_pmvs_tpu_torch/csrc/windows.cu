// Normalized texture-window kernel (K2).
//
// Replaces the Pallas TPU kernel `_windows_kernel` (cmvs_pmvs_tpu/ops/
// pallas_incc.py, launched by `windows_pallas`) and the XLA block gather
// `_gather_blocks` that fed it: for every (patch, view) pair it samples
// the s2 block-relative positions (relx, rely) bilinearly inside the
// BLOCK_K x BLOCK_K block at atlas[n, sy:sy+k, sx:sx+k] - the block
// start clamped into the atlas like the reference's CLIP-mode gather, a
// tap outside [0, k) of the block weighing 0 - then normalizes the
// window to zero per-channel mean and unit global variance. Failed grabs
// (ok = 0) give zeros. Output [pairs, s2, 3] float32.
//
// Layout: one warp per pair, four pairs per block; the window lives in
// shared memory between the sampling pass and the two normalization
// passes. Taps are read straight from the uint8 atlas - no pre-gathered
// [pairs, 20, 60] block array exists on the GPU.
//
// What bounds it on an H100: the output write (s2*3 floats per pair,
// 588 B at wsize 7) and the scattered tap reads; arithmetic is trivial.
// The design reads each tap once and writes each output value once.
//
// Numerics: float32, two-pass moments, -fmad=false so sample weights
// round exactly like the plain version (ops/windows.windows_plain).

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void windows_kernel(const uint8_t* __restrict__ atlas, int N,
                               int H, int WA,
                               const int* __restrict__ starts,
                               const float* __restrict__ relx,
                               const float* __restrict__ rely,
                               const uint8_t* __restrict__ ok,
                               float* __restrict__ out, long long pairs,
                               int s2, int k) {
  extern __shared__ float sh[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (p >= pairs) return;
  float* dst = out + p * s2 * 3;
  if (ok[p] == 0) {
    for (int i = lane; i < s2 * 3; i += 32) dst[i] = 0.f;
    return;
  }
  float* win = sh + w * s2 * 3;
  const int n = cmvs::clampi(starts[p * 3], 0, N - 1);
  const int sy = cmvs::clampi(starts[p * 3 + 1], 0, H - k > 0 ? H - k : 0);
  const int sx = cmvs::clampi(starts[p * 3 + 2], 0, WA - k > 0 ? WA - k : 0);

  float sum[3] = {0.f, 0.f, 0.f};
  for (int s = lane; s < s2; s += 32) {
    const float rx = relx[p * s2 + s];
    const float ry = rely[p * s2 + s];
    const float fx = floorf(rx), fy = floorf(ry);
    const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
    const float ax = rx - fx, ay = ry - fy;
    const float wx0 = (lx >= 0 && lx < k) ? 1.f - ax : 0.f;
    const float wx1 = (lx + 1 >= 0 && lx + 1 < k) ? ax : 0.f;
    const float wy0 = (ly >= 0 && ly < k) ? 1.f - ay : 0.f;
    const float wy1 = (ly + 1 >= 0 && ly + 1 < k) ? ay : 0.f;
    float p00[3], p01[3], p10[3], p11[3];  // p<dx><dy>
    cmvs::atlas_rgb(atlas, n, H, WA, sy + ly, sx + lx, p00);
    cmvs::atlas_rgb(atlas, n, H, WA, sy + ly + 1, sx + lx, p01);
    cmvs::atlas_rgb(atlas, n, H, WA, sy + ly, sx + lx + 1, p10);
    cmvs::atlas_rgb(atlas, n, H, WA, sy + ly + 1, sx + lx + 1, p11);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float row0 = wy0 * p00[c] + wy1 * p01[c];
      const float row1 = wy0 * p10[c] + wy1 * p11[c];
      const float val = wx0 * row0 + wx1 * row1;
      win[s * 3 + c] = val;
      sum[c] += val;
    }
  }
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = cmvs::warp_sum(sum[c]) / s2;
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
  float sd = sqrtf(cmvs::warp_sum(sq) / (3.f * s2));
  if (sd == 0.f) sd = 1.f;
  __syncwarp();
  for (int i = lane; i < s2 * 3; i += 32) dst[i] = win[i] / sd;
}

}  // namespace

extern "C" int cmvs_windows(const void* atlas, int N, int H, int WA,
                            const void* starts, const void* relx,
                            const void* rely, const void* ok, void* out,
                            long long pairs, int s2, int k, void* stream) {
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  const size_t shmem = static_cast<size_t>(kWarps) * s2 * 3 * sizeof(float);
  windows_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, shmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(starts), static_cast<const float*>(relx),
      static_cast<const float*>(rely), static_cast<const uint8_t*>(ok),
      static_cast<float*>(out), pairs, s2, k);
  return static_cast<int>(cudaGetLastError());
}
