// Refine-fan robust INCC kernel, v1 tile semantics (K3).
//
// Replaces the Pallas TPU kernel `_fan_kernel` (cmvs_pmvs_tpu/ops/
// pallas_fan.py, launched by `incc_fan`). Same function as K1
// (csrc/fan2.cu) - for every (patch b, view v, probe f) the robust INCC
// x / (1 + 3x) of x = 1 - NCC of the view's wsize x wsize window against
// the view-0 window at the same probe - with v1's own rule: every probe
// of a (patch, view) pair is sampled from ONE 32 x 32-px tile of the
// atlas, the pair's probe-0 tile (origin tile_org[b, v], atlas pixels).
// A bilinear tap outside that tile weighs 0, and tile pixels past the
// atlas edge read 0 (the reference pads its tiles with zeros).
//
// Layout: one block per patch, one warp per view. Each warp stages its
// pair's tile (32 rows x 96 bytes of uint8 RGB) in shared memory once;
// then, probe by probe, it samples its window from the tile into shared
// memory, centres it, and correlates it with warp 0's window of the same
// probe. The TPU kernel's hat-weight matmuls and int/frac geometry split
// existed only for its matrix unit and are not carried over.
//
// What bounds it on an H100: the tile loads (T x 3 KB per patch, read
// byte by byte) and the per-sample arithmetic; the window, its moments
// and the tile never leave the SM, and one float per (pair, probe) is
// written.
//
// Numerics: float32, two-pass (mean-subtracted) moments, -fmad=false and
// the operation order of the plain version (ops/fan.incc_fan_v1_plain).
// Probes with ok = 0 contribute an all-zero window.

#include "common.cuh"

namespace {

using cmvs::kTile;
using cmvs::kTileRow;

__global__ void fan_v1_kernel(const uint8_t* __restrict__ atlas, int N,
                              int H, int WA, const int* __restrict__ vid,
                              const int* __restrict__ tile_org,
                              const float* __restrict__ frames,
                              const uint8_t* __restrict__ ok,
                              float* __restrict__ out, int T, int fan,
                              int wsize) {
  extern __shared__ float sh[];
  const int s2 = wsize * wsize;
  float* var_sh = sh + T * s2 * 3;                        // [T]
  uint8_t* tiles = reinterpret_cast<uint8_t*>(var_sh + T);  // [T, 32, 96]
  const int b = blockIdx.x;
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(b) * T + v;
  const int n = cmvs::clampi(vid[pair], 0, N - 1);
  const int ox = tile_org[pair * 2], oy = tile_org[pair * 2 + 1];
  uint8_t* tile = tiles + v * kTile * kTileRow;
  const cmvs::Tile tl = cmvs::staged_tile(tile);
  float* win = sh + v * s2 * 3;
  const float* ref = sh;                                  // warp 0's window

  cmvs::stage_tile(tile, atlas, n, H, WA, ox, oy, lane);
  __syncwarp();

  const int margin = wsize / 2;
  for (int f = 0; f < fan; ++f) {
    const long long probe = pair * fan + f;
    const float* fr = frames + probe * 6;
    const bool okp = ok[probe] != 0;
    float sum[3] = {0.f, 0.f, 0.f};
    for (int s = lane; s < s2; s += 32) {
      float val[3] = {0.f, 0.f, 0.f};
      if (okp) {
        const float gx = static_cast<float>(s % wsize - margin);
        const float gy = static_cast<float>(s / wsize - margin);
        const float x = fr[0] + gx * fr[2] + gy * fr[4] - ox;
        const float y = fr[1] + gx * fr[3] + gy * fr[5] - oy;
        const float fx = floorf(x), fy = floorf(y);
        const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
        const float dx1 = x - fx, dy1 = y - fy;
        const float dx0 = 1.f - dx1, dy0 = 1.f - dy1;
        float c00[3], c10[3], c01[3], c11[3];
        cmvs::tile_rgb(tl, lx, ly, c00);
        cmvs::tile_rgb(tl, lx + 1, ly, c10);
        cmvs::tile_rgb(tl, lx, ly + 1, c01);
        cmvs::tile_rgb(tl, lx + 1, ly + 1, c11);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          val[c] = c00[c] * dx0 * dy0 + c10[c] * dx1 * dy0 +
                   c01[c] * dx0 * dy1 + c11[c] * dx1 * dy1;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        win[s * 3 + c] = val[c];
        sum[c] += val[c];
      }
    }
    const float var = cmvs::center_window(win, s2, lane, sum);
    if (lane == 0) var_sh[v] = var;
    __syncthreads();

    float cross = 0.f;
    for (int s = lane; s < s2; s += 32) {
#pragma unroll
      for (int c = 0; c < 3; ++c) cross += win[s * 3 + c] * ref[s * 3 + c];
    }
    const float cov = cmvs::warp_sum(cross) / (3.f * s2);
    if (lane == 0) {
      const float var_r = var_sh[0];
      const float istd_v =
          var <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var, 1e-20f));
      const float istd_r =
          var_r <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var_r, 1e-20f));
      const float dot = cov * istd_r * istd_v;
      const float xx = 1.f - dot;
      out[probe] = xx / (1.f + 3.f * xx);
    }
    __syncthreads();  // the next probe overwrites the windows
  }
}

}  // namespace

extern "C" int cmvs_fan_v1_incc(const void* atlas, int N, int H, int WA,
                                const void* vid, const void* tile_org,
                                const void* frames, const void* ok,
                                void* out, int B, int T, int fan, int wsize,
                                void* stream) {
  const int s2 = wsize * wsize;
  const size_t shmem = (static_cast<size_t>(T) * s2 * 3 + T) * sizeof(float) +
                       static_cast<size_t>(T) * kTile * kTileRow;
  const cudaError_t attr = cmvs::allow_shared(fan_v1_kernel, shmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fan_v1_kernel<<<B, 32 * T, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(vid), static_cast<const int*>(tile_org),
      static_cast<const float*>(frames), static_cast<const uint8_t*>(ok),
      static_cast<float*>(out), T, fan, wsize);
  return static_cast<int>(cudaGetLastError());
}
