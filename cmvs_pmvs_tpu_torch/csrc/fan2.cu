// Refine-fan robust INCC kernel (K1).
//
// Replaces the Pallas TPU kernel `_fan2_kernel` (cmvs_pmvs_tpu/ops/
// pallas_fan2.py) together with its XLA tail `_moments_tail2`: for every
// (patch b, view v, probe f) it builds the wsize x wsize sample lattice
// org + gx*dx + gy*dy from six frame scalars, samples bilinear RGB from
// the uint8 atlas, normalizes the window (zero per-channel mean, unit
// global variance) and returns the robust INCC x / (1 + 3x) of
// x = 1 - NCC against the same patch's view-0 window at the same probe.
//
// Layout: one block per (patch, probe), one warp per view, so the
// reference window (warp 0) is shared through shared memory and every
// reduction is a warp shuffle. Each lane reads its samples' four taps
// straight from the atlas: the TPU kernel built hat-weight matrices and
// ran matmuls only because the TPU vector unit has no per-row gather.
//
// What bounds it on an H100: scattered 3-byte tap reads (4 per sample,
// mostly L1/L2 hits since a window spans ~10x10 px) and the two passes
// over the window; there is no data reuse for tensor cores to exploit.
// The design keeps every intermediate on chip (window in shared memory,
// moments in registers) and writes one float per (pair, probe); the
// TPU kernel's moment sums never reach device memory.
//
// Numerics: float32 throughout, two-pass (mean-subtracted) moments.
// Built with -fmad=false so sample positions and bilinear weights round
// exactly like the plain PyTorch version (ops/fan2.incc_fan_plain).
// Probes with ok = 0 contribute an all-zero window.

#include "common.cuh"

namespace {

__global__ void fan_incc_kernel(const uint8_t* __restrict__ atlas, int N,
                                int H, int WA,
                                const int* __restrict__ vid,
                                const float* __restrict__ frames,
                                const uint8_t* __restrict__ ok,
                                float* __restrict__ out, int T, int fan,
                                int wsize) {
  extern __shared__ float sh[];
  const int s2 = wsize * wsize;
  float* var_sh = sh + T * s2 * 3;            // [T]
  const int b = blockIdx.x / fan;
  const int f = blockIdx.x % fan;
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(b) * T + v;
  const long long probe = pair * fan + f;
  const float* fr = frames + probe * 6;
  const bool okp = ok[probe] != 0;
  const int n = cmvs::clampi(vid[pair], 0, N - 1);
  const int margin = wsize / 2;
  float* win = sh + v * s2 * 3;

  float sum[3] = {0.f, 0.f, 0.f};
  for (int s = lane; s < s2; s += 32) {
    float val[3] = {0.f, 0.f, 0.f};
    if (okp) {
      const float gx = static_cast<float>(s % wsize - margin);
      const float gy = static_cast<float>(s / wsize - margin);
      const float x = fr[0] + gx * fr[2] + gy * fr[4];
      const float y = fr[1] + gx * fr[3] + gy * fr[5];
      const float fx = floorf(x), fy = floorf(y);
      const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
      const float dx1 = x - fx, dy1 = y - fy;
      const float dx0 = 1.f - dx1, dy0 = 1.f - dy1;
      float c00[3], c10[3], c01[3], c11[3];
      cmvs::atlas_rgb(atlas, n, H, WA, ly, lx, c00);
      cmvs::atlas_rgb(atlas, n, H, WA, ly, lx + 1, c10);
      cmvs::atlas_rgb(atlas, n, H, WA, ly + 1, lx, c01);
      cmvs::atlas_rgb(atlas, n, H, WA, ly + 1, lx + 1, c11);
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

  const float* ref = sh;                        // warp 0's deviations
  float cross = 0.f;
  for (int s = lane; s < s2; s += 32) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cross += win[s * 3 + c] * ref[s * 3 + c];
  }
  const float cov = cmvs::warp_sum(cross) / (3.f * s2);
  if (lane == 0) {
    const float var_r = var_sh[0];
    const float istd_v = var <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var, 1e-20f));
    const float istd_r =
        var_r <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var_r, 1e-20f));
    const float dot = cov * istd_r * istd_v;
    const float xx = 1.f - dot;
    out[probe] = xx / (1.f + 3.f * xx);
  }
}

}  // namespace

extern "C" int cmvs_fan_incc(const void* atlas, int N, int H, int WA,
                             const void* vid, const void* frames,
                             const void* ok, void* out, int B, int T,
                             int fan, int wsize, void* stream) {
  const int s2 = wsize * wsize;
  const size_t shmem = (static_cast<size_t>(T) * s2 * 3 + T) * sizeof(float);
  fan_incc_kernel<<<B * fan, 32 * T, shmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(vid), static_cast<const float*>(frames),
      static_cast<const uint8_t*>(ok), static_cast<float*>(out), T, fan,
      wsize);
  return static_cast<int>(cudaGetLastError());
}
