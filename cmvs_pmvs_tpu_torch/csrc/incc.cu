// Fused block INCC kernel (K4).
//
// Replaces the Pallas TPU kernel `_incc_kernel` (cmvs_pmvs_tpu/ops/
// pallas_incc.py, launched by `incc_pallas` and `incc_pallas_regions`)
// and the XLA block gather that fed it: for every (patch b, view v) pair
// it samples the s2 block-relative positions (relx, rely) bilinearly
// inside the k x k block of starts[b, v] (K2's block rule, shared through
// common.cuh), normalizes the window to zero per-channel mean and unit
// global variance, and returns the robust INCC x / (1 + 3x) of
// x = 1 - <window, view-0 window> / (3 s2). Output conventions of the
// TPU kernel: 2.0 where the pair's or the reference's grab failed; the
// reference slot holds 0.0 when its grab succeeded, else 2.0.
//
// Layout: one block per patch, one warp per view (T <= 32). The windows
// live in shared memory; only the [B, T] INCCs are written.
//
// What bounds it on an H100: the relx/rely reads (8 * s2 bytes per pair)
// and the scattered tap reads; arithmetic is small. No window reaches
// device memory (the unfused path writes and re-reads 12 * s2 bytes per
// pair).
//
// Numerics: float32, two-pass moments, -fmad=false, sampling in the
// plain version's operation order (ops/incc.incc_blocks_plain).

#include "common.cuh"

namespace {

__global__ void incc_blocks_kernel(const uint8_t* __restrict__ atlas, int N,
                                   int H, int WA,
                                   const int* __restrict__ starts,
                                   const float* __restrict__ relx,
                                   const float* __restrict__ rely,
                                   const uint8_t* __restrict__ ok,
                                   float* __restrict__ out, int T, int s2,
                                   int k) {
  extern __shared__ float sh[];
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const long long p = base + v;
  const bool okp = ok[p] != 0;
  float* win = sh + v * s2 * 3;
  const float* ref = sh;                                  // warp 0's window

  float sum[3] = {0.f, 0.f, 0.f};
  if (okp) {
    const cmvs::Block blk = cmvs::block_of(starts, p, N, H, WA, k);
    for (int s = lane; s < s2; s += 32) {
      float val[3];
      cmvs::block_sample(atlas, H, WA, blk, k, relx[p * s2 + s],
                         rely[p * s2 + s], val);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        win[s * 3 + c] = val[c];
        sum[c] += val[c];
      }
    }
  } else {
    for (int i = lane; i < s2 * 3; i += 32) win[i] = 0.f;
  }
  float sd = sqrtf(cmvs::center_window(win, s2, lane, sum));
  if (sd == 0.f) sd = 1.f;
  __syncwarp();
  for (int i = lane; i < s2 * 3; i += 32) win[i] = win[i] / sd;
  __syncthreads();

  float cross = 0.f;
  for (int i = lane; i < s2 * 3; i += 32) cross += win[i] * ref[i];
  const float dot = cmvs::warp_sum(cross) / (3.f * s2);
  if (lane == 0) {
    const bool ref_ok = ok[base] != 0;
    float val;
    if (v == 0) {
      val = ref_ok ? 0.f : 2.f;
    } else if (ref_ok && okp) {
      const float xx = 1.f - dot;
      val = xx / (1.f + 3.f * xx);
    } else {
      val = 2.f;
    }
    out[p] = val;
  }
}

}  // namespace

extern "C" int cmvs_incc_blocks(const void* atlas, int N, int H, int WA,
                                const void* starts, const void* relx,
                                const void* rely, const void* ok, void* out,
                                int B, int T, int s2, int k, void* stream) {
  const size_t shmem = static_cast<size_t>(T) * s2 * 3 * sizeof(float);
  const cudaError_t attr = cmvs::allow_shared(incc_blocks_kernel, shmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  incc_blocks_kernel<<<B, 32 * T, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(starts), static_cast<const float*>(relx),
      static_cast<const float*>(rely), static_cast<const uint8_t*>(ok),
      static_cast<float*>(out), T, s2, k);
  return static_cast<int>(cudaGetLastError());
}
