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
// Layout (the body is in common.cuh, shared with K4): one warp per pair,
// eight warps per block. Lane l holds samples l, l + 32, ... in registers
// (up to four a lane, wsize <= 11; larger windows, up to 63, recompute
// their samples in each pass); no shared memory, no barrier. Taps are
// read straight from the uint8 atlas - no pre-gathered [pairs, 20, 60]
// block array exists on the GPU.
//
// What bounds it on an H100: bytes - the output (12 * s2 bytes a pair,
// 588 at wsize 7, written for failed pairs too) and, for ok pairs, the
// relx/rely reads (8 * s2 bytes) and the taps; the arithmetic is ~46
// float32 operations a sample. What held the first version (four
// pairs a block, the window staged in shared memory with no launch
// check of its size, twelve one-byte tap loads and conversions a sample,
// an IEEE division a value) far from that was instruction issue. Now a
// failed pair reads its ok flag and block start and writes its zeros with
// 16-byte stores; an ok pair issues all its relx/rely loads first, reads
// each tap row as aligned 8-byte words (row_pair), takes the inner path
// where every tap lies inside its block, divides by sd with div_by (three
// instructions, the division's bits), and each lane writes its samples'
// 12 bytes. The compiler is asked for 8 resident blocks an SM (32
// registers a thread) where that costs no spill. Registers (nvcc -Xptxas
// -v, CUDA 12.8, sm_90a): 27 / 32 / 32 / 40 for 1-4 samples a lane, 52
// recomputing; no spills.
//
// Instantiations: uint8 or float32 atlas (gamma-decoded
// pyramids; float taps are six scalar loads a row), and the blocked rule
// or the unblocked one (the reference's `bilinear_color`, taken when its
// `_USE_BLOCK_SAMPLING` is False: the start as given, every tap read and
// clamped into the atlas plane; a window inside its block takes the same
// inner path as under the blocked rule): cmvs_windows, cmvs_windows_f32,
// cmvs_windows_unblocked, cmvs_windows_unblocked_f32 (chip_smoke.py's
// build phase logs each one's registers and spills).
//
// Numerics: float32, bit-identical to the first version (same sampling
// and normalization operation order, -fmad=false, the same butterflies),
// and to the plain version (ops/windows.windows_plain) up to summation
// order.

#include "common.cuh"

namespace {

// Resident blocks an SM asked of the compiler: 8 (32 registers a thread,
// 64 warps) where the window fits in them without spilling, 6 for four
// samples a lane, none on the recomputing path.
template <int kHeld>
constexpr int kMinBlocks = kHeld == 0 ? 1 : (kHeld == 4 ? 6 : 8);

template <int kHeld, bool kBlocked, typename P>
__global__ void __launch_bounds__(32 * cmvs::kBlockWarps, kMinBlocks<kHeld>)
    windows_kernel(const P* __restrict__ atlas, int N, int H, int WA,
                   const int* __restrict__ starts,
                   const float* __restrict__ relx,
                   const float* __restrict__ rely,
                   const uint8_t* __restrict__ ok, float* __restrict__ out,
                   long long pairs, int s2, int k,
                   const cmvs::WinConst wc) {
  const long long p =
      static_cast<long long>(blockIdx.x) * cmvs::kBlockWarps +
      (threadIdx.x >> 5);
  if (p >= pairs) return;
  const int lane = threadIdx.x & 31;
  float* dst = out + p * s2 * 3;
  // the block start is read with the ok flag (12 bytes a pair, counted
  // for every pair), so an ok pair waits for one load before its positions
  const int n = starts[p * 3], sy = starts[p * 3 + 1], sx = starts[p * 3 + 2];
  if (ok[p] == 0) {
    cmvs::zero_fill(dst, s2 * 3, lane);
    return;
  }
  const cmvs::BlockView<P> bv =
      cmvs::block_view<kBlocked>(atlas, N, H, WA, k, n, sy, sx);
  const float* rxp = relx + p * s2;
  const float* ryp = rely + p * s2;
  if constexpr (kHeld > 0) {
    float rx[kHeld], ry[kHeld], x[kHeld][3];
    cmvs::held_positions<kHeld>(rxp, ryp, s2, lane, rx, ry);
    cmvs::held_window<kHeld, kBlocked>(bv, H, WA, k, rx, ry, s2, wc, lane, x);
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int s = lane + 32 * j;
      if (s < s2) {
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[s * 3 + c] = x[j][c];
      }
    }
  } else {
    const cmvs::BlockStats st =
        cmvs::block_stats<kBlocked>(bv, H, WA, k, rxp, ryp, s2, wc, lane);
    for (int s = lane; s < s2; s += 32) {
      float v[3];
      cmvs::block_value<kBlocked>(bv, H, WA, k, st, __ldg(rxp + s),
                                  __ldg(ryp + s), v);
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[s * 3 + c] = v[c];
    }
  }
}

// K2 on an atlas of pixel type P under the block rule kBlocked (see
// common.cuh). Returns the CUDA error code (invalid value for s2 outside
// 1..63^2, k < 1 or an atlas plane of 2^31 values or more).
template <bool kBlocked, typename P>
int launch_windows(const void* atlas, int N, int H, int WA,
                   const void* starts, const void* relx, const void* rely,
                   const void* ok, void* out, long long pairs, int s2, int k,
                   void* stream) {
  if (cmvs::block_args_bad(H, WA, s2, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (pairs + cmvs::kBlockWarps - 1) / cmvs::kBlockWarps);
  auto go = [&](auto kernel) {
    kernel<<<blocks, 32 * cmvs::kBlockWarps, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const P*>(atlas), N, H, WA,
        static_cast<const int*>(starts), static_cast<const float*>(relx),
        static_cast<const float*>(rely), static_cast<const uint8_t*>(ok),
        static_cast<float*>(out), pairs, s2, k, cmvs::win_const(s2));
  };
  switch (cmvs::held_samples(s2)) {
    case 1: go(windows_kernel<1, kBlocked, P>); break;
    case 2: go(windows_kernel<2, kBlocked, P>); break;
    case 3: go(windows_kernel<3, kBlocked, P>); break;
    case 4: go(windows_kernel<4, kBlocked, P>); break;
    default: go(windows_kernel<0, kBlocked, P>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four instantiations: uint8 or float32 atlas, blocked or unblocked.
#define CMVS_WINDOWS_ENTRY(NAME, BLOCKED, P)                                  \
  extern "C" int NAME(const void* atlas, int N, int H, int WA,               \
                      const void* starts, const void* relx, const void* rely, \
                      const void* ok, void* out, long long pairs, int s2,     \
                      int k, void* stream) {                                  \
    return launch_windows<BLOCKED, P>(atlas, N, H, WA, starts, relx, rely,   \
                                      ok, out, pairs, s2, k, stream);         \
  }
CMVS_WINDOWS_ENTRY(cmvs_windows, true, uint8_t)
CMVS_WINDOWS_ENTRY(cmvs_windows_f32, true, float)
CMVS_WINDOWS_ENTRY(cmvs_windows_unblocked, false, uint8_t)
CMVS_WINDOWS_ENTRY(cmvs_windows_unblocked_f32, false, float)
