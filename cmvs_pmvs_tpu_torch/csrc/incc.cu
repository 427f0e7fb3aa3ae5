// Fused block INCC kernel (K4).
//
// The counterpart of the Pallas TPU kernel `_incc_kernel` (cmvs_pmvs_tpu/
// ops/pallas_incc.py, launched by `incc_pallas` and `incc_pallas_regions`,
// which nothing in the reference package calls): on the port's central
// path it computes the reference's non-kernel objective (`grab_tex` +
// `normalize_tex` + `ncc_dot`, refine.per_view_inccs) in one kernel. For
// every (patch b, view v) pair
// it samples the s2 block-relative positions (relx, rely) bilinearly
// inside the k x k block of starts[b, v] (K2's block rule), normalizes
// the window to zero per-channel mean and unit global variance, and
// returns the robust INCC x / (1 + 3x) of x = 1 - <window, view-0
// window> / (3 s2). Output conventions of the TPU kernel: 2.0 where the
// pair's or the reference's grab failed; the reference slot holds 0.0
// when its grab succeeded, else 2.0.
//
// Layout (the window body is in common.cuh, shared with K2): one warp per
// patch, eight warps per block, walking the patch's T <= 32 views. Lane
// l holds samples l, l + 32, ... of each window in registers (up to four
// a lane, wsize <= 11; larger windows, up to 63, recompute their samples
// in each pass, view 0's included), so view 0's normalized window stays
// in registers for the whole walk and each view's cross sum with it is
// lane-local. The views' block starts and ok flags are loaded once, one
// view a lane, and handed out by shuffles; lane v keeps view v's cross
// sum and the T INCCs are finished together, one a lane. No shared
// memory, no barrier; only the [B, T] INCCs are written.
//
// What bounds it on an H100: bytes - the relx/rely reads (8 * s2 bytes
// an ok pair) and the taps; the output is 4 bytes a pair and the
// arithmetic ~52 float32 operations a sample. What held the first version
// (one block per patch, one warp per view, every window staged
// in shared memory - T * s2 * 12 bytes, over the 227 KB an SM has at
// T = 32 and wsize >= 25 - and read again after a block barrier, twelve
// one-byte tap loads a sample, an IEEE division a value, every pair's
// positions read) far from that was instruction issue and the barrier.
// Now failed views, and every view of a patch whose reference failed,
// read nothing past their ok flags; an ok window issues its relx/rely
// loads first, reads tap rows as aligned 8-byte words (row_pair), takes
// the inner path where every tap lies inside its block, and divides by
// sd with div_by (the division's bits in three instructions). Registers
// (nvcc -Xptxas -v, CUDA 12.8, sm_90a): 44 / 46 / 48 / 64 for 1-4
// samples a lane, no spills; 64 and 16 bytes spilled on the recomputing
// path (wsize >= 13).
//
// Instantiations, as K2's: uint8 or float32 atlas, blocked or
// unblocked rule (cmvs_incc_blocks, _f32, _unblocked, _unblocked_f32;
// chip_smoke.py's build phase logs each one's registers and spills).
//
// Numerics: float32, -fmad=false. Each window's values are the first
// version's bit for bit (K2's arithmetic), and so is each product
// (v / sd_v) * (r / sd_0); only the cross sum's order differs (by sample,
// then channel, where the first version summed by element), so the INCCs
// differ from that kernel's and the plain version's (ops/incc.
// incc_blocks_plain) by summation order alone.

#include "common.cuh"

namespace {

template <int kHeld, bool kBlocked, typename P>
__global__ void __launch_bounds__(32 * cmvs::kBlockWarps)
    incc_blocks_kernel(const P* __restrict__ atlas, int N, int H,
                       int WA, const int* __restrict__ starts,
                       const float* __restrict__ relx,
                       const float* __restrict__ rely,
                       const uint8_t* __restrict__ ok,
                       float* __restrict__ out, int B, int T, int s2, int k,
                       const cmvs::WinConst wc) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long b =
      static_cast<long long>(blockIdx.x) * cmvs::kBlockWarps +
      (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const long long base = b * T;
  // lane j < T: view j's block start and ok flag
  int n = 0, sy = 0, sx = 0;
  bool ok_j = false;
  if (lane < T) {
    const int* st = starts + (base + lane) * 3;
    n = st[0];
    sy = st[1];
    sx = st[2];
    ok_j = ok[base + lane] != 0;
  }
  const unsigned oks = __ballot_sync(kAll, ok_j);
  const bool ref_ok = (oks & 1u) != 0;
  auto view = [&](int v) {
    return cmvs::block_view<kBlocked>(atlas, N, H, WA, k,
                                      __shfl_sync(kAll, n, v),
                                      __shfl_sync(kAll, sy, v),
                                      __shfl_sync(kAll, sx, v));
  };
  const float* rx0 = relx + base * s2;
  const float* ry0 = rely + base * s2;
  float cross = 0.f;  // lane v: view v's cross sum with view 0
  if (ref_ok) {
    if constexpr (kHeld > 0) {
      float rx[kHeld], ry[kHeld], r[kHeld][3];  // r: view 0's window
      cmvs::held_positions<kHeld>(rx0, ry0, s2, lane, rx, ry);
      cmvs::held_window<kHeld, kBlocked>(view(0), H, WA, k, rx, ry, s2, wc,
                                         lane, r);
      for (int v = 1; v < T; ++v) {
        if (!((oks >> v) & 1u)) continue;
        float x[kHeld][3];
        cmvs::held_positions<kHeld>(rx0 + v * s2, ry0 + v * s2, s2, lane, rx,
                                    ry);
        cmvs::held_window<kHeld, kBlocked>(view(v), H, WA, k, rx, ry, s2, wc,
                                           lane, x);
        float q[1] = {0.f};
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) q[0] += x[j][c] * r[j][c];
        }
        cmvs::warp_sum_n(q);
        cross = lane == v ? q[0] : cross;
      }
    } else {
      const cmvs::BlockView<P> R = view(0);
      const cmvs::BlockStats r0 =
          cmvs::block_stats<kBlocked>(R, H, WA, k, rx0, ry0, s2, wc, lane);
      for (int v = 1; v < T; ++v) {
        if (!((oks >> v) & 1u)) continue;
        const cmvs::BlockView<P> V = view(v);
        const float* rxv = rx0 + v * s2;
        const float* ryv = ry0 + v * s2;
        const cmvs::BlockStats st =
            cmvs::block_stats<kBlocked>(V, H, WA, k, rxv, ryv, s2, wc, lane);
        float q[1] = {0.f};
        for (int s = lane; s < s2; s += 32) {
          float x[3], e[3];
          cmvs::block_value<kBlocked>(V, H, WA, k, st, __ldg(rxv + s),
                                      __ldg(ryv + s), x);
          cmvs::block_value<kBlocked>(R, H, WA, k, r0, __ldg(rx0 + s),
                                      __ldg(ry0 + s), e);
#pragma unroll
          for (int c = 0; c < 3; ++c) q[0] += x[c] * e[c];
        }
        cmvs::warp_sum_n(q);
        cross = lane == v ? q[0] : cross;
      }
    }
  }
  if (lane < T) {
    float val = 2.f;
    if (lane == 0) {
      val = ref_ok ? 0.f : 2.f;
    } else if (ref_ok && ok_j) {
      const float xx = 1.f - cross / wc.n3;
      val = xx / (1.f + 3.f * xx);
    }
    out[base + lane] = val;
  }
}

// K4 on an atlas of pixel type P under the block rule kBlocked (see
// common.cuh). Returns the CUDA error code (invalid value for T outside
// 1..32, s2 outside 1..63^2, k < 1 or an atlas plane of 2^31 values or
// more).
template <bool kBlocked, typename P>
int launch_incc_blocks(const void* atlas, int N, int H, int WA,
                       const void* starts, const void* relx, const void* rely,
                       const void* ok, void* out, int B, int T, int s2, int k,
                       void* stream) {
  if (T < 1 || T > 32 || cmvs::block_args_bad(H, WA, s2, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(B) + cmvs::kBlockWarps - 1) /
      cmvs::kBlockWarps);
  auto go = [&](auto kernel) {
    kernel<<<blocks, 32 * cmvs::kBlockWarps, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const P*>(atlas), N, H, WA,
        static_cast<const int*>(starts), static_cast<const float*>(relx),
        static_cast<const float*>(rely), static_cast<const uint8_t*>(ok),
        static_cast<float*>(out), B, T, s2, k, cmvs::win_const(s2));
  };
  switch (cmvs::held_samples(s2)) {
    case 1: go(incc_blocks_kernel<1, kBlocked, P>); break;
    case 2: go(incc_blocks_kernel<2, kBlocked, P>); break;
    case 3: go(incc_blocks_kernel<3, kBlocked, P>); break;
    case 4: go(incc_blocks_kernel<4, kBlocked, P>); break;
    default: go(incc_blocks_kernel<0, kBlocked, P>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four instantiations: uint8 or float32 atlas, blocked or unblocked.
#define CMVS_INCC_ENTRY(NAME, BLOCKED, P)                                     \
  extern "C" int NAME(const void* atlas, int N, int H, int WA,               \
                      const void* starts, const void* relx, const void* rely, \
                      const void* ok, void* out, int B, int T, int s2, int k, \
                      void* stream) {                                         \
    return launch_incc_blocks<BLOCKED, P>(atlas, N, H, WA, starts, relx,     \
                                          rely, ok, out, B, T, s2, k,         \
                                          stream);                            \
  }
CMVS_INCC_ENTRY(cmvs_incc_blocks, true, uint8_t)
CMVS_INCC_ENTRY(cmvs_incc_blocks_f32, true, float)
CMVS_INCC_ENTRY(cmvs_incc_blocks_unblocked, false, uint8_t)
CMVS_INCC_ENTRY(cmvs_incc_blocks_unblocked_f32, false, float)
