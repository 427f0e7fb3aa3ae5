// Refine-fan robust INCC kernel (K1).
//
// Replaces the Pallas TPU kernel `_fan2_kernel` (cmvs_pmvs_tpu/ops/
// pallas_fan2.py) together with its XLA tail `_moments_tail2`: for every
// (patch b, view v, probe f) it builds the wsize x wsize sample lattice
// org + gx*dx + gy*dy from six frame scalars, samples bilinear RGB from
// the uint8 atlas, normalizes the window (zero per-channel mean, unit
// global variance) and returns the robust INCC x / (1 + 3x) of
// x = 1 - NCC against the same patch's view-0 window at the same probe.
// The TPU kernel built hat-weight matrices and ran matmuls only because
// its vector unit has no per-row gather; here each lane reads its taps.
//
// Layout (the body is `cmvs::fan_incc_kernel` in common.cuh, shared with
// K3): one warp per (patch, probe), eight warps per block, walking the
// patch's T views in turn. Lane l holds samples l and l + 32 of each
// window in registers (up to four a lane, wsize <= 11; larger windows,
// up to 63, recompute their samples in each pass), so view 0's centred
// window stays in registers and each view's cross-sum with it is
// lane-local. The views' frames are loaded once, one view a lane, and
// handed out by shuffles; lane v keeps view v's moment sums, and the
// T INCCs are finished together, one a lane.
//
// What bounded the first version (PRs 1-3: one block per (patch, probe),
// one warp per view) on an H100: the window went through shared memory
// and was read twice more after a block barrier; five warp reductions
// and the IEEE divisions and square roots of the INCC ran once per view;
// and each sample issued twelve one-byte tap loads and twelve int-to-
// float conversions (conversions run at 1/8 of the FP32 rate). Now: no
// shared memory and no barrier; two butterflies a view (three channel
// sums, then the squared and cross sums); the INCC's divisions once per
// warp, the means' as a corrected reciprocal product (three
// instructions, the division's bits); two to four aligned 8-byte loads a
// sample (one or two a tap row, the pixels cut out with funnel shifts;
// the atlas's first and last row read byte by byte, so no load passes
// the allocation), bytes turned into floats by a PRMT into the mantissa
// of 2^23 and one FADD, and floor() by a rounded-down add. What bounds it now: instruction issue
// and latency, ~130 instructions a sample at about half the SMs' issue
// rate, 7% of the float32 operations bound (PERF.md section 6).
//
// Registers (nvcc -Xptxas -v, CUDA 12.8, sm_90a): 47 / 64 / 72 / 76 / 64
// for 1 / 2 / 3 / 4 samples a lane and the recomputing path; no spills
// (wsize 7 holds 2 a lane) but 32 bytes on the recomputing path.
//
// Float32 atlases (gamma-decoded pyramids): the same body with
// P = float (cmvs_fan_incc_f32), the reference's float `tiles2`. A tap
// row is six scalar loads (a 12-byte pixel is only 4-byte aligned) and
// needs no byte conversion; no row rule applies. The moments stay two-
// pass: gamma values lie in [0, 1] and dark windows have variances of
// 1e-8 and less, which a difference of sums (the reference's
// `_moments_tail2`) would cancel. On an H100 it takes what the uint8
// body takes (PERF.md section 6); chip_smoke.py's build phase logs each
// instantiation's registers and spills.
//
// Numerics: float32; sample positions, bilinear weights, two-pass
// moments and the INCC in the operation order of the parent kernel and
// the plain PyTorch version (ops/fan2.incc_fan_plain), built with
// -fmad=false, so the outputs are the parent kernel's bit for bit and
// differ from the plain version only by summation order (a flat window
// keeps its exact mean: a fused bilinear would turn its rounding noise
// into a different NCC). Probes with ok = 0 give an all-zero window.

#include "common.cuh"

extern "C" int cmvs_fan_incc(const void* atlas, int N, int H, int WA,
                             const void* vid, const void* frames,
                             const void* ok, void* out, int B, int T,
                             int fan, int wsize, void* stream) {
  return cmvs::launch_fan_incc<false, uint8_t>(atlas, N, H, WA, vid, nullptr,
                                               frames, ok, out, B, T, fan,
                                               wsize, stream);
}

// K1 on a float32 atlas (gamma-decoded pyramids; the reference package's
// float `tiles2`, pyramid.py:59-77): the same body, taps read as floats.
extern "C" int cmvs_fan_incc_f32(const void* atlas, int N, int H, int WA,
                                 const void* vid, const void* frames,
                                 const void* ok, void* out, int B, int T,
                                 int fan, int wsize, void* stream) {
  return cmvs::launch_fan_incc<false, float>(atlas, N, H, WA, vid, nullptr,
                                             frames, ok, out, B, T, fan,
                                             wsize, stream);
}
