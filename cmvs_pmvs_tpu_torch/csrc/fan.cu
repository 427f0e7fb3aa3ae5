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
// Layout: K1's body (`cmvs::fan_incc_kernel<kHeld, true>` in
// common.cuh): one warp per (patch, probe), the T views in turn, samples
// in registers. The taps are read in place from the atlas; the tile rule
// is a mask on the bilinear row and column factors (the tile is a
// rectangle, four unsigned compares a sample), so a K3 window costs what
// a K1 window costs, and where no tap leaves the tile K3 returns K1's
// bits.
//
// What bounded the first version (PRs 2-3: one block per patch, one warp
// per view) on an H100: each warp staged its pair's 32 x 96-byte tile in
// shared memory one byte per lane per iteration (3,072 one-byte loads and
// stores with a div/mod each), 55% of the kernel at fan 4 and nearly all
// of it at fan 1, then paid two block barriers per probe. Reading in
// place drops the staging; what bounds it now is what bounds K1.
//
// Registers (nvcc -Xptxas -v, CUDA 12.8, sm_90a): 47 / 64 / 71 / 79 / 75
// for 1 / 2 / 3 / 4 samples a lane and the recomputing path; no spills.
//
// Float32 atlases (gamma-decoded pyramids): the same body with
// P = float (cmvs_fan_v1_incc_f32), the reference's float `tiles`; see
// csrc/fan2.cu.
//
// Numerics: float32, the parent kernel's and the plain version's
// operation order (ops/fan.incc_fan_v1_plain), -fmad=false; outputs are
// the parent kernel's bit for bit. Probes with ok = 0 contribute an
// all-zero window.

#include "common.cuh"

extern "C" int cmvs_fan_v1_incc(const void* atlas, int N, int H, int WA,
                                const void* vid, const void* tile_org,
                                const void* frames, const void* ok,
                                void* out, int B, int T, int fan, int wsize,
                                void* stream) {
  return cmvs::launch_fan_incc<true, uint8_t>(atlas, N, H, WA, vid, tile_org,
                                              frames, ok, out, B, T, fan,
                                              wsize, stream);
}

// K3 on a float32 atlas (gamma-decoded pyramids; the reference package's
// float `tiles`, pyramid.py:59-77): the same body, taps read as floats.
extern "C" int cmvs_fan_v1_incc_f32(const void* atlas, int N, int H, int WA,
                                    const void* vid, const void* tile_org,
                                    const void* frames, const void* ok,
                                    void* out, int B, int T, int fan,
                                    int wsize, void* stream) {
  return cmvs::launch_fan_incc<true, float>(atlas, N, H, WA, vid, tile_org,
                                            frames, ok, out, B, T, fan, wsize,
                                            stream);
}
