// Fan-kernel ablations (K5, K6, K7): the refine-fan kernel cut into its
// stages - tap loads, y-interpolation, x-fold, moments - one compile-time
// mode per cut.
//
// Replaces the Pallas TPU kernels of the three ablation scripts:
//   K5 `_fan_kernel_abl` (scripts/ablate_fan.py:28): the v1 fan INCC from
//      32-px tiles with hi/lo affine geometry; modes full, no_moments,
//      wy_only, dma_only.
//   K6 `_kernel_abl` (scripts/ablate_fan2.py:34): the v2 interpolation
//      body, bilinear RGB per sample; modes full, no_x, no_mm, wy_only,
//      no_fold, dma_only.
//   K7 `_kernel_abl` (scripts/ablate_fan25.py:35): v2.5 frame expansion,
//      interpolation and the 9 moment sums of every (pair, probe); modes
//      full, no_moments, no_expand, body_only.
// ops/ablate.py holds the plain versions, which define each mode.
//
// All three take the uint8 atlas [N, H, WA, 3] and the packed tilemap
// (v << 20 | ty << 10 | tx per (patch, view) pair: the tile at atlas pixel
// (12 tx, 12 ty) of view v) and obey the v1 tile rule of common.cuh. Taps
// weigh max(0, 1 - |r - i|), the TPU kernels' hat weights, and combine
// y first, then x, in their order. Everything is float32 (the TPU kernels
// round some operands to bf16), with -fmad=false.
//
// Layouts. K5 and K7 are built on the body of K1 and K3 (common.cuh,
// `fan_incc_kernel`), so that their mode sweeps split the time of that
// body: one warp per (patch, probe) walks the T views, kFanWarps warps a
// block, with no shared memory and no block barrier. Lane j < T loads
// view j's tile code and its probe's geometry (K5: 12 floats, the x/y
// hi/lo rows' origin, d_x, d_y; K7: the 6-float frame) once; shuffles hand
// a view's to every lane. Lane l owns samples l, l + 32, ... in registers
// (1-4 a lane; K5's windows above 128 samples recompute them from the
// atlas, view 0's beside each view's), view 0's values stay resident for
// the walk, so the cross-sum with view 0 is lane-local. Taps are read in
// place as aligned 8-byte words (row_words; the atlas's first and last
// rows byte by byte), bytes converted by PRMT, and the tile rule masks
// the hat weights, as K3 masks its bilinear factors. K5 finishes each
// view's one-pass moments (S per channel, Q and X over the channels) with
// one 5-value butterfly and lane v its INCC at the end; K7 sums its 9
// values per view with a reduce-scatter (12 shuffles where a butterfly
// takes 45; the butterfly's bits) that leaves each sum in one pair of
// lanes, which writes it. K6: one warp per (pair, probe) window, samples
// across lanes, taps read in place byte by byte (not redesigned yet).
//
// A cut mode does not do the work it cuts, and does the rest as the full
// mode does it: K5 no_moments interpolates every sample of every view,
// wy_only y-interpolates tile column 0 at every sample, dma_only issues
// full's tap loads alone; K7's cut modes interpolate every view's window
// and write only the kept view-0 windows. Where a mode drops a result
// that the full mode computes (the values no_moments and wy_only do not
// write, dma_only's loaded words, K6's tiny output, the windows K7's cut
// modes do not write), the result feeds a store guarded by `sink`, a
// kernel argument the host code always passes as 0: the compiler cannot
// drop the work, and nothing is stored.
//
// What bounds them on an H100: K5 and K7, the per-sample work, as for K1
// and K3, at ~7% of the float32 operations bound; their sweeps put ~56%
// of K5 in the tap loads with their positions and addresses (the
// y-interpolation of one column hides behind them), ~28% in the second
// column and the x-fold, ~16% in the moments. The first layout (one block
// per patch, a warp per view, K5's tile staged byte by byte in shared
// memory, K7's view-0 window exchanged through it behind a barrier) took
// 2.1x (K5) and 1.16x (K7) as long. K6, its bytes: 8 B of positions read
// and 12 B of RGB written per sample against ~37 float operations.
//
// Registers (nvcc -Xptxas -v, CUDA 12.8, sm_90a), no spills: K5 full 54 /
// 80 / 80 / 97 for 1-4 samples a lane and 101 recomputing, dma_only 44 /
// 64 for 1 / 2; K7 full 47 / 53 for 1 / 2 samples a lane.

#include "common.cuh"

namespace {

using cmvs::FanMeta;
using cmvs::FanView;
using cmvs::Tile;
using cmvs::hat;
using cmvs::tile_rgb;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kK5MaxWsize = 63;  // the largest window K5 takes
constexpr int kK7MaxS2 = 64;     // K7's window limit (the TPU harness's)

struct TileCode {
  int n, ox, oy;
};

__device__ __forceinline__ TileCode decode_tile(int code, int N) {
  return {cmvs::clampi(code >> 20, 0, N - 1),
          (code & 0x3FF) * cmvs::kTileStride,
          ((code >> 10) & 0x3FF) * cmvs::kTileStride};
}

// K5's and K7's view metadata, loaded once: lane j < T holds view j's tile
// (plane and origin, from tilemap[b, j]) and, with kFrames, probe f's
// frame frames[b, j, f]; ok is always set.
template <bool kFrames>
__device__ __forceinline__ FanMeta tile_meta(const int* __restrict__ tilemap,
                                             const float* __restrict__ frames,
                                             int N, int b, int T, int fan,
                                             int f, int lane) {
  FanMeta m = {0, 0, 0, {}, true};
  if (lane < T) {
    const long long pair = static_cast<long long>(b) * T + lane;
    const TileCode tc = decode_tile(__ldg(tilemap + pair), N);
    m.n = tc.n;
    m.ox = tc.ox;
    m.oy = tc.oy;
    if (kFrames) {
#pragma unroll
      for (int i = 0; i < 6; ++i)
        m.fr[i] = __ldg(frames + (pair * fan + f) * 6 + i);
    }
  }
  return m;
}

// The four taps of tile-relative position (rx, ry) in view fv's tile
// under the v1 tile rule: the hat weights of tap columns lx, lx + 1 and
// rows ly, ly + 1, each 0 outside the tile or past the atlas edge (a
// tile is a rectangle, so masking the row and column weights zeroes the
// products of the taps the reference reads as 0), and the two tap rows as
// row_words reads them (a masked tap's pixel is read clamped into the
// atlas and weighs 0). kCol0: the taps of tile column 0 instead of lx
// (wy_only). Positions are clamped to +-kFanPosMax, where floor_int is
// exact; taps that far out are masked either way.
struct TileTaps {
  float wx0, wx1, wy0, wy1;
  unsigned lo0, hi0, lo1, hi1;  // rows ly and ly + 1
  bool adjacent;
};

template <bool kCol0>
__device__ __forceinline__ TileTaps tile_taps(const FanView& fv, int H,
                                              int WA, float rx, float ry) {
  rx = fminf(fmaxf(rx, -cmvs::kFanPosMax), cmvs::kFanPosMax);
  ry = fminf(fmaxf(ry, -cmvs::kFanPosMax), cmvs::kFanPosMax);
  int lx, ly;
  const float fx = cmvs::floor_int(rx, lx), fy = cmvs::floor_int(ry, ly);
  if (kCol0) lx = 0;
  const unsigned tw = fv.tw, th = fv.th;
  const bool col = !kCol0 || tw > 0u;  // wy_only: column 0 in the atlas
  TileTaps t;
  t.wx0 = static_cast<unsigned>(lx) < tw ? hat(rx - fx) : 0.f;
  t.wx1 = static_cast<unsigned>(lx + 1) < tw ? hat(rx - (fx + 1.f)) : 0.f;
  t.wy0 = col && static_cast<unsigned>(ly) < th ? hat(ry - fy) : 0.f;
  t.wy1 = col && static_cast<unsigned>(ly + 1) < th ? hat(ry - (fy + 1.f))
                                                    : 0.f;
  const int ax = fv.ox + lx, ay = fv.oy + ly;  // atlas pixel of tap 00
  const int xa = cmvs::clampi(ax, 0, WA - 1);
  const int xb = cmvs::clampi(ax + 1, 0, WA - 1);
  const int r0 = cmvs::clampi(ay, 0, H - 1);
  const int r1 = cmvs::clampi(ay + 1, 0, H - 1);
  t.adjacent = xb != xa;
  const uint8_t* p = fv.img + (r0 * WA + xa) * 3;
  cmvs::row_words(p, t.adjacent, r0 >= fv.row_lo && r0 <= fv.row_hi, t.lo0,
                  t.hi0);
  cmvs::row_words(p + (r1 - r0) * WA * 3, t.adjacent,
                  r1 >= fv.row_lo && r1 <= fv.row_hi, t.lo1, t.hi1);
  return t;
}

// What a mode does with a sample's taps.
enum TapUse {
  kBilinear,  // bilinear RGB: y-interpolation, then the x-fold
  kColumn0,   // tile column 0's y-interpolated RGB (K5 wy_only)
  kWords      // the loaded words alone, added into `words` (K5 dma_only)
};

// The sample at tile-relative (rx, ry) of view fv, in the plain versions'
// operation order (ops/ablate.tile_bilinear): val (0 for kWords).
template <int kUse>
__device__ __forceinline__ void tile_sample(const FanView& fv, int H, int WA,
                                            float rx, float ry, float val[3],
                                            unsigned& words) {
  const TileTaps t = tile_taps<kUse == kColumn0>(fv, H, WA, rx, ry);
  if constexpr (kUse == kWords) {
    words += t.lo0 + t.hi0 + t.lo1 + t.hi1;
#pragma unroll
    for (int c = 0; c < 3; ++c) val[c] = 0.f;
    return;
  }
  float c00[3], c10[3], c01[3], c11[3];  // c<dx><dy>
  cmvs::pair_rgb(t.lo0, t.hi0, t.adjacent, c00, c10);
  cmvs::pair_rgb(t.lo1, t.hi1, t.adjacent, c01, c11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float row0 = t.wy0 * c00[c] + t.wy1 * c01[c];
    if (kUse == kColumn0) {
      val[c] = row0;
    } else {
      const float row1 = t.wy0 * c10[c] + t.wy1 * c11[c];
      val[c] = t.wx0 * row0 + t.wx1 * row1;
    }
  }
}

// ---- K5 --------------------------------------------------------------------

enum { kK5Full, kK5NoMoments, kK5WyOnly, kK5DmaOnly };

// Tile-relative position of lattice point (gx, gy) from a view's geometry
// g[c] = (origin, d_x, d_y) of rows c = x hi, y hi, x lo, y lo: hi + lo,
// in the plain version's order (ops/ablate.fan_abl_positions).
__device__ __forceinline__ void k5_position(const float (&g)[4][3], float gx,
                                            float gy, float& rx, float& ry) {
  float lat[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) lat[c] = g[c][0] + gx * g[c][1] + gy * g[c][2];
  rx = lat[0] + lat[2];
  ry = lat[1] + lat[3];
}

// View v's tile and geometry, from lane v to every lane.
__device__ __forceinline__ FanView k5_view(const FanMeta& meta,
                                           const float (&geo)[4][3],
                                           const uint8_t* atlas, int N, int H,
                                           int WA, int v, float (&g)[4][3]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int u = 0; u < 3; ++u) g[c][u] = __shfl_sync(kAll, geo[c][u], v);
  return cmvs::fan_view<true>(meta, atlas, N, H, WA, v);
}

// One view's one-pass sums, added into m: S per channel (m[0..2]), and over
// the channels Q, the sum of squares (m[3]), and X, the cross-sum with view
// 0's values r (m[4]).
__device__ __forceinline__ void k5_sums(const float (&x)[3],
                                        const float (&r)[3], float (&m)[5]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] += x[c];
    m[3] += x[c] * x[c];
    m[4] += x[c] * r[c];
  }
}

// out[b, v, f]: full, the robust INCC of window (b, v, f) vs (b, 0, f) from
// one-pass moments; no_moments, sample 0's R; wy_only, the y-interpolation
// of tile column 0's R at sample 0; dma_only, 0. kHeld > 0: samples held
// in registers (windows of up to 32 kHeld samples); 0: recomputed.
template <int MODE, int kHeld>
__global__ void __launch_bounds__(32 * cmvs::kFanWarps)
    fan_abl_kernel(const uint8_t* __restrict__ atlas, int N, int H, int WA,
                   const int* __restrict__ tilemap,
                   const float* __restrict__ geom, float* __restrict__ out,
                   int B, int T, int fan, int wsize, int sink) {
  constexpr int kUse = MODE == kK5WyOnly    ? kColumn0
                       : MODE == kK5DmaOnly ? kWords
                                            : kBilinear;
  const long long w = static_cast<long long>(blockIdx.x) * cmvs::kFanWarps +
                      (threadIdx.x >> 5);
  if (w >= static_cast<long long>(B) * fan) return;
  const int b = static_cast<int>(w / fan), f = static_cast<int>(w % fan);
  const int lane = threadIdx.x & 31;
  const int s2 = wsize * wsize;
  const FanMeta meta =
      tile_meta<false>(tilemap, nullptr, N, b, T, fan, f, lane);
  float geo[4][3] = {};  // lane j < T: view j's geometry
  if (lane < T) {
    const long long lines = static_cast<long long>(B) * T * fan * 4;
    const float* g =
        geom + ((static_cast<long long>(b) * T + lane) * fan + f) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int u = 0; u < 3; ++u) geo[c][u] = __ldg(g + c * lines + u);
  }
  // Lane v keeps view v's result: full, its sums (k5_sums); no_moments
  // and wy_only, sample 0's R in keep[0].
  float keep[5] = {};
  float junk = 0.f;    // values the cut modes do not write (sink)
  unsigned words = 0;  // dma_only's loaded words (sink)

  if constexpr (kHeld > 0) {
    float gx[kHeld], gy[kHeld];
    bool in[kHeld];
    float r[kHeld][3] = {};  // view 0's values
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      in[k] = lane + 32 * k < s2;
      cmvs::lattice(in[k] ? lane + 32 * k : 0, wsize, gx[k], gy[k]);
    }
    for (int v = 0; v < T; ++v) {
      float g[4][3];
      const FanView fv = k5_view(meta, geo, atlas, N, H, WA, v, g);
      float x[kHeld][3] = {};
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (!in[k]) continue;
        float rx, ry;
        k5_position(g, gx[k], gy[k], rx, ry);
        tile_sample<kUse>(fv, H, WA, rx, ry, x[k], words);
      }
      if constexpr (MODE == kK5Full) {
        float m[5] = {};
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
#pragma unroll
          for (int c = 0; c < 3; ++c) r[k][c] = v == 0 ? x[k][c] : r[k][c];
          k5_sums(x[k], r[k], m);
        }
        cmvs::warp_sum_n(m);
#pragma unroll
        for (int i = 0; i < 5; ++i) keep[i] = lane == v ? m[i] : keep[i];
      } else if constexpr (MODE != kK5DmaOnly) {
        const float x0 = __shfl_sync(kAll, x[0][0], 0);
        keep[0] = lane == v ? x0 : keep[0];
#pragma unroll
        for (int k = 0; k < kHeld; ++k)
#pragma unroll
          for (int c = 0; c < 3; ++c) junk += x[k][c];
      }
    }
  } else {
    float g0[4][3];
    const FanView R = k5_view(meta, geo, atlas, N, H, WA, 0, g0);
    for (int v = 0; v < T; ++v) {
      float g[4][3];
      const FanView fv = k5_view(meta, geo, atlas, N, H, WA, v, g);
      float m[5] = {};
      float x0 = 0.f;  // sample 0's R (lane 0)
      for (int s = lane; s < s2; s += 32) {
        float gx, gy, rx, ry, x[3];
        cmvs::lattice(s, wsize, gx, gy);
        k5_position(g, gx, gy, rx, ry);
        tile_sample<kUse>(fv, H, WA, rx, ry, x, words);
        if constexpr (MODE == kK5Full || MODE == kK5DmaOnly) {
          float r[3] = {x[0], x[1], x[2]};  // view 0's, recomputed
          if (v != 0) {
            k5_position(g0, gx, gy, rx, ry);
            tile_sample<kUse>(R, H, WA, rx, ry, r, words);
          }
          if constexpr (MODE == kK5Full) k5_sums(x, r, m);
        } else {
          if (s == 0) x0 = x[0];
#pragma unroll
          for (int c = 0; c < 3; ++c) junk += x[c];
        }
      }
      if constexpr (MODE == kK5Full) {
        cmvs::warp_sum_n(m);
#pragma unroll
        for (int i = 0; i < 5; ++i) keep[i] = lane == v ? m[i] : keep[i];
      } else if constexpr (MODE != kK5DmaOnly) {
        x0 = __shfl_sync(kAll, x0, 0);
        keep[0] = lane == v ? x0 : keep[0];
      }
    }
  }

  float res = keep[0];
  if constexpr (MODE == kK5Full) {
    // The plain version's epilogue (ops/ablate.one_pass_incc), view 0's
    // sums from lane 0.
    const float inv_s2 = 1.f / s2, inv_3s2 = 1.f / (3.f * s2);
    float Sr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) Sr[c] = __shfl_sync(kAll, keep[c], 0);
    const float Qr = __shfl_sync(kAll, keep[3], 0);
    const float var_v = (keep[3] - (keep[0] * keep[0] + keep[1] * keep[1] +
                                    keep[2] * keep[2]) * inv_s2) * inv_3s2;
    const float var_r =
        (Qr - (Sr[0] * Sr[0] + Sr[1] * Sr[1] + Sr[2] * Sr[2]) * inv_s2) *
        inv_3s2;
    const float cov = (keep[4] - (Sr[0] * keep[0] + Sr[1] * keep[1] +
                                  Sr[2] * keep[2]) * inv_s2) * inv_3s2;
    res = cmvs::robust_incc(var_v, var_r, cov);
  } else if constexpr (MODE == kK5DmaOnly) {
    res = sink ? static_cast<float>(__reduce_add_sync(kAll, words)) : 0.f;
  }
  if (lane < T) {
    float* o = out + (static_cast<long long>(b) * T + lane) * fan + f;
    *o = res;
    if (sink) *o += junk;
  }
}

// ---- K6 --------------------------------------------------------------------

enum { kK6Full, kK6NoX, kK6NoMm, kK6WyOnly, kK6NoFold, kK6DmaOnly };

// out[r, window, s] (tiny: out[r, group, 0..1, s], only the first two
// windows of every group of ppv patches): full, bilinear RGB; no_x, the sum
// over the 32 tile columns of the y-interpolated RGB; no_mm, the sum over
// tile columns i of wy[i] wx[i] in every row; wy_only, row 0 the sum of the
// in-tile wy[i], rows 1-2 0; no_fold, rows x = 0..7 the x-weighted
// y-interpolation of column x's R; dma_only, 0 after the taps are read.
template <int MODE>
__global__ void interp_abl_kernel(const uint8_t* __restrict__ atlas, int N,
                                  int H, int WA,
                                  const int* __restrict__ tilemap,
                                  const float* __restrict__ rel,
                                  float* __restrict__ out, long long windows,
                                  int T, int fan, int s2, int ppv, int tiny,
                                  int sink) {
  constexpr int R = MODE == kK6NoFold ? 8 : 3;   // output rows
  const long long w =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (w >= windows) return;
  const int lane = threadIdx.x & 31;
  const long long pair = w / fan;
  const TileCode tc = decode_tile(tilemap[pair], N);
  const Tile tl = cmvs::atlas_tile(atlas, tc.n, H, WA, tc.ox, tc.oy);
  long long dst = w, row_len = windows * s2;
  bool keep = true;
  if (tiny) {
    const long long b = pair / T, k = w % (static_cast<long long>(T) * fan);
    keep = b % ppv == 0 && k < 2;
    dst = b / ppv * 2 + (k & 1);
    row_len = windows / (static_cast<long long>(T) * fan) / ppv * 2 * s2;
  }
  for (int s = lane; s < s2; s += 32) {
    const float rx = rel[w * s2 + s];
    const float ry = rel[windows * s2 + w * s2 + s];
    const float fx = floorf(rx), fy = floorf(ry);
    const int lx = static_cast<int>(fx), ly = static_cast<int>(fy);
    const float wy0 = hat(ry - fy), wy1 = hat(ry - (fy + 1.f));
    float val[R];
    if constexpr (MODE == kK6Full) {
      cmvs::tile_bilinear(tl, rx, ry, val);
    } else if constexpr (MODE == kK6NoX) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int x = 0; x < cmvs::kTile; ++x) {
        float p0[3], p1[3];
        tile_rgb(tl, x, ly, p0);
        tile_rgb(tl, x, ly + 1, p1);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] += wy0 * p0[c] + wy1 * p1[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) val[c] = acc[c];
    } else if constexpr (MODE == kK6NoMm || MODE == kK6WyOnly) {
      const bool in0 = ly >= 0 && ly < cmvs::kTile;
      const bool in1 = ly + 1 >= 0 && ly + 1 < cmvs::kTile;
      float acc = 0.f;
      if constexpr (MODE == kK6NoMm) {
        if (in0) acc += wy0 * hat(rx - fy);
        if (in1) acc += wy1 * hat(rx - (fy + 1.f));
        val[0] = val[1] = val[2] = acc;
      } else {
        if (in0) acc += wy0;
        if (in1) acc += wy1;
        val[0] = acc;
        val[1] = val[2] = 0.f;
      }
    } else if constexpr (MODE == kK6NoFold) {
#pragma unroll
      for (int x = 0; x < R; ++x) {
        float p0[3], p1[3];
        tile_rgb(tl, x, ly, p0);
        tile_rgb(tl, x, ly + 1, p1);
        val[x] = (wy0 * p0[0] + wy1 * p1[0]) * hat(rx - static_cast<float>(x));
      }
    } else {  // dma_only: the four taps' bytes, nothing computed
      float p00[3], p01[3], p10[3], p11[3];
      tile_rgb(tl, lx, ly, p00);
      tile_rgb(tl, lx, ly + 1, p01);
      tile_rgb(tl, lx + 1, ly, p10);
      tile_rgb(tl, lx + 1, ly + 1, p11);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc += p00[c] + p01[c] + p10[c] + p11[c];
#pragma unroll
      for (int r = 0; r < R; ++r) val[r] = sink ? acc : 0.f;
    }
    if (keep || sink) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[r * row_len + dst * s2 + s] = val[r];
    }
  }
}

// ---- K7 --------------------------------------------------------------------

enum { kK7Full, kK7NoMoments, kK7NoExpand, kK7BodyOnly };

// K7's warp sums, scattered. A butterfly gives every lane the sums of all
// M values in 5 M shuffles; K7 needs each of its 9 sums in one lane only,
// to write it. A reduce-scatter halves each lane's values at every step
// instead: the lanes of a pair (lane ^ off) keep opposite halves, the
// values padded with a zero to an even count, and each adds the half its
// partner sends; at one value a lane, adds across the remaining offsets
// finish the sums. 9 values take 12 shuffles (5 + 3 + 2 + 1 + 1), and the
// pairs add in the butterfly's order, so the sums have its bits.

template <int N>
__device__ __forceinline__ void halve(const float (&a)[N],
                                      float (&b)[(N + 1) / 2], int off,
                                      bool upper) {
  constexpr int kH = (N + 1) / 2;
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const float lo = a[j], hi = j + kH < N ? a[j + kH] : 0.f;
    b[j] = (upper ? hi : lo) + __shfl_xor_sync(kAll, upper ? lo : hi, off);
  }
}

// The warp sum of value scatter_index<M>(lane) of the lanes' values a.
template <int N, int kOff = 16>
__device__ __forceinline__ float scatter_sum(const float (&a)[N], int lane) {
  if constexpr (N == 1) {
    float v = a[0];
#pragma unroll
    for (int off = kOff; off > 0; off >>= 1)
      v += __shfl_xor_sync(kAll, v, off);
    return v;
  } else {
    float b[(N + 1) / 2];
    halve(a, b, kOff, lane & kOff);
    return scatter_sum<(N + 1) / 2, kOff / 2>(b, lane);
  }
}

// The value whose sum scatter_sum<M> leaves in `lane`, or -1 where the
// lane holds padding.
template <int M>
__host__ __device__ constexpr int scatter_index(int lane) {
  int first = 0, real = M;  // the lane's group: first value, real count
  for (int n = M, off = 16; n > 1; n = (n + 1) / 2, off >>= 1) {
    const int h = (n + 1) / 2;
    if (lane & off) {
      first += h;
      real = real > h ? real - h : 0;
    } else {
      real = real < h ? real : h;
    }
  }
  return real > 0 ? first : -1;
}

// The lanes that share each sum: 32 >> (halving steps).
template <int M>
__host__ __device__ constexpr int scatter_group() {
  int g = 32;
  for (int n = M; n > 1; n = (n + 1) / 2) g >>= 1;
  return g;
}

// full / no_expand: out[b, v, f, 0..8] = per channel the window sum S, the
// sum of squares and the cross-sum with window (b, 0, f); no_moments /
// body_only: out[group, f, s] = R of window (ppv group, 0, f < lead). The
// no_expand modes sample at lattice + 14 px instead of the frames.
// kHeld: samples a lane holds (s2 <= 32 kHeld <= kK7MaxS2).
template <int MODE, int kHeld>
__global__ void __launch_bounds__(32 * cmvs::kFanWarps)
    moments_abl_kernel(const uint8_t* __restrict__ atlas, int N, int H,
                       int WA, const int* __restrict__ tilemap,
                       const float* __restrict__ frames,
                       float* __restrict__ out, int B, int T, int fan,
                       int wsize, int ppv, int lead, int sink) {
  constexpr bool kExpand = MODE == kK7Full || MODE == kK7NoMoments;
  constexpr bool kMoments = MODE == kK7Full || MODE == kK7NoExpand;
  const long long w = static_cast<long long>(blockIdx.x) * cmvs::kFanWarps +
                      (threadIdx.x >> 5);
  if (w >= static_cast<long long>(B) * fan) return;
  const int b = static_cast<int>(w / fan), f = static_cast<int>(w % fan);
  const int lane = threadIdx.x & 31;
  const int s2 = wsize * wsize;
  const FanMeta meta =
      tile_meta<kExpand>(tilemap, frames, N, b, T, fan, f, lane);
  float gx[kHeld], gy[kHeld];
  bool in[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    in[k] = lane + 32 * k < s2;
    cmvs::lattice(in[k] ? lane + 32 * k : 0, wsize, gx[k], gy[k]);
  }
  // The cut modes write this warp's view-0 window where it is kept.
  const bool kept = b % ppv == 0 && f < lead;
  // The moment modes: each view's sum i is written by its first lane.
  const int sum_i = scatter_index<9>(lane);
  const bool writer = sum_i >= 0 && lane % scatter_group<9>() == 0;
  float r[kHeld][3] = {};  // view 0's window
  float junk = 0.f;        // values the cut modes do not write (sink)
  unsigned words = 0;      // unused (tile_sample's word sink)

  for (int v = 0; v < T; ++v) {
    const FanView fv = cmvs::fan_view<true>(meta, atlas, N, H, WA, v);
    float x[kHeld][3] = {};
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (!in[k]) continue;
      const float rx =
          kExpand ? fv.fr[0] + gx[k] * fv.fr[2] + gy[k] * fv.fr[4]
                  : gx[k] + 14.f;
      const float ry =
          kExpand ? fv.fr[1] + gx[k] * fv.fr[3] + gy[k] * fv.fr[5]
                  : gy[k] + 14.f;
      tile_sample<kBilinear>(fv, H, WA, rx, ry, x[k], words);
    }
    if constexpr (kMoments) {
      float m[9] = {};
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (v == 0) r[k][c] = x[k][c];
          m[c] += x[k][c];
          m[3 + c] += x[k][c] * x[k][c];
          m[6 + c] += x[k][c] * r[k][c];
        }
      }
      const float sum = scatter_sum(m, lane);
      if (writer)
        out[((static_cast<long long>(b) * T + v) * fan + f) * 9 + sum_i] =
            sum;
    } else {
      if (v == 0 && kept) {
        float* o = out + (static_cast<long long>(b / ppv) * lead + f) * s2;
#pragma unroll
        for (int k = 0; k < kHeld; ++k)
          if (in[k]) o[lane + 32 * k] = x[k][0];
      }
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) junk += x[k][c];
    }
  }
  if (!kMoments && sink) out[0] = junk;
}

}  // namespace

// Launch `kernel` with one warp per (row, probe) of B rows, kFanWarps
// warps a block: K5 and K7 a warp per (patch, probe), K6 (B = patches *
// views) per window.
template <typename K, typename... Args>
static int launch_warps(K kernel, int B, int fan, void* stream,
                        Args... args) {
  const long long warps = static_cast<long long>(B) * fan;
  const unsigned blocks = static_cast<unsigned>(
      (warps + cmvs::kFanWarps - 1) / cmvs::kFanWarps);
  kernel<<<blocks, 32 * cmvs::kFanWarps, 0,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

using K5Kernel = void (*)(const uint8_t*, int, int, int, const int*,
                          const float*, float*, int, int, int, int, int);

template <int MODE>
static K5Kernel k5_kernel(int held) {
  switch (held) {  // registers up to s2 = 128 (wsize 11), then recompute
    case 1: return fan_abl_kernel<MODE, 1>;
    case 2: return fan_abl_kernel<MODE, 2>;
    case 3: return fan_abl_kernel<MODE, 3>;
    case 4: return fan_abl_kernel<MODE, 4>;
    default: return fan_abl_kernel<MODE, 0>;
  }
}

// K5's kernel for `mode`, or nullptr for a mode outside the enum, T outside
// 1..32, wsize outside 1..kK5MaxWsize or an atlas plane of 2 GB or more.
static K5Kernel k5_select(int H, int WA, int T, int wsize, int mode) {
  if (T < 1 || T > 32 || wsize < 1 || wsize > kK5MaxWsize ||
      3LL * H * WA >= (1LL << 31))
    return nullptr;
  const int held = cmvs::held_samples(wsize * wsize);
  switch (mode) {
    case kK5Full: return k5_kernel<kK5Full>(held);
    case kK5NoMoments: return k5_kernel<kK5NoMoments>(held);
    case kK5WyOnly: return k5_kernel<kK5WyOnly>(held);
    case kK5DmaOnly: return k5_kernel<kK5DmaOnly>(held);
    default: return nullptr;
  }
}

// K5 on `stream`. Returns the CUDA error code (invalid value where
// k5_select has no kernel).
extern "C" int cmvs_fan_abl(const void* atlas, int N, int H, int WA,
                            const void* tilemap, const void* geom, void* out,
                            int B, int T, int fan, int wsize, int mode,
                            void* stream) {
  const K5Kernel kernel = k5_select(H, WA, T, wsize, mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_warps(kernel, B, fan, stream,
                      static_cast<const uint8_t*>(atlas), N, H, WA,
                      static_cast<const int*>(tilemap),
                      static_cast<const float*>(geom),
                      static_cast<float*>(out), B, T, fan, wsize,
                      /*sink=*/0);
}

extern "C" int cmvs_interp_abl(const void* atlas, int N, int H, int WA,
                               const void* tilemap, const void* rel,
                               void* out, int B, int T, int fan, int s2,
                               int ppv, int tiny, int mode, void* stream) {
  void (*kernel)(const uint8_t*, int, int, int, const int*, const float*,
                 float*, long long, int, int, int, int, int, int);
  switch (mode) {
    case kK6Full: kernel = interp_abl_kernel<kK6Full>; break;
    case kK6NoX: kernel = interp_abl_kernel<kK6NoX>; break;
    case kK6NoMm: kernel = interp_abl_kernel<kK6NoMm>; break;
    case kK6WyOnly: kernel = interp_abl_kernel<kK6WyOnly>; break;
    case kK6NoFold: kernel = interp_abl_kernel<kK6NoFold>; break;
    case kK6DmaOnly: kernel = interp_abl_kernel<kK6DmaOnly>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_warps(kernel, B * T, fan, stream,
                      static_cast<const uint8_t*>(atlas), N, H, WA,
                      static_cast<const int*>(tilemap),
                      static_cast<const float*>(rel),
                      static_cast<float*>(out),
                      static_cast<long long>(B) * T * fan, T, fan, s2, ppv,
                      tiny, /*sink=*/0);
}

using K7Kernel = void (*)(const uint8_t*, int, int, int, const int*,
                          const float*, float*, int, int, int, int, int, int,
                          int);

template <int MODE>
static K7Kernel k7_kernel(int held) {
  return held == 1 ? moments_abl_kernel<MODE, 1> : moments_abl_kernel<MODE, 2>;
}

// K7's kernel for `mode`, or nullptr for a mode outside the enum, T outside
// 1..32, a window of more than kK7MaxS2 samples, ppv < 1 or an atlas plane
// of 2 GB or more.
static K7Kernel k7_select(int H, int WA, int T, int wsize, int ppv,
                          int mode) {
  const int s2 = wsize * wsize;
  if (T < 1 || T > 32 || wsize < 1 || s2 > kK7MaxS2 || ppv < 1 ||
      3LL * H * WA >= (1LL << 31))
    return nullptr;
  const int held = (s2 + 31) / 32;
  switch (mode) {
    case kK7Full: return k7_kernel<kK7Full>(held);
    case kK7NoMoments: return k7_kernel<kK7NoMoments>(held);
    case kK7NoExpand: return k7_kernel<kK7NoExpand>(held);
    case kK7BodyOnly: return k7_kernel<kK7BodyOnly>(held);
    default: return nullptr;
  }
}

// K7 on `stream`. Returns the CUDA error code (invalid value where
// k7_select has no kernel).
extern "C" int cmvs_moments_abl(const void* atlas, int N, int H, int WA,
                                const void* tilemap, const void* frames,
                                void* out, int B, int T, int fan, int wsize,
                                int ppv, int lead, int mode, void* stream) {
  const K7Kernel kernel = k7_select(H, WA, T, wsize, ppv, mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_warps(kernel, B, fan, stream,
                      static_cast<const uint8_t*>(atlas), N, H, WA,
                      static_cast<const int*>(tilemap),
                      static_cast<const float*>(frames),
                      static_cast<float*>(out), B, T, fan, wsize, ppv, lead,
                      /*sink=*/0);
}
