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
// lanes, which writes it.
//
// K6 has no moments and no walk over views: each sample stands alone, so
// it is laid out as a stream. A thread takes kK6Run = 4 consecutive
// samples of the flat [B, T, fan, S2] order, reads their positions as one
// float4 a plane and writes each output row as one float4 (one float at a
// time for a tail, an unaligned plane or the tiny output); no lane idles
// on a 49-sample window. A sample's pair, window and patch come from
// multiply-highs by fixed-point reciprocals the host computes (`udiv`; no
// 64-bit division), and a pair's tile code is read once for the run of
// samples that share it. Its taps are read as K5's (tile_taps: a row's
// pixel and its right neighbour in one or two aligned 8-byte words, the
// tile rule as a weight mask); no_x and no_fold read their 32 and 8
// columns of two rows as 24-byte chunks of aligned words (the atlas's
// first and last rows byte by byte, under the same rule).
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
// and 12 B of RGB written per sample against ~37 float operations; its
// first layout (a warp per window, 12 one-byte tap loads a sample, a
// second pass of 17 samples over 32 lanes, 64-bit divisions) ran at 38%
// of that bound and this one at 58% (H100 80GB HBM3, 700 W): the
// positions and rows stream at ~2.8 TB/s, and the random tap loads add
// ~30% that does not hide behind the stream.
//
// Registers (nvcc -Xptxas -v, CUDA 12.8, sm_90a), no spills: K5 full 54 /
// 80 / 80 / 97 for 1-4 samples a lane and 101 recomputing, dma_only 44 /
// 64 for 1 / 2; K7 full 47 / 53 for 1 / 2 samples a lane; K6 full 47,
// no_x 63, no_mm 25, wy_only 26, no_fold 64, dma_only 40.

#include "common.cuh"

namespace {

using cmvs::FanMeta;
using cmvs::FanView;
using cmvs::hat;

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

constexpr int kK6Threads = 64;  // threads a block
constexpr int kK6Run = 4;       // consecutive samples a thread: one float4

// n / d for 0 <= n < 2^31, from the host's fixed-point reciprocal of d
// (ops/ablate.div_magic): l = ceil(log2 d) and m = ceil(2^(31 + l) / d) <
// 2^32, so that 2 n m / 2^(32 + l) = n / d + e with 0 <= e < 2^-l <= 1 / d,
// which leaves the floor of n / d unchanged. A multiply-high and a shift.
struct Div {
  unsigned m;
  int l;
};

__device__ __forceinline__ int udiv(int n, Div d) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(n) << 1, d.m) >>
                          d.l);
}

struct K6Args {
  const uint8_t* atlas;
  int N, H, WA;
  const int* tilemap;  // [B * T]
  const float* rel;    // [2, total]: x plane, then y plane
  float* out;          // [R, total] (tiny: [R, tiny_len])
  int total, s2;       // samples (windows * s2), samples a window
  Div pair, window, patch, group;  // division by s2 fan, s2, T fan, ppv
  int tfan, ppv, tiny_len;
  int vec;   // rel planes and output rows 16-byte aligned: float4 access
  int tiny, sink;
};

// The tile of tile code `code` as the fan body's FanView (fan_view's row
// rule: the rows whose tap words lie inside the atlas), without shuffles.
__device__ __forceinline__ FanView k6_view(const K6Args& a, int code) {
  const TileCode tc = decode_tile(code, a.N);
  FanView fv;
  fv.img = a.atlas + static_cast<long long>(tc.n) * a.H * a.WA * 3;
  fv.ok = true;
  fv.row_lo = tc.n == 0 ? 1 : 0;
  fv.row_hi = a.WA < 5 ? -1 : (tc.n == a.N - 1 ? a.H - 2 : a.H - 1);
  fv.ox = tc.ox;
  fv.oy = tc.oy;
  fv.tw = cmvs::clampi(a.WA - tc.ox, 0, cmvs::kTile);
  fv.th = cmvs::clampi(a.H - tc.oy, 0, cmvs::kTile);
  return fv;
}

// Bytes [p, p + 24) - eight RGB pixels of an atlas row - as six words,
// byte k in bits 8 (k % 4) of word k / 4. wide: the aligned 8-byte words
// over them lie inside the atlas; three are read (four where p is not
// aligned) and the bytes cut out with funnel shifts. Else byte by byte,
// the pixels from `avail` on (past the row's end) as 0.
__device__ __forceinline__ void chunk_words(const uint8_t* p, int avail,
                                            bool wide, unsigned (&b)[6]) {
  if (wide) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const uint2* w =
        reinterpret_cast<const uint2*>(addr & ~static_cast<uintptr_t>(7));
    const unsigned off = static_cast<unsigned>(addr & 7);
    unsigned u[8];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint2 v = __ldg(w + i);
      u[2 * i] = v.x;
      u[2 * i + 1] = v.y;
    }
    const uint2 v3 = off > 0 ? __ldg(w + 3) : make_uint2(0u, 0u);
    u[6] = v3.x;
    u[7] = v3.y;
    unsigned s[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) s[k] = off < 4 ? u[k] : u[k + 1];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      b[k] = __funnelshift_r(s[k], s[k + 1], (off & 3) * 8);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = 0u;
#pragma unroll
    for (int k = 0; k < 24; ++k)
      if (k / 3 < avail)
        b[k / 4] |= static_cast<unsigned>(p[k]) << (8 * (k % 4));
  }
}

// Channel c of pixel x (0..7) of chunk_words' words.
__device__ __forceinline__ float chunk_channel(const unsigned (&b)[6], int x,
                                               int c) {
  return cmvs::byte_float(b[(3 * x + c) / 4], (3 * x + c) % 4);
}

// no_x (kChunks 4: the sum over the 32 tile columns of the y-interpolated
// RGB) and no_fold (kChunks 1: row x = 0..7, column x's y-interpolated R
// times its x weight) at (rx, ry) of tile fv. Rows ly and ly + 1 are read
// from the tile's first column on, eight pixels a chunk, as words where the
// row is one fan_view allows and the atlas is wide enough that the words
// end inside the next row (WA >= 8 kChunks + 2); the tile rule masks the
// row weights and zeroes the columns past the tile's readable width, which
// is what the plain version's zero taps give, bit for bit.
template <int kChunks, int R>
__device__ __forceinline__ void k6_columns(const FanView& fv, int H, int WA,
                                           float rx, float ry,
                                           float (&val)[R]) {
  ry = fminf(fmaxf(ry, -cmvs::kFanPosMax), cmvs::kFanPosMax);
  int ly;
  const float fy = cmvs::floor_int(ry, ly);
  const unsigned th = fv.th;
  const float wy0 = static_cast<unsigned>(ly) < th ? hat(ry - fy) : 0.f;
  const float wy1 =
      static_cast<unsigned>(ly + 1) < th ? hat(ry - (fy + 1.f)) : 0.f;
  const int xa = cmvs::clampi(fv.ox, 0, WA - 1);
  const int r0 = cmvs::clampi(fv.oy + ly, 0, H - 1);
  const int r1 = cmvs::clampi(fv.oy + ly + 1, 0, H - 1);
  const bool fit = WA >= 8 * kChunks + 2;
  const bool wide0 = fit && r0 >= fv.row_lo && r0 <= fv.row_hi;
  const bool wide1 = fit && r1 >= fv.row_lo && r1 <= fv.row_hi;
  const uint8_t* p0 = fv.img + (r0 * WA + xa) * 3;
  const uint8_t* p1 = fv.img + (r1 * WA + xa) * 3;
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    unsigned b0[6], b1[6];
    chunk_words(p0 + 24 * c, WA - xa - 8 * c, wide0, b0);
    chunk_words(p1 + 24 * c, WA - xa - 8 * c, wide1, b1);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const bool in = 8 * c + x < fv.tw;
      if constexpr (kChunks == 1) {
        const float q0 = in ? chunk_channel(b0, x, 0) : 0.f;
        const float q1 = in ? chunk_channel(b1, x, 0) : 0.f;
        val[x] = (wy0 * q0 + wy1 * q1) * hat(rx - static_cast<float>(x));
      } else {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float q0 = in ? chunk_channel(b0, x, ch) : 0.f;
          const float q1 = in ? chunk_channel(b1, x, ch) : 0.f;
          acc[ch] += wy0 * q0 + wy1 * q1;
        }
      }
    }
  }
  if constexpr (kChunks != 1) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) val[ch] = acc[ch];
  }
}

// One sample of mode MODE at (rx, ry) of tile fv (interp_abl_kernel's
// output rows); dma_only adds its tap words into `words`.
template <int MODE, int R>
__device__ __forceinline__ void k6_sample(const FanView& fv, int H, int WA,
                                          float rx, float ry, float (&val)[R],
                                          unsigned& words) {
  if constexpr (MODE == kK6Full) {
    tile_sample<kBilinear>(fv, H, WA, rx, ry, val, words);
  } else if constexpr (MODE == kK6DmaOnly) {
    tile_sample<kWords>(fv, H, WA, rx, ry, val, words);
  } else if constexpr (MODE == kK6NoX) {
    k6_columns<4>(fv, H, WA, rx, ry, val);
  } else if constexpr (MODE == kK6NoFold) {
    k6_columns<1>(fv, H, WA, rx, ry, val);
  } else {  // no_mm, wy_only: the weights alone, no taps
    ry = fminf(fmaxf(ry, -cmvs::kFanPosMax), cmvs::kFanPosMax);
    int ly;
    const float fy = cmvs::floor_int(ry, ly);
    const float wy0 = hat(ry - fy), wy1 = hat(ry - (fy + 1.f));
    const bool in0 = static_cast<unsigned>(ly) < cmvs::kTile;
    const bool in1 = static_cast<unsigned>(ly + 1) < cmvs::kTile;
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
  }
}

// out[r, i] for the flat samples i of [B, T, fan, S2] (tiny: out[r, group,
// window, s], only the first min(2, T fan) windows of every group of ppv
// patches):
// full, bilinear RGB; no_x, the sum over the 32 tile columns of the
// y-interpolated RGB; no_mm, the sum over tile columns i of wy[i] wx[i] in
// every row; wy_only, row 0 the sum of the in-tile wy[i], rows 1-2 0;
// no_fold, rows x = 0..7 the x-weighted y-interpolation of column x's R;
// dma_only, 0 after the taps are read. Each thread takes kK6Run
// consecutive samples: their positions as one float4 a plane and their
// rows as one float4 each where `vec`, else (a tail, an unaligned plane,
// the tiny output) one float at a time. A sample's pair comes from one
// udiv, and the pair's tile code is read once for the run of samples that
// share it.
template <int MODE>
__global__ void __launch_bounds__(kK6Threads)
    interp_abl_kernel(const K6Args a) {
  constexpr int R = MODE == kK6NoFold ? 8 : 3;  // output rows
  const long long first =
      (static_cast<long long>(blockIdx.x) * kK6Threads + threadIdx.x) *
      kK6Run;
  if (first >= a.total) return;
  const int i0 = static_cast<int>(first);
  float rx[kK6Run], ry[kK6Run];
  if (a.vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a.rel + i0));
    const float4 y =
        __ldg(reinterpret_cast<const float4*>(a.rel + a.total + i0));
    rx[0] = x.x, rx[1] = x.y, rx[2] = x.z, rx[3] = x.w;
    ry[0] = y.x, ry[1] = y.y, ry[2] = y.z, ry[3] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < kK6Run; ++j) {
      const bool in = i0 + j < a.total;
      rx[j] = in ? __ldg(a.rel + i0 + j) : 0.f;
      ry[j] = in ? __ldg(a.rel + a.total + i0 + j) : 0.f;
    }
  }
  float val[kK6Run][R];
  unsigned words = 0;  // dma_only's loaded words (sink)
  FanView fv;
  int pair = -1;
#pragma unroll
  for (int j = 0; j < kK6Run; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) val[j][r] = 0.f;
    if (i0 + j >= a.total) continue;
    const int p = udiv(i0 + j, a.pair);
    if (p != pair) {
      pair = p;
      fv = k6_view(a, __ldg(a.tilemap + p));
    }
    k6_sample<MODE>(fv, a.H, a.WA, rx[j], ry[j], val[j], words);
  }
  if constexpr (MODE == kK6DmaOnly) {
#pragma unroll
    for (int j = 0; j < kK6Run; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r)
        val[j][r] = a.sink ? static_cast<float>(words) : 0.f;
  }
  if (!a.tiny) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* o = a.out + static_cast<long long>(r) * a.total + i0;
      if (a.vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(val[0][r], val[1][r], val[2][r], val[3][r]);
      } else {
#pragma unroll
        for (int j = 0; j < kK6Run; ++j)
          if (i0 + j < a.total) o[j] = val[j][r];
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kK6Run; ++j) {
    const int i = i0 + j;
    if (i >= a.total) continue;
    const int w = udiv(i, a.window), s = i - w * a.s2;
    const int b = udiv(w, a.patch), k = w - b * a.tfan;
    const int g = udiv(b, a.group);
    if ((b == g * a.ppv && k < 2) || a.sink) {
      const int dst = (g * min(a.tfan, 2) + (k & 1)) * a.s2 + s;
#pragma unroll
      for (int r = 0; r < R; ++r)
        a.out[static_cast<long long>(r) * a.tiny_len + dst] = val[j][r];
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

// Launch `kernel` with one warp per (patch, probe) of B patches, kFanWarps
// warps a block (K5 and K7).
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

// K6 on `stream`: one thread a run of kK6Run flat samples, the divisions'
// reciprocals and the alignment choice (`vec`) from the host
// (ops/ablate.interp_abl). Returns the CUDA error code (invalid value for a
// mode outside the enum, total outside 1..2^31 - 1 - kK6Run, s2 < 1 or an
// atlas plane of 2 GB or more).
extern "C" int cmvs_interp_abl(const void* atlas, int N, int H, int WA,
                               const void* tilemap, const void* rel,
                               void* out, int total, int s2, int tfan,
                               int ppv, unsigned pair_m, int pair_l,
                               unsigned window_m, int window_l,
                               unsigned patch_m, int patch_l,
                               unsigned group_m, int group_l, int tiny_len,
                               int vec, int tiny, int mode, void* stream) {
  if (total < 1 || total > 0x7fffffff - kK6Run || s2 < 1 ||
      3LL * H * WA >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const K6Args);
  switch (mode) {
    case kK6Full: kernel = interp_abl_kernel<kK6Full>; break;
    case kK6NoX: kernel = interp_abl_kernel<kK6NoX>; break;
    case kK6NoMm: kernel = interp_abl_kernel<kK6NoMm>; break;
    case kK6WyOnly: kernel = interp_abl_kernel<kK6WyOnly>; break;
    case kK6NoFold: kernel = interp_abl_kernel<kK6NoFold>; break;
    case kK6DmaOnly: kernel = interp_abl_kernel<kK6DmaOnly>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const K6Args a = {static_cast<const uint8_t*>(atlas), N, H, WA,
                    static_cast<const int*>(tilemap),
                    static_cast<const float*>(rel), static_cast<float*>(out),
                    total, s2,
                    {pair_m, pair_l}, {window_m, window_l},
                    {patch_m, patch_l}, {group_m, group_l},
                    tfan, ppv, tiny_len, vec, tiny, /*sink=*/0};
  constexpr int kPerBlock = kK6Threads * kK6Run;
  const unsigned blocks = static_cast<unsigned>((total + kPerBlock - 1) /
                                                kPerBlock);
  kernel<<<blocks, kK6Threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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
