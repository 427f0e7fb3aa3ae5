// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cmvs {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- The v1 tile rule (K3, K5-K7) ----------------------------------------
// A pair samples one kTile x kTile-px tile of the atlas: a tap outside the
// tile weighs 0, and a tile pixel past the atlas edge reads 0 (the
// reference zero-pads its tiles).

constexpr int kTile = 32;            // tile extent in px
constexpr int kTileStride = 12;      // tile origin stride in px

// The TPU kernels' bilinear hat weight of a tap at distance d.
__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

// ---- The refine-fan INCC body (K1: csrc/fan2.cu, K3: csrc/fan.cu) --------
// One warp per (patch b, probe f) walks the patch's T views, with no
// shared memory and no block barrier. Lane l owns samples l, l + 32, ...
// of every window. With kHeld > 0 samples per lane (windows of up to
// 32 * kHeld samples) the values stay in registers, view 0's deviations
// for the whole walk, so each view's cross-sum with view 0 is lane-local;
// with kHeld = 0 (larger windows) each pass recomputes its samples from
// the atlas. Two-pass moments, as in the plain versions: one butterfly
// for a view's three channel sums, one for its squared and cross sums.

constexpr int kFanWarps = 8;      // warps per block
constexpr int kFanMaxWsize = 63;  // the largest window K1 and K3 take
// Sample positions are clamped to +-2^21 px, where floor_int is exact; a
// tap that far out is clamped to the atlas edge (K1) or masked (K3) all
// the same.
constexpr float kFanPosMax = 2097152.f;

// Butterfly sum of M values over the warp; every lane gets the totals.
template <int M>
__device__ __forceinline__ void warp_sum_n(float (&v)[M]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

// Byte k of w as an exact float: the byte becomes the low mantissa bits
// of 2^23 (one PRMT) and 2^23 is subtracted (one FADD). A shift, mask and
// I2F would cost a conversion, which runs at 1/8 of the FP32 rate.
__device__ __forceinline__ float byte_float(unsigned w, unsigned k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k)) -
         8388608.f;
}

// floor(x) as a float, and as an int in i, for |x| < 2^22: x + 1.5 * 2^23
// rounded down has an ulp of 1, so it holds floor(x) exactly in its low
// mantissa bits. Three full-rate instructions instead of two conversions.
__device__ __forceinline__ float floor_int(float x, int& i) {
  const float m = __fadd_rd(x, 12582912.f);
  i = __float_as_int(m) - 0x4B400000;
  return m - 12582912.f;
}

// Bytes 0-3 (lo) and 4-7 (hi) from p, of which bytes 0-5 hold the atlas
// pixel at byte p and its right neighbour; where `adjacent` is false (the
// clamped right edge) only the pixel's bytes 0-2 are read. wide: the two
// aligned 8-byte words from p's word on lie inside the atlas; the first
// (and the second where the 6 bytes cross it) is read and the bytes are
// cut out with funnel shifts. Else byte by byte.
__device__ __forceinline__ void row_words(const uint8_t* p, bool adjacent,
                                          bool wide, unsigned& lo,
                                          unsigned& hi) {
  if (wide) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const uint2* w =
        reinterpret_cast<const uint2*>(addr & ~static_cast<uintptr_t>(7));
    const unsigned off = static_cast<unsigned>(addr & 7);
    const uint2 w0 = __ldg(w);
    const uint2 w1 = off > 2 ? __ldg(w + 1) : make_uint2(0u, 0u);
    const unsigned r0 = off < 4 ? w0.x : w0.y;
    const unsigned r1 = off < 4 ? w0.y : w1.x;
    const unsigned r2 = off < 4 ? w1.x : w1.y;
    lo = __funnelshift_r(r0, r1, (off & 3) * 8);
    hi = __funnelshift_r(r1, r2, (off & 3) * 8);
  } else {
    const unsigned b3 = adjacent ? p[3] : 0u;
    lo = p[0] | p[1] << 8 | p[2] << 16 | b3 << 24;
    hi = adjacent ? p[4] | p[5] << 8 : 0u;
  }
}

// The pixel's RGB (a) and its right neighbour's (b; the pixel again where
// `adjacent` is false) from row_words' lo and hi.
__device__ __forceinline__ void pair_rgb(unsigned lo, unsigned hi,
                                         bool adjacent, float a[3],
                                         float b[3]) {
  const unsigned pb = __byte_perm(lo, hi, adjacent ? 0x0543u : 0x0210u);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = byte_float(lo, c);
    b[c] = byte_float(pb, c);
  }
}

// RGB of the atlas pixel at byte p and of its right neighbour (or of the
// pixel again where `adjacent` is false), read as row_words reads them.
__device__ __forceinline__ void row_pair(const uint8_t* p, bool adjacent,
                                         bool wide, float a[3], float b[3]) {
  unsigned lo, hi;
  row_words(p, adjacent, wide, lo, hi);
  pair_rgb(lo, hi, adjacent, a, b);
}

// A warp's view metadata, loaded once: lane j < T holds view j's plane,
// frame (orgx, orgy, dxx, dxy, dyx, dyy), ok flag and (K3) tile origin.
struct FanMeta {
  int n, ox, oy;
  float fr[6];
  bool ok;
};

template <bool kV1>
__device__ __forceinline__ FanMeta fan_meta(int N, const int* vid,
                                            const int* tile_org,
                                            const float* frames,
                                            const uint8_t* ok, int b, int T,
                                            int fan, int f, int lane) {
  FanMeta m = {0, 0, 0, {}, false};
  if (lane < T) {
    const long long pair = static_cast<long long>(b) * T + lane;
    const long long probe = pair * fan + f;
    m.n = clampi(vid[pair], 0, N - 1);
#pragma unroll
    for (int i = 0; i < 6; ++i) m.fr[i] = frames[probe * 6 + i];
    m.ok = ok[probe] != 0;
    if (kV1) {
      m.ox = tile_org[pair * 2];
      m.oy = tile_org[pair * 2 + 1];
    }
  }
  return m;
}

// View v of the warp's patch at its probe, handed to every lane by
// shuffles: its atlas plane, frame, ok flag, the rows [row_lo, row_hi]
// whose taps may be read as aligned words (not the atlas's first row nor
// its last, so the words stay inside it) and, for K3, the pair's probe-0
// tile (origin ox, oy; readable extent tw, th).
struct FanView {
  const uint8_t* img;
  float fr[6];
  bool ok;
  int row_lo, row_hi, ox, oy, tw, th;
};

template <bool kV1>
__device__ __forceinline__ FanView fan_view(const FanMeta& m,
                                            const uint8_t* atlas, int N,
                                            int H, int WA, int v) {
  constexpr unsigned kAll = 0xffffffffu;
  FanView fv;
  const int n = __shfl_sync(kAll, m.n, v);
  fv.img = atlas + static_cast<long long>(n) * H * WA * 3;
#pragma unroll
  for (int i = 0; i < 6; ++i) fv.fr[i] = __shfl_sync(kAll, m.fr[i], v);
  fv.ok = __shfl_sync(kAll, static_cast<int>(m.ok), v) != 0;
  fv.row_lo = n == 0 ? 1 : 0;
  fv.row_hi = WA < 5 ? -1 : (n == N - 1 ? H - 2 : H - 1);
  fv.ox = kV1 ? __shfl_sync(kAll, m.ox, v) : 0;
  fv.oy = kV1 ? __shfl_sync(kAll, m.oy, v) : 0;
  fv.tw = clampi(WA - fv.ox, 0, kTile);
  fv.th = clampi(H - fv.oy, 0, kTile);
  return fv;
}

// Bilinear RGB of lattice point (gx, gy) of view `fv`, in the plain
// versions' operation order (no FMA: a flat window must come out as the
// same bits, or its NCC is made of different rounding noise). K1 (kV1
// false): taps clamped into the atlas plane. K3: positions relative to
// the tile, taps outside it weigh 0 (the tile is a rectangle, so the row
// and column factors are masked, which zeroes the same products).
template <bool kV1>
__device__ __forceinline__ void fan_sample(const FanView& fv, int H, int WA,
                                           float gx, float gy,
                                           float val[3]) {
  float x = fv.fr[0] + gx * fv.fr[2] + gy * fv.fr[4];
  float y = fv.fr[1] + gx * fv.fr[3] + gy * fv.fr[5];
  if (kV1) {
    x = x - fv.ox;
    y = y - fv.oy;
  }
  x = fminf(fmaxf(x, -kFanPosMax), kFanPosMax);
  y = fminf(fmaxf(y, -kFanPosMax), kFanPosMax);
  int lx, ly;
  const float fx = floor_int(x, lx), fy = floor_int(y, ly);
  float dx1 = x - fx, dy1 = y - fy;
  float dx0 = 1.f - dx1, dy0 = 1.f - dy1;
  if (kV1) {
    const unsigned tw = fv.tw, th = fv.th;
    dx0 = static_cast<unsigned>(lx) < tw ? dx0 : 0.f;
    dx1 = static_cast<unsigned>(lx + 1) < tw ? dx1 : 0.f;
    dy0 = static_cast<unsigned>(ly) < th ? dy0 : 0.f;
    dy1 = static_cast<unsigned>(ly + 1) < th ? dy1 : 0.f;
  }
  const int ax = fv.ox + lx, ay = fv.oy + ly;  // atlas pixel of tap 00
  const int xa = clampi(ax, 0, WA - 1), xb = clampi(ax + 1, 0, WA - 1);
  const int r0 = clampi(ay, 0, H - 1), r1 = clampi(ay + 1, 0, H - 1);
  float c00[3], c10[3], c01[3], c11[3];
  const uint8_t* p0 = fv.img + (r0 * WA + xa) * 3;
  row_pair(p0, xb != xa, r0 >= fv.row_lo && r0 <= fv.row_hi, c00, c10);
  row_pair(p0 + (r1 - r0) * WA * 3, xb != xa,
           r1 >= fv.row_lo && r1 <= fv.row_hi, c01, c11);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    val[c] = c00[c] * dx0 * dy0 + c10[c] * dx1 * dy0 + c01[c] * dx0 * dy1 +
             c11[c] * dx1 * dy1;
}

// Lattice offsets (gx, gy) of sample s of a wsize x wsize window.
__device__ __forceinline__ void lattice(int s, int wsize, float& gx,
                                        float& gy) {
  const int margin = wsize / 2;
  gx = static_cast<float>(s % wsize - margin);
  gy = static_cast<float>(s / wsize - margin);
}

// a / b rounded to nearest, from y = RN(1/b): the product a * y is within
// an ulp of a / b, the remainder a - b q is exact in one FMA, and one
// correction step rounds it correctly (Markstein's theorem, barring
// overflow and underflow; a = 0 gives 0). Three instructions where an
// IEEE division takes a dozen and a branch; the bits are the division's.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = a * y;
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// x / (1 + 3x) of x = 1 - NCC, from a view's variance, the reference's
// variance and their covariance; a variance <= 0 normalizes by 1.
__device__ __forceinline__ float robust_incc(float var, float var_r,
                                             float cov) {
  const float istd_v = var <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var, 1e-20f));
  const float istd_r =
      var_r <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var_r, 1e-20f));
  const float dot = cov * istd_r * istd_v;
  const float xx = 1.f - dot;
  return xx / (1.f + 3.f * xx);
}

template <int kHeld, bool kV1>
__global__ void __launch_bounds__(32 * kFanWarps)
    fan_incc_kernel(const uint8_t* __restrict__ atlas, int N, int H, int WA,
                    const int* __restrict__ vid,
                    const int* __restrict__ tile_org,
                    const float* __restrict__ frames,
                    const uint8_t* __restrict__ ok, float* __restrict__ out,
                    int B, int T, int fan, int wsize) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kFanWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(B) * fan) return;
  const int b = static_cast<int>(w / fan), f = static_cast<int>(w % fan);
  const int lane = threadIdx.x & 31;
  const int s2 = wsize * wsize;
  const float s2f = static_cast<float>(s2), rs2 = 1.f / s2f;
  const FanMeta meta =
      fan_meta<kV1>(N, vid, tile_org, frames, ok, b, T, fan, f, lane);
  // Lane v keeps view v's sum of squared deviations (sq) and of
  // deviations times view 0's (cross); the INCCs of all T views are
  // finished together at the end, one view a lane.
  float sq = 0.f, cross = 0.f;

  if constexpr (kHeld > 0) {
    float gx[kHeld], gy[kHeld];
    bool in[kHeld];
    float d0[kHeld][3] = {};  // view 0's deviations
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      in[k] = lane + 32 * k < s2;
      lattice(in[k] ? lane + 32 * k : 0, wsize, gx[k], gy[k]);
    }
    for (int v = 0; v < T; ++v) {
      const FanView V = fan_view<kV1>(meta, atlas, N, H, WA, v);
      float x[kHeld][3] = {};
      float m[3] = {};
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (in[k] && V.ok) fan_sample<kV1>(V, H, WA, gx[k], gy[k], x[k]);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) m[ch] += x[k][ch];
      }
      warp_sum_n(m);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) m[ch] = div_by(m[ch], s2f, rs2);
      float q[2] = {};
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float d = in[k] ? x[k][ch] - m[ch] : 0.f;
          if (v == 0) d0[k][ch] = d;
          q[0] += d * d;
          q[1] += d * d0[k][ch];
        }
      }
      warp_sum_n(q);
      sq = lane == v ? q[0] : sq;
      cross = lane == v ? q[1] : cross;
    }
  } else {
    const FanView R = fan_view<kV1>(meta, atlas, N, H, WA, 0);
    float mean0[3] = {};
    for (int v = 0; v < T; ++v) {
      const FanView V = fan_view<kV1>(meta, atlas, N, H, WA, v);
      float m[3] = {};
      for (int s = lane; s < s2; s += 32) {
        float gx, gy, x[3] = {};
        lattice(s, wsize, gx, gy);
        if (V.ok) fan_sample<kV1>(V, H, WA, gx, gy, x);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) m[ch] += x[ch];
      }
      warp_sum_n(m);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) m[ch] = div_by(m[ch], s2f, rs2);
      if (v == 0)
        for (int ch = 0; ch < 3; ++ch) mean0[ch] = m[ch];
      float q[2] = {};
      for (int s = lane; s < s2; s += 32) {
        float gx, gy, x[3] = {}, r[3] = {};
        lattice(s, wsize, gx, gy);
        if (V.ok) fan_sample<kV1>(V, H, WA, gx, gy, x);
        if (R.ok) fan_sample<kV1>(R, H, WA, gx, gy, r);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float d = x[ch] - m[ch];
          q[0] += d * d;
          q[1] += d * (r[ch] - mean0[ch]);
        }
      }
      warp_sum_n(q);
      sq = lane == v ? q[0] : sq;
      cross = lane == v ? q[1] : cross;
    }
  }
  const float norm = 3.f * s2;
  const float var = sq / norm;
  const float var0 = __shfl_sync(0xffffffffu, var, 0);
  if (lane < T)
    out[(static_cast<long long>(b) * T + lane) * fan + f] =
        robust_incc(var, var0, cross / norm);
}

// Launch K1 (kV1 false; tile_org unused) or K3 on `stream`: one warp per
// (patch, probe), kFanWarps warps per block, samples held in registers
// where the window allows. Returns the CUDA error code (invalid value for
// T outside 1..32, wsize outside 1..kFanMaxWsize or an atlas plane of 2
// GB or more).
template <bool kV1>
__host__ inline int launch_fan_incc(const void* atlas, int N, int H, int WA,
                                    const void* vid, const void* tile_org,
                                    const void* frames, const void* ok,
                                    void* out, int B, int T, int fan,
                                    int wsize, void* stream) {
  if (T < 1 || T > 32 || wsize < 1 || wsize > kFanMaxWsize ||
      3LL * H * WA >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(B) * fan;
  const unsigned blocks =
      static_cast<unsigned>((warps + kFanWarps - 1) / kFanWarps);
  const int held = (wsize * wsize + 31) / 32;
  auto go = [&](auto kernel) {
    kernel<<<blocks, 32 * kFanWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(atlas), N, H, WA,
        static_cast<const int*>(vid), static_cast<const int*>(tile_org),
        static_cast<const float*>(frames), static_cast<const uint8_t*>(ok),
        static_cast<float*>(out), B, T, fan, wsize);
  };
  switch (held) {  // registers up to s2 = 128 (wsize 11), then recompute
    case 1: go(fan_incc_kernel<1, kV1>); break;
    case 2: go(fan_incc_kernel<2, kV1>); break;
    case 3: go(fan_incc_kernel<3, kV1>); break;
    case 4: go(fan_incc_kernel<4, kV1>); break;
    default: go(fan_incc_kernel<0, kV1>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- The block-window body (K2: csrc/windows.cu, K4: csrc/incc.cu) -------
// A (patch, view) pair samples its s2 block-relative positions (relx,
// rely) bilinearly inside the k x k block at starts = (n, sy, sx_atlas),
// the start clamped into the atlas like the reference's CLIP-mode block
// gather and a tap outside [0, k) of the block weighing 0, and its window
// is normalized to zero per-channel mean and unit global variance. One
// warp per window, with no shared memory and no block barrier. Lane l
// owns samples l, l + 32, ...; with kHeld > 0 samples per lane (windows
// of up to 32 * kHeld samples) they stay in registers, with kHeld = 0
// (larger windows) each pass recomputes its samples from the atlas. A
// held window whose taps all lie inside its block, on rows that may be
// read as words (every window the reference's geometry makes, barring
// the atlas's first and last rows), takes the inner path: no masks,
// clamps or row checks, so fewer instructions a sample. The
// arithmetic is the first kernels' and the plain version's operation
// for operation (ops/texture.block_bilinear, normalize_tex), so a window
// comes out as the same bits on either path.

constexpr int kBlockWarps = 8;      // warps per block
constexpr int kBlockMaxWsize = 63;  // K2 and K4 take s2 <= kBlockMaxWsize^2

// Samples a lane holds in registers for an s2-sample window (0: recompute).
__host__ inline int held_samples(int s2) {
  const int held = (s2 + 31) / 32;
  return held <= 4 ? held : 0;
}

// The constants of an s2-sample window's two divisions (the per-channel
// mean by s2, the variance by 3 * s2) and their reciprocals for div_by,
// computed once by the launcher (the host's IEEE division gives the
// device's bits) and passed to the kernel.
struct WinConst {
  float s2f, rs2, n3, rn3;
};

__host__ inline WinConst win_const(int s2) {
  const float s2f = static_cast<float>(s2), n3 = 3.f * s2f;
  return {s2f, 1.f / s2f, n3, 1.f / n3};
}

// A pair's block: its atlas plane, its origin clamped into the atlas, and
// the rows row_lo .. row_lo + row_n whose taps may be read as aligned
// words (as in fan_view). inner: the block lies inside the atlas (k >= 2)
// and every row of it may be read as words, so a tap inside the block
// needs no clamp and no row check.
struct BlockView {
  const uint8_t* img;
  int sy, sx, row_lo;
  unsigned row_n;
  bool inner;
};

__device__ __forceinline__ BlockView block_view(const uint8_t* atlas, int N,
                                                int H, int WA, int k, int n,
                                                int sy, int sx) {
  BlockView bv;
  n = clampi(n, 0, N - 1);
  bv.img = atlas + static_cast<long long>(n) * H * WA * 3;
  bv.sy = clampi(sy, 0, H - k > 0 ? H - k : 0);
  bv.sx = clampi(sx, 0, WA - k > 0 ? WA - k : 0);
  bv.row_lo = n == 0 ? 1 : 0;
  const int row_hi = WA < 5 ? -1 : (n == N - 1 ? H - 2 : H - 1);
  bv.row_n = row_hi >= bv.row_lo ? static_cast<unsigned>(row_hi - bv.row_lo)
                                 : 0u;
  if (row_hi < bv.row_lo) bv.row_lo = H;  // no row qualifies
  bv.inner = k >= 2 && H >= k && WA >= k && bv.sy >= bv.row_lo &&
             bv.sy + k - 1 <= row_hi;
  return bv;
}

// Bilinear RGB at block-relative (rx, ry): interpolated in y, then in x,
// products unfused (-fmad=false), as in the plain version. The block rule
// masks the row and column weights; the masked tap's pixel is still read,
// clamped into the atlas, and weighs exactly 0. Positions are clamped to
// +-kFanPosMax, where floor_int is exact; taps that far out weigh 0 either
// way. Each tap row is read with row_pair (aligned 8-byte words).
__device__ __forceinline__ void block_tap(const BlockView& bv, int H, int WA,
                                          int k, float rx, float ry,
                                          float val[3]) {
  rx = fminf(fmaxf(rx, -kFanPosMax), kFanPosMax);
  ry = fminf(fmaxf(ry, -kFanPosMax), kFanPosMax);
  int lx, ly;
  const float fx = floor_int(rx, lx), fy = floor_int(ry, ly);
  const float ax = rx - fx, ay = ry - fy;
  const unsigned ku = static_cast<unsigned>(k);
  const float wx0 = static_cast<unsigned>(lx) < ku ? 1.f - ax : 0.f;
  const float wx1 = static_cast<unsigned>(lx + 1) < ku ? ax : 0.f;
  const float wy0 = static_cast<unsigned>(ly) < ku ? 1.f - ay : 0.f;
  const float wy1 = static_cast<unsigned>(ly + 1) < ku ? ay : 0.f;
  const int x0 = bv.sx + lx, y0 = bv.sy + ly;  // atlas pixel of tap 00
  const int xa = clampi(x0, 0, WA - 1), xb = clampi(x0 + 1, 0, WA - 1);
  const int r0 = clampi(y0, 0, H - 1), r1 = clampi(y0 + 1, 0, H - 1);
  float p00[3], p10[3], p01[3], p11[3];  // p<dx><dy>
  const uint8_t* q = bv.img + (r0 * WA + xa) * 3;
  row_pair(q, xb != xa, static_cast<unsigned>(r0 - bv.row_lo) <= bv.row_n,
           p00, p10);
  row_pair(q + (r1 - r0) * WA * 3, xb != xa,
           static_cast<unsigned>(r1 - bv.row_lo) <= bv.row_n, p01, p11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float row0 = wy0 * p00[c] + wy1 * p01[c];
    const float row1 = wy0 * p10[c] + wy1 * p11[c];
    val[c] = wx0 * row0 + wx1 * row1;
  }
}

// Whether the four taps at (rx, ry) lie inside the block: floor in
// [0, k - 2] on both axes (2 <= k < 2^22). floor_int's integer is wrong
// only for |x| >= 2^22 (or NaN), and then never in that range, so no
// clamp is needed.
__device__ __forceinline__ bool taps_inside(float rx, float ry, int k) {
  int lx, ly;
  floor_int(rx, lx);
  floor_int(ry, ly);
  const unsigned last = static_cast<unsigned>(k - 2);
  return static_cast<unsigned>(lx) <= last &&
         static_cast<unsigned>(ly) <= last;
}

// block_tap for taps inside an inner block: the masks, clamps and row
// checks change nothing there and are left out; the same operations
// otherwise, so the same bits.
__device__ __forceinline__ void inner_tap(const BlockView& bv, int WA,
                                          float rx, float ry, float val[3]) {
  int lx, ly;
  const float fx = floor_int(rx, lx), fy = floor_int(ry, ly);
  const float wx1 = rx - fx, wy1 = ry - fy;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  float p00[3], p10[3], p01[3], p11[3];  // p<dx><dy>
  const uint8_t* q = bv.img + ((bv.sy + ly) * WA + bv.sx + lx) * 3;
  row_pair(q, true, true, p00, p10);
  row_pair(q + WA * 3, true, true, p01, p11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float row0 = wy0 * p00[c] + wy1 * p01[c];
    const float row1 = wy0 * p10[c] + wy1 * p11[c];
    val[c] = wx0 * row0 + wx1 * row1;
  }
}

// A window's held positions: rx[j], ry[j] of sample lane + 32 j (0 past
// s2), all loaded before any of its taps.
template <int kHeld>
__device__ __forceinline__ void held_positions(const float* __restrict__ rxp,
                                               const float* __restrict__ ryp,
                                               int s2, int lane,
                                               float (&rx)[kHeld],
                                               float (&ry)[kHeld]) {
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int s = lane + 32 * j;
    rx[j] = s < s2 ? __ldg(rxp + s) : 0.f;
    ry[j] = s < s2 ? __ldg(ryp + s) : 0.f;
  }
}

// The normalized window of one pair at the held positions, its samples
// held in registers: x[j] is sample lane + 32 j, 0 past s2. Lane sums by
// sample, one butterfly, the means' and the variance's divisions, and one
// division by sd a value, as the first kernels did (div_by gives the
// IEEE division's bits). kInner: every tap lies inside an inner block.
template <int kHeld, bool kInner>
__device__ __forceinline__ void held_window_at(
    const BlockView& bv, int H, int WA, int k, const float (&rx)[kHeld],
    const float (&ry)[kHeld], int s2, const WinConst& wc, int lane,
    float (&x)[kHeld][3]) {
  float m[3] = {};
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[j][c] = 0.f;
    if (lane + 32 * j < s2) {
      if (kInner)
        inner_tap(bv, WA, rx[j], ry[j], x[j]);
      else
        block_tap(bv, H, WA, k, rx[j], ry[j], x[j]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] += x[j][c];
  }
  warp_sum_n(m);
#pragma unroll
  for (int c = 0; c < 3; ++c) m[c] = div_by(m[c], wc.s2f, wc.rs2);
  float sq[1] = {0.f};
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = lane + 32 * j < s2 ? x[j][c] - m[c] : 0.f;
      x[j][c] = d;
      sq[0] += d * d;
    }
  }
  warp_sum_n(sq);
  float sd = sqrtf(div_by(sq[0], wc.n3, wc.rn3));
  if (sd == 0.f) sd = 1.f;
  const float y = 1.f / sd;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[j][c] = div_by(x[j][c], sd, y);
  }
}

// held_window_at, on the inner path where every tap of the window lies
// inside an inner block (a vote over the warp; the reference's block
// geometry puts every window there), else on the general one.
template <int kHeld>
__device__ __forceinline__ void held_window(const BlockView& bv, int H,
                                            int WA, int k,
                                            const float (&rx)[kHeld],
                                            const float (&ry)[kHeld],
                                            int s2, const WinConst& wc,
                                            int lane, float (&x)[kHeld][3]) {
  bool inner = bv.inner;
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (lane + 32 * j < s2) inner = inner && taps_inside(rx[j], ry[j], k);
  if (__all_sync(0xffffffffu, inner))
    held_window_at<kHeld, true>(bv, H, WA, k, rx, ry, s2, wc, lane, x);
  else
    held_window_at<kHeld, false>(bv, H, WA, k, rx, ry, s2, wc, lane, x);
}

// A window's moments for the recomputing path (kHeld = 0): per-channel
// means, sd (1 where the variance is 0) and RN(1 / sd).
struct BlockStats {
  float mean[3], sd, y;
};

__device__ __forceinline__ BlockStats block_stats(
    const BlockView& bv, int H, int WA, int k, const float* __restrict__ rxp,
    const float* __restrict__ ryp, int s2, const WinConst& wc, int lane) {
  BlockStats st;
  float m[3] = {};
  for (int s = lane; s < s2; s += 32) {
    float v[3];
    block_tap(bv, H, WA, k, __ldg(rxp + s), __ldg(ryp + s), v);
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] += v[c];
  }
  warp_sum_n(m);
#pragma unroll
  for (int c = 0; c < 3; ++c) st.mean[c] = div_by(m[c], wc.s2f, wc.rs2);
  float sq[1] = {0.f};
  for (int s = lane; s < s2; s += 32) {
    float v[3];
    block_tap(bv, H, WA, k, __ldg(rxp + s), __ldg(ryp + s), v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = v[c] - st.mean[c];
      sq[0] += d * d;
    }
  }
  warp_sum_n(sq);
  st.sd = sqrtf(div_by(sq[0], wc.n3, wc.rn3));
  if (st.sd == 0.f) st.sd = 1.f;
  st.y = 1.f / st.sd;
  return st;
}

// Normalized RGB of the sample at (rx, ry) of a window with moments st.
__device__ __forceinline__ void block_value(const BlockView& bv, int H,
                                            int WA, int k,
                                            const BlockStats& st, float rx,
                                            float ry, float val[3]) {
  block_tap(bv, H, WA, k, rx, ry, val);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    val[c] = div_by(val[c] - st.mean[c], st.sd, st.y);
}

// One warp writes n zeros from dst (4-byte aligned): 16-byte stores from
// the first 16-byte boundary on, single floats before and after it.
__device__ __forceinline__ void zero_fill(float* dst, int n, int lane) {
  const int skew = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  const int head = skew < n ? skew : n;
  if (lane < head) dst[lane] = 0.f;
  float4* body = reinterpret_cast<float4*>(dst + head);
  const int n4 = (n - head) / 4;
  for (int i = lane; i < n4; i += 32)
    body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tail = head + 4 * n4;
  if (tail + lane < n) dst[tail + lane] = 0.f;
}

// Arguments K2 and K4 do not take: an empty or too large window, a block
// of k < 1, an atlas plane of 2 GB or more.
__host__ inline bool block_args_bad(int H, int WA, int s2, int k) {
  return s2 < 1 || s2 > kBlockMaxWsize * kBlockMaxWsize || k < 1 ||
         3LL * H * WA >= (1LL << 31);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
__host__ inline cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cmvs
