// Fan-kernel ablations (K5, K6, K7): the refine-fan kernel cut into its
// stages - tile fetch, y-interpolation, x-fold, moments - one compile-time
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
// Layouts: K5 is K3's (csrc/fan.cu): one block per patch, one warp per
// view, the pair's tile staged byte by byte in shared memory once, probes
// in a loop. K6: one warp per (pair, probe) window, samples across lanes,
// taps read from the atlas in place. K7: one block per (patch, probe),
// one warp per view, taps read in place, warp-shuffle sums against view
// 0's window in shared memory.
//
// A cut mode does not do the work it cuts. Where a mode drops a result
// that the TPU kernel computed all the same (K5 dma_only's staged bytes,
// K6's tiny output, the windows K7 no_moments does not write), the result
// feeds a store guarded by `sink`, a kernel argument the host code always
// passes as 0: the compiler cannot drop the work, and nothing is stored.
//
// What bounds them on an H100: K5 and K7, the per-sample arithmetic (and
// K5's byte-wise tile staging); K6, its bytes: 8 B of positions read and
// 12 B of RGB written per sample against ~37 float operations.

#include "common.cuh"

namespace {

using cmvs::Tile;
using cmvs::hat;
using cmvs::tile_rgb;

struct TileCode {
  int n, ox, oy;
};

__device__ __forceinline__ TileCode decode_tile(int code, int N) {
  return {cmvs::clampi(code >> 20, 0, N - 1),
          (code & 0x3FF) * cmvs::kTileStride,
          ((code >> 10) & 0x3FF) * cmvs::kTileStride};
}

// ---- K5 --------------------------------------------------------------------

enum { kK5Full, kK5NoMoments, kK5WyOnly, kK5DmaOnly };

// out[b, v, f]: full, the robust INCC of window (b, v, f) vs (b, 0, f) from
// one-pass moments; no_moments, sample 0's R; wy_only, the y-interpolation
// of tile column 0's R at sample 0; dma_only, 0.
template <int MODE>
__global__ void fan_abl_kernel(const uint8_t* __restrict__ atlas, int N,
                               int H, int WA, const int* __restrict__ tilemap,
                               const float* __restrict__ geom,
                               float* __restrict__ out, int T, int fan,
                               int wsize, int sink) {
  extern __shared__ float sh[];
  const int s2 = wsize * wsize;
  float* mom = sh + T * s2 * 3;                          // [T][S 3, Ssq 3]
  uint8_t* tiles = reinterpret_cast<uint8_t*>(mom + T * 6);
  const int b = blockIdx.x;
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(b) * T + v;
  const TileCode tc = decode_tile(tilemap[pair], N);
  uint8_t* tile = tiles + v * cmvs::kTile * cmvs::kTileRow;
  unsigned staged = cmvs::stage_tile(tile, atlas, tc.n, H, WA, tc.ox, tc.oy,
                                     lane);
  __syncwarp();

  if constexpr (MODE == kK5DmaOnly) {
    staged = __reduce_add_sync(0xffffffffu, staged + tile[lane]);
    if (lane == 0)
      for (int f = 0; f < fan; ++f)
        out[pair * fan + f] = sink ? static_cast<float>(staged) : 0.f;
    return;
  }

  const Tile tl = cmvs::staged_tile(tile);
  const long long lines = static_cast<long long>(gridDim.x) * T * fan * 4;
  const int margin = wsize / 2;
  const float inv_s2 = 1.f / s2, inv_3s2 = 1.f / (3.f * s2);
  float* win = sh + v * s2 * 3;
  const float* ref = sh;                                 // warp 0's window
  for (int f = 0; f < fan; ++f) {
    const long long probe = pair * fan + f;
    const float* g = geom + probe * 4;    // row c of line u: g[c * lines + u]
    float S[3] = {0.f, 0.f, 0.f}, Q[3] = {0.f, 0.f, 0.f};
    for (int s = lane; s < s2; s += 32) {
      const float gx = static_cast<float>(s % wsize - margin);
      const float gy = static_cast<float>(s / wsize - margin);
      float lat[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* gc = g + c * lines;
        lat[c] = gc[0] + gx * gc[1] + gy * gc[2];
      }
      const float rx = lat[0] + lat[2], ry = lat[1] + lat[3];
      float val[3];
      if constexpr (MODE == kK5WyOnly) {
        const float fy = floorf(ry);
        const int ly = static_cast<int>(fy);
        const float wy0 = hat(ry - fy), wy1 = hat(ry - (fy + 1.f));
        float p0[3], p1[3];
        tile_rgb(tl, 0, ly, p0);
        tile_rgb(tl, 0, ly + 1, p1);
#pragma unroll
        for (int c = 0; c < 3; ++c) val[c] = wy0 * p0[c] + wy1 * p1[c];
      } else {
        cmvs::tile_bilinear(tl, rx, ry, val);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        win[s * 3 + c] = val[c];
        S[c] += val[c];
        Q[c] += val[c] * val[c];
      }
    }
    if constexpr (MODE != kK5Full) {
      __syncwarp();
      if (lane == 0) out[probe] = win[0];
      __syncwarp();  // the next probe overwrites the window
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        S[c] = cmvs::warp_sum(S[c]);
        Q[c] = cmvs::warp_sum(Q[c]);
      }
      if (lane == 0)
        for (int c = 0; c < 3; ++c) {
          mom[v * 6 + c] = S[c];
          mom[v * 6 + 3 + c] = Q[c];
        }
      __syncthreads();
      float X[3] = {0.f, 0.f, 0.f};
      for (int s = lane; s < s2; s += 32) {
#pragma unroll
        for (int c = 0; c < 3; ++c) X[c] += win[s * 3 + c] * ref[s * 3 + c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) X[c] = cmvs::warp_sum(X[c]);
      if (lane == 0) {
        const float* Sr = mom;
        const float* Qr = mom + 3;
        const float var_v =
            ((Q[0] + Q[1] + Q[2]) - (S[0] * S[0] + S[1] * S[1] + S[2] * S[2]) *
                                        inv_s2) * inv_3s2;
        const float var_r =
            ((Qr[0] + Qr[1] + Qr[2]) -
             (Sr[0] * Sr[0] + Sr[1] * Sr[1] + Sr[2] * Sr[2]) * inv_s2) *
            inv_3s2;
        const float istd_v =
            var_v <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var_v, 1e-20f));
        const float istd_r =
            var_r <= 0.f ? 1.f : 1.f / sqrtf(fmaxf(var_r, 1e-20f));
        const float cov =
            ((X[0] + X[1] + X[2]) -
             (Sr[0] * S[0] + Sr[1] * S[1] + Sr[2] * S[2]) * inv_s2) * inv_3s2;
        const float dot = cov * istd_r * istd_v;
        const float x = 1.f - dot;
        out[probe] = x / (1.f + 3.f * x);
      }
      __syncthreads();  // the next probe overwrites the windows and moments
    }
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

// full / no_expand: out[b, v, f, 0..8] = per channel the window sum S, the
// sum of squares and the cross-sum with window (b, 0, f); no_moments /
// body_only: out[group, f, s] = R of window (ppv group, 0, f < lead). The
// no_expand modes sample at lattice + 14 px instead of the frames.
template <int MODE>
__global__ void moments_abl_kernel(const uint8_t* __restrict__ atlas, int N,
                                   int H, int WA,
                                   const int* __restrict__ tilemap,
                                   const float* __restrict__ frames,
                                   float* __restrict__ out, int T, int fan,
                                   int wsize, int ppv, int lead, int sink) {
  constexpr bool kExpand = MODE == kK7Full || MODE == kK7NoMoments;
  constexpr bool kMoments = MODE == kK7Full || MODE == kK7NoExpand;
  extern __shared__ float ref[];                         // [s2][3], view 0
  const int s2 = wsize * wsize;
  const int margin = wsize / 2;
  const int b = blockIdx.x / fan, f = blockIdx.x % fan;
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(b) * T + v;
  const long long probe = pair * fan + f;
  const TileCode tc = decode_tile(tilemap[pair], N);
  const Tile tl = cmvs::atlas_tile(atlas, tc.n, H, WA, tc.ox, tc.oy);
  const float* fr = frames + probe * 6;

  float tex[2][3];                                       // s2 <= 64
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    tex[k][0] = tex[k][1] = tex[k][2] = 0.f;
    if (s >= s2) continue;
    const float gx = static_cast<float>(s % wsize - margin);
    const float gy = static_cast<float>(s / wsize - margin);
    const float rx = kExpand ? fr[0] + gx * fr[2] + gy * fr[4] : gx + 14.f;
    const float ry = kExpand ? fr[1] + gx * fr[3] + gy * fr[5] : gy + 14.f;
    cmvs::tile_bilinear(tl, rx, ry, tex[k]);
  }

  if constexpr (!kMoments) {
    const bool keep = b % ppv == 0 && v == 0 && f < lead;
    if (keep || sink) {
      const long long dst = (static_cast<long long>(b / ppv) * lead +
                             (keep ? f : 0)) * s2;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (lane + 32 * k < s2) out[dst + lane + 32 * k] = tex[k][0];
    }
    return;
  }

  if (v == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < s2)
        for (int c = 0; c < 3; ++c) ref[(lane + 32 * k) * 3 + c] = tex[k][c];
  }
  __syncthreads();
  float S[3], Q[3], X[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    S[c] = Q[c] = X[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = lane + 32 * k;
      const float r = s < s2 ? ref[s * 3 + c] : 0.f;
      S[c] += tex[k][c];
      Q[c] += tex[k][c] * tex[k][c];
      X[c] += tex[k][c] * r;
    }
    S[c] = cmvs::warp_sum(S[c]);
    Q[c] = cmvs::warp_sum(Q[c]);
    X[c] = cmvs::warp_sum(X[c]);
  }
  if (lane == 0) {
    float* o = out + probe * 9;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = S[c];
      o[3 + c] = Q[c];
      o[6 + c] = X[c];
    }
  }
}

}  // namespace

extern "C" int cmvs_fan_abl(const void* atlas, int N, int H, int WA,
                            const void* tilemap, const void* geom, void* out,
                            int B, int T, int fan, int wsize, int mode,
                            void* stream) {
  const int s2 = wsize * wsize;
  const size_t shmem =
      (static_cast<size_t>(T) * s2 * 3 + T * 6) * sizeof(float) +
      static_cast<size_t>(T) * cmvs::kTile * cmvs::kTileRow;
  void (*kernel)(const uint8_t*, int, int, int, const int*, const float*,
                 float*, int, int, int, int);
  switch (mode) {
    case kK5Full: kernel = fan_abl_kernel<kK5Full>; break;
    case kK5NoMoments: kernel = fan_abl_kernel<kK5NoMoments>; break;
    case kK5WyOnly: kernel = fan_abl_kernel<kK5WyOnly>; break;
    case kK5DmaOnly: kernel = fan_abl_kernel<kK5DmaOnly>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cmvs::allow_shared(kernel, shmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<B, 32 * T, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(tilemap), static_cast<const float*>(geom),
      static_cast<float*>(out), T, fan, wsize, /*sink=*/0);
  return static_cast<int>(cudaGetLastError());
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
  constexpr int kWarps = 8;
  const long long windows = static_cast<long long>(B) * T * fan;
  const unsigned blocks =
      static_cast<unsigned>((windows + kWarps - 1) / kWarps);
  kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(tilemap), static_cast<const float*>(rel),
      static_cast<float*>(out), windows, T, fan, s2, ppv, tiny, /*sink=*/0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cmvs_moments_abl(const void* atlas, int N, int H, int WA,
                                const void* tilemap, const void* frames,
                                void* out, int B, int T, int fan, int wsize,
                                int ppv, int lead, int mode, void* stream) {
  void (*kernel)(const uint8_t*, int, int, int, const int*, const float*,
                 float*, int, int, int, int, int, int);
  switch (mode) {
    case kK7Full: kernel = moments_abl_kernel<kK7Full>; break;
    case kK7NoMoments: kernel = moments_abl_kernel<kK7NoMoments>; break;
    case kK7NoExpand: kernel = moments_abl_kernel<kK7NoExpand>; break;
    case kK7BodyOnly: kernel = moments_abl_kernel<kK7BodyOnly>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shmem = static_cast<size_t>(wsize) * wsize * 3 * sizeof(float);
  kernel<<<static_cast<unsigned>(B) * fan, 32 * T, shmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(atlas), N, H, WA,
      static_cast<const int*>(tilemap), static_cast<const float*>(frames),
      static_cast<float*>(out), T, fan, wsize, ppv, lead, /*sink=*/0);
  return static_cast<int>(cudaGetLastError());
}
