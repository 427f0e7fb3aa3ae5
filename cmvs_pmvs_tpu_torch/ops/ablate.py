"""Fan-kernel ablations: kernels K5, K6 and K7 and their plain versions.

Counterparts of the three Pallas TPU kernels of the ablation scripts:
`_fan_kernel_abl` (scripts/ablate_fan.py:28, K5), `_kernel_abl`
(scripts/ablate_fan2.py:34, K6) and `_kernel_abl`
(scripts/ablate_fan25.py:35, K7). Each cuts a refine-fan kernel into its
stages - tile fetch, y-interpolation, x-fold, moments - one mode per
cut, so that a timed sweep over the modes
(`python -m cmvs_pmvs_tpu_torch.scripts.ablate_fan`, `ablate_fan2`,
`ablate_fan25`) says where a fan kernel's time goes.

The inputs keep what the TPU kernels compute, not their layouts: the
uint8 atlas [N, H, WA, 3] and the packed tilemap [B, T] (v << 20 |
ty << 10 | tx per (patch, view) pair: the TILE_PX tile at atlas pixel
(12 tx, 12 ty) of view v) instead of pre-cut tiles, and no 128-lane
padding. Every tap obeys the v1 tile rule of ops/fan (outside the pair's
tile it weighs 0, past the atlas edge it reads 0). Taps weigh
max(0, 1 - |r - i|), the TPU kernels' hat weights, and combine y first,
then x, in the TPU kernels' order. Everything is float32; the TPU
kernels round wy (all three) and K5's x-weighted rows to bf16.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel (csrc/ablate.cu, one instantiation per mode) for CUDA
tensors, counting launches in `.launches`; a CUDA call at a shape the
kernel does not take raises (`check_fan_abl_shape`,
`check_moments_abl_shape`). K5 and K7 run on the body of the fan
kernels K1 and K3 (one warp per (patch, probe) walking the views, the
window in registers, taps read in place as 8-byte words), so their mode
sweeps split that body's time into stages. K6, whose samples stand
alone, streams them: a thread per run of four flat samples, positions and
rows as float4, its divisions by multiply-highs with the reciprocals of
`div_magic`, taps read as K5's.
"""
from __future__ import annotations

import torch

from . import kernels
from .fan import TILE_PX, TILE_STRIDE, tile_px, window_positions

# Mode names in the order of csrc/ablate.cu's mode enums.
FAN_ABL_MODES = ("full", "no_moments", "wy_only", "dma_only")
INTERP_ABL_MODES = ("full", "no_x", "no_mm", "wy_only", "no_fold",
                    "dma_only")
MOMENTS_ABL_MODES = ("full", "no_moments", "no_expand", "body_only")
# The largest window K5 takes (csrc/ablate.cu kK5MaxWsize; windows above
# 128 samples recompute their samples) and K7's sample limit (kK7MaxS2,
# the TPU harness's: the plain version holds to it too).
FAN_ABL_MAX_WSIZE = 63
MOMENTS_ABL_MAX_S2 = 64
# The most samples K6 takes (csrc/ablate.cu: a thread's run of kK6Run = 4
# sample indices stays below 2**31).
INTERP_ABL_MAX_SAMPLES = 2 ** 31 - 5


def check_fan_abl_shape(name: str, t: int, wsize: int):
    """Raise on a view count or window K5 does not take."""
    if not 1 <= t <= 32:
        raise ValueError(f"{name}: T={t} views, the kernel takes 1..32")
    if not 1 <= wsize <= FAN_ABL_MAX_WSIZE:
        raise ValueError(f"{name}: wsize={wsize}, the kernel takes "
                         f"1..{FAN_ABL_MAX_WSIZE}")


def check_moments_abl_shape(name: str, t: int, wsize: int):
    """Raise on a view count or window K7 does not take."""
    if not 1 <= t <= 32:
        raise ValueError(f"{name}: T={t} views, the kernel takes 1..32")
    if not 1 <= wsize * wsize <= MOMENTS_ABL_MAX_S2:
        raise ValueError(f"{name}: wsize={wsize}, the kernel takes windows "
                         f"of 1..{MOMENTS_ABL_MAX_S2} samples")


def _mode_index(modes, mode: str) -> int:
    if mode not in modes:
        raise ValueError(f"mode {mode!r}, expected one of {modes}")
    return modes.index(mode)


def decode_tilemap(atlas_u8, tilemap):
    """(n, ox, oy), int64 like tilemap: view (clamped into the atlas) and
    atlas-pixel origin of each packed tile code."""
    code = tilemap.long()
    n = (code >> 20).clamp(0, atlas_u8.shape[0] - 1)
    return (n, (code & 0x3FF) * TILE_STRIDE,
            ((code >> 10) & 0x3FF) * TILE_STRIDE)


def _hat(d):
    return torch.clamp(1.0 - d.abs(), min=0.0)


def tile_bilinear(atlas_u8, tile, rx, ry):
    """Bilinear RGB [..., 3] at tile-relative positions rx/ry [...] of the
    tiles `tile` = (n, ox, oy) (broadcast to rx): hat weights, y first,
    then x (csrc/ablate.cu `tile_sample`)."""
    fx = torch.floor(rx)
    fy = torch.floor(ry)
    lx = fx.to(torch.int64)
    ly = fy.to(torch.int64)
    wx0 = _hat(rx - fx)[..., None]
    wx1 = _hat(rx - (fx + 1.0))[..., None]
    wy0 = _hat(ry - fy)[..., None]
    wy1 = _hat(ry - (fy + 1.0))[..., None]

    def px(dx, dy):
        return tile_px(atlas_u8, *tile, lx + dx, ly + dy)

    row0 = wy0 * px(0, 0) + wy1 * px(0, 1)
    row1 = wy0 * px(1, 0) + wy1 * px(1, 1)
    return wx0 * row0 + wx1 * row1


def _lattice(wsize: int, device):
    margin = wsize // 2
    s = torch.arange(wsize * wsize, device=device)
    return ((s % wsize - margin).to(torch.float32),
            (s // wsize - margin).to(torch.float32))


# ---- K5: the v1 fan INCC from tiles (scripts/ablate_fan.py) ---------------

def fan_abl_positions(geom, b: int, t: int, fan: int, wsize: int):
    """K5's tile-relative sample positions (x, y), each [B, T, fan, S2]:
    the lattice origin + gx d_x + gy d_y of geom [4, B*T*fan*4] (rows x hi,
    y hi, x lo, y lo; per probe the lines origin, d_x, d_y, pad), hi + lo
    (scripts/ablate_fan.py:45-77)."""
    gx, gy = _lattice(wsize, geom.device)
    g = geom.reshape(4, b, t, fan, 4)[..., None]
    lat = g[..., 0, :] + gx * g[..., 1, :] + gy * g[..., 2, :]
    return lat[0] + lat[2], lat[1] + lat[3]


def one_pass_incc(tex):
    """Robust INCC [B, T, F] of every window of tex [B, T, F, S2, 3]
    against view 0's window at the same probe, from one-pass moments in
    the reference's order (scripts/ablate_fan.py:104-129)."""
    s2 = tex.shape[-2]
    inv_s2 = 1.0 / s2
    inv_3s2 = 1.0 / (3.0 * s2)
    S = tex.sum(dim=-2)                                      # [B, T, F, 3]
    Ssq = (tex * tex).sum(dim=-2)
    Sc = (tex * tex[:, 0:1]).sum(dim=-2)
    Sr = S[:, 0:1]

    def var_of(Ssum, Ssqv):
        return (Ssqv.sum(-1) - (Ssum * Ssum).sum(-1) * inv_s2) * inv_3s2

    def istd(v):
        return torch.where(v <= 0.0, torch.ones_like(v),
                           torch.rsqrt(v.clamp(min=1e-20)))

    var_v = var_of(S, Ssq)
    var_r = var_of(Sr, Ssq[:, 0:1])
    cov = (Sc.sum(-1) - (Sr * S).sum(-1) * inv_s2) * inv_3s2
    dot = cov * istd(var_r) * istd(var_v)
    x = 1.0 - dot
    return x / (1.0 + 3.0 * x)


def incc_fan_abl_plain(atlas_u8, tilemap, geom, *, fan: int, mode: str,
                       wsize: int = 7):
    """Plain PyTorch version of K5: atlas_u8 [N, H, WA, 3] u8, tilemap
    [B, T] i32, geom [4, B*T*fan*4] f32 -> [B, T, fan] f32:
      full        robust INCC vs view 0 from one-pass moments;
      no_moments  sample 0's R;
      wy_only     the y-interpolation of tile column 0's R at sample 0;
      dma_only    0."""
    _mode_index(FAN_ABL_MODES, mode)
    b, t = tilemap.shape
    if mode == "dma_only":
        return torch.zeros((b, t, fan), dtype=torch.float32,
                           device=geom.device)
    rx, ry = fan_abl_positions(geom, b, t, fan, wsize)
    n, ox, oy = decode_tilemap(atlas_u8, tilemap)
    if mode == "full":
        tile = (n[..., None, None], ox[..., None, None], oy[..., None, None])
        return one_pass_incc(tile_bilinear(atlas_u8, tile, rx, ry))
    tile = (n[..., None], ox[..., None], oy[..., None])
    rx, ry = rx[..., 0], ry[..., 0]
    if mode == "no_moments":
        return tile_bilinear(atlas_u8, tile, rx, ry)[..., 0]
    fy = torch.floor(ry)
    ly = fy.to(torch.int64)
    col0 = torch.zeros_like(ly)
    return (_hat(ry - fy) * tile_px(atlas_u8, *tile, col0, ly)[..., 0]
            + _hat(ry - (fy + 1.0))
            * tile_px(atlas_u8, *tile, col0, ly + 1)[..., 0])


def incc_fan_abl(atlas_u8, tilemap, geom, *, fan: int, mode: str,
                 wsize: int = 7):
    """K5 on CUDA tensors, `incc_fan_abl_plain` on CPU tensors; shapes
    and modes as there."""
    mode_id = _mode_index(FAN_ABL_MODES, mode)
    if not geom.is_cuda:
        return incc_fan_abl_plain(atlas_u8, tilemap, geom, fan=fan,
                                  mode=mode, wsize=wsize)
    b, t = tilemap.shape
    dev = geom.device
    check_fan_abl_shape("incc_fan_abl", t, wsize)
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(tilemap, "tilemap", torch.int32, (b, t), dev)
    kernels.require(geom, "geom", torch.float32, (4, b * t * fan * 4), dev)
    out = torch.empty((b, t, fan), dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    kernels.check(kernels.lib().cmvs_fan_abl(
        atlas_u8.data_ptr(), n, h, wa, tilemap.data_ptr(), geom.data_ptr(),
        out.data_ptr(), b, t, fan, wsize, mode_id, kernels.stream_handle()),
        "incc_fan_abl")
    incc_fan_abl.launches += 1
    return out


incc_fan_abl.launches = 0


# ---- K6: the v2 interpolation body (scripts/ablate_fan2.py) ---------------

def interp_abl_rows(mode: str) -> int:
    """Output rows of K6 in `mode`: tile columns 0-7 for no_fold, RGB
    otherwise."""
    return 8 if mode == "no_fold" else 3


def interp_abl_plain(atlas_u8, tilemap, rel, *, mode: str, ppv: int = 4,
                     tiny: bool = False):
    """Plain PyTorch version of K6: tilemap [B, T] i32, rel [2, B, T, fan,
    S2] f32 tile-relative sample positions (x, y) -> [R, B, T, fan, S2]
    f32 (R = `interp_abl_rows(mode)`):
      full      bilinear RGB;
      no_x      per channel, the sum over the TILE_PX tile columns of the
                y-interpolated rows;
      no_mm     sum_i wy[i] wx[i] over tile columns i, in every row;
      wy_only   row 0 the sum of the in-tile wy[i], rows 1-2 0;
      no_fold   row x = 0..7: wx[x] times the y-interpolation of column
                x's R;
      dma_only  0.
    tiny: only the first two windows, in (view, probe) order, of every
    group of ppv patches -> [R, B // ppv, min(2, T fan), S2] (the TPU
    harness's ABL_TINY_OUT, its first 128 lanes of every grid step)."""
    _mode_index(INTERP_ABL_MODES, mode)
    _, b, t, fan, s2 = rel.shape
    if tiny and b % ppv:
        raise ValueError(f"interp_abl: tiny output needs B={b} divisible "
                         f"by ppv={ppv}")
    rx, ry = rel[0], rel[1]
    tile = tuple(x[..., None, None] for x in decode_tilemap(atlas_u8,
                                                            tilemap))
    fy = torch.floor(ry)
    ly = fy.to(torch.int64)
    wy0 = _hat(ry - fy)
    wy1 = _hat(ry - (fy + 1.0))

    def yrow(x):
        col = torch.full_like(ly, x)
        return (wy0[..., None] * tile_px(atlas_u8, *tile, col, ly)
                + wy1[..., None] * tile_px(atlas_u8, *tile, col, ly + 1))

    zero = torch.zeros_like(rx)
    in0 = (ly >= 0) & (ly < TILE_PX)
    in1 = (ly + 1 >= 0) & (ly + 1 < TILE_PX)
    if mode == "full":
        out = tile_bilinear(atlas_u8, tile, rx, ry).movedim(-1, 0)
    elif mode == "no_x":
        acc = torch.zeros(rx.shape + (3,), device=rx.device)
        for x in range(TILE_PX):
            acc = acc + yrow(x)
        out = acc.movedim(-1, 0)
    elif mode == "no_mm":
        acc = (torch.where(in0, wy0 * _hat(rx - fy), zero)
               + torch.where(in1, wy1 * _hat(rx - (fy + 1.0)), zero))
        out = torch.stack([acc] * 3)
    elif mode == "wy_only":
        out = torch.stack([torch.where(in0, wy0, zero)
                           + torch.where(in1, wy1, zero), zero, zero])
    elif mode == "no_fold":
        out = torch.stack([yrow(x)[..., 0] * _hat(rx - float(x))
                           for x in range(8)])
    else:
        out = torch.zeros((3,) + rx.shape, device=rx.device)
    if tiny:
        out = out.reshape(out.shape[0], b, t * fan, s2)[:, ::ppv, :2]
    return out


def div_magic(d: int) -> tuple[int, int]:
    """The fixed-point reciprocal (m, l) by which K6 divides a sample
    index 0 <= n < 2**31 by d (csrc/ablate.cu `udiv`): n // d ==
    ((2 n m) >> 32) >> l, with l = ceil(log2 d) and m = ceil(2**(31 + l)
    / d) < 2**32."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"div_magic: divisor {d} outside 1..2**31 - 1")
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), l


def interp_abl_vector(rel, out, tiny: bool) -> bool:
    """Whether K6 reads its positions and writes its rows as float4: both
    planes of rel (and the rows of a full-size output) start on 16-byte
    boundaries, so the flat sample count must be a multiple of 4."""
    total = rel[0].numel()
    return (total % 4 == 0 and rel.data_ptr() % 16 == 0
            and (tiny or out.data_ptr() % 16 == 0))


def interp_abl_args(atlas_u8, tilemap, rel, out, mode_id: int, ppv: int,
                    tiny: bool) -> tuple:
    """The arguments of csrc/ablate.cu `cmvs_interp_abl` but the stream:
    pointers and shapes, the fixed-point reciprocals of the divisions by
    S2 fan (a sample's pair), S2 (its window), T fan (a window's patch) and
    ppv (a patch's group; tiny only), the tiny output's row length and
    the float4 choice."""
    n, h, wa, _ = atlas_u8.shape
    _, b, t, fan, s2 = rel.shape
    divs = (div_magic(s2 * fan), div_magic(s2), div_magic(t * fan),
            div_magic(ppv) if tiny else (0, 0))
    return (atlas_u8.data_ptr(), n, h, wa, tilemap.data_ptr(),
            rel.data_ptr(), out.data_ptr(), b * t * fan * s2, s2, t * fan,
            ppv, *(v for d in divs for v in d),
            out[0].numel() if tiny else 0,
            int(interp_abl_vector(rel, out, tiny)), int(tiny), mode_id)


def interp_abl(atlas_u8, tilemap, rel, *, mode: str, ppv: int = 4,
               tiny: bool = False):
    """K6 on CUDA tensors, `interp_abl_plain` on CPU tensors; shapes and
    modes as there. The kernel takes up to INTERP_ABL_MAX_SAMPLES
    samples."""
    mode_id = _mode_index(INTERP_ABL_MODES, mode)
    if not rel.is_cuda:
        return interp_abl_plain(atlas_u8, tilemap, rel, mode=mode, ppv=ppv,
                                tiny=tiny)
    _, b, t, fan, s2 = rel.shape
    dev = rel.device
    if tiny and b % ppv:
        raise ValueError(f"interp_abl: tiny output needs B={b} divisible "
                         f"by ppv={ppv}")
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(tilemap, "tilemap", torch.int32, (b, t), dev)
    kernels.require(rel, "rel", torch.float32, (2, b, t, fan, s2), dev)
    if rel[0].numel() > INTERP_ABL_MAX_SAMPLES:
        raise ValueError(f"interp_abl: {rel[0].numel()} samples, the "
                         f"kernel takes at most {INTERP_ABL_MAX_SAMPLES}")
    rows = interp_abl_rows(mode)
    shape = ((rows, b // ppv, min(2, t * fan), s2) if tiny
             else (rows, b, t, fan, s2))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    kernels.check(kernels.lib().cmvs_interp_abl(
        *interp_abl_args(atlas_u8, tilemap, rel, out, mode_id, ppv, tiny),
        kernels.stream_handle()), "interp_abl")
    interp_abl.launches += 1
    return out


interp_abl.launches = 0


# ---- K7: expansion, interpolation, moments (scripts/ablate_fan25.py) ------

def moments_abl_lead(fan: int) -> int:
    """Windows the no_moments modes write per group of ppv patches: the
    (patch, view 0) probes in the TPU harness's first 128 sample lanes
    (64 lanes a probe at fan >= 2, 128 at fan 1; S2 <= 64)."""
    return min(fan, 2)


def moments_abl_plain(atlas_u8, tilemap, frames, *, mode: str,
                      wsize: int = 7, ppv: int = 4):
    """Plain PyTorch version of K7: tilemap [B, T] i32, frames [B, T,
    fan, 6] f32 tile-relative (orgx, orgy, dxx, dxy, dyx, dyy); samples at
    org + gx d_x + gy d_y (the no_expand modes: at gx + 14, gy + 14):
      full, no_expand       [B, T, fan, 9]: per channel the window sum S,
                            the sum of squares and the cross-sum with the
                            patch's view-0 window at the same probe;
      no_moments, body_only [B // ppv, lead, S2]: channel 0 of windows
                            (ppv i, view 0, probe < lead), lead =
                            `moments_abl_lead(fan)`."""
    _mode_index(MOMENTS_ABL_MODES, mode)
    b, t, fan, _ = frames.shape
    if wsize * wsize > MOMENTS_ABL_MAX_S2:
        raise ValueError(f"moments_abl: wsize={wsize}, at most 8")
    if mode in ("full", "no_moments"):
        rx, ry = window_positions(frames, wsize)
    else:
        gx, gy = _lattice(wsize, frames.device)
        shape = (b, t, fan, wsize * wsize)
        rx, ry = (gx + 14.0).expand(shape), (gy + 14.0).expand(shape)
    tile = tuple(x[..., None, None] for x in decode_tilemap(atlas_u8,
                                                            tilemap))
    if mode in ("no_moments", "body_only"):
        if b % ppv:
            raise ValueError(f"moments_abl: B={b} not divisible by "
                             f"ppv={ppv}")
        lead = moments_abl_lead(fan)
        tile = tuple(x[::ppv, 0] for x in tile)
        return tile_bilinear(atlas_u8, tile, rx[::ppv, 0, :lead],
                             ry[::ppv, 0, :lead])[..., 0]
    tex = tile_bilinear(atlas_u8, tile, rx, ry)              # [B,T,F,S2,3]
    return torch.cat([tex.sum(dim=-2), (tex * tex).sum(dim=-2),
                      (tex * tex[:, 0:1]).sum(dim=-2)], -1)


def moments_abl(atlas_u8, tilemap, frames, *, mode: str, wsize: int = 7,
                ppv: int = 4):
    """K7 on CUDA tensors, `moments_abl_plain` on CPU tensors; shapes and
    modes as there."""
    mode_id = _mode_index(MOMENTS_ABL_MODES, mode)
    if not frames.is_cuda:
        return moments_abl_plain(atlas_u8, tilemap, frames, mode=mode,
                                 wsize=wsize, ppv=ppv)
    b, t, fan, _ = frames.shape
    dev = frames.device
    check_moments_abl_shape("moments_abl", t, wsize)
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(tilemap, "tilemap", torch.int32, (b, t), dev)
    kernels.require(frames, "frames", torch.float32, (b, t, fan, 6), dev)
    lead = moments_abl_lead(fan)
    if mode in ("full", "no_expand"):
        shape = (b, t, fan, 9)
    elif b % ppv:
        raise ValueError(f"moments_abl: B={b} not divisible by ppv={ppv}")
    else:
        shape = (b // ppv, lead, wsize * wsize)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    kernels.check(kernels.lib().cmvs_moments_abl(
        atlas_u8.data_ptr(), n, h, wa, tilemap.data_ptr(), frames.data_ptr(),
        out.data_ptr(), b, t, fan, wsize, ppv, lead, mode_id,
        kernels.stream_handle()), "moments_abl")
    moments_abl.launches += 1
    return out


moments_abl.launches = 0
