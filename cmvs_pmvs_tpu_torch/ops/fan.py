"""Refine-fan front end and the v1 fan INCC: kernel K3 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_fan.py. The LM fan path
(ops/refine._refine_patches_fan) evaluates, for every (patch, view) pair
and every probe of the fan, the robust INCC of the view's window against
the reference view's window at the same probe.

`grab_frames` is the shared front end of both fan kernels (v2: ops/fan2,
K1; v1: here, K3). It keeps the reference accelerator path's gates - the
60 deg cone, pyramid level chosen from probe 0, the margin-3 grabSafe
check and the tile-budget gate (span <= 8.5 px, pallas_fan.py:439-447) -
so the port marks exactly the pairs invalid that the JAX kernel path
marks, and it returns the probe-0 tile of every pair (pallas_fan.py:
449-468) as an atlas-pixel origin instead of the bit-packed tilemap.

What v1 computes beyond v2: every probe of a pair is sampled from the
one TILE_PX x TILE_PX tile chosen from probe 0; a bilinear tap outside
that tile weighs 0, and tile pixels past the atlas edge read 0 (the
reference's zero-padded `build_tiles`). `incc_fan_v1` launches the CUDA
kernel (csrc/fan.cu) for CUDA tensors - its uint8 or its float32
(gamma-decoded atlas) instantiation - and runs `incc_fan_v1_plain` for
CPU tensors.
"""
from __future__ import annotations

import torch

from ..geom.cameras import unit3
from . import kernels

TILE_PX = 32       # tile extent in px (pallas_fan.py:57)
TILE_STRIDE = 12   # tile origin stride in px (pallas_fan.py:58)
# Tile-budget gate of the reference kernel path: the window's half-span
# must stay <= (TILE_PX - TILE_STRIDE - 1) / 2 - 1 px (pallas_fan.py:
# 439-447), so probe 0's window always fits its tile.
SPAN_BUDGET = (TILE_PX - TILE_STRIDE - 1) / 2.0 - 1.0
# The largest window the fan kernels K1 and K3 take (csrc/common.cuh
# kFanMaxWsize); the plain versions take any.
MAX_WSIZE = 63


def check_fan_shape(name: str, t: int, wsize: int):
    """Raise on a view count or window the fan kernels do not take."""
    if not 1 <= t <= 32:
        raise ValueError(f"{name}: T={t} views, the kernel takes 1..32")
    if not 1 <= wsize <= MAX_WSIZE:
        raise ValueError(f"{name}: wsize={wsize}, the kernel takes "
                         f"1..{MAX_WSIZE}")


def tile_counts(h: int, wa: int) -> tuple[int, int]:
    """(TY, TX) tile-grid dims covering an [h, wa]-px atlas."""
    ty = max(1, -(-(h - TILE_PX) // TILE_STRIDE) + 1)
    tx = max(1, -(-(wa - TILE_PX) // TILE_STRIDE) + 1)
    return ty, tx


def grab_frames(cams, pyr, level: int, wsize: int, views, view_valid,
                coords_fan, normals_fan):
    """Per-(pair, probe) affine frames for the fan kernels.

    coords_fan/normals_fan: [fan, B, 4]; views/view_valid: [B, T].
    Returns (vid [B, T] i32, tile_org [B, T, 2] i32 = (x, y) atlas pixel
    of the pair's probe-0 tile, frames [B, T, fan, 6] f32 = orgx, orgy,
    dxx, dxy, dyx, dyy in atlas pixels of the chosen level (the level's
    xoff folded into orgx; zeros where invalid), ok [B, T, fan] bool)."""
    from .refine import _patch_axes
    fan, b = coords_fan.shape[:2]
    t = views.shape[1]
    vid = views.clamp(min=0).long()
    margin = wsize // 2
    ref = vid[:, 0]

    cf = coords_fan.reshape(fan * b, 4)
    nf = normals_fan.reshape(fan * b, 4)
    pxf, pyf = _patch_axes(cams, level, ref.repeat(fan), cf, nf)
    P = cams.P[vid]                                           # [B, T, 3, 4]
    ctr = cams.center[vid]                                    # [B, T, 4]

    def proj_all(pts):
        # [fan*b, 4] -> [fan, b, t, 2] level-space projections
        q = (P[None] * pts.reshape(fan, b, 1, 1, 4)).sum(-1)
        z = q[..., 2]
        bad = z <= 0.0
        zsafe = torch.where(bad, torch.ones_like(z), z)
        xy = q[..., :2] / (zsafe[..., None] * (2.0 ** level))
        return torch.where(bad[..., None], torch.full_like(xy, -65535.0),
                           xy), bad

    c2f, zbad = proj_all(cf)
    dxf = proj_all(cf + pxf)[0] - c2f
    dyf = proj_all(cf + pyf)[0] - c2f

    ray = unit3(ctr[None] - cf.reshape(fan, b, 1, 4))
    wgt = (ray[..., :3] * nf.reshape(fan, b, 1, 4)[..., :3]).sum(-1)
    okf = view_valid[None] & (wgt >= 0.5) & ~zbad             # cos 60 deg

    ratio = (torch.linalg.vector_norm(dxf[0], dim=-1)
             + torch.linalg.vector_norm(dyf[0], dim=-1)) / 2.0
    safe = torch.where(ratio > 0.0, ratio, torch.ones_like(ratio))
    leveldif = torch.floor(torch.log2(safe) + 0.5).long().clamp(-level, 2)
    newlevel = (level + leveldif).clamp(0, pyr.num_levels - 1)  # [B, T]
    scale = torch.pow(2.0, (newlevel - level).to(c2f.dtype))[None, ..., None]
    c2f = c2f / scale
    dxf = dxf / scale
    dyf = dyf / scale

    span = (dxf.abs() + dyf.abs()) * margin
    w = pyr.widths[newlevel, vid].to(c2f.dtype)[None]
    h = pyr.heights[newlevel, vid].to(c2f.dtype)[None]
    mn = c2f - span
    mx = c2f + span
    okf = okf & ((mn[..., 0] >= 3.0) & (mn[..., 1] >= 3.0)
                 & (mx[..., 0] < w - 1 - 3.0) & (mx[..., 1] < h - 1 - 3.0))
    okf = okf & (span[..., 0] <= SPAN_BUDGET) & (span[..., 1] <= SPAN_BUDGET)

    # enclosing tile from probe 0 (pallas_fan.py:449-460), x in atlas px
    x0 = pyr.xoff[newlevel].to(c2f.dtype)
    ty_n, tx_n = tile_counts(pyr.atlas.shape[1], pyr.atlas.shape[2])

    def tile_index(lo, count):
        i = torch.div(lo.clamp(min=0.0), TILE_STRIDE, rounding_mode="floor")
        return torch.nan_to_num(i, nan=0.0).clamp(0, count - 1).to(
            torch.int32) * TILE_STRIDE

    tile_org = torch.stack(
        [tile_index(c2f[0, ..., 0] + x0 - span[0, ..., 0] - 1.0, tx_n),
         tile_index(c2f[0, ..., 1] - span[0, ..., 1] - 1.0, ty_n)], -1)

    frames = torch.stack([c2f[..., 0] + x0[None], c2f[..., 1], dxf[..., 0],
                          dxf[..., 1], dyf[..., 0], dyf[..., 1]], -1)
    frames = torch.where(okf[..., None], frames, torch.zeros_like(frames))
    return (vid.to(torch.int32).contiguous(), tile_org.contiguous(),
            frames.permute(1, 2, 0, 3).contiguous(),
            okf.permute(1, 2, 0).contiguous())


def window_positions(frames, wsize: int):
    """Sample positions (x, y), each [..., S2], of the wsize x wsize
    lattice org + gx * d_x + gy * d_y of frames [..., 6]."""
    margin = wsize // 2
    s = torch.arange(wsize * wsize, device=frames.device)
    gx = (s % wsize - margin).to(torch.float32)
    gy = (s // wsize - margin).to(torch.float32)
    fr = frames[..., None, :]
    return (fr[..., 0] + gx * fr[..., 2] + gy * fr[..., 4],
            fr[..., 1] + gx * fr[..., 3] + gy * fr[..., 5])


def robust_incc_vs_ref(tex, ok):
    """Robust INCC of every window of tex [B, T, F, S2, 3] against view
    0's window at the same probe (two-pass moments); windows with ok
    [B, T, F] False count as all zeros. Returns [B, T, F] (unmasked)."""
    s2 = tex.shape[-2]
    tex = torch.where(ok[..., None, None], tex, torch.zeros_like(tex))
    dev = tex - tex.mean(dim=-2, keepdim=True)
    var = (dev * dev).sum(dim=(-2, -1)) / (3.0 * s2)         # [B, T, F]
    cov = (dev * dev[:, 0:1]).sum(dim=(-2, -1)) / (3.0 * s2)

    def istd(v):
        return torch.where(v <= 0.0, torch.ones_like(v),
                           torch.rsqrt(v.clamp(min=1e-20)))

    dot = cov * istd(var[:, 0:1]) * istd(var)
    xx = 1.0 - dot
    return xx / (1.0 + 3.0 * xx)


def tile_px(atlas, n, ox, oy, tx, ty):
    """RGB [..., 3] f32 of pixel (tx, ty) of the TILE_PX tile at atlas
    pixel (ox, oy) of view n (all int64, broadcast): 0 outside the tile
    or past the atlas edge (the v1 tile rule of csrc/common.cuh)."""
    h, wa = atlas.shape[1], atlas.shape[2]
    y = oy + ty
    x = ox + tx
    inside = ((tx >= 0) & (tx < TILE_PX) & (ty >= 0) & (ty < TILE_PX)
              & (y < h) & (x < wa))
    val = atlas[n, y.clamp(0, h - 1), x.clamp(0, wa - 1)]
    return torch.where(inside[..., None], val.to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=atlas.device))


def _tile_bilinear(atlas, n, org, rx, ry):
    """Bilinear RGB [..., 3] at tile-relative positions rx/ry of the
    TILE_PX tile at atlas[n, org_y:, org_x:]; taps outside the tile or
    past the atlas edge read 0. Operation order of csrc/fan.cu."""
    fx = torch.floor(rx)
    fy = torch.floor(ry)
    lx = fx.to(torch.int64)
    ly = fy.to(torch.int64)
    dx1 = (rx - fx)[..., None]
    dy1 = (ry - fy)[..., None]
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1
    ox = org[..., 0].long()
    oy = org[..., 1].long()

    def px(tx, ty):
        return tile_px(atlas, n, ox, oy, tx, ty)

    return (px(lx, ly) * dx0 * dy0 + px(lx + 1, ly) * dx1 * dy0
            + px(lx, ly + 1) * dx0 * dy1 + px(lx + 1, ly + 1) * dx1 * dy1)


def incc_fan_v1_plain(atlas, vid, tile_org, frames, ok, wsize: int):
    """Plain PyTorch version of the K3 kernel, same signature:
    atlas [N, H, WA, 3] u8 or f32, vid [B, T] i32, tile_org [B, T, 2] i32,
    frames [B, T, fan, 6] f32, ok [B, T, fan] bool -> incc [B, T, fan]
    f32 (unmasked; callers apply validity)."""
    x, y = window_positions(frames, wsize)                  # [B,T,F,S2]
    org = tile_org[:, :, None, None, :]
    n = vid.long().clamp(0, atlas.shape[0] - 1)[:, :, None, None]
    tex = _tile_bilinear(atlas, n, org, x - org[..., 0].to(x.dtype),
                         y - org[..., 1].to(y.dtype))
    return robust_incc_vs_ref(tex, ok)


def count_clipped(stats, tile_org, frames, ok, wsize: int):
    """Accumulate ok probes ("probes") and those whose window leaves the
    pair's probe-0 tile ("clipped"), as device scalars."""
    half = (wsize // 2) * (frames[..., 2:4].abs() + frames[..., 4:6].abs())
    rel = frames[..., 0:2] - tile_org[:, :, None, :].to(frames.dtype)
    out = ((rel - half) < 0.0) | ((rel + half) > TILE_PX - 1.0)
    clipped = out.any(dim=-1) & ok
    stats["probes"] = stats.get("probes", 0) + ok.sum()
    stats["clipped"] = stats.get("clipped", 0) + clipped.sum()


def incc_fan_v1(atlas, vid, tile_org, frames, ok, wsize: int):
    """Robust INCC of every (patch, view, probe) vs the patch's view-0
    window at the same probe, all probes of a pair sampled from its
    probe-0 tile; K3 on CUDA tensors (the instantiation for the atlas's
    dtype, uint8 or float32), `incc_fan_v1_plain` on CPU tensors. Shapes
    as in `incc_fan_v1_plain`."""
    if incc_fan_v1.clip_stats is not None:
        count_clipped(incc_fan_v1.clip_stats, tile_org, frames, ok, wsize)
    if not frames.is_cuda:
        return incc_fan_v1_plain(atlas, vid, tile_org, frames, ok, wsize)
    b, t, fan, _ = frames.shape
    dev = frames.device
    check_fan_shape("incc_fan_v1", t, wsize)
    n, h, wa = kernels.require_atlas(atlas, dev)
    entry = kernels.entry_for(incc_fan_v1.entries, atlas.dtype,
                              "incc_fan_v1")
    kernels.require(vid, "vid", torch.int32, (b, t), dev)
    kernels.require(tile_org, "tile_org", torch.int32, (b, t, 2), dev)
    kernels.require(frames, "frames", torch.float32, (b, t, fan, 6), dev)
    kernels.require(ok, "ok", torch.bool, (b, t, fan), dev)
    out = torch.empty((b, t, fan), dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    entry.launch((atlas.data_ptr(), n, h, wa, vid.data_ptr(),
                  tile_org.data_ptr(), frames.data_ptr(), ok.data_ptr(),
                  out.data_ptr(), b, t, fan, wsize),
                 (atlas, vid, tile_org, frames, ok, wsize), {})
    return out


# One instantiation an atlas dtype, each with its launch count and capture
# list (kernels.Entry; chip_smoke.py replays the captured launches of
# phases 5, 8, 9 and 13).
incc_fan_v1.entries = {
    torch.uint8: kernels.Entry("incc_fan_v1", "cmvs_fan_v1_incc"),
    torch.float32: kernels.Entry("incc_fan_v1_f32", "cmvs_fan_v1_incc_f32")}
# Opt-in diagnostic: set to a dict to accumulate, as device scalars, the
# ok probes ("probes") and those with a sample outside the pair's probe-0
# tile ("clipped") - the v1 rule gives such taps weight 0.
incc_fan_v1.clip_stats = None
