"""Refine-fan robust INCC: geometry front end, kernel K1 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_fan2.py (`incc_fan2`,
`fan_geometry2`, `_moments_tail2`) plus `grab_frames` from
cmvs_pmvs_tpu/ops/pallas_fan.py:362-474. The LM fan path
(ops/refine._refine_patches_fan) evaluates, for every (patch, view) pair
and every probe of the fan, the robust INCC of the view's window against
the reference view's window; `incc_fan` is that evaluation.

`grab_frames` keeps the reference accelerator path's gates - the 60 deg
cone, pyramid level chosen from probe 0, the margin-3 grabSafe check and
the tile-budget gate (span <= 8.5 px, pallas_fan.py:439-447) - so the
port marks exactly the pairs invalid that the JAX kernel path marks,
although no tile exists on the GPU.

`incc_fan` launches the CUDA kernel (csrc/fan2.cu) for CUDA tensors and
runs `incc_fan_plain` for CPU tensors. The kernel computes in float32
throughout; the reference's `precise` switch (bf16 rounding in its fast
mode) has no counterpart and is not accepted.
"""
from __future__ import annotations

import torch

from ..geom.cameras import unit3
from ..image.sample import bilinear_at
from . import kernels

# Tile-budget gate of the reference kernel path: the window's half-span
# must stay <= (TILE_PX - TILE_STRIDE - 1) / 2 - 1 px with the TPU's
# 32-px tiles at a 12-px stride (pallas_fan.py:57-58, :439-447).
SPAN_BUDGET = (32 - 12 - 1) / 2.0 - 1.0


def grab_frames(cams, pyr, level: int, wsize: int, views, view_valid,
                coords_fan, normals_fan):
    """Per-(pair, probe) affine frames for the fan kernel.

    coords_fan/normals_fan: [fan, B, 4]; views/view_valid: [B, T].
    Returns (vid [B, T] i32, frames [B, T, fan, 6] f32 = orgx, orgy,
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

    x0 = pyr.xoff[newlevel].to(c2f.dtype)[None]
    frames = torch.stack([c2f[..., 0] + x0, c2f[..., 1], dxf[..., 0],
                          dxf[..., 1], dyf[..., 0], dyf[..., 1]], -1)
    frames = torch.where(okf[..., None], frames, torch.zeros_like(frames))
    return (vid.to(torch.int32).contiguous(),
            frames.permute(1, 2, 0, 3).contiguous(),
            okf.permute(1, 2, 0).contiguous())


def _window_offsets(wsize: int, device):
    margin = wsize // 2
    s = torch.arange(wsize * wsize, device=device)
    return ((s % wsize - margin).to(torch.float32),
            (s // wsize - margin).to(torch.float32))


def incc_fan_plain(atlas_u8, vid, frames, ok, wsize: int):
    """Plain PyTorch version of the K1 kernel, same signature:
    atlas_u8 [N, H, WA, 3] u8, vid [B, T] i32, frames [B, T, fan, 6]
    f32, ok [B, T, fan] bool -> incc [B, T, fan] f32 (unmasked; callers
    apply validity)."""
    b, t, fan, _ = frames.shape
    s2 = wsize * wsize
    gx, gy = _window_offsets(wsize, frames.device)
    fr = frames[..., None, :]                                # [B,T,F,1,6]
    x = fr[..., 0] + gx * fr[..., 2] + gy * fr[..., 4]       # [B,T,F,S2]
    y = fr[..., 1] + gx * fr[..., 3] + gy * fr[..., 5]
    n = vid.long().clamp(0, atlas_u8.shape[0] - 1)[:, :, None, None]
    tex = bilinear_at(atlas_u8, n, x, y)                     # [B,T,F,S2,3]
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


def incc_fan(atlas_u8, vid, frames, ok, wsize: int):
    """Robust INCC of every (patch, view, probe) vs the patch's view-0
    window at the same probe; K1 on CUDA tensors, `incc_fan_plain` on CPU
    tensors. Shapes as in `incc_fan_plain`."""
    if not frames.is_cuda:
        return incc_fan_plain(atlas_u8, vid, frames, ok, wsize)
    b, t, fan, _ = frames.shape
    dev = frames.device
    if not 1 <= t <= 32:
        raise ValueError(f"incc_fan: T={t} views, the kernel takes 1..32")
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(vid, "vid", torch.int32, (b, t), dev)
    kernels.require(frames, "frames", torch.float32, (b, t, fan, 6), dev)
    kernels.require(ok, "ok", torch.bool, (b, t, fan), dev)
    out = torch.empty((b, t, fan), dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    lib = kernels.lib()
    kernels.check(lib.cmvs_fan_incc(
        atlas_u8.data_ptr(), n, h, wa, vid.data_ptr(), frames.data_ptr(),
        ok.data_ptr(), out.data_ptr(), b, t, fan, wsize,
        kernels.stream_handle()), "incc_fan")
    incc_fan.launches += 1
    return out


incc_fan.launches = 0
