"""Batched patch texture grabbing and NCC scoring.

Counterpart of cmvs_pmvs_tpu/ops/texture.py (reference optim.cpp:783-863
grabTex, :1031-1067 normalize, :1069-1088 dot) over [B, T] (patch, view)
batches with validity masks.

Sampling follows the reference package's block path (`_block_bilinear`,
texture.py:259-297): each (patch, view) window is read out of one
BLOCK_K x BLOCK_K pixel block whose origin sits one pixel before the
window's minimum corner; a bilinear tap that falls outside the block
gets weight 0. Inside the block this is plain bilinear interpolation.
`block_bilinear` is that sampler (grabTex's windows are
`block_bilinear` on the geometry of `grab_block_geometry`), used by the
plain versions of the windows and block-INCC kernels (ops/windows,
ops/incc).
"""
from __future__ import annotations

import math

import torch

from ..geom.cameras import CameraSet, project, unit3
from ..image.pyramid import PyramidSet

BLOCK_K = 20


def robustincc(x):
    """x / (1 + 3x) (optim.hpp:86-88)."""
    return x / (1.0 + 3.0 * x)


def unrobustincc(x):
    """x / (1 - 3x) (optim.hpp:90-92)."""
    return x / (1.0 - 3.0 * x)


def _cos(angle):
    return torch.cos(angle) if isinstance(angle, torch.Tensor) \
        else math.cos(angle)


def _grab_frame(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
                coord, pxaxis, pyaxis, pzaxis, views, view_valid,
                angle_threshold):
    """grabTex's geometry: projected frame, adaptive level, grabSafe gate
    (optim.cpp:815-843, :783-805). Returns (c2, dx2, dy2, newlevel, vid,
    ok) with c2/dx2/dy2 [B, T, 2] in newlevel pixels."""
    vid = views.clamp(min=0).long()
    margin = wsize // 2
    ray = unit3(cams.center[vid] - coord[:, None, :])
    weight = (ray[..., :3] * pzaxis[:, None, :3]).sum(-1)
    ok = view_valid & (weight >= _cos(angle_threshold))

    P = cams.P[vid]                                          # [B, T, 3, 4]
    center2 = project(P, coord[:, None, :], level)
    dx = project(P, (coord + pxaxis)[:, None, :], level) - center2
    dy = project(P, (coord + pyaxis)[:, None, :], level) - center2

    ratio = (torch.linalg.vector_norm(dx[..., :2], dim=-1)
             + torch.linalg.vector_norm(dy[..., :2], dim=-1)) / 2.0
    safe = torch.where(ratio > 0.0, ratio, torch.ones_like(ratio))
    leveldif = torch.floor(torch.log2(safe) + 0.5).to(torch.int64)
    newlevel = (level + leveldif.clamp(-level, 2)).clamp(
        0, pyr.num_levels - 1)
    scale = torch.pow(2.0, (newlevel - level).to(center2.dtype))[..., None]
    c2 = center2[..., :2] / scale
    dx2 = dx[..., :2] / scale
    dy2 = dy[..., :2] / scale

    span = (dx2.abs() + dy2.abs()) * margin
    minxy = c2 - span
    maxxy = c2 + span
    w = pyr.widths[newlevel, vid].to(c2.dtype)
    h = pyr.heights[newlevel, vid].to(c2.dtype)
    m2 = 3.0
    ok = ok & ((minxy[..., 0] >= m2) & (minxy[..., 1] >= m2)
               & (maxxy[..., 0] < w - 1 - m2)
               & (maxxy[..., 1] < h - 1 - m2))
    return c2, dx2, dy2, newlevel, vid, ok


def _sample_positions(c2, dx2, dy2, ok, wsize: int):
    """[B, T, S2, 2] sample positions (optim.cpp:846-862); invalid pairs
    sit at 3.0 so gathers stay in range."""
    margin = wsize // 2
    offs = torch.arange(wsize, dtype=c2.dtype, device=c2.device) - margin
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    gx = gx.reshape(-1)[:, None]
    gy = gy.reshape(-1)[:, None]
    pos = (c2[:, :, None, :] + gx * dx2[:, :, None, :]
           + gy * dy2[:, :, None, :])
    return torch.where(ok[..., None, None], pos, torch.full_like(pos, 3.0))


def _block_origin(pyr: PyramidSet, vid, newlevel, pos, k: int):
    """Block origin per (patch, view): one pixel before the window's
    minimum corner, clamped inside the level strip. Returns
    (sy, sx_atlas, relx, rely) with rel* [B, T, S2] block-relative."""
    start = torch.floor(pos.amin(dim=2)).to(torch.int64) - 1    # [B, T, 2]
    lvl_w = pyr.widths[newlevel, vid].long()
    lvl_h = pyr.heights[newlevel, vid].long()
    sx = torch.minimum(start[..., 0].clamp(min=0),
                       (lvl_w - k).clamp(min=0))
    sy = torch.minimum(start[..., 1].clamp(min=0),
                       (lvl_h - k).clamp(min=0))
    relx = pos[..., 0] - sx[..., None].to(pos.dtype)
    rely = pos[..., 1] - sy[..., None].to(pos.dtype)
    return sy, sx + pyr.xoff[newlevel].long(), relx, rely


def block_bilinear(atlas, n, sy, sx, relx, rely, k: int = BLOCK_K):
    """Bilinear RGB of block-relative positions inside the k x k block at
    atlas[n, sy:sy+k, sx:sx+k] (start clamped into the atlas, like the
    reference's CLIP-mode gather); taps outside [0, k) weigh 0.

    atlas [N, H, WA, 3] (any dtype); n/sy/sx [...]; rel* [..., S2].
    Returns [..., S2, 3] float32."""
    h, wa = atlas.shape[1], atlas.shape[2]
    n = n.long()[..., None]
    sy = sy.long().clamp(0, max(h - k, 0))[..., None]
    sx = sx.long().clamp(0, max(wa - k, 0))[..., None]
    fx = torch.floor(relx)
    fy = torch.floor(rely)
    lx = fx.long()
    ly = fy.long()
    wx1 = relx - fx
    wy1 = rely - fy
    zero = torch.zeros_like(wx1)

    def w(wgt, tap):
        return torch.where((tap >= 0) & (tap < k), wgt, zero)[..., None]

    wx0, wx1 = w(1.0 - wx1, lx), w(wx1, lx + 1)
    wy0, wy1 = w(1.0 - wy1, ly), w(wy1, ly + 1)

    def px(dx, dy):
        yy = (sy + ly + dy).clamp(0, h - 1)
        xx = (sx + lx + dx).clamp(0, wa - 1)
        return atlas[n, yy, xx].to(torch.float32)

    row0 = wy0 * px(0, 0) + wy1 * px(0, 1)
    row1 = wy0 * px(1, 0) + wy1 * px(1, 1)
    return wx0 * row0 + wx1 * row1


def grab_block_geometry(cams: CameraSet, pyr: PyramidSet, level: int,
                        wsize: int, coord, pxaxis, pyaxis, pzaxis, views,
                        view_valid, angle_threshold: float = math.pi / 3.0,
                        k: int = BLOCK_K):
    """Kernel-ready block geometry (texture.py:216-244). Returns
    (starts [B*T, 3] i32 (n, sy, sx_atlas), relx [B*T, S2],
    rely [B*T, S2], ok [B, T] bool)."""
    c2, dx2, dy2, newlevel, vid, ok = _grab_frame(
        cams, pyr, level, wsize, coord, pxaxis, pyaxis, pzaxis, views,
        view_valid, angle_threshold)
    pos = _sample_positions(c2, dx2, dy2, ok, wsize)
    b, t, s2, _ = pos.shape
    sy, sx, relx, rely = _block_origin(pyr, vid, newlevel, pos, k)
    starts = torch.stack([vid, sy, sx], -1).reshape(b * t, 3)
    return (starts.to(torch.int32), relx.reshape(b * t, s2).contiguous(),
            rely.reshape(b * t, s2).contiguous(), ok)


def normalize_tex(texs, valid):
    """Zero per-channel mean, unit global variance per window
    (optim.cpp:1031-1067); zeros where invalid."""
    s2 = texs.shape[-2]
    dev = texs - texs.mean(dim=-2, keepdim=True)
    std = torch.sqrt((dev * dev).sum(dim=(-2, -1)) / (3.0 * s2))
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    out = dev / std[..., None, None]
    return torch.where(valid[..., None, None], out, torch.zeros_like(out))


def ncc_dot(tex0, tex1):
    """Mean elementwise product over 3*S2 values (optim.cpp:1069-1077)."""
    s2 = tex0.shape[-2]
    return (tex0 * tex1).sum(dim=(-2, -1)) / (3.0 * s2)
