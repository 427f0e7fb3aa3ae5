"""Batched patch texture grabbing and NCC scoring.

Counterpart of cmvs_pmvs_tpu/ops/texture.py (reference optim.cpp:783-863
grabTex, :1031-1067 normalize, :1069-1088 dot) over [B, T] (patch, view)
batches with validity masks.

Sampling follows the reference package's switches of the same names
(texture.py:23-28, :255):
  * SAMPLING = "bilinear" with _USE_BLOCK_SAMPLING (the defaults): the
    block path (`_block_bilinear`, texture.py:259-297). Each (patch,
    view) window is read out of one BLOCK_K x BLOCK_K pixel block whose
    origin sits one pixel before the window's minimum corner; a bilinear
    tap that falls outside the block gets weight 0. Inside the block this
    is plain bilinear interpolation. `block_bilinear` is that sampler
    (grabTex's windows are `block_bilinear` on the geometry of
    `grab_block_geometry`), used by the plain versions of the windows and
    block-INCC kernels (ops/windows, ops/incc);
  * _USE_BLOCK_SAMPLING = False: unblocked bilinear (`bilinear_color`),
    every tap read, clamped into the atlas - `block_bilinear(...,
    blocked=False)` on the same geometry, and the kernels' unblocked
    instantiations;
  * SAMPLING = "bicubic": the reference's FURUKAWA_IMAGE_BICUBIC
    (`bicubic_color`). No kernel samples bicubically, in the port as in
    the reference package; `grab_tex` is its only route.
`grab_tex` is the reference's grabTex under those switches. The kernels
run only while SAMPLING is "bilinear" (ops/refine._use_fan).
"""
from __future__ import annotations

import math

import torch

from ..geom.cameras import CameraSet, project, unit3
from ..image.pyramid import PyramidSet
from ..image.sample import bicubic_color, bilinear_color

BLOCK_K = 20
# Subpixel sampling: "bilinear" (the reference's default) or "bicubic"
# (its compile-time FURUKAWA_IMAGE_BICUBIC, image.hpp:282-433).
SAMPLING = "bilinear"
# Bilinear windows read from one BLOCK_K block per pair (True, the
# reference package's default) or tap by tap from the atlas (False).
_USE_BLOCK_SAMPLING = True
# Rows (patches) per grab batch on the paths that sample in plain torch or
# through the windows kernel: bounds the [B, T, S2, 3] buffers (8192 x 12
# views x 49 x 3 x 4 B ~ 58 MB; the bicubic grab's 16 taps a sample
# multiply its intermediates, so it is chunked the same way).
GRAB_CHUNK = 8192


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


def block_bilinear(atlas, n, sy, sx, relx, rely, k: int = BLOCK_K,
                   blocked: bool = True):
    """Bilinear RGB of block-relative positions of the k x k block at
    atlas[n, sy:sy+k, sx:sx+k]. blocked: the start clamped into the atlas
    (like the reference's CLIP-mode gather) and taps outside [0, k)
    weighing 0. Unblocked: the start as given and every tap read, clamped
    into the atlas plane - the reference's `bilinear_color` at atlas
    position (sx + relx, sy + rely).

    atlas [N, H, WA, 3] (any dtype); n/sy/sx [...]; rel* [..., S2].
    Returns [..., S2, 3] float32."""
    h, wa = atlas.shape[1], atlas.shape[2]
    n = n.long()[..., None]
    sy = sy.long()[..., None]
    sx = sx.long()[..., None]
    if blocked:
        sy = sy.clamp(0, max(h - k, 0))
        sx = sx.clamp(0, max(wa - k, 0))
    fx = torch.floor(relx)
    fy = torch.floor(rely)
    lx = fx.long()
    ly = fy.long()
    wx1 = relx - fx
    wy1 = rely - fy
    zero = torch.zeros_like(wx1)

    def w(wgt, tap):
        if not blocked:
            return wgt[..., None]
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


def grab_tex(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
             coord, pxaxis, pyaxis, pzaxis, views, view_valid,
             angle_threshold: float = math.pi / 3.0):
    """grabTex (optim.cpp:815-863, texture.py:105-133) for a [B, T] batch
    of (patch, view) pairs: the view-angle gate, the footprint-adaptive
    level, the margin-3 grabSafe check, then wsize^2 RGB samples by the
    SAMPLING / _USE_BLOCK_SAMPLING switches. coord/p*axis [B, 4]; views
    [B, T] i32; view_valid [B, T] bool. Returns (texs [B, T, S2, 3] f32,
    ok [B, T] bool); texs are unnormalized, and hold samples at 3.0 where
    not ok."""
    if SAMPLING not in ("bilinear", "bicubic"):
        raise ValueError(f"SAMPLING {SAMPLING!r}: 'bilinear' or 'bicubic'")
    c2, dx2, dy2, newlevel, vid, ok = _grab_frame(
        cams, pyr, level, wsize, coord, pxaxis, pyaxis, pzaxis, views,
        view_valid, angle_threshold)
    pos = _sample_positions(c2, dx2, dy2, ok, wsize)
    if SAMPLING == "bilinear" and _USE_BLOCK_SAMPLING:
        sy, sx, relx, rely = _block_origin(pyr, vid, newlevel, pos, BLOCK_K)
        return block_bilinear(pyr.atlas, vid, sy, sx, relx, rely), ok
    nl = newlevel[..., None].expand(pos.shape[:-1])
    nv = vid[..., None].expand(pos.shape[:-1])
    sample = bicubic_color if SAMPLING == "bicubic" else bilinear_color
    return sample(pyr, nv, nl, pos[..., 0], pos[..., 1]), ok


def normalize_tex(texs, valid):
    """Zero per-channel mean, unit global variance per window
    (optim.cpp:1031-1067); zeros where invalid.

    Only a variance of exactly 0 is guarded (the window stays its zero
    deviations), as in the reference. A window whose samples differ by
    their rounding alone (a flat region; unblocked taps all clamped onto
    one pixel) has a variance of rounding noise, so its values are that
    noise scaled up and depend on the order of operations: unspecified,
    beyond being finite with a sum of squares of 0 or 3 * S2. The kernels
    (csrc/common.cuh) give the same guarantee for such windows."""
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
