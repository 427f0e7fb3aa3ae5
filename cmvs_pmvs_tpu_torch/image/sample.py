"""Subpixel sampling out of the packed pyramid atlas.

Counterpart of cmvs_pmvs_tpu/image/sample.py: the reference's bilinear
getColor (image.hpp:434-471), its compile-time bicubic variant
(FURUKAWA_IMAGE_BICUBIC, image.hpp:282-433) and nearest-neighbour
getMask/getEdge (image.hpp:553-593) as gathers with a per-element level.
"""
from __future__ import annotations

import torch

from ..device import device_constant
from ..geom.cameras import project
from .pyramid import PyramidSet


def _atlas_gather(plane, n, xi, yi):
    """plane [N, H, WA(, C)]; integer gather with clamped indices."""
    h, wa = plane.shape[1], plane.shape[2]
    return plane[n, yi.clamp(0, h - 1), xi.clamp(0, wa - 1)]


def bilinear_at(atlas, n, x, y, xo=0):
    """Bilinear RGB [..., 3] float32 at pixel coords (x, y) of plane n of
    `atlas` (any dtype), the taps' columns shifted by the integer `xo`;
    indices clamped, not checked. The operation order is the one the
    fan kernel (csrc/fan2.cu) uses, so both round samples identically."""
    fx = torch.floor(x)
    fy = torch.floor(y)
    lx = fx.to(torch.int64) + xo
    ly = fy.to(torch.int64)
    dx1 = (x - fx)[..., None]
    dy1 = (y - fy)[..., None]
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1

    def px(xx, yy):
        return _atlas_gather(atlas, n, xx, yy).to(torch.float32)

    return (px(lx, ly) * dx0 * dy0 + px(lx + 1, ly) * dx1 * dy0
            + px(lx, ly + 1) * dx0 * dy1 + px(lx + 1, ly + 1) * dx1 * dy1)


def bilinear_color(pyr: PyramidSet, n, level, x, y):
    """Bilinear RGB at level-l pixel coords (x, y) of view n (the
    reference's getColor, image.hpp:434-471); [..., 3]."""
    return bilinear_at(pyr.atlas, n, x, y, pyr.xoff[level])


def _cubic_weights(p):
    """The reference's cubic-convolution (a = -1) weights of taps -1..2
    for fraction p (image.hpp:286-302)."""
    f0 = 1.0 + p
    w0 = ((-f0 + 5.0) * f0 - 8.0) * f0 + 4.0
    w1 = (p - 2.0) * p * p + 1.0
    f2 = 1.0 - p
    w2 = (f2 - 2.0) * f2 * f2 + 1.0
    f3 = 2.0 - p
    w3 = ((-f3 + 5.0) * f3 - 8.0) * f3 + 4.0
    return w0, w1, w2, w3


def bicubic_color(pyr: PyramidSet, n, level, x, y):
    """Bicubic RGB at level-l pixel coords (x, y) of view n: 4x4 cubic
    convolution (a = -1) around floor(x), floor(y), taps clamped into the
    atlas (the reference's FURUKAWA_IMAGE_BICUBIC getColor); [..., 3]."""
    fx = torch.floor(x)
    fy = torch.floor(y)
    ax = fx.to(torch.int64) + pyr.xoff[level]
    ly = fy.to(torch.int64)
    wx = _cubic_weights((x - fx)[..., None])
    wy = _cubic_weights((y - fy)[..., None])
    out = 0.0
    for j, wyj in enumerate(wy):
        row = 0.0
        for i, wxi in enumerate(wx):
            row = row + wxi * _atlas_gather(pyr.atlas, n, ax + i - 1,
                                            ly + j - 1).to(torch.float32)
        out = out + wyj * row
    return out


def _nearest_plane(plane, pyr: PyramidSet, n, level, x, y):
    """floor(v + 0.5) lookup; out of bounds passes (returns 1)."""
    xi = torch.floor(x + 0.5).to(torch.int64)
    yi = torch.floor(y + 0.5).to(torch.int64)
    w = pyr.widths[level, n]
    h = pyr.heights[level, n]
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    val = _atlas_gather(plane, n, xi + pyr.xoff[level], yi)
    return torch.where(inb, val, torch.ones_like(val))


def mask_at(pyr: PyramidSet, n, level, x, y):
    """Mask lookup (1.0 = in) at level-l pixel coords of view n."""
    return _nearest_plane(pyr.mask_atlas, pyr, n, level, x, y)


def edge_at(pyr: PyramidSet, n, level, x, y):
    return _nearest_plane(pyr.edge_atlas, pyr, n, level, x, y)


def mask_all(pyr: PyramidSet, cams_P, coord, level: int):
    """AND of all views' masks at the projections of coord [..., 4]
    (photoSetS.hpp:108-119). Returns [...] bool."""
    ic = project(cams_P, coord[..., None, :], level)        # [..., N, 3]
    ns = torch.arange(pyr.num_images, device=coord.device)
    val = _nearest_plane(pyr.mask_atlas, pyr, ns, level, ic[..., 0],
                         ic[..., 1])
    return (val > 0.0).all(dim=-1)


def inside_bimages(pyr: PyramidSet, P, coord, level: int,
                   bindexes: tuple):
    """insideBimages (findMatch.cpp:109-118); empty bindexes -> True."""
    if not bindexes:
        return torch.ones(coord.shape[:-1], dtype=torch.bool,
                          device=coord.device)
    bi = device_constant(tuple(bindexes), torch.int64, coord.device)
    ic = project(P[bi], coord[..., None, :], level)
    w = pyr.widths[level, bi].to(ic.dtype)
    h = pyr.heights[level, bi].to(ic.dtype)
    ok = ((ic[..., 0] >= 0.0) & (ic[..., 0] <= w - 1)
          & (ic[..., 1] >= 0.0) & (ic[..., 1] <= h - 1))
    return ok.all(dim=-1)
