"""Subpixel sampling out of the packed pyramid atlas.

Counterpart of cmvs_pmvs_tpu/image/sample.py: the reference's bilinear
getColor (image.hpp:434-471) and nearest-neighbour getMask/getEdge
(image.hpp:553-593) as gathers with a per-element level. Bicubic
sampling is not ported yet.
"""
from __future__ import annotations

import torch

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


def _nearest_plane(plane, pyr: PyramidSet, n, level, x, y):
    """floor(v + 0.5) lookup; out of bounds passes (returns 1)."""
    xi = torch.floor(x + 0.5).to(torch.int64)
    yi = torch.floor(y + 0.5).to(torch.int64)
    w = pyr.widths[level, n]
    h = pyr.heights[level, n]
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    val = _atlas_gather(plane, n, xi + pyr.xoff[level], yi)
    return torch.where(inb, val, torch.ones_like(val))


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
    bi = torch.as_tensor(bindexes, dtype=torch.int64, device=coord.device)
    ic = project(P[bi], coord[..., None, :], level)
    w = pyr.widths[level, bi].to(ic.dtype)
    h = pyr.heights[level, bi].to(ic.dtype)
    ok = ((ic[..., 0] >= 0.0) & (ic[..., 0] <= w - 1)
          & (ic[..., 1] >= 0.0) & (ic[..., 1] <= h - 1))
    return ok.all(dim=-1)
