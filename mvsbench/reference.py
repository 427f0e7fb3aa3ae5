"""The plain reference that judges a reconstruction.

It imports nothing of the program. From the images and cameras the
benchmark wrote, and from the scene's true geometry (scene.py), it works
out again what the program's run produced, and reads the program's
written files with readers of its own:

- the image pyramid that loading builds (PMVS2's image.cpp: each level
  a 4x4 {1,3,3,1}^2/64 stride-2 downsample of the one before, which
  skips the last row and column, renormalizes at the borders and rounds
  to the byte grid), compared with the program's atlas;
- the .ply colours: the mean bilinear colour of each patch's projection
  into its images at the run's level (patchOrganizerS.cpp:722-734),
  recomputed from the .patch file's positions and images;
- the files read back: .patch, .ply and .pset against each other and
  against the program's final cloud;
- each patch's photo-consistency score: the weighted, robust mean NCC
  of its reference view's window against those of its first tau listed
  views, recomputed at the written position and normal from the
  reference's own pyramid (optim.cpp's getPAxes, grabTex, normalize,
  computeINCC), against the score the .patch file gives;
- coverage against the true surface: how much of the surface that
  three cameras see has a patch near it.

Every function takes the dtype it computes in: float64 for the check,
bfloat16 for the lower-precision control (control.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import scene as S

_K1 = (1.0, 3.0, 3.0, 1.0)


# ---- the written files ----

def read_patch(path: str) -> dict:
    """The .patch file's cloud: coord/normal [P, 4], ncc/dscale/ascale
    [P] float64, images/vimages as lists of id lists."""
    with open(path) as f:
        tok = f.read().split()
    if tok[0] != "PATCHES":
        raise ValueError(f"{path}: no PATCHES header")
    num = int(tok[1])
    heads = np.empty((num, 11))
    images, vimages = [], []
    i = 2
    for p in range(num):
        if tok[i] != "PATCHS":
            raise ValueError(f"{path}: patch {p} has header {tok[i]}")
        heads[p] = tok[i + 1:i + 12]
        i += 12
        k = int(tok[i])
        images.append([int(t) for t in tok[i + 1:i + 1 + k]])
        i += 1 + k
        k = int(tok[i])
        vimages.append([int(t) for t in tok[i + 1:i + 1 + k]])
        i += 1 + k
    if i != len(tok):
        raise ValueError(f"{path}: {len(tok) - i} tokens after the patches")
    return {"coord": heads[:, 0:4], "normal": heads[:, 4:8],
            "ncc": heads[:, 8], "dscale": heads[:, 9], "ascale": heads[:, 10],
            "images": images, "vimages": vimages}


def read_ply(path: str) -> np.ndarray:
    """The ASCII .ply's vertex rows [P, 10]: x y z nx ny nz r g b
    quality."""
    with open(path) as f:
        text = f.read()
    head, sep, body = text.partition("end_header\n")
    if not sep or not head.startswith("ply\nformat ascii 1.0\n"):
        raise ValueError(f"{path}: not an ASCII PLY")
    n = next(int(line.split()[2]) for line in head.splitlines()
             if line.startswith("element vertex"))
    rows = np.array(body.split(), dtype=np.float64)
    if rows.size != n * 10:
        raise ValueError(f"{path}: {rows.size} values for {n} vertices")
    return rows.reshape(n, 10)


def read_pset(path: str) -> np.ndarray:
    """The .pset's rows [P, 6]: x y z nx ny nz."""
    with open(path) as f:
        rows = np.array(f.read().split(), dtype=np.float64)
    if rows.size % 6:
        raise ValueError(f"{path}: {rows.size} values, not rows of 6")
    return rows.reshape(-1, 6)


def padded(ids: list, width: int) -> np.ndarray:
    """Id lists as a [P, width] int64 array, -1 padded."""
    out = np.full((len(ids), width), -1, np.int64)
    for p, row in enumerate(ids):
        out[p, :len(row)] = row
    return out


def file_misses(patch: dict, ply: np.ndarray, pset: np.ndarray,
                cloud: dict) -> int:
    """Patches whose values differ between the three files or from the
    program's final cloud `cloud` (its alive rows in order: float32
    coord/normal [P, 4], ncc/dscale/ascale [P], images/vimages [P, K] as
    on disk, -1 padded); a file with another patch count counts every
    patch of the larger. Text holds float32 values exactly (%.17g and
    %.9g both round-trip), so any difference is a miss."""
    n = len(cloud["ncc"])
    counts = (len(patch["ncc"]), len(ply), len(pset))
    if any(c != n for c in counts):
        return max(n, *counts)

    def f32(a):
        return np.asarray(a, np.float64).astype(np.float32)

    miss = np.zeros(n, bool)
    for name in ("coord", "normal"):
        miss |= (f32(patch[name]) != cloud[name]).any(1)
    for name in ("ncc", "dscale", "ascale"):
        miss |= f32(patch[name]) != cloud[name]
    k = cloud["images"].shape[1]
    miss |= (padded(patch["images"], k) != cloud["images"]).any(1)
    miss |= (padded(patch["vimages"], k) != cloud["vimages"]).any(1)
    miss |= (f32(ply[:, 0:3]) != cloud["coord"][:, :3]).any(1)
    miss |= (f32(ply[:, 3:6]) != cloud["normal"][:, :3]).any(1)
    miss |= f32(ply[:, 9]) != cloud["ncc"]
    miss |= (f32(pset[:, 0:3]) != cloud["coord"][:, :3]).any(1)
    miss |= (f32(pset[:, 3:6]) != cloud["normal"][:, :3]).any(1)
    return int(miss.sum())


# ---- the image pyramid ----

def downsample(img: torch.Tensor, dtype) -> torch.Tensor:
    """One level of PMVS2's pyramid from the level before, [N, H, W, 3]:
    taps on the last row and column are not used, the weights of the
    used taps renormalize the sum, the result rounds to the byte grid."""
    n, h, w, c = img.shape
    oh, ow = h // 2, w // 2
    img = img.to(dtype)
    pad = img.new_zeros((n, 2 * oh + 3, 2 * ow + 3, c))
    val = img.new_zeros((n, 2 * oh + 3, 2 * ow + 3))
    hh, ww = min(h - 1, 2 * oh + 2), min(w - 1, 2 * ow + 2)
    pad[:, 1:1 + hh, 1:1 + ww] = img[:, :hh, :ww]
    val[:, 1:1 + hh, 1:1 + ww] = 1.0
    num = img.new_zeros((n, oh, ow, c))
    den = img.new_zeros((n, oh, ow))
    for i in range(4):
        for j in range(4):
            wgt = _K1[i] * _K1[j] / 64.0
            num = num + wgt * pad[:, i:i + 2 * oh:2, j:j + 2 * ow:2]
            den = den + wgt * val[:, i:i + 2 * oh:2, j:j + 2 * ow:2]
    out = num / den.clamp(min=1e-30)[..., None]
    return torch.where(den[..., None] > 0, torch.floor(out + 0.5),
                       torch.zeros_like(out))


def pyramid(images: torch.Tensor, levels: int, dtype) -> list:
    """The `levels` levels of every image, level 0 the images."""
    out = [images.to(dtype)]
    for _ in range(1, levels):
        out.append(downsample(out[-1], dtype))
    return out


def pyramid_gap(levels: list, atlas: torch.Tensor, widths, heights,
                xoff) -> float:
    """Largest |difference| in grey levels between the reference's levels
    and the program's atlas [N, H0, WA, 3] at its level offsets `xoff`;
    inf where the program's level sizes differ from the reference's."""
    gap = 0.0
    for lv, ref in enumerate(levels):
        n, h, w, _ = ref.shape
        if (list(widths[lv]) != [w] * n) or (list(heights[lv]) != [h] * n):
            return math.inf
        x0 = int(xoff[lv])
        got = atlas[:, :h, x0:x0 + w].to(torch.float64)
        gap = max(gap, float((got - ref.to(torch.float64)).abs().max()))
    return gap


# ---- projections and colours ----

def project(P: torch.Tensor, X: torch.Tensor, level: int) -> torch.Tensor:
    """Pixel coordinates [..., 2] at `level` of points X [..., 3] through
    projections P broadcasting against X's leading dims."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    v = (P * Xh[..., None, :]).sum(-1)
    return v[..., :2] / v[..., 2:3] / (2.0 ** level)


def bilinear(img: torch.Tensor, n, x, y) -> torch.Tensor:
    """Bilinear RGB of level images img [N, H, W, 3] at (x, y) of image n,
    taps clamped into the image."""
    _, h, w, _ = img.shape
    fx, fy = torch.floor(x), torch.floor(y)
    dx, dy = (x - fx)[..., None], (y - fy)[..., None]
    lx, ly = fx.long(), fy.long()

    def px(xx, yy):
        return img[n, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    return (px(lx, ly) * (1 - dx) * (1 - dy) + px(lx + 1, ly) * dx * (1 - dy)
            + px(lx, ly + 1) * (1 - dx) * dy + px(lx + 1, ly + 1) * dx * dy)


def colors(level_img: torch.Tensor, P: torch.Tensor, coord: torch.Tensor,
           images: torch.Tensor, level: int, dtype) -> torch.Tensor:
    """Each patch's mean colour over its images ([P, K] image indices, -1
    padded) at `level`, rounded and clipped as the .ply stores it."""
    P = P.to(dtype)
    coord = coord.to(dtype)
    img = level_img.to(dtype)
    ok = images >= 0
    vid = images.clamp(min=0)
    ic = project(P[vid], coord[:, None, :], level)
    col = bilinear(img, vid, ic[..., 0], ic[..., 1])
    col = torch.where(ok[..., None], col, torch.zeros_like(col))
    mean = col.sum(1) / ok.sum(1).clamp(min=1)[:, None].to(dtype)
    return torch.floor(mean.to(torch.float64) + 0.5).clamp(0, 255)


# ---- photo-consistency ----

def cameras(P: torch.Tensor):
    """(centres [N, 3], x axes [N, 3], pixel scales [N]) of projections
    P [N, 3, 4] as PMVS2 derives them (camera.cpp:109-136,
    optim.cpp:43-64), in float64."""
    P = P.to(torch.float64)
    z = P[:, 2, :3] / torch.linalg.vector_norm(P[:, 2, :3], dim=-1,
                                               keepdim=True)
    C = torch.linalg.solve(P[:, :, :3], -P[:, :, 3:])[..., 0]
    y = torch.linalg.cross(z, P[:, 0, :3])
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    x = torch.linalg.cross(y, z)
    scale = (x * P[:, 0, :3]).sum(-1) + (y * P[:, 1, :3]).sum(-1)
    return C, x, scale


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def ncc_scores(levels: list, P: torch.Tensor, coord: torch.Tensor,
               normal: torch.Tensor, images: torch.Tensor, level: int,
               wsize: int, tau: int, dtype, chunk: int = 8192):
    """Each patch's score (optim.cpp:652, computeINCC :875-938): the
    patch's wsize x wsize lattice, one pixel a step in its reference view
    (its first listed image), is sampled bilinearly in each of its first
    `tau` listed views ([P, K] indices, -1 padded) at the level its
    footprint picks (at most two above `level`); each window is
    normalized (zero mean a channel, unit variance); a view's NCC is its
    mean product with the reference's window. Score = 1 - unrobust(mean
    of robust(1 - NCC) over the other views, weighted by min(1, the
    reference's pixel footprint over the view's)), 1.4 where no view
    counts. `levels` is the pyramid, [N, H_l, W_l, 3] a level. Returns
    [P] in float64."""
    out = [torch.empty(0, dtype=torch.float64, device=coord.device)]
    for s in range(0, coord.shape[0], chunk):
        out.append(_ncc_chunk(levels, P, coord[s:s + chunk],
                              normal[s:s + chunk], images[s:s + chunk],
                              level, wsize, tau, dtype))
    return torch.cat(out)


def _ncc_chunk(levels, P, coord, normal, images, level, wsize, tau, dtype):
    C, xaxis, scale = (t.to(dtype) for t in cameras(P))
    P, X, n = P.to(dtype), coord.to(dtype), normal.to(dtype)
    lv = 2.0 ** level
    views = images[:, :tau]
    valid = views >= 0
    vid = views.clamp(min=0)
    ref = vid[:, 0]

    def unit(idx, pt):          # getUnit: one pixel's footprint at pt
        return 2.0 * _norm(pt - C[idx]) * lv / scale[idx]

    def proj(Pm, pt):
        return project(Pm, pt, level)

    # getPAxes: the tangent frame, one reference pixel a step
    y3 = torch.linalg.cross(n, xaxis[ref])
    y3 = y3 / _norm(y3)[:, None]
    x3 = torch.linalg.cross(y3, n)
    pscale = unit(ref, X)[:, None]
    px, py = x3 * pscale, y3 * pscale
    pc = proj(P[ref], X)
    for ax in (px, py):
        d = _norm(proj(P[ref], X + ax) - pc)
        ax /= torch.where(d == 0, torch.ones_like(d), d)[:, None]

    # grabTex: angle gate, footprint level, margin, lattice
    Xb = X[:, None, :]
    ray = C[vid] - Xb
    ray = ray / _norm(ray)[..., None]
    facing = (ray * n[:, None, :]).sum(-1)
    ok = valid & (facing >= 0.5)
    Pv = P[vid]
    c2 = proj(Pv, Xb)
    dx = proj(Pv, Xb + px[:, None, :]) - c2
    dy = proj(Pv, Xb + py[:, None, :]) - c2
    ratio = (_norm(dx) + _norm(dy)) / 2.0
    ratio = torch.where(ratio > 0, ratio, torch.ones_like(ratio))
    shift = torch.floor(torch.log2(ratio.double()) + 0.5).long()
    top = len(levels) - 1
    newl = (level + shift.clamp(-level, 2)).clamp(0, top)
    f = (2.0 ** (newl - level)).to(dtype)[..., None]
    c2, dx, dy = c2 / f, dx / f, dy / f
    span = (dx.abs() + dy.abs()) * (wsize // 2)
    lo, hi = c2 - span, c2 + span
    wl = torch.tensor([lev.shape[2] for lev in levels], device=X.device)
    hl = torch.tensor([lev.shape[1] for lev in levels], device=X.device)
    ok = ok & (lo >= 3).all(-1) & (hi[..., 0] < (wl[newl] - 4).to(dtype)) \
        & (hi[..., 1] < (hl[newl] - 4).to(dtype))
    offs = torch.arange(wsize, device=X.device, dtype=dtype) - wsize // 2
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    pos = (c2[..., None, :] + gx.reshape(-1, 1) * dx[..., None, :]
           + gy.reshape(-1, 1) * dy[..., None, :])
    s2 = pos.shape[-2]
    tex = torch.zeros(pos.shape[:-1] + (3,), dtype=dtype, device=X.device)
    for lev in range(top + 1):
        m = ok & (newl == lev)
        if bool(m.any()):
            nid = vid[m][:, None].expand(-1, s2)
            tex[m] = bilinear(levels[lev].to(dtype), nid, pos[m][..., 0],
                              pos[m][..., 1])

    # normalize, NCC against the reference's window
    dev = tex - tex.mean(-2, keepdim=True)
    std = torch.sqrt((dev * dev).sum((-2, -1)) / (3.0 * s2))
    dev = dev / torch.where(std == 0, torch.ones_like(std), std)[..., None,
                                                                  None]
    ncc = (dev[:, :1] * dev).sum((-2, -1)) / (3.0 * s2)

    # computeINCC: robust, footprint-weighted mean over the other views
    fine = torch.where(facing > 0, unit(vid, Xb) / torch.where(
        facing > 0, facing, torch.ones_like(facing)),
        torch.full_like(facing, 1e10))
    fine = torch.where(valid, fine, torch.full_like(fine, 1e10))
    pair = ok & ok[:, :1]
    pair[:, 0] = False
    w = torch.where(pair, (fine[:, :1] / fine).clamp(max=1.0),
                    torch.zeros_like(fine))
    x = 1.0 - ncc
    incc = torch.where(pair, x / (1.0 + 3.0 * x), torch.full_like(x, 2.0))
    total = w.sum(-1)
    none = (total == 0) | ~ok[:, 0]
    score = (incc * w).sum(-1) / torch.where(none, torch.ones_like(total),
                                             total)
    score = torch.where(none, torch.full_like(score, 2.0), score)
    return (1.0 - score / (1.0 - 3.0 * score)).to(torch.float64)


# ---- against the true surface ----

def sees(boxes, P: torch.Tensor, C: torch.Tensor, X: torch.Tensor,
         width: int, height: int, slack: torch.Tensor,
         margin: float = 3.0) -> torch.Tensor:
    """Whether cameras (P [..., 3, 4], centres C [..., 3]) see points X
    [..., 3]: the point projects inside the level-0 image by `margin`
    pixels and no surface lies on its ray more than `slack` (world units)
    before it."""
    xy = project(P, X, 0)
    v = (P[..., 2, :3] * X).sum(-1) + P[..., 2, 3]
    inside = ((v > 0) & (xy[..., 0] >= margin) & (xy[..., 1] >= margin)
              & (xy[..., 0] <= width - 1 - margin)
              & (xy[..., 1] <= height - 1 - margin))
    d = X - C
    dist = torch.linalg.vector_norm(d, dim=-1)
    t = S.ray_depth(boxes, C, d)
    return inside & (t * dist >= dist - slack)


def coverage(boxes, P, C, K_focal: float, width: int, height: int,
             coord: torch.Tensor, pixels: torch.Tensor, level: int,
             csize: int, min_views: int, block: int = 512):
    """(covered, reconstructable) true surface points. `pixels` [M, 3]
    (image, x, y) pick level-0 pixels whose rays' first hits are the
    points; a point is reconstructable where `min_views` cameras see it
    (`sees`, within 1e-6 of its depth) at less than 60 degrees from the
    true normal, and covered where a patch lies within 1.5 patch
    spacings of it (csize * 2^level pixels at its depth in the image it
    was drawn from)."""
    n = P.shape[0]
    img = pixels[:, 0].long()
    Kinv = torch.linalg.inv(P[img, :, :3])
    uv1 = torch.stack([pixels[:, 1], pixels[:, 2],
                       torch.ones_like(pixels[:, 1])], -1).to(P.dtype)
    d = (Kinv @ uv1[..., None])[..., 0]
    t = S.ray_depth(boxes, C[img], d)
    hit = torch.isfinite(t)
    X = C[img] + t[:, None] * d
    X, img = X[hit], img[hit]
    true_n = S.surface_normal(boxes, X)
    cos60 = 0.5
    views = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for j in range(n):
        Cj = C[j].expand_as(X)
        ray = Cj - X
        facing = (true_n * ray).sum(-1) > cos60 * torch.linalg.vector_norm(
            ray, dim=-1)
        slack = 1e-6 * torch.linalg.vector_norm(ray, dim=-1)
        views += (facing & sees(boxes, P[j].expand(X.shape[0], 3, 4), Cj, X,
                                width, height, slack)).long()
    keep = views >= min_views
    X, img = X[keep], img[keep]
    if X.shape[0] == 0:
        return 0, 0
    depth = torch.linalg.vector_norm(X - C[img], dim=-1)
    radius = 1.5 * csize * (2 ** level) * depth / K_focal
    pts = coord.to(X.dtype)
    covered = 0
    for s in range(0, X.shape[0], block):
        if pts.shape[0] == 0:
            break
        dist = torch.cdist(X[s:s + block], pts,
                           compute_mode="donot_use_mm_for_euclid_dist")
        covered += int((dist.amin(1) <= radius[s:s + block]).sum())
    return covered, int(X.shape[0])
