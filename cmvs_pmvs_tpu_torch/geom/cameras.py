"""Batched camera geometry on tensors.

Counterpart of cmvs_pmvs_tpu/geom/cameras.py: all N cameras live in one
struct-of-arrays `CameraSet`; level-l projections are derived on the fly
(rows 0-1 divided by 2^l, reference camera.cpp:56-68). Points are
homogeneous [..., 4] (w=1), normals have w=0; projections return
[..., 3] = (x, y, 1) or PROJ_SENTINEL behind the camera.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PROJ_SENTINEL = -65535.0  # reference camera.hpp:95-99 (-0xffff)
_CLIP = 1.0e9


@dataclass(frozen=True)
class CameraSet:
    """All cameras of a reconstruction problem (CCamera::updateCamera,
    camera.cpp:109-136; COptim::setAxesScales, optim.cpp:43-64)."""

    P: torch.Tensor          # [N, 3, 4] level-0 projections
    center: torch.Tensor     # [N, 4] optical centers (w = 1)
    oaxis: torch.Tensor      # [N, 4] unit optical axis
    xaxis: torch.Tensor      # [N, 3]
    yaxis: torch.Tensor      # [N, 3]
    zaxis: torch.Tensor      # [N, 3]
    ipscale: torch.Tensor    # [N]
    ipscale_optim: torch.Tensor  # [N]

    @property
    def num(self) -> int:
        return self.P.shape[0]


def build_camera_set(P: np.ndarray, dtype=torch.float32,
                     device="cpu") -> CameraSet:
    """Derive the per-camera quantities from [N, 3, 4] projections, in
    float64 numpy (the optical-center solve is ill-conditioned in f32)."""
    P = np.asarray(P, dtype=np.float64).reshape(-1, 3, 4)
    n = P.shape[0]
    oaxis = P[:, 2, :].copy()
    oaxis = oaxis / np.linalg.norm(oaxis[:, :3], axis=1, keepdims=True)
    center = np.ones((n, 4))
    ortho = np.all(P[:, 2, :3] == 0.0, axis=1)
    for i in range(n):
        if ortho[i]:
            v = np.cross(P[i, 0, :3], P[i, 1, :3])
            center[i, :3] = v / np.linalg.norm(v)
            center[i, 3] = 0.0
        else:
            center[i, :3] = np.linalg.solve(P[i, :, :3], -P[i, :, 3])
    zaxis = oaxis[:, :3]
    xaxis = P[:, 0, :3]
    yaxis = np.cross(zaxis, xaxis)
    yaxis /= np.linalg.norm(yaxis, axis=1, keepdims=True)
    xaxis = np.cross(yaxis, zaxis)
    ipscale = (np.linalg.norm(P[:, 0, :3], axis=1)
               + np.linalg.norm(P[:, 1, :3], axis=1)) / 2.0
    ipscale = np.where(ipscale == 0.0, 1.0, ipscale)
    ipscale_optim = (np.einsum("nk,nk->n", xaxis, P[:, 0, :3])
                     + np.einsum("nk,nk->n", yaxis, P[:, 1, :3]))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return CameraSet(P=t(P), center=t(center), oaxis=t(oaxis),
                     xaxis=t(xaxis), yaxis=t(yaxis), zaxis=t(zaxis),
                     ipscale=t(ipscale), ipscale_optim=t(ipscale_optim))


def level_projection(P, level):
    """Rows 0-1 divided by 2^level; `level` may be an int or a tensor of
    per-element levels broadcasting against P's leading dims."""
    if isinstance(level, torch.Tensor):
        scale = torch.pow(2.0, level.to(P.dtype))
        div = torch.stack([scale, scale, torch.ones_like(scale)], dim=-1)
        return P / div[..., :, None]
    s = float(2.0 ** level)
    div = torch.tensor([s, s, 1.0], dtype=P.dtype, device=P.device)
    return P / div[:, None]


def mult(P, coord, level=0):
    """Raw projective product, no divide (camera.hpp:110-117)."""
    Pl = level_projection(P, level)
    return (Pl * coord[..., None, :]).sum(-1)


def project(P, coord, level=0):
    """Pinhole projection with the behind-camera sentinel
    (camera.hpp:89-108). Broadcasts over leading dims."""
    v = mult(P, coord, level)
    z = v[..., 2:3]
    bad = z <= 0.0
    out = v / torch.where(bad, torch.ones_like(z), z)
    out = out.clamp(-_CLIP, _CLIP)
    sentinel = torch.tensor([PROJ_SENTINEL, PROJ_SENTINEL, -1.0],
                            dtype=out.dtype, device=out.device)
    return torch.where(bad, sentinel, out)


def unit3(v):
    """v divided by the norm of its xyz part (homogeneous rays)."""
    return v / torch.linalg.vector_norm(v[..., :3], dim=-1, keepdim=True)


def get_unit(cams: CameraSet, index, coord, level):
    """Footprint of one pixel at `coord` in camera `index`
    (optim.cpp:1116-1124)."""
    fz = torch.linalg.vector_norm(
        coord[..., :3] - cams.center[index][..., :3], dim=-1)
    ipscale = cams.ipscale_optim[index]
    zero = ipscale == 0.0
    unit = 2.0 * fz * (2.0 ** level) / torch.where(
        zero, torch.ones_like(ipscale), ipscale)
    return torch.where(zero, torch.ones_like(unit), unit)


def get_paxes(cams: CameraSet, index, coord, normal, level):
    """Patch tangent frame scaled to ~1 px steps in camera `index`
    (optim.cpp:1127-1144). Returns (pxaxis, pyaxis), w = 0."""
    pscale = get_unit(cams, index, coord, level)
    n3 = normal[..., :3]
    y3 = torch.linalg.cross(n3, cams.xaxis[index])
    y3 = y3 / torch.linalg.vector_norm(y3, dim=-1, keepdim=True)
    x3 = torch.linalg.cross(y3, n3)
    zeros = torch.zeros(x3.shape[:-1] + (1,), dtype=coord.dtype,
                        device=coord.device)
    px = torch.cat([x3, zeros], -1) * pscale[..., None]
    py = torch.cat([y3, zeros], -1) * pscale[..., None]
    Pl = cams.P[index]
    pc = project(Pl, coord, level)
    xdis = torch.linalg.vector_norm(project(Pl, coord + px, level) - pc,
                                    dim=-1)
    ydis = torch.linalg.vector_norm(project(Pl, coord + py, level) - pc,
                                    dim=-1)
    xdis = torch.where(xdis == 0.0, torch.ones_like(xdis), xdis)
    ydis = torch.where(ydis == 0.0, torch.ones_like(ydis), ydis)
    return px / xdis[..., None], py / ydis[..., None]


def fundamental_matrix(P0, P1, level=0):
    """F from 4x4 determinants of projection rows (camera.hpp:129-151);
    the epipolar line of p0 in image 1 is F^T p0."""
    p0 = level_projection(P0, level)
    p1 = level_projection(P1, level)
    p0, p1 = torch.broadcast_tensors(p0, p1)
    pairs = [(1, 2), (2, 0), (0, 1)]
    rows = []
    for a, b in pairs:
        row = []
        for c, d in pairs:
            m = torch.stack([p0[..., a, :], p0[..., b, :], p1[..., c, :],
                             p1[..., d, :]], dim=-2)
            row.append(torch.linalg.det(m))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def epipolar_distance(F, p0, p1):
    """|unit(F p1) . p0| (camera.hpp:119-127)."""
    line = (F * p1[..., None, :]).sum(-1)
    ftmp = torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
    zero = ftmp == 0.0
    safe = torch.where(zero, torch.ones_like(ftmp), ftmp)
    d = ((line / safe[..., None]) * p0).sum(-1).abs()
    return torch.where(zero, torch.zeros_like(d), d)


def _solve(A, b):
    """Batched solve that never raises on a singular system (JAX's solve
    returns non-finite values there; callers mask such rows)."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def triangulate_dlt(P0l, P1l, icoord0, icoord1):
    """Two-view DLT triangulation via 3x3 normal equations
    (seed.cpp:340-384). P*l are level-adjusted projections; icoord* are
    [..., 2] pixel coords at that level. Returns [..., 4] points."""
    a0 = P0l[..., 0, :] - icoord0[..., 0:1] * P0l[..., 2, :]
    a1 = P0l[..., 1, :] - icoord0[..., 1:2] * P0l[..., 2, :]
    a2 = P1l[..., 0, :] - icoord1[..., 0:1] * P1l[..., 2, :]
    a3 = P1l[..., 1, :] - icoord1[..., 1:2] * P1l[..., 2, :]
    A4 = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)
    A = A4[..., :3]
    b = -A4[..., 3]
    ATA = A.transpose(-1, -2) @ A
    ATb = (A * b[..., None]).sum(-2)
    x = _solve(ATA, ATb)
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def unproject(P, icoord, level=0):
    """Solve P[:, :3] X = icoord - P[:, 3] (camera.cpp:505-517)."""
    Pl = level_projection(P, level)
    x = _solve(Pl[..., :, :3], icoord - Pl[..., :, 3])
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
