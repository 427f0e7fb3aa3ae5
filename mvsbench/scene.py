"""The benchmark's scenes: a textured ground plane with three textured
boxes, seen by a ring of pinhole cameras, rendered on the device.

A PyTorch rewrite of the port's `utils/synthetic.make_occluded_scene`
(the test `test_mvsbench_scene.py` holds the two to the same images at
a small size): every pixel's ray is cast against the plane z = 0 and the
boxes in float64, and each surface is coloured by a world-anchored sum of
random sinusoids whose parameters come from numpy's `default_rng`, drawn
in the original's order. The whole ring is rendered in a few batched
calls, so the 47-view scene takes well under a second on a card where
the numpy original takes minutes on the host.

The geometry is also the ground truth the plain reference (reference.py)
judges a reconstruction's coverage by: `ray_depth` and
`surface_normal`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# The occluded scene's boxes (min corner, max corner), as the port's
# make_occluded_scene places them.
BOXES = (((-0.55, -0.45, 0.0), (-0.05, 0.05, 0.45)),
         ((0.15, -0.15, 0.0), (0.65, 0.35, 0.7)),
         ((-0.25, 0.35, 0.0), (0.25, 0.75, 0.3)))
# A second scene of the same cameras and object draws its textures from
# this offset of the first's texture seed.
SECOND_TEXTURES = 1_000_003


@dataclass
class Scene:
    """A rendered scene: level-0 projections, centres and uint8 images on
    the host, and the boxes of its geometry."""

    P: np.ndarray          # [N, 3, 4] float64
    centers: np.ndarray    # [N, 3]
    images: np.ndarray     # [N, H, W, 3] uint8
    boxes: np.ndarray      # [B, 2, 3]
    focal: float

    @property
    def num(self) -> int:
        return self.P.shape[0]


def look_at(center: np.ndarray, target: np.ndarray,
            up: np.ndarray) -> np.ndarray:
    """World-to-camera rotation with +z toward the target."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def ring_cameras(num: int, width: int, height: int, focal: float,
                 radius: float, height_z: float):
    """Projections [N, 3, 4], centres [N, 3] and world-to-camera rotations
    of a ring of cameras looking at the origin."""
    K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]])
    Ps, Cs, Rs = [], [], []
    for i in range(num):
        ang = 2 * math.pi * i / num
        C = np.array([radius * math.cos(ang), radius * math.sin(ang),
                      height_z])
        R = look_at(C, np.zeros(3), up=np.array([0.0, 1.0, 0.0]))
        Ps.append(K @ np.hstack([R, (-R @ C)[:, None]]))
        Cs.append(C)
        Rs.append(R)
    return np.stack(Ps), np.stack(Cs), np.stack(Rs), K


def texture_params(rng: np.random.Generator, nwaves: int = 24):
    """Frequencies [3, W, 2], phases [3, W] and amplitudes [3, W] of the
    three channels, drawn in the original's order."""
    f, p, a = [], [], []
    for _ in range(3):
        f.append(rng.uniform(0.5, 6.0, size=(nwaves, 2)))
        p.append(rng.uniform(0, 2 * math.pi, size=nwaves))
        a.append(rng.uniform(0.3, 1.0, size=nwaves))
    return np.stack(f), np.stack(p), np.stack(a)


def texture(x: torch.Tensor, y: torch.Tensor, params) -> torch.Tensor:
    """uint8 RGB [N, H, W, 3] of sinusoid sums at surface coordinates x, y
    [N, H, W]; each of the N images is normalized to [0, 255] over its own
    pixels per channel, as the original normalizes each rendered view."""
    freqs, phases, amps = (torch.as_tensor(v, dtype=x.dtype,
                                           device=x.device) for v in params)
    out = []
    for c in range(3):
        val = torch.zeros_like(x)
        for k in range(freqs.shape[1]):
            val = val + amps[c, k] * torch.sin(
                freqs[c, k, 0] * x + freqs[c, k, 1] * y + phases[c, k])
        flat = val.reshape(val.shape[0], -1)
        val = val - flat.amin(1)[:, None, None]
        top = val.reshape(val.shape[0], -1).amax(1).clamp(min=1e-9)
        out.append(val / top[:, None, None])
    # numpy's astype(uint8) truncates toward zero
    return torch.trunc(torch.stack(out, -1) * 255.0).to(torch.uint8)


def ray_directions(K: np.ndarray, R: np.ndarray, width: int, height: int,
                   device) -> torch.Tensor:
    """[N, H, W, 3] world directions of every pixel centre's ray (not
    normalized), float64."""
    Kinv = torch.as_tensor(np.linalg.inv(K), dtype=torch.float64,
                           device=device)
    Rt = torch.as_tensor(R, dtype=torch.float64,
                         device=device).transpose(1, 2)
    us = torch.arange(width, dtype=torch.float64, device=device)
    vs = torch.arange(height, dtype=torch.float64, device=device)
    v, u = torch.meshgrid(vs, us, indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], -1)        # [H, W, 3]
    M = Rt @ Kinv                                            # [N, 3, 3]
    return torch.einsum("hwk,njk->nhwj", pix, M)


def ray_box(C: torch.Tensor, d: torch.Tensor, lo, hi) -> torch.Tensor:
    """t of the first hit of rays C + t d with the box [lo, hi] (inf when
    missed); C broadcasts against d [..., 3]."""
    lo = torch.as_tensor(lo, dtype=d.dtype, device=d.device)
    hi = torch.as_tensor(hi, dtype=d.dtype, device=d.device)
    t1 = (lo - C) / d
    t2 = (hi - C) / d
    # numpy's nanmax / nanmin over the three slabs: a 0/0 slab is left
    # out, as the original's errstate-guarded division leaves it
    lo_t = torch.minimum(t1, t2)
    hi_t = torch.maximum(t1, t2)
    tmin = torch.where(torch.isnan(lo_t), -math.inf, lo_t).amax(-1)
    tmax = torch.where(torch.isnan(hi_t), math.inf, hi_t).amin(-1)
    hit = tmax >= torch.clamp(tmin, min=1e-6)
    return torch.where(hit, tmin, torch.full_like(tmin, math.inf))


def cast(C: torch.Tensor, d: torch.Tensor, boxes):
    """First hits of rays C + t d with the scene: (t, which) with which 0
    for the plane and k + 1 for box k."""
    tz = torch.where(d[..., 2] != 0.0, -C[..., 2] / d[..., 2],
                     torch.full_like(d[..., 2], math.inf))
    best = torch.where(tz > 1e-6, tz, torch.full_like(tz, math.inf))
    which = torch.zeros(best.shape, dtype=torch.int64, device=d.device)
    for k, (lo, hi) in enumerate(boxes):
        tb = ray_box(C, d, lo, hi)
        closer = tb < best
        best = torch.where(closer, tb, best)
        which = torch.where(closer, k + 1, which)
    return best, which


def render(num: int, width: int, height: int, focal: float, radius: float,
           height_z: float, texture_seed: int, device,
           boxes=BOXES) -> Scene:
    """The occluded scene with textures from `texture_seed`, rendered on
    `device` (the original's `seed`)."""
    P, C, R, K = ring_cameras(num, width, height, focal, radius, height_z)
    d = ray_directions(K, R, width, height, device)
    Ct = torch.as_tensor(C, dtype=torch.float64, device=device)[:, None,
                                                                None, :]
    t, which = cast(Ct, d, boxes)
    X = Ct + t[..., None] * d
    img = texture(X[..., 0] * 16.0, X[..., 1] * 16.0, texture_params(
        np.random.default_rng(texture_seed + 2000)))
    for k in range(len(boxes)):
        m = which == k + 1
        if not bool(m.any()):
            continue
        bt = texture((X[..., 0] + X[..., 2]) * 20.0,
                     (X[..., 1] - X[..., 2]) * 20.0, texture_params(
                         np.random.default_rng(texture_seed + 2000 + k + 1)))
        img = torch.where(m[..., None], bt, img)
    return Scene(P=P, centers=C, images=img.cpu().numpy(),
                 boxes=np.asarray(boxes, np.float64), focal=focal)


def ray_depth(boxes, C: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Distance t (in units of |d|) to the first surface along C + t d."""
    return cast(C, d, boxes)[0]


def surface_normal(boxes, X: torch.Tensor) -> torch.Tensor:
    """Unit normal [..., 3] of the surface nearest each point X [..., 3]:
    +z for the plane, the normal of the nearest face for a box."""
    best = X[..., 2].abs()
    normal = torch.zeros_like(X)
    normal[..., 2] = 1.0
    for lo, hi in boxes:
        lo = torch.as_tensor(lo, dtype=X.dtype, device=X.device)
        hi = torch.as_tensor(hi, dtype=X.dtype, device=X.device)
        # the six faces: distance to each face's rectangle
        for axis in range(3):
            for side, val in ((-1.0, lo[axis]), (1.0, hi[axis])):
                q = X.clone()
                q[..., axis] = val
                others = [a for a in range(3) if a != axis]
                for a in others:
                    q[..., a] = X[..., a].clamp(lo[a], hi[a])
                dist = torch.linalg.vector_norm(X - q, dim=-1)
                closer = dist < best
                n = torch.zeros_like(X)
                n[..., axis] = side
                normal = torch.where(closer[..., None], n, normal)
                best = torch.where(closer, dist, best)
    return normal
