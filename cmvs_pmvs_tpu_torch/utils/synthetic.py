"""Synthetic calibrated scenes with analytic ground truth.

The reference ships no test data (SURVEY.md section 4), so correctness is
established against procedurally rendered scenes where every pixel's 3D
pre-image is known in closed form: a textured plane (optionally several
slanted planes) viewed by a ring of pinhole cameras. Scene generators write
standard PMVS directory trees (visualize/ txt/ models/) so the full CLI
pipeline can run on them.

The port's own copy of cmvs_pmvs_tpu/utils/synthetic.py
(the port imports nothing of the JAX package), with two additions:
`write_bundle_file` takes the extent of its SfM points (the JAX default),
and `make_ring_bundle` is tests/test_cmvs_scale.py's CMVS bundle.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticScene:
    P: np.ndarray          # [N, 3, 4] projections
    centers: np.ndarray    # [N, 3]
    images: np.ndarray     # [N, H, W, 3] uint8
    width: int
    height: int
    # plane through origin: points X with plane_n . X = plane_d
    plane_n: np.ndarray
    plane_d: float

    @property
    def num(self) -> int:
        return self.P.shape[0]

    def plane_distance(self, points: np.ndarray) -> np.ndarray:
        """Unsigned distance of [..., 3] points to the ground-truth plane."""
        return np.abs(points @ self.plane_n - self.plane_d)


def _look_at(center: np.ndarray, target: np.ndarray,
             up: np.ndarray) -> np.ndarray:
    """World->camera rotation with +z toward the target."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _texture(x: np.ndarray, y: np.ndarray, rng: np.random.Generator,
             nwaves: int = 24, scale: float = 1.0) -> np.ndarray:
    """Smooth, high-contrast RGB texture: random sinusoid mixtures.

    Band-limited so bilinear interpolation is accurate; distinct patterns
    per channel so color NCC is informative.
    """
    out = np.zeros(x.shape + (3,))
    for c in range(3):
        freqs = rng.uniform(0.5, 6.0, size=(nwaves, 2)) * scale
        phases = rng.uniform(0, 2 * math.pi, size=nwaves)
        amps = rng.uniform(0.3, 1.0, size=nwaves)
        val = np.zeros_like(x)
        for k in range(nwaves):
            val = val + amps[k] * np.sin(
                freqs[k, 0] * x + freqs[k, 1] * y + phases[k])
        val = val - val.min()
        val = val / max(val.max(), 1e-9)
        out[..., c] = val
    return (out * 255.0).astype(np.uint8)


def make_plane_scene(num_cameras: int = 6, width: int = 320,
                     height: int = 240, focal: float = 400.0,
                     ring_radius: float = 1.2, ring_height: float = 3.0,
                     seed: int = 42,
                     tilt: float = 0.0) -> SyntheticScene:
    """Cameras on a ring above the plane z=0, looking at the origin.

    `tilt` rotates the plane about the x axis (radians) to exercise
    non-frontoparallel normals; the texture is attached to the plane.
    """
    rng = np.random.default_rng(seed)
    # plane frame: normal starts at +z, tilted about x
    ct, st = math.cos(tilt), math.sin(tilt)
    R_plane = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], dtype=float)
    plane_n = R_plane @ np.array([0.0, 0.0, 1.0])
    plane_u = R_plane @ np.array([1.0, 0.0, 0.0])
    plane_v = R_plane @ np.array([0.0, 1.0, 0.0])

    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]])
    Kinv = np.linalg.inv(K)

    Ps, centers, images = [], [], []
    us, vs = np.meshgrid(np.arange(width) + 0.0, np.arange(height) + 0.0)
    pix = np.stack([us, vs, np.ones_like(us)], axis=-1)  # [H, W, 3]

    for i in range(num_cameras):
        ang = 2 * math.pi * i / num_cameras
        C = np.array([ring_radius * math.cos(ang),
                      ring_radius * math.sin(ang), ring_height])
        R = _look_at(C, np.zeros(3), up=np.array([0.0, 1.0, 0.0]))
        t = -R @ C
        P = K @ np.hstack([R, t[:, None]])
        Ps.append(P)
        centers.append(C)

        # ray cast to the plane: X = C + s d, plane_n.X = 0
        d = pix @ (R.T @ Kinv).T      # [H, W, 3] world directions
        denom = d @ plane_n
        s = -(C @ plane_n) / denom
        X = C[None, None] + s[..., None] * d
        tex_x = X @ plane_u
        tex_y = X @ plane_v
        # x16: highest spatial frequency ~0.7 rad/px at the ring distance,
        # rich at pixel scale but safely below the bilinear Nyquist limit
        images.append(_texture(tex_x * 16.0, tex_y * 16.0,
                               np.random.default_rng(seed + 1000)))

    return SyntheticScene(
        P=np.stack(Ps), centers=np.stack(centers),
        images=np.stack(images), width=width, height=height,
        plane_n=plane_n, plane_d=0.0)


@dataclass
class OccludedScene:
    """Ground plane + floating boxes: occlusions, depth discontinuities
    and multi-surface geometry (the structures the reference's
    filterOutside/filterExact passes exist for,
    reference source/pmvs/filter.cpp:29-355)."""

    P: np.ndarray          # [N, 3, 4]
    centers: np.ndarray    # [N, 3]
    images: np.ndarray     # [N, H, W, 3] uint8
    width: int
    height: int
    boxes: np.ndarray      # [B, 2, 3] (min corner, max corner)

    @property
    def num(self) -> int:
        return self.P.shape[0]

    def surface_distance(self, points: np.ndarray) -> np.ndarray:
        """Unsigned distance of [..., 3] points to the nearest scene
        surface (plane z=0 or a box boundary)."""
        d = np.abs(points[..., 2])
        for lo, hi in self.boxes:
            c = (lo + hi) / 2.0
            half = (hi - lo) / 2.0
            q = np.abs(points - c) - half
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            inside = np.minimum(np.max(q, axis=-1), 0.0)
            d = np.minimum(d, np.abs(outside + inside))
        return d


def _ray_box(C, d, lo, hi):
    """Slab intersection: t of first hit (inf when missed).

    C [3]; d [..., 3]. Returns t [...]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo[None, None] - C) / d
        t2 = (hi[None, None] - C) / d
    tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
    hit = (tmax >= np.maximum(tmin, 1e-6))
    return np.where(hit, tmin, np.inf)


def make_occluded_scene(num_cameras: int = 10, width: int = 320,
                        height: int = 240, focal: float = 400.0,
                        ring_radius: float = 1.6, ring_height: float = 3.2,
                        seed: int = 42) -> OccludedScene:
    """Textured ground plane with 3 textured boxes on it, viewed by a
    camera ring: each view occludes different parts of the ground and
    of the box sides, so expansion must stop at depth edges and the
    visibility filters see real outliers."""
    rng = np.random.default_rng(seed)
    boxes = np.array([
        [[-0.55, -0.45, 0.0], [-0.05, 0.05, 0.45]],
        [[0.15, -0.15, 0.0], [0.65, 0.35, 0.7]],
        [[-0.25, 0.35, 0.0], [0.25, 0.75, 0.3]],
    ])

    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]])
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(width) + 0.0, np.arange(height) + 0.0)
    pix = np.stack([us, vs, np.ones_like(us)], axis=-1)

    Ps, centers, images = [], [], []
    for i in range(num_cameras):
        ang = 2 * math.pi * i / num_cameras
        C = np.array([ring_radius * math.cos(ang),
                      ring_radius * math.sin(ang), ring_height])
        R = _look_at(C, np.zeros(3), up=np.array([0.0, 1.0, 0.0]))
        t = -R @ C
        P = K @ np.hstack([R, t[:, None]])
        Ps.append(P)
        centers.append(C)

        d = pix @ (R.T @ Kinv).T
        # ground plane z = 0
        tz = np.where(d[..., 2] != 0.0, -C[2] / d[..., 2], np.inf)
        tz = np.where(tz > 1e-6, tz, np.inf)
        best_t = tz
        which = np.zeros(tz.shape, dtype=np.int64)   # 0 = plane
        for k, (lo, hi) in enumerate(boxes):
            tb = _ray_box(C, d, lo, hi)
            closer = tb < best_t
            best_t = np.where(closer, tb, best_t)
            which = np.where(closer, k + 1, which)
        X = C[None, None] + best_t[..., None] * d

        # fresh generators per view so every view renders the SAME
        # world-anchored texture
        img = _texture(X[..., 0] * 16.0, X[..., 1] * 16.0,
                       np.random.default_rng(seed + 2000))
        for k in range(len(boxes)):
            m = which == k + 1
            if not m.any():
                continue
            # box texture keyed on a surface parametrization that varies
            # along every face: mix of all three coords
            bt = _texture((X[..., 0] + X[..., 2]) * 20.0,
                          (X[..., 1] - X[..., 2]) * 20.0,
                          np.random.default_rng(seed + 2000 + k + 1))
            img = np.where(m[..., None], bt, img)
        images.append(img)

    return OccludedScene(
        P=np.stack(Ps), centers=np.stack(centers),
        images=np.stack(images), width=width, height=height, boxes=boxes)


def write_bundle_file(scene: SyntheticScene, root: str,
                      num_points: int = 400, seed: int = 7,
                      extent: float = 0.45) -> None:
    """Write a synthetic bundle.rd.out: SfM points sampled on the plane
    z = 0 within |x|, |y| <= extent, visible in every camera whose
    projection lands inside the image.

    Bundler convention stores R/t with the camera looking down -z; the
    reference drops cameras with f=0 and reads only visibility here, so
    we emit identity rotations and rely on the txt/ cameras for geometry
    (reference bundle.cpp:541-636 readBundle + prep).
    """
    rng = np.random.default_rng(seed)
    pts = []
    vis_lists = []
    trials = 0
    while len(pts) < num_points and trials < num_points * 20:
        trials += 1
        u = rng.uniform(-extent, extent)
        v = rng.uniform(-extent, extent)
        X = u * np.array([1.0, 0, 0]) + v * np.array([0.0, 1.0, 0])
        Xh = np.append(X, 1.0)
        vis = []
        for c in range(scene.num):
            pr = scene.P[c] @ Xh
            if pr[2] <= 0:
                continue
            x, y = pr[0] / pr[2], pr[1] / pr[2]
            if 0 <= x < scene.width and 0 <= y < scene.height:
                vis.append(c)
        if len(vis) >= 2:
            pts.append(X)
            vis_lists.append(vis)

    with open(os.path.join(root, "bundle.rd.out"), "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{scene.num} {len(pts)}\n")
        for c in range(scene.num):
            f.write("520.0 0 0\n1 0 0\n0 1 0\n0 0 1\n0 0 0\n")
        for X, vis in zip(pts, vis_lists):
            f.write(f"{X[0]} {X[1]} {X[2]}\n128 128 128\n")
            f.write(str(len(vis)) + " "
                    + " ".join(f"{c} 0 0.0 0.0" for c in vis) + "\n")


def write_pmvs_tree(scene: SyntheticScene, root: str,
                    mask_border: int = 0) -> None:
    """Write visualize/%08d.ppm + txt/%08d.txt (+ empty models/).

    `mask_border` > 0 additionally writes masks/%08d.pgm excluding a
    border of that many pixels (exercises the mask-pyramid gates the
    reference reads from masks/, photoSetS.cpp:30-44)."""
    from ..io.cameras import write_camera_txt
    from ..io.images import save_pgm, save_ppm
    os.makedirs(os.path.join(root, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(root, "txt"), exist_ok=True)
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    if mask_border > 0:
        os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    for i in range(scene.num):
        save_ppm(os.path.join(root, "visualize", "%08d.ppm" % i),
                 scene.images[i])
        write_camera_txt(os.path.join(root, "txt", "%08d.txt" % i),
                         scene.P[i])
        if mask_border > 0:
            m = np.zeros((scene.height, scene.width), np.uint8)
            b = mask_border
            m[b:-b, b:-b] = 1
            save_pgm(os.path.join(root, "masks", "%08d.pgm" % i), m)


def _value_noise(x: np.ndarray, y: np.ndarray, seed: int,
                 octaves: int = 5, base_freq: float = 4.0,
                 persistence: float = 0.55) -> np.ndarray:
    """Multi-octave value noise in [0, 1], world-anchored.

    Integer-hash lattice + smoothstep interpolation: the same (x, y)
    gives the same value in every view, so multi-view consistency is
    exact while the spectrum is photograph-like (power at all octaves)
    instead of the band-limited sinusoid mixtures of `_texture`.
    """
    out = np.zeros_like(x, dtype=np.float64)
    amp, total = 1.0, 0.0
    for k in range(octaves):
        f = base_freq * (2.0 ** k)
        xi = np.floor(x * f).astype(np.int64)
        yi = np.floor(y * f).astype(np.int64)
        xf = x * f - xi
        yf = y * f - yi

        def h(ix, iy):
            v = (ix * 374761393 + iy * 668265263
                 + np.int64(seed * 962287 + k * 104729))
            v = (v ^ (v >> 13)) * 1274126177
            v = v ^ (v >> 16)
            return (v & 0xFFFF).astype(np.float64) / 65535.0

        sx = xf * xf * (3.0 - 2.0 * xf)
        sy = yf * yf * (3.0 - 2.0 * yf)
        val = ((h(xi, yi) * (1 - sx) + h(xi + 1, yi) * sx) * (1 - sy)
               + (h(xi, yi + 1) * (1 - sx) + h(xi + 1, yi + 1) * sx) * sy)
        out += amp * val
        total += amp
        amp *= persistence
    return out / total


def make_textured_scene(num_cameras: int = 10, width: int = 320,
                        height: int = 240, focal: float = 400.0,
                        ring_radius: float = 1.6,
                        ring_height: float = 3.2,
                        seed: int = 42,
                        flat_radius: float = 0.28,
                        specular: float = 0.25,
                        jitter: float = 0.08,
                        noise_sigma: float = 2.0) -> OccludedScene:
    """The occluded scene rendered in a photographic regime
    (VERDICT r4 item 7): multi-octave noise textures, a TEXTURELESS
    disk on the ground (the regime setEdge exists for, reference
    image.cpp:407-471), a view-dependent specular lobe that violates
    the Lambertian NCC assumption, per-view photometric gain/bias
    jitter, and Gaussian sensor noise. Geometry (and the
    surface_distance oracle) is identical to make_occluded_scene.
    """
    rng = np.random.default_rng(seed)
    boxes = np.array([
        [[-0.55, -0.45, 0.0], [-0.05, 0.05, 0.45]],
        [[0.15, -0.15, 0.0], [0.65, 0.35, 0.7]],
        [[-0.25, 0.35, 0.0], [0.25, 0.75, 0.3]],
    ])
    light = np.array([0.3, -0.5, 0.8])
    light = light / np.linalg.norm(light)

    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]])
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(width) + 0.0, np.arange(height) + 0.0)
    pix = np.stack([us, vs, np.ones_like(us)], axis=-1)

    gains = rng.uniform(1.0 - jitter, 1.0 + jitter, (num_cameras, 3))
    biases = rng.uniform(-255 * jitter / 2, 255 * jitter / 2,
                         (num_cameras, 3))

    Ps, centers, images = [], [], []
    for i in range(num_cameras):
        ang = 2 * math.pi * i / num_cameras
        C = np.array([ring_radius * math.cos(ang),
                      ring_radius * math.sin(ang), ring_height])
        R = _look_at(C, np.zeros(3), up=np.array([0.0, 1.0, 0.0]))
        t = -R @ C
        P = K @ np.hstack([R, t[:, None]])
        Ps.append(P)
        centers.append(C)

        d = pix @ (R.T @ Kinv).T
        tz = np.where(d[..., 2] != 0.0, -C[2] / d[..., 2], np.inf)
        tz = np.where(tz > 1e-6, tz, np.inf)
        best_t = tz
        which = np.zeros(tz.shape, dtype=np.int64)
        for k, (lo, hi) in enumerate(boxes):
            tb = _ray_box(C, d, lo, hi)
            closer = tb < best_t
            best_t = np.where(closer, tb, best_t)
            which = np.where(closer, k + 1, which)
        X = C[None, None] + best_t[..., None] * d

        # world-anchored multi-octave albedo, distinct per channel
        img = np.stack([
            _value_noise(X[..., 0], X[..., 1], seed * 10 + c)
            for c in range(3)], axis=-1)
        for k in range(len(boxes)):
            m = which == k + 1
            if not m.any():
                continue
            bt = np.stack([
                _value_noise(X[..., 0] + X[..., 2],
                             X[..., 1] - X[..., 2],
                             seed * 10 + 100 * (k + 1) + c)
                for c in range(3)], axis=-1)
            img = np.where(m[..., None], bt, img)

        # textureless disk on the ground: flat mid-gray albedo
        flat = ((which == 0)
                & ((X[..., 0] - 0.9) ** 2 + (X[..., 1] + 0.9) ** 2
                   < flat_radius ** 2))
        img = np.where(flat[..., None], 0.55, img)

        # Lambertian shading + a view-dependent specular lobe on the
        # ground (n = +z): violates the constant-appearance assumption
        # the way glossy surfaces do in photographs
        vdir = C[None, None] - X
        vdir = vdir / np.linalg.norm(vdir, axis=-1, keepdims=True)
        half = vdir + light[None, None]
        half = half / np.linalg.norm(half, axis=-1, keepdims=True)
        spec = specular * np.maximum(half[..., 2], 0.0) ** 24
        ground = which == 0
        shade = 0.72 + 0.28 * np.where(ground, light[2], 0.85)
        val = img * shade[..., None] + np.where(
            ground, spec, 0.0)[..., None]

        # per-view photometric jitter + sensor noise, then quantize
        val = val * 255.0 * gains[i] + biases[i]
        val = val + rng.normal(0.0, noise_sigma, val.shape)
        images.append(np.clip(val, 0, 255).astype(np.uint8))

    return OccludedScene(
        P=np.stack(Ps), centers=np.stack(centers),
        images=np.stack(images), width=width, height=height,
        boxes=boxes)


def make_ring_bundle(n_cams: int = 300, n_pts: int = 30_000, seed: int = 7,
                     vis_window=(0.15, 0.5)) -> dict:
    """A CMVS problem at scale: cameras on a ring looking at a noisy
    point sphere, each point seen by the cameras within a random angular
    window of it (the generator of tests/test_cmvs_scale.py, bit for
    bit). Returns the problem's fields (coords, visibles, centers,
    ipscales, widths, heights, dlevel) as numpy arrays and lists."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    centers = np.stack([6.0 * np.cos(ang), 6.0 * np.sin(ang),
                        rng.normal(0, 0.5, n_cams)], axis=1)
    ipscales = np.full(n_cams, 800.0)
    pts = rng.normal(0, 1.0, (n_pts, 3))
    pang = np.arctan2(pts[:, 1], pts[:, 0])
    diff = np.abs((pang[:, None] - ang[None] + np.pi)
                  % (2 * np.pi) - np.pi)
    vis = diff < rng.uniform(*vis_window, (n_pts, 1))
    visibles = []
    keep = []
    for i in range(n_pts):
        v = np.nonzero(vis[i])[0]
        if len(v) >= 2:
            visibles.append(v.tolist())
            keep.append(i)
    return dict(coords=pts[keep], visibles=visibles, centers=centers,
                ipscales=ipscales, widths=np.full(n_cams, 640),
                heights=np.full(n_cams, 480), dlevel=5)
