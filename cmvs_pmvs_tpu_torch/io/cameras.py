"""Camera parameter files: CONTOUR / CONTOUR2 / CONTOUR3 text format.

Replicates reference source/image/camera.cpp:
  CONTOUR  (:26-27, :265-271)  raw 3x4 projection, 12 numbers row-major
  CONTOUR2 (:28-29, :272-294)  K compact form [fx fy skew cx cy ?] +
                               Euler extrinsics [a b g tx ty tz] (degrees)
  CONTOUR3 (:30-31, :295-312)  [fovx width height 0 0 0] + [tx ty tz rx ry rz]
All variants reduce to a 3x4 level-0 projection matrix.

The port's own copy of cmvs_pmvs_tpu/io/cameras.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math

import numpy as np


def q2proj(q: np.ndarray) -> np.ndarray:
    """Euler(angles deg a,b,g)+translation -> 4x4 RT
    (reference camera.cpp:406-426)."""
    a, b, g = (math.radians(float(x)) for x in q[:3])
    s1, s2, s3 = math.sin(a), math.sin(b), math.sin(g)
    c1, c2, c3 = math.cos(a), math.cos(b), math.cos(g)
    m = np.eye(4)
    m[0, 0] = c2 * c3
    m[0, 1] = c3 * s2 * s1 - s3 * c1
    m[0, 2] = c3 * s2 * c1 + s3 * s1
    m[1, 0] = s3 * c2
    m[1, 1] = s3 * s2 * s1 + c3 * c1
    m[1, 2] = s3 * s2 * c1 - c3 * s1
    m[2, 0] = -s2
    m[2, 1] = c2 * s1
    m[2, 2] = c2 * c1
    m[0, 3], m[1, 3], m[2, 3] = q[3], q[4], q[5]
    return m


def proj2q(mat: np.ndarray) -> np.ndarray:
    """4x4 RT -> Euler(angles deg a,b,g)+translation, the inverse of
    q2proj (reference camera.cpp:368-404) including the gimbal-lock
    branches and the +-180 degree wrap."""
    mat = np.asarray(mat, dtype=np.float64)
    q = np.zeros(6)
    q[3:6] = mat[:3, 3]
    if mat[2, 0] == 1.0:
        q[1] = -math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(-mat[0, 1], mat[1, 1])
    elif mat[2, 0] == -1.0:
        q[1] = math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(mat[0, 1], mat[1, 1])
    else:
        q[1] = math.asin(-mat[2, 0])
        s = 1.0 if math.cos(q[1]) > 0.0 else -1.0
        q[0] = math.atan2(mat[2, 1] * s, mat[2, 2] * s)
        q[2] = math.atan2(mat[1, 0] * s, mat[0, 0] * s)
    q[:3] = np.degrees(q[:3])
    for i in range(3):
        if abs(q[i]) > 180.0:
            q[i] = q[i] - 360.0 if q[i] > 0 else q[i] + 360.0
    return q


def projection_from_txt(txt_type: int, intrinsics: np.ndarray,
                        extrinsics: np.ndarray) -> np.ndarray:
    """Compose the 3x4 level-0 projection (reference camera.cpp:257-366)."""
    if txt_type == 0:
        params = np.concatenate([intrinsics, extrinsics]).astype(np.float64)
        return params.reshape(3, 4)
    if txt_type == 2:
        K = np.zeros((4, 4))
        K[0, 0], K[1, 1] = intrinsics[0], intrinsics[1]
        K[0, 1], K[0, 2] = intrinsics[2], intrinsics[3]
        K[1, 2] = intrinsics[4]
        K[2, 2] = K[3, 3] = 1.0
        mtmp = K @ q2proj(extrinsics)
        return mtmp[:3, :]
    if txt_type == 3:
        # fovx(deg), width, height | tx ty tz rx ry rz (camera.cpp:295-366)
        fovx = math.radians(float(intrinsics[0]))
        width, height = float(intrinsics[1]), float(intrinsics[2])
        f = width / 2.0 / math.tan(fovx / 2.0)
        K = np.array([[f, 0.0, 0.0], [0.0, f, 0.0], [0.0, 0.0, -1.0]])
        trans = np.array([[1.0, 0.0, width / 2.0],
                          [0.0, -1.0, height / 2.0],
                          [0.0, 0.0, 1.0]])
        K = trans @ K
        rx, ry, rz = (math.radians(float(x)) for x in extrinsics[3:6])
        Rx = np.array([[1, 0, 0],
                       [0, math.cos(rx), -math.sin(rx)],
                       [0, math.sin(rx), math.cos(rx)]])
        Ry = np.array([[math.cos(ry), 0, math.sin(ry)],
                       [0, 1, 0],
                       [-math.sin(ry), 0, math.cos(ry)]])
        Rz = np.array([[math.cos(rz), -math.sin(rz), 0],
                       [math.sin(rz), math.cos(rz), 0],
                       [0, 0, 1]])
        R = Rx.T @ Ry.T @ Rz.T
        t = np.asarray(extrinsics[:3], dtype=np.float64)
        P = np.zeros((3, 4))
        P[:, :3] = K @ R
        P[:, 3] = -K @ (R @ t)
        return P
    raise ValueError(f"Unrecognizable txt format type: {txt_type}")


_TXT_TYPES = {"CONTOUR": 0, "CONTOUR2": 2, "CONTOUR3": 3}
_TXT_HEADERS = {v: k for k, v in _TXT_TYPES.items()}


def read_camera_txt_full(path: str):
    """Read a txt/%08d.txt camera file preserving the stored form ->
    (txt_type, intrinsics[6], extrinsics[6]) (reference camera.cpp:13-54:
    the reference keeps _txtType/_intrinsics/_extrinsics and re-derives
    the projection)."""
    with open(path) as f:
        tokens = f.read().split()
    header = tokens[0]
    if header not in _TXT_TYPES:
        raise ValueError(f"Unrecognizable txt format: {header}")
    vals = np.array([float(t) for t in tokens[1:13]])
    return _TXT_TYPES[header], vals[:6], vals[6:12]


def read_camera_txt(path: str) -> np.ndarray:
    """Read a txt/%08d.txt camera file -> 3x4 float64 projection matrix
    (reference camera.cpp:13-54)."""
    txt_type, intr, extr = read_camera_txt_full(path)
    return projection_from_txt(txt_type, intr, extr)


def write_camera_txt(path: str, P: np.ndarray = None, txt_type: int = 0,
                     intrinsics: np.ndarray = None,
                     extrinsics: np.ndarray = None) -> None:
    """Write a camera file (reference CCamera::write, camera.cpp:70-107):
    echoes the stored intrinsics/extrinsics under the matching header.
    Passing only P writes raw CONTOUR (intrinsics = first 6 entries of P,
    extrinsics = last 6, the txtType==0 storage layout)."""
    if intrinsics is None or extrinsics is None:
        if txt_type != 0:
            raise ValueError(
                "CONTOUR2/3 need explicit intrinsics+extrinsics")
        flat = np.asarray(P, dtype=np.float64).reshape(12)
        intrinsics, extrinsics = flat[:6], flat[6:]
    v = [f"{float(x):.17g}" for x in
         list(np.asarray(intrinsics).reshape(6))
         + list(np.asarray(extrinsics).reshape(6))]
    with open(path, "w") as f:
        f.write(_TXT_HEADERS[txt_type] + "\n")
        if txt_type == 0:
            f.write(" ".join(v[0:4]) + "\n")
            f.write(" ".join(v[4:8]) + "\n")
            f.write(" ".join(v[8:12]) + "\n")
        else:
            f.write(" ".join(v[0:6]) + "\n")
            f.write(" ".join(v[6:12]) + "\n")
