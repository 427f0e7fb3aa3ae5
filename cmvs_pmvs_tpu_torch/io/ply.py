"""ASCII PLY writer/reader for patch clouds.

Schema matches reference source/pmvs/patchOrganizerS.cpp:687-779:
x y z nx ny nz diffuse_{red,green,blue} quality(=ncc).

The port's own copy of cmvs_pmvs_tpu/io/ply.py (the port imports nothing
of the JAX package). The writer prepares the arrays and hands them to the
host C++ writers (`io/writers`, `csrc/writers.cpp`); the bytes are the
same as the JAX package's Python writer.
"""
from __future__ import annotations

import numpy as np

from . import writers

_HEADER = """ply
format ascii 1.0
element vertex {n}
property float x
property float y
property float z
property float nx
property float ny
property float nz
property uchar diffuse_red
property uchar diffuse_green
property uchar diffuse_blue
property float quality
end_header
"""


def write_patch_ply(path: str, coords: np.ndarray, normals: np.ndarray,
                    colors: np.ndarray | None = None,
                    quality: np.ndarray | None = None) -> None:
    coords = np.asarray(coords).reshape(-1, 3)
    normals = np.asarray(normals).reshape(-1, 3)
    n = len(coords)
    if colors is None:
        colors = np.full((n, 3), 128, dtype=np.int64)
    else:
        colors = np.clip(np.floor(np.asarray(colors) + 0.5), 0,
                         255).astype(np.int64).reshape(-1, 3)
    if quality is None:
        quality = np.zeros(n)
    writers.write_ply(path, _HEADER.format(n=n),
                      np.concatenate([coords.astype(np.float64),
                                      normals.astype(np.float64)], 1),
                      colors, np.asarray(quality, np.float64).reshape(-1))


def read_ply_xyz(path: str) -> np.ndarray:
    """Read vertex x,y,z from an ASCII PLY (enough for comparisons)."""
    with open(path) as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError("Not a PLY file")
        nvert = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError("No end_header")
            if line.startswith("element vertex"):
                nvert = int(line.split()[2])
            if line.strip() == "end_header":
                break
        out = np.empty((nvert, 3))
        for i in range(nvert):
            vals = f.readline().split()
            out[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
    return out
