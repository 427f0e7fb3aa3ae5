""".patch / .pset text formats for reconstructed patch clouds.

Format (reference source/pmvs/patch.cpp:30-48 per patch,
source/pmvs/patchOrganizerS.cpp:98-131 file level):
    PATCHES
    <num>
    PATCHS
    x y z 1
    nx ny nz 0
    ncc dscale ascale
    <num images> / ids / <num vimages> / ids

The port's own copy of cmvs_pmvs_tpu/io/patches.py (the port imports
nothing of the JAX package). The writers take the cloud as arrays and
hand them to the host C++ writers (`io/writers`, `csrc/writers.cpp`);
the bytes are the same as the JAX package's Python writers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import writers


@dataclass
class PatchRecord:
    coord: np.ndarray           # [4] homogeneous (w = 1)
    normal: np.ndarray          # [4] (w = 0)
    ncc: float = -1.0
    dscale: float = 0.0
    ascale: float = 0.0
    images: list[int] = field(default_factory=list)
    vimages: list[int] = field(default_factory=list)


def write_patch_arrays(path: str, coord, normal, ncc, dscale, ascale,
                       images, vimages) -> None:
    """The .patch file of a cloud held as arrays: coord/normal [P, 4],
    ncc/dscale/ascale [P], images/vimages [P, K] int ids, -1 padded
    (negative ids are left out). Same bytes as the JAX package's
    `write_patch_file` on the matching records."""
    heads = np.concatenate(
        [np.asarray(coord, np.float64).reshape(-1, 4),
         np.asarray(normal, np.float64).reshape(-1, 4),
         np.stack([np.asarray(v, np.float64).reshape(-1)
                   for v in (ncc, dscale, ascale)], 1)], 1)
    writers.write_patch(path, heads, images, vimages)


def read_patch_file(path: str) -> list[PatchRecord]:
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "PATCHES":
        raise ValueError(f"Bad patch file header: {tokens[0]}")
    num = int(tokens[1])
    out: list[PatchRecord] = []
    i = 2
    for _ in range(num):
        header = tokens[i]; i += 1
        coord = np.array([float(t) for t in tokens[i:i + 4]]); i += 4
        normal = np.array([float(t) for t in tokens[i:i + 4]]); i += 4
        ncc, dscale, ascale = (float(t) for t in tokens[i:i + 3]); i += 3
        if header == "PATCHA":  # legacy variant (patch.cpp:12-15)
            i += 5
        nimg = int(tokens[i]); i += 1
        images = [int(t) for t in tokens[i:i + nimg]]; i += nimg
        nvimg = int(tokens[i]); i += 1
        vimages = [int(t) for t in tokens[i:i + nvimg]]; i += nvimg
        out.append(PatchRecord(coord, normal, ncc, dscale, ascale,
                               images, vimages))
    return out


def write_pset(path: str, coords: np.ndarray, normals: np.ndarray) -> None:
    """x y z nx ny nz per line (reference patchOrganizerS.cpp:118-131)."""
    writers.write_pset(path, np.concatenate(
        [np.asarray(coords, np.float64).reshape(-1, 3),
         np.asarray(normals, np.float64).reshape(-1, 3)], 1))


def read_pset(path: str) -> tuple[np.ndarray, np.ndarray]:
    data = np.loadtxt(path, dtype=np.float64).reshape(-1, 6)
    return data[:, :3], data[:, 3:]
