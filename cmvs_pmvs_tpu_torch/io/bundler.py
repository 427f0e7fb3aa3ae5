"""bundle.rd.out (Bundler SfM output) reader.

Format (reference source/cmvs/bundle.cpp:541-636):
    # comment lines
    <num_cameras> <num_points>
    per camera, 15 floats: f k1 k2 / R(9) / t(3)
    per point: x y z / r g b / num_views (cam_id key_id sx sy)*
Cameras with f == 0 are dropped and ids compacted; points with < 2
surviving views are dropped.

The port's own copy of cmvs_pmvs_tpu/io/bundler.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BundleData:
    # Compacted cameras (f != 0 only)
    focals: np.ndarray          # [C]
    distortions: np.ndarray     # [C, 2]  (k1, k2)
    rotations: np.ndarray       # [C, 3, 3]
    translations: np.ndarray    # [C, 3]
    original_ids: np.ndarray    # [C] index in the raw bundle file
    coords: np.ndarray          # [P, 3]
    colors: np.ndarray          # [P, 3]
    visibles: list[list[int]]   # per point, sorted compacted camera ids

    @property
    def num_cameras(self) -> int:
        return len(self.focals)

    @property
    def num_points(self) -> int:
        return len(self.coords)


def read_bundle(path: str) -> BundleData:
    tokens: list[str] = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            tokens.extend(line.split())
    it = iter(tokens)

    def nf() -> float:
        return float(next(it))

    def ni() -> int:
        return int(next(it))

    cnum, pnum = ni(), ni()
    ids = np.full(cnum, -1, dtype=np.int64)
    focals, dists, rots, trans, origs = [], [], [], [], []
    for c in range(cnum):
        params = [nf() for _ in range(15)]
        if params[0] != 0.0:
            ids[c] = len(focals)
            focals.append(params[0])
            dists.append(params[1:3])
            rots.append(np.array(params[3:12]).reshape(3, 3))
            trans.append(params[12:15])
            origs.append(c)

    coords, colors, visibles = [], [], []
    for _ in range(pnum):
        coord = [nf(), nf(), nf()]
        color = [nf(), nf(), nf()]
        num = ni()
        vis = []
        for _ in range(num):
            cam = ni()
            ni(); nf(); nf()  # key id, sx, sy (bundle.cpp:611-618)
            if cam >= cnum:
                continue
            if ids[cam] == -1:
                raise ValueError(f"camera {cam} has f=0 but is referenced")
            vis.append(int(ids[cam]))
        if len(vis) < 2:
            continue
        vis.sort()
        coords.append(coord)
        colors.append(color)
        visibles.append(vis)

    return BundleData(
        focals=np.array(focals, dtype=np.float64),
        distortions=np.array(dists, dtype=np.float64).reshape(-1, 2),
        rotations=np.array(rots, dtype=np.float64).reshape(-1, 3, 3),
        translations=np.array(trans, dtype=np.float64).reshape(-1, 3),
        original_ids=np.array(origs, dtype=np.int64),
        coords=np.array(coords, dtype=np.float64).reshape(-1, 3),
        colors=np.array(colors, dtype=np.float64).reshape(-1, 3),
        visibles=visibles,
    )
