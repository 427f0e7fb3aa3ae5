"""End-to-end check: a full reconstruction, PASS or FAIL.

Port of scripts/verify_e2e.py: the 5-camera 256x192 plane scene (focal
400) through `reconstruct` (expand_iters 1, max_waves 2, 8-iteration
refine, p_cap 30,000; K1 and K2 on the card), then one JSON line
`{"verify": "PASS"|"FAIL", "patches": ..., "median_offset": ...,
"models": [...]}` with the reference's bars: more than 500 patches (at
another image size, 500 scaled by its pixel count), the median plane
distance / dscale < 0.3, a .patch and a .ply written. Exit code 0 on
PASS, 1 on FAIL.

    python -m cmvs_pmvs_tpu_torch.scripts.verify_e2e [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from ..device import resolve_device

OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
          "timages -1 0 {n}\noimages 0\n")
MAX_MEDIAN = 0.3


def write_tree(root: str, width: int = 256, height: int = 192,
               num_cameras: int = 5):
    """The plane scene (focal 400 at 256 px wide, scaled with the width)
    as a PMVS tree at `root` with its option.txt; returns the scene."""
    from ..utils.synthetic import make_plane_scene, write_pmvs_tree
    scene = make_plane_scene(num_cameras=num_cameras, width=width,
                             height=height, focal=400.0 * width / 256)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(OPTION.format(n=num_cameras))
    return scene


def check(root: str, scene, device="cuda", p_cap: int = 30000,
          log=lambda *a: None) -> dict:
    """Reconstruct the tree at `root` and hold it to the bars (`p_cap`
    is the engine's initial capacity; it grows as needed)."""
    from ..models.engine import reconstruct
    dev = resolve_device(device)
    eng = reconstruct(root, "option.txt", p_cap=p_cap, expand_iters=1,
                      max_waves=2, refine_iters=8, device=dev, log=log)
    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    coord = eng.cloud.coord.cpu().numpy()[alive]
    dscale = eng.cloud.dscale.cpu().numpy()[alive]
    med = float(np.median(scene.plane_distance(coord[:, :3]) / dscale)) \
        if n else float("inf")
    h, w = scene.images[0].shape[:2]
    min_patches = 500 * w * h / (256 * 192)
    models = sorted(os.listdir(os.path.join(root, "models")))
    ok = n > min_patches and med < MAX_MEDIAN \
        and any(m.endswith(".patch") for m in models) \
        and any(m.endswith(".ply") for m in models)
    return {"verify": "PASS" if ok else "FAIL", "patches": n,
            "median_offset": round(med, 4), "models": models,
            "min_patches": min_patches}


def verify(width: int = 256, height: int = 192, device="cuda") -> dict:
    """Write the scene under the temp directory, check it, remove it."""
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="verify_e2e_")
    try:
        return check(root, write_tree(root, width, height), dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = verify(device=args.device)
    print(json.dumps(r))
    return 0 if r["verify"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
